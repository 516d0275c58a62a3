"""The port's import boundary: ``fedtpu_torch`` and ``chip_smoke.py`` never
load JAX, its libraries or anything of ``fedtpu``; importing
``chip_smoke.py`` loads neither grpc nor the ``msgpack`` package (its
federation phase imports grpc when it runs), and only the edge's socket
modules import grpc. The coordinator (``fedtpu_torch.ft``,
``fedtpu_torch.transport.federation``'s ``PrimaryServer`` and
``BackupServer``) and its fault injection, codec policy and mid tier
(``fedtpu_torch.ft.chaos``, ``transport.codec_policy``,
``transport.aggregator``) are held to the same boundary;
``fedtpu_torch.ft`` loads no grpc (the chaos interceptors import it when
they are built). The zoo (``fedtpu_torch.models``' families and
``fedtpu_torch.data.datasets``' loaders), the checkpoint store
(``fedtpu_torch.checkpoint``) and the massive-cohort engine
(``fedtpu_torch.sim``, ``SimFederation`` included), the asynchronous
engine (``fedtpu_torch.core.async_engine``) and the standalone trainer
(``fedtpu_torch.core.solo``) load none of them either; the observability
package (``fedtpu_torch.obs``, its tracer and trace propagation included)
loads not even torch.

One check imports every module in a fresh interpreter and looks at
``sys.modules``; the other reads every source file's imports. Top-level
names are compared exactly, so ``fedtpu_torch`` is not ``fedtpu``.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "fedtpu"}
# Packages chip_smoke.py's closure must not load, beside FORBIDDEN.
NOT_ON_THE_CARD = {"grpc", "msgpack"}
# The modules that open sockets, the only ones that may import grpc.
GRPC_MODULES = {("transport", "service.py"), ("transport", "retry.py"), ("transport", "federation.py"),
                ("transport", "aggregator.py")}
# Modules that import grpc inside the functions that build its classes only.
LAZY_GRPC_MODULES = {("ft", "chaos.py"), ("obs", "propagate.py")}


def _sources():
    return sorted((ROOT / "fedtpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax_and_no_fedtpu():
    script = f"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {str(ROOT)!r})
import fedtpu_torch
mods = [m.name for m in pkgutil.walk_packages(fedtpu_torch.__path__, "fedtpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # noqa: F401  (its own imports; main() does not run)
print(json.dumps({{"modules": mods, "loaded": sorted({{k.split(".")[0] for k in sys.modules}})}}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=120, cwd=str(ROOT), env=env,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(result["modules"]) >= 15, result["modules"]
    assert not FORBIDDEN & set(result["loaded"]), FORBIDDEN & set(result["loaded"])


def _loaded_by(imports: str):
    script = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
{imports}
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=120, cwd=str(ROOT), env=env,
    )
    assert proc.returncode == 0, proc.stderr
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_chip_smoke_closure_loads_no_grpc_and_no_msgpack():
    loaded = _loaded_by("import chip_smoke  # noqa: F401")
    assert "fedtpu_torch" in loaded
    assert not (FORBIDDEN | NOT_ON_THE_CARD) & loaded, (FORBIDDEN | NOT_ON_THE_CARD) & loaded
    # The edge's trainer and server math, and the package itself, neither.
    loaded = _loaded_by(
        "import fedtpu_torch.transport, fedtpu_torch.transport.trainer, "
        "fedtpu_torch.transport.aggregation  # noqa: F401"
    )
    assert not NOT_ON_THE_CARD & loaded, NOT_ON_THE_CARD & loaded


def test_coordinator_closure_loads_no_jax_and_no_fedtpu():
    loaded = _loaded_by(
        "import fedtpu_torch.ft\n"
        "from fedtpu_torch.transport.federation import BackupServer, PrimaryServer  # noqa: F401"
    )
    assert {"fedtpu_torch", "grpc"} <= loaded
    assert not FORBIDDEN & loaded, FORBIDDEN & loaded
    loaded = _loaded_by("import fedtpu_torch.ft  # noqa: F401")
    assert not (FORBIDDEN | NOT_ON_THE_CARD) & loaded, (FORBIDDEN | NOT_ON_THE_CARD) & loaded


def _imported_names(path, top_level_only=False):
    tree = ast.parse(path.read_text(), str(path))
    for node in (tree.body if top_level_only else ast.walk(tree)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_only_the_socket_modules_import_grpc_and_none_imports_msgpack():
    for path in _sources():
        where = (path.parent.name, path.name)
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top != "msgpack", f"{path}: imports {name}"
            if top == "grpc":
                assert where in GRPC_MODULES | LAZY_GRPC_MODULES, f"{path}: imports grpc"
        if where in LAZY_GRPC_MODULES:
            assert "grpc" not in {n.split(".")[0] for n in _imported_names(path, top_level_only=True)}, path


def test_fault_injection_policy_and_tier_load_no_jax_and_no_fedtpu():
    loaded = _loaded_by(
        "import fedtpu_torch.ft.chaos, fedtpu_torch.transport.codec_policy  # noqa: F401"
    )
    assert "fedtpu_torch" in loaded
    assert not (FORBIDDEN | NOT_ON_THE_CARD) & loaded, (FORBIDDEN | NOT_ON_THE_CARD) & loaded
    loaded = _loaded_by("from fedtpu_torch.transport.aggregator import AggregatorServer  # noqa: F401")
    assert {"fedtpu_torch", "grpc"} <= loaded
    assert not FORBIDDEN & loaded, FORBIDDEN & loaded


ZOO_MODULES = [
    "fedtpu_torch.models.mlp", "fedtpu_torch.models.lenet", "fedtpu_torch.models.smallcnn",
    "fedtpu_torch.models.resnet", "fedtpu_torch.models.preact_resnet", "fedtpu_torch.models.vgg",
    "fedtpu_torch.models.densenet", "fedtpu_torch.models.registry", "fedtpu_torch.data.datasets",
]


def test_zoo_loads_no_jax_no_fedtpu_and_no_grpc():
    for path in ZOO_MODULES:
        assert (ROOT / (path.replace(".", "/") + ".py")).exists(), path
    loaded = _loaded_by("import " + ", ".join(ZOO_MODULES) + "  # noqa: F401")
    assert "fedtpu_torch" in loaded
    assert not (FORBIDDEN | NOT_ON_THE_CARD) & loaded, (FORBIDDEN | NOT_ON_THE_CARD) & loaded


@pytest.mark.parametrize("imports", [
    "import fedtpu_torch.checkpoint, fedtpu_torch.checkpoint.writer  # noqa: F401",
    "import fedtpu_torch.sim\nfrom fedtpu_torch.sim import SimFederation  # noqa: F401",
    "from fedtpu_torch.core.async_engine import AsyncFederation, fedbuff_combine  # noqa: F401",
    "from fedtpu_torch.core.solo import SoloTrainer, run_solo  # noqa: F401",
    "from fedtpu_torch import AsyncFederation, SoloTrainer  # noqa: F401",
], ids=["checkpoint", "sim", "async", "solo", "exports"])
def test_checkpoint_and_sim_load_no_jax_no_fedtpu_and_no_grpc(imports):
    loaded = _loaded_by(imports)
    assert "fedtpu_torch" in loaded
    assert not (FORBIDDEN | NOT_ON_THE_CARD) & loaded, (FORBIDDEN | NOT_ON_THE_CARD) & loaded


@pytest.mark.parametrize("imports", [
    "import fedtpu_torch.obs  # noqa: F401",
    "from fedtpu_torch.obs import FlightRecorder, MetricsRegistry, ObsServer, Telemetry  # noqa: F401",
    "import fedtpu_torch.obs.trace, fedtpu_torch.obs.propagate  # noqa: F401",
    "from fedtpu_torch.obs import SpanTracer, Telemetry\nTelemetry('trace')  # noqa: F401",
], ids=["package", "names", "tracer", "traced"])
def test_obs_loads_no_torch_no_jax_and_no_grpc(imports):
    """The registry, the exporters, the flight recorder, the status plane,
    the tracer and trace propagation are host-only: config-only and ft
    users pay for no backend (the profiler bridge imports torch when a
    span opens, the interceptor grpc when it is built)."""
    loaded = _loaded_by(imports)
    assert "fedtpu_torch" in loaded
    assert not (FORBIDDEN | NOT_ON_THE_CARD | {"torch"}) & loaded, (FORBIDDEN | NOT_ON_THE_CARD | {"torch"}) & loaded


def test_no_source_file_imports_jax_or_fedtpu():
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"
