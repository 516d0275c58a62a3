"""The port's import boundary: ``fedtpu_torch`` and ``chip_smoke.py`` never
load JAX, its libraries or anything of ``fedtpu``.

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

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "fedtpu"}


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
