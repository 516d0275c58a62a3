"""The engines' telemetry and status boards against fedtpu's, after the
same rounds.

``Federation`` on the smallest config ``tests/torch_parity.py`` ``track``
builds (smallcnn, 4 clients, 2 rounds on the same batches), then a
``run()`` of fedtpu's MLP config with a seeded sign-flip attack that always fires;
``SimFederation`` over a 40-client population; ``AsyncFederation`` ticked
and fused. After the same calls both packages' registries hold the same
names, kinds and labels, the same counter and gauge values and the same
histogram counts, and ``status_snapshot()`` agrees in every key but
``updated_at``. One fedtpu engine is built per case. The constructors
take fedtpu's positional order, and ``mesh=`` names ROADMAP item 6.

The span cases reuse those engines (module fixtures, so nothing compiles
twice): ``Telemetry("trace")`` is swapped in after build on both sides,
and after the same calls (``Federation.step``, the sim's ``step`` and
``run_on_device``, the async ``tick`` and fused ticks) both tracers hold
the same spans, as (name, parent's name, args), and each snapshot names
its tracer's ``trace_id``.
"""

import inspect
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu import config as jconfig
from fedtpu.core import round as jround
from fedtpu.core.async_engine import AsyncFederation as JAsync
from fedtpu.core.engine import Federation as JFederation
from fedtpu.sim.engine import SimFederation as JSim
from fedtpu.obs import Telemetry as JTelemetry
from fedtpu_torch import config as tconfig
from fedtpu_torch.core import engine as tengine
from fedtpu_torch.core import round as tround
from fedtpu_torch.core.async_engine import AsyncFederation as TAsync
from fedtpu_torch.core.engine import Federation as TFederation
from fedtpu_torch.obs import Telemetry
from fedtpu_torch.ops.compression import make_compressor
from fedtpu_torch.sim.engine import SimFederation as TSim
from torch_parity import configs, round_inputs, seeded_data, track


def _shape(registry):
    """name -> [(labels, kind, value or histogram count)]."""
    out = {}
    for name, entries in registry.snapshot().items():
        out[name] = [
            (e["labels"], e["kind"], e["count"] if e["kind"] == "histogram" else e["value"])
            for e in entries
        ]
    return out


def _board(engine):
    snap = engine.status_snapshot()
    assert snap.pop("updated_at") > 0
    return snap


def _mlp(mod, **fed_kw):
    return mod.RoundConfig(
        model="mlp", num_classes=10, steps_per_round=2,
        opt=mod.OptimizerConfig(learning_rate=0.05, weight_decay=0.0),
        data=mod.DataConfig(dataset="synthetic", batch_size=8, eval_batch_size=64, num_examples=256,
                            augment=False, partition="round_robin"),
        fed=mod.FedConfig(num_clients=4, **fed_kw),
    )


def _spans(telemetry):
    """(name, parent's name, args without the ids) of each span, in the
    order they ended."""
    events = telemetry.trace_events()
    name_of = {e["args"]["span_id"]: e["name"] for e in events}
    return [(e["name"], name_of.get(e["args"].get("parent_id")),
             {k: v for k, v in e["args"].items() if k not in ("span_id", "parent_id")}) for e in events]


def _trace(jeng, teng):
    jeng.telemetry, teng.telemetry = JTelemetry("trace"), Telemetry("trace")


def _traced_board(eng):
    board = _board(eng)
    assert board.pop("trace_id") == eng.telemetry.tracer.trace_id
    return board


@pytest.fixture(scope="module")
def tracked():
    return track(*configs(), rounds=2)


@pytest.fixture(scope="module")
def sims():
    def cfg(mod):
        return mod.RoundConfig(
            model="mlp", num_classes=10, steps_per_round=2,
            opt=mod.OptimizerConfig(learning_rate=0.01, weight_decay=0.0),
            data=mod.DataConfig(dataset="synthetic", batch_size=4, partition="iid", num_examples=400,
                                device_layout="gather", augment=False),
            fed=mod.FedConfig(num_clients=8, sim=mod.SimConfig(
                population=40, scenario="dirichlet:alpha=0.3", malicious_fraction=0.25,
                attack="sign_flip")),
        )

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JSim(cfg(jconfig), seed=0), TSim(cfg(tconfig), seed=0, device="cpu")


@pytest.fixture(scope="module")
def asyncs():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng = JAsync(_mlp(jconfig), seed=0, buffer_k=2)
    return jeng, TAsync(_mlp(tconfig), seed=0, buffer_k=2, device="cpu")


def test_federation_step_counts_and_board_match_fedtpus(tracked):
    jfed, tfed = tracked
    assert _shape(tfed.telemetry.registry) == _shape(jfed.telemetry.registry)
    assert _shape(tfed.telemetry.registry)["fedtpu_rounds_completed_total"] == [({}, "counter", 2.0)]
    assert _board(tfed) == _board(jfed)
    assert _board(tfed) == {"role": "engine", "phase": "idle", "round": 2, "num_clients": 4,
                            "alive": [True] * 4}


def test_federation_run_counts_rounds_walls_and_attacks_as_fedtpus():
    # p=1: every seated attacker fires (fedtpu's fire draws are threefry
    # uniforms, which the port draws from its own generator).
    sim = dict(malicious_fraction=0.5, attack="sign_flip:p=1")
    jcfg, tcfg = _mlp(jconfig, sim=jconfig.SimConfig(**sim)), _mlp(tconfig, sim=tconfig.SimConfig(**sim))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jfed = JFederation(jcfg, seed=0)
    tfed = TFederation(tcfg, seed=0, device="cpu")
    jfed.run(num_rounds=2)
    tfed.run(num_rounds=2)
    fired = [rec["attackers_fired"] for rec in tfed.history]
    assert _shape(tfed.telemetry.registry) == _shape(jfed.telemetry.registry)
    shape = _shape(tfed.telemetry.registry)
    assert shape["fedtpu_round_wall_seconds"] == [({}, "histogram", 2)]
    assert fired == [2, 2]
    assert shape["fedtpu_attack_injected_total"] == [({"kind": "sign_flip"}, "counter", 4.0)]
    assert _board(tfed) == _board(jfed)
    # Swapped after construction, as fedtpu allows: nothing more counts.
    tfed.telemetry = Telemetry("off")
    tfed.step()
    assert tfed.telemetry.registry.snapshot() == {} and _board(tfed)["round"] == 3


def test_sim_gauges_and_board_match_fedtpus(sims):
    jfed, tfed = sims
    boards = []
    for fed in (jfed, tfed):
        fed.step()
        fed.run_on_device(2)
        boards.append(_board(fed))
    assert boards[1] == boards[0]
    assert boards[1]["sim"]["cohort_round"] == 1 and boards[1]["round"] == 3
    assert _shape(tfed.telemetry.registry) == _shape(jfed.telemetry.registry)
    gauges = _shape(tfed.telemetry.registry)
    assert gauges["fedtpu_sim_population"] == [({}, "gauge", 40.0)]
    assert {n for n in gauges if n.startswith("fedtpu_sim_")} == {
        "fedtpu_sim_malicious_in_cohort", "fedtpu_sim_population", "fedtpu_sim_cohort_size",
        "fedtpu_sim_heterogeneity_index", "fedtpu_sim_never_sampled"}


def test_async_counter_and_board_match_fedtpus(asyncs):
    jeng, teng = asyncs
    boards = []
    for eng in (jeng, teng):
        assert _board(eng)["role"] == "async_engine"
        eng.tick()
        eng.set_alive(3, False)
        eng.run_on_device(2)
        boards.append(_board(eng))
    assert boards[1] == boards[0]
    assert boards[1] == {"role": "async_engine", "phase": "idle", "round": 3, "num_clients": 4,
                         "fused_block": 2, "alive": [True, True, True, False]}
    assert _shape(teng.telemetry.registry) == _shape(jeng.telemetry.registry)
    assert _shape(teng.telemetry.registry)["fedtpu_async_updates_total"] == [({}, "counter", 3.0)]


def test_constructors_take_fedtpus_positional_order(monkeypatch):
    for jcls, tcls, n in ((JFederation, TFederation, 6), (JSim, TSim, 4)):
        jnames = list(inspect.signature(jcls.__init__).parameters)
        tnames = list(inspect.signature(tcls.__init__).parameters)
        assert tnames[:n + 1] == jnames[:n + 1], (tcls, tnames, jnames)
        assert tnames[n + 1:] == ["device", "draws"]
    _, tcfg = configs(compression="topk")
    codec = make_compressor(tcfg.fed)
    # fedtpu's positional call: the codec binds to ``compressor``, so the
    # engine never builds one of its own.
    monkeypatch.setattr(tengine, "make_compressor", lambda fed: pytest.fail("built a second codec"))
    fed = TFederation(tcfg, 0, codec, seeded_data(3), None, None, "cpu")
    assert fed.data_source == "caller" and fed.device.type == "cpu"
    with pytest.raises(NotImplementedError, match=r"ROADMAP.*slice 8, part 6"):
        TFederation(tcfg, 0, codec, seeded_data(3), object(), device="cpu")


def test_federation_step_spans_match_fedtpus(tracked):
    jfed, tfed = tracked
    _trace(jfed, tfed)
    x, y, sm = round_inputs(np.random.default_rng(5))
    w, alive = np.asarray(jfed.weights), np.ones(4, bool)
    jfed.step(jround.RoundBatch(x=jnp.asarray(x), y=jnp.asarray(y), step_mask=jnp.asarray(sm),
                                weights=jnp.asarray(w), alive=jnp.asarray(alive)))
    tfed.step(tround.RoundBatch(x=torch.from_numpy(x), y=torch.from_numpy(y), step_mask=torch.from_numpy(sm),
                                weights=torch.from_numpy(w.copy()), alive=torch.from_numpy(alive)))
    r = _board(tfed)["round"] - 1
    assert _spans(tfed.telemetry) == _spans(jfed.telemetry) == [("round", None, {"round": r})]
    assert _traced_board(tfed) == _traced_board(jfed)


def test_sim_and_fused_round_spans_match_fedtpus(sims):
    jfed, tfed = sims
    _trace(jfed, tfed)
    for fed in (jfed, tfed):
        fed.step()
        fed.run_on_device(2)
    r = _board(tfed)["round"] - 3
    assert _spans(tfed.telemetry) == _spans(jfed.telemetry) == [
        ("cohort_sample", None, {"round": r}), ("round", None, {"round": r}),
        ("cohort_sample", None, {"round": r + 1}), ("fused_rounds", None, {"round": r + 1, "num_rounds": 2})]
    assert _traced_board(tfed) == _traced_board(jfed)


def test_async_tick_spans_match_fedtpus(asyncs):
    jeng, teng = asyncs
    _trace(jeng, teng)
    for eng in (jeng, teng):
        eng.tick()
        eng.run_on_device(2)
    t = _board(teng)["round"] - 3
    assert _spans(teng.telemetry) == _spans(jeng.telemetry) == [
        ("async_tick", None, {"tick": t}), ("fused_ticks", None, {"tick": t + 1, "num_ticks": 2})]
    assert _traced_board(teng) == _traced_board(jeng)
