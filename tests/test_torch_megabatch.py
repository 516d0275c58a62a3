"""megabatch_clients and remat in the port.

- megabatch k=1 is bit-identical to the per-client path (fedtpu's own
  gate); k=2 tracks fedtpu's megabatched round within the plain round's
  ``atol=1e-5, rtol=1e-4``;
- remat (per-block recompute of MobileNet's blocks) gives the gradients
  and the round of the plain model, bit for bit, in f32 and with a bf16
  forward; the parameter names do not change.
"""

import numpy as np
import pytest
import torch
from torch.func import functional_call, grad, vmap

from fedtpu_torch import config as tconfig
from fedtpu_torch import models
from fedtpu_torch.core import round as tround
from fedtpu_torch.core.engine import Federation as TFederation
from torch_parity import configs, round_inputs, seeded_data, track


def test_megabatch_k1_bit_identical_to_per_client():
    _, base = configs()
    _, mega = configs(megabatch_clients=1)
    data = seeded_data(23)
    feds = [TFederation(cfg, seed=0, data=data, device="cpu") for cfg in (base, mega)]
    rng = np.random.default_rng(23)
    for _ in range(2):
        x, y, sm = round_inputs(rng)
        batch = tround.RoundBatch(x=torch.from_numpy(x), y=torch.from_numpy(y), step_mask=torch.from_numpy(sm),
                                  weights=feds[0].weights, alive=torch.tensor([True, False, True, True]))
        ms = [f.step(batch) for f in feds]
        assert torch.equal(ms[0].per_client_loss, ms[1].per_client_loss)
    for part in ("params", "opt_state"):
        a, b = (getattr(f.state, part) for f in feds)
        for k in a:
            assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), (part, k)


def test_megabatch_k2_tracks_fedtpu():
    jcfg, tcfg = configs(megabatch_clients=2)
    track(jcfg, tcfg, alive=[True, True, False, True])


def test_megabatch_must_divide_the_clients():
    _, tcfg = configs(megabatch_clients=3)
    with pytest.raises(ValueError, match="must divide"):
        TFederation(tcfg, data=seeded_data(0), device="cpu")


# --------------------------------------------------------------- remat


def _mobilenet_grads(remat, dtype):
    torch.manual_seed(0)
    model = models.create("mobilenet", 10, remat=remat)
    p = {k: v.detach().expand(2, *v.shape).clone() for k, v in model.named_parameters()}
    b = {k: v.detach().expand(2, *v.shape).clone() for k, v in model.named_buffers()}
    x = torch.randn(2, 3, 32, 32, 3, generator=torch.Generator().manual_seed(1))

    def loss(p, b, x):
        cast = {k: v.to(dtype) for k, v in p.items()}
        logits, stats = functional_call(model, (cast, b), (x.to(dtype),), {"train": True})
        return logits.float().square().mean(), stats

    return vmap(grad(loss, has_aux=True))(p, b, x), [n for n, _ in model.named_parameters()]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_remat_gradients_bit_equal(dtype):
    (g0, s0), names0 = _mobilenet_grads(False, dtype)
    (g1, s1), names1 = _mobilenet_grads(True, dtype)
    assert names0 == names1 and len(g0) == 83 and len(s1) == 54
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


def test_remat_round_bit_equal():
    """One MobileNet round (2 clients, batch 2) with and without remat."""
    rng = np.random.default_rng(2)
    data = (rng.normal(size=(8, 32, 32, 3)).astype(np.float32), rng.integers(0, 10, 8).astype(np.int32))
    states = []
    for remat in (False, True):
        cfg = tconfig.RoundConfig(
            model="mobilenet", steps_per_round=1, remat=remat,
            data=tconfig.DataConfig(batch_size=2, partition="iid", augment=False),
            fed=tconfig.FedConfig(num_clients=2),
        )
        fed = TFederation(cfg, seed=0, data=data, device="cpu")
        fed.step(fed.device_batch(0, offset=1))
        states.append(fed.state)
    for part in ("params", "batch_stats", "opt_state"):
        a, b = (getattr(s, part) for s in states)
        for k in a:
            assert torch.equal(a[k], b[k]), (part, k)


def test_remat_on_a_model_without_it_raises_like_fedtpu():
    with pytest.raises(ValueError, match="does not support remat"):
        models.create("smallcnn", 10, remat=True)
