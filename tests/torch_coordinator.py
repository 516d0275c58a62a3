"""Shared helpers of the coordinator's tests: the same small config in
both packages, fleets of scripted clients over real gRPC on localhost, and
the two packages' primaries side by side.

A scripted client is a Trainer servicer of the test's own that trains
nothing: its StartTrain reply is a delta drawn from numpy, seeded by the
client's index and the lineage round, put on the wire by fedtpu's own
``sparse`` / ``wire`` encoders (a dense reply is the global model it last
received plus the delta). Two coordinators driving the same fleet get the
same bytes for the same global model, so their models must agree bit for
bit.
"""

import threading
import time
import warnings

import grpc

import jax
import numpy as np

from fedtpu import config as jconfig
from fedtpu.transport import federation as jfederation
from fedtpu.transport import proto as jproto
from fedtpu.transport import service as jservice
from fedtpu.transport import sparse as jsparse
from fedtpu.transport import wire as jwire
from fedtpu_torch import config as tconfig
from fedtpu_torch.transport import federation as tfederation
from test_federation import free_port

# Record fields both coordinators fill with the same meaning.
RECORD_FIELDS = ("participants", "alive", "stragglers", "aborted", "bytes_up",
                 "bytes_up_by_codec", "bytes_down", "round", "world", "aggregated")


def configs(screen=None, retry=None, **fed_kw):
    """smallcnn on CIFAR-10's synthetic fallback, in both packages."""
    def build(mod):
        extra = {}
        if screen:
            extra["screen"] = mod.ScreenConfig(**screen)
        if retry:
            extra["retry"] = mod.RetryPolicy(**retry)
        return mod.RoundConfig(
            model="smallcnn",
            opt=mod.OptimizerConfig(learning_rate=0.01),
            data=mod.DataConfig(dataset="cifar10", batch_size=8, eval_batch_size=16,
                                partition="iid", augment=False, num_examples=64),
            fed=mod.FedConfig(**{"num_clients": 4, "topk_fraction": 0.05, **fed_kw, **extra}),
        )

    return build(jconfig), build(tconfig)


def fedtpu_primary(jcfg, addrs, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jfederation.PrimaryServer(jcfg, addrs, **kw)


def host_tree(primary):
    """A primary's global model as the flax tree of numpy arrays."""
    if isinstance(primary, tfederation.PrimaryServer):
        return primary._host_model()
    return {"params": jax.tree.map(np.asarray, primary.params),
            "batch_stats": jax.tree.map(np.asarray, primary.batch_stats)}


def bits(tree):
    return [np.asarray(a, np.float32).view(np.int32) for a in jax.tree_util.tree_leaves(tree)]


def assert_bit_equal(got, want, what):
    g, w = bits(got), bits(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape, (what, i)
        bad = int((a != b).sum())
        assert bad == 0, f"{what}: leaf {i}: {bad} of {a.size} coordinates differ"


class ScriptedClient(jservice.TrainerServicer):
    """A client that answers StartTrain with a seeded delta in ``codec``
    (``layout`` per_leaf or flat); ``scale`` multiplies its deltas (an
    attacker's); ``delay_s`` or ``gate`` holds a reply back (a straggler),
    ``send_gate`` a SendModel;
    ``fence_at`` rejects a lower coordinator epoch as stale; ``obey_codec``
    answers in the codec a StartTrain asks for (``TrainRequest.codec``);
    ``down`` fails every RPC UNAVAILABLE (a client gone silently)."""

    def __init__(self, index, like, codec="none", layout="per_leaf", scale=1.0,
                 examples=8, bits=4, obey_codec=False):
        self.index = index
        self.like = like
        self.codec = codec
        self.obey_codec = obey_codec
        self.layout = layout
        self.scale = scale
        self.examples = examples
        self.rotq_bits = bits
        self.global_tree = None
        self.calls = []  # (lineage round, rank, world, epoch) of each StartTrain
        self.codecs = []  # the codec each StartTrain asked for (None: none asked)
        self.installs = 0
        self.delay_s = 0.0
        self.gate = None  # a threading.Event a StartTrain waits on
        self.fence_at = None  # an epoch: StartTrain rejects lower ones as stale
        self.send_gate = None  # a threading.Event a SendModel waits on
        self.down = False
        self.lock = threading.Lock()

    def _check_up(self, context):
        if self.down:
            context.abort(grpc.StatusCode.UNAVAILABLE, "client down")

    def _delta(self, lineage_round):
        rng = np.random.default_rng([self.index, max(lineage_round, 0)])
        return jax.tree.map(
            lambda a: (self.scale * 1e-3 * rng.normal(size=np.shape(a))).astype(np.float32),
            self.like,
        )

    def StartTrain(self, request, context):
        self._check_up(context)
        with self.lock:
            self.calls.append((request.round, request.rank, request.world, request.epoch))
            self.codecs.append(jproto.CODEC_NAMES.get(request.codec))
        if self.fence_at is not None and request.epoch < self.fence_at:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          f"STALE_COORDINATOR: epoch {request.epoch} < {self.fence_at}")
        if self.gate is not None:
            self.gate.wait()
        if self.delay_s:
            time.sleep(self.delay_s)
        delta = self._delta(request.round)
        extra = {"num_examples": np.float32(self.examples)}
        seed = (max(request.round, 0) << 16) | (request.rank & 0xFFFF)
        flat = self.layout == "flat"
        codec = self.codec
        if self.obey_codec:
            codec = jproto.CODEC_NAMES.get(request.codec, codec)
        if codec == "none":
            g = self.global_tree
            tree = jax.tree.map(lambda a, d: (np.asarray(a) + d).astype(np.float32), g, delta)
            payload = jwire.encode(dict(tree, num_examples=np.float32(self.examples)))
        elif codec == "topk":
            enc = jsparse.encode_topk_flat if flat else jsparse.encode_topk
            payload, _ = enc(delta, 0.05, extra=extra, collect_residual=False)
        elif codec == "int8":
            enc = jsparse.encode_int8_flat if flat else jsparse.encode_int8
            payload, _ = enc(delta, extra=extra)
        elif codec == "rotq":
            payload, _ = jsparse.encode_rotq_flat(delta, bits=self.rotq_bits, extra=extra,
                                                  collect_residual=False, seed=seed)
        else:
            payload, _ = jsparse.encode_randk_flat(delta, 0.05, extra=extra,
                                                   collect_residual=False, seed=seed)
        return jproto.TrainReply(message=payload)

    def SendModel(self, request, context):
        self._check_up(context)
        if self.send_gate is not None:
            self.send_gate.wait()
        self.global_tree = jwire.decode(request.model, self.like)
        self.installs += 1
        return jproto.SendModelReply(reply=b"ok")

    def HeartBeat(self, request, context):
        self._check_up(context)
        return jproto.HeartBeatResponse(status=1)


class Fleet:
    """Scripted clients, each on its own localhost gRPC server."""

    def __init__(self, like, n=4, codec="none", layout="per_leaf", scales=None, bits=4,
                 obey_codec=False):
        self.agents, self.servers, self.addrs = [], [], []
        for i in range(n):
            agent = ScriptedClient(i, like, codec, layout, (scales or {}).get(i, 1.0),
                                   examples=8 * (i + 1), bits=bits, obey_codec=obey_codec)
            addr = f"localhost:{free_port()}"
            server = jservice.create_server(addr, agent)
            server.start()
            self.agents.append(agent)
            self.servers.append(server)
            self.addrs.append(addr)

    def stop(self, i=None):
        for j, s in enumerate(self.servers):
            if i is None or i == j:
                s.stop(0)


def model_like(jcfg):
    """The flax ``{"params", "batch_stats"}`` zeros of the config's model."""
    from fedtpu import models

    params, stats = jfederation._model_template(
        models.create(jcfg.model, num_classes=jcfg.num_classes), jcfg)
    return {"params": params, "batch_stats": stats}
