"""The client side of the gRPC edge: one client's local training, on the
card, behind fedtpu's wire.

The port of ``fedtpu.transport.federation.LocalTrainer``. A coordinator
(fedtpu's ``PrimaryServer``, over :mod:`fedtpu_torch.transport.federation`)
installs the global model with :meth:`LocalTrainer.set_global` and asks
for a round with :meth:`LocalTrainer.train_round`, whose reply is the bytes
a fedtpu client would send for the same state:

- before the first global model lands, the trained weights as a dense FTP1
  payload (zlib-compressed when a codec is configured);
- once synced, the delta ``trained - round start`` through the round's
  codec (the configured one, or the coordinator's per-round choice) as an
  FSP1 record, with error feedback carried in a residual between rounds
  and flushed into the weights when the codec switches to ``none``.

A chaos schedule (:mod:`fedtpu_torch.ft.chaos`) set on :attr:`LocalTrainer.
chaos` makes the client an attacker: once a round its attack rules are
consulted, keyed on ``identity`` and the local round. ``label_flip``
shifts the round's labels; ``sign_flip``, ``scale`` and ``noise`` poison
the update it sends, on the host and in fedtpu's arithmetic, while its own
state stays the honest one.

Training is the port's vmapped local update (:mod:`fedtpu_torch.core.
client`) with one client, on this client's shard of the deterministic
``world``-way partition, at fedtpu's learning rate for the round. The delta
is formed on the card (an f32 subtraction is exact, so it is fedtpu's bit
for bit), packed into flax's order and layout there
(:func:`fedtpu_torch.ops.flat.pack_tree`) and copied to the host once; the
codecs run on the host (:mod:`fedtpu_torch.transport.sparse`), as
fedtpu's do. A ring of round-start snapshots lets a coordinator that
replays a round (after recovering from an older checkpoint) find this
client's state as it was. With ``state_dir`` the local state (round
counter, generator, momentum, error-feedback residual) is saved every
round through the checkpoint store (:mod:`fedtpu_torch.checkpoint`) and
restored on construction, so a restarted client resumes rather than
diverges; a replay deeper than the ring reads the generation from disk.

fedtpu draws the crop and flip of augmentation from a threefry key split
each round, which torch cannot reproduce: the port draws them from a
seeded ``torch.Generator``. The trainer runs on the card unless the
caller passes ``device="cpu"``. Nothing here imports grpc or msgpack.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fedtpu_torch import models
from fedtpu_torch.config import RoundConfig, validate_edge
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.core import optim
from fedtpu_torch.core.client import make_eval_fn, make_local_update
from fedtpu_torch.core.engine import resolve_device
from fedtpu_torch.data import datasets, partition
from fedtpu_torch.obs import Telemetry, propagate
from fedtpu_torch.ops import flat as flat_ops
from fedtpu_torch.transport import sparse, wire

log = logging.getLogger("fedtpu_torch.federation")

Tree = Dict[str, Dict[str, torch.Tensor]]

LOSSY_CODECS = ("topk", "int8", "rotq", "randk")


class LocalTrainer:
    """One federated client: its model, optimizer state, shard and codec
    state, trained one round per :meth:`train_round`."""

    # Round-start snapshots kept for a coordinator's replay: a ring, newest
    # rounds kept.
    SNAPSHOT_KEEP = 4

    def __init__(
        self,
        cfg: RoundConfig,
        seed: int = 0,
        state_dir: Optional[str] = None,
        device=None,
        data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        eval_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ):
        """``seed`` seeds the initial weights (replaced by the first global
        model) and the augmentation draws. ``data`` / ``eval_data``:
        ``(images, labels)`` instead of loading ``cfg.data.dataset``'s train
        / test split (several trainers in one process can share one copy).
        ``state_dir``: where the client's local state is kept across
        restarts, a generation a round (keep 3), restored here."""
        validate_edge(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        shape, n_classes = datasets.dataset_info(cfg.data.dataset)
        if cfg.num_classes != n_classes:
            raise ValueError(
                f"cfg.num_classes={cfg.num_classes} but dataset "
                f"'{cfg.data.dataset}' has {n_classes} classes"
            )
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = models.create(cfg.model, cfg.num_classes, shape, remat=cfg.remat)
        self.model.to(self.device)
        n = cfg.data.num_examples
        self.images, self.labels = (
            datasets.load(cfg.data.dataset, "train", seed=cfg.data.seed, num=n)
            if data is None else data
        )
        self.eval_images, self.eval_labels = (
            datasets.load(cfg.data.dataset, "test", seed=cfg.data.seed, num=n)
            if eval_data is None else eval_data
        )
        self.params = {k: p.detach().clone() for k, p in self.model.named_parameters()}
        self.batch_stats = {k: b.detach().clone() for k, b in self.model.named_buffers()}
        self.opt_state = optim.init(self.params, 1, cfg.opt)
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.round_idx = 0
        self._local_update = make_local_update(self.model, cfg)
        self._evaluate = make_eval_fn(self.model)
        # Until the first global model lands, replies are dense weights: a
        # delta needs the round-start model to be the coordinator's.
        self.synced = False
        # Error feedback on the edge: what the codec dropped, carried into
        # the next round's delta (a flax-layout tree on the host).
        self.edge_residual = None
        self.identity = "self"
        # A FaultSchedule whose attack rules make this client an attacker.
        self.chaos = None
        self.layout = flat_ops.make_tree_layout(
            {"params": self.params, "batch_stats": self.batch_stats}
        )
        self._template = flat_ops.flax_tree(self.layout, np.zeros(self.layout.total, np.float32))
        self._dense_bytes = sum(
            t.numel() * t.element_size() for t in (*self.params.values(), *self.batch_stats.values())
        )
        self._snapshots: Dict[int, dict] = {}
        # A client's telemetry: bytes out and in, and the last reply's
        # size against a dense payload.
        self.telemetry = Telemetry(cfg.fed.telemetry, role="client")
        # Seconds of the last round: local update, copy to the host, encode.
        self.last_times: Dict[str, float] = {}
        # The local state a cold restart needs to resume, not diverge: a
        # reset counter would replay old batch draws, a fresh residual
        # re-inject mass top-k already shipped.
        self._state_ckpt = None
        if state_dir:
            from fedtpu_torch.checkpoint import Checkpointer

            self._state_ckpt = Checkpointer(
                state_dir, keep=3, backend="wire",
                metrics=self.telemetry.registry if self.telemetry.enabled else None,
            )
            self._restore_client_state()

    # ------------------------------------------------------------ layout

    def host_model(self) -> dict:
        """The trainer's model as the nested flax tree ``{"params",
        "batch_stats"}`` of f32 numpy arrays (one copy from the device)."""
        return flat_ops.to_flax_host(self.layout, {"params": self.params, "batch_stats": self.batch_stats})

    def _shard(self, rank: int, world: int):
        """This client's row of the deterministic ``world``-way partition,
        as ``(idx [1, L], mask [1, L])``: every client computes the same
        partition from the shared data seed, so shards are disjoint with no
        coordination."""
        cfg = self.cfg
        if cfg.data.partition == "round_robin":
            idx, mask = partition.round_robin(len(self.images), world, cfg.data.batch_size)
        elif cfg.data.partition == "iid":
            idx, mask = partition.iid(len(self.images), world, seed=cfg.data.seed)
        elif cfg.data.partition == "dirichlet":
            idx, mask = partition.dirichlet(
                self.labels, world, alpha=cfg.data.dirichlet_alpha, seed=cfg.data.seed
            )
        else:
            raise ValueError(f"unknown partition {cfg.data.partition}")
        return idx[rank : rank + 1], mask[rank : rank + 1]

    # ------------------------------------------------- local durability

    def _client_state(self) -> dict:
        """fedtpu's client-state tree, in flax names and layouts: the local
        round counter, the generator (fedtpu keeps a threefry key under
        ``rng``; the port its ``torch.Generator``'s state, so a file does
        not cross packages), the momentum, and the error-feedback residual
        (``has_residual`` tells "none yet" from a zero residual)."""
        residual = self.edge_residual
        return {
            "round_idx": np.asarray(self.round_idx, np.int64),
            "rng": self.generator.get_state().numpy(),
            "opt_state": {"momentum": to_flax({k: v[0] for k, v in self.opt_state.items()})},
            "has_residual": np.asarray(0 if residual is None else 1, np.int8),
            "residual": self._template if residual is None else residual,
        }

    def _install_client_state(self, tree: dict) -> None:
        self.round_idx = int(tree["round_idx"])
        self.generator.set_state(torch.from_numpy(np.array(tree["rng"], np.uint8)))
        mom = from_flax(tree["opt_state"]["momentum"], device=self.device)
        self.opt_state = {k: mom[k][None].to(v.dtype) for k, v in self.opt_state.items()}
        self.edge_residual = (
            wire.tree_map(np.array, tree["residual"]) if int(tree["has_residual"]) else None
        )

    def _restore_client_state(self) -> None:
        try:
            latest = self._state_ckpt.restore_latest(self._client_state())
        except (ValueError, OSError) as exc:
            log.warning("client state in %s unusable (%s); starting fresh", self._state_ckpt.directory, exc)
            return
        if latest is None:
            return
        self._install_client_state(latest[1])
        # The restored cut seeds the ring: a coordinator replaying exactly
        # this round (the usual recovery) needs nothing more.
        self._snapshot_round(self.round_idx)
        log.info(
            "client state restored: resuming at local round %d (residual=%s)",
            self.round_idx, "yes" if self.edge_residual is not None else "no",
        )

    def _persist_client_state(self) -> None:
        if self._state_ckpt is not None:
            # A failed save is logged by the store and costs the client its
            # restartability, never the round.
            self._state_ckpt.save(self.round_idx, self._client_state())

    # --------------------------------------------------- replay rollback

    def _snapshot_round(self, round_idx: int) -> None:
        """The round-start state, kept for a replay. Rounds replace the
        trainer's tensors and residual rather than writing into them, so
        the snapshot holds references."""
        self._snapshots[round_idx] = {
            "params": dict(self.params),
            "batch_stats": dict(self.batch_stats),
            "opt_state": dict(self.opt_state),
            "generator": self.generator.get_state(),
            "residual": self.edge_residual,
        }
        for r in sorted(self._snapshots):
            if len(self._snapshots) <= self.SNAPSHOT_KEEP:
                break
            del self._snapshots[r]

    def _rollback(self, target_round: int) -> bool:
        snap = self._snapshots.get(target_round)
        if snap is None:
            # Deeper than the ring (this client restarted too, and seeded
            # only its newest cut): a generation on disk may hold the round.
            # It has no weights; the coordinator's broadcast re-bases them.
            if self._state_ckpt is None:
                return False
            try:
                tree = self._state_ckpt.restore(target_round, self._client_state())
            except (ValueError, OSError):
                return False
            self._install_client_state(tree)
            for r in [r for r in self._snapshots if r > target_round]:
                del self._snapshots[r]
            return True
        self.round_idx = target_round
        self.params = dict(snap["params"])
        self.batch_stats = dict(snap["batch_stats"])
        self.opt_state = dict(snap["opt_state"])
        self.generator.set_state(snap["generator"])
        self.edge_residual = snap["residual"]
        for r in [r for r in self._snapshots if r > target_round]:
            del self._snapshots[r]
        return True

    # ------------------------------------------------------------ rounds

    def train_round(
        self, rank: int, world: int,
        trace_ctx: Optional[propagate.TraceContext] = None,
        coord_round: int = -1,
        codec_override: Optional[str] = None,
    ) -> bytes:
        """One local epoch on this client's shard; returns the reply
        payload. ``trace_ctx``: the coordinator's propagated trace context,
        when the StartTrain carried one; the ``client_train`` span then
        records the federation ``trace_id`` and ``remote_parent`` /
        ``remote_role`` (the link ``tools/trace_merge.py`` nests this
        client's work by), and the tracer adopts the trace id.
        ``coord_round``: the coordinator's lineage round (-1 when it sends
        none); one behind this client's counter rolls the local state back
        to that round's snapshot. ``codec_override``: the coordinator's
        codec for this round, else the configured one."""
        tel = self.telemetry
        propagate.adopt(tel.tracer, trace_ctx)
        with tel.span("client_train", rank=rank, round=self.round_idx,
                      **propagate.span_args(trace_ctx)):
            payload = self._train_round_impl(rank, world, coord_round, codec_override)
        self._persist_client_state()
        tel.counter(
            "fedtpu_client_tx_bytes_total",
            "StartTrain reply payload bytes shipped by this client",
        ).inc(len(payload))
        tel.gauge(
            "fedtpu_client_compression_ratio",
            "last reply's wire bytes / dense model payload bytes",
        ).set(len(payload) / max(self._dense_bytes, 1))
        return payload

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _train_round_impl(
        self, rank: int, world: int, coord_round: int, codec_override: Optional[str]
    ) -> bytes:
        cfg = self.cfg
        if 0 <= coord_round < self.round_idx:
            local_was = self.round_idx
            if self._rollback(coord_round):
                log.warning(
                    "coordinator replays round %d (local counter was %d): "
                    "rolled local state back to the matching snapshot",
                    coord_round, local_was,
                )
            else:
                log.warning(
                    "coordinator replays round %d but no local snapshot "
                    "survives (local counter %d); training forward — "
                    "trajectories may diverge", coord_round, self.round_idx,
                )
        self._snapshot_round(self.round_idx)
        start_round = self.round_idx
        # One attack consult a round, on the identity and the local round.
        atk = self.chaos.decide_attack(self.identity, start_round) if self.chaos is not None else None
        own, own_mask = self._shard(rank, world)
        num_examples = float(own_mask.sum())
        # One epoch is the shard's batch count; local_epochs multiplies it.
        steps = max(1, int(own_mask[0].sum()) // cfg.data.batch_size) * max(1, cfg.fed.local_epochs)
        x, y, step_mask = partition.make_client_batches(
            self.images, self.labels, own, own_mask, cfg.data.batch_size, steps,
            seed=cfg.data.seed + self.round_idx,
        )
        if atk is not None and atk.kind == "label_flip":
            y = (np.asarray(y) + atk.label_offset) % cfg.num_classes
        t0 = time.perf_counter()
        dev = self.device
        start_params, start_stats = self.params, self.batch_stats
        out = self._local_update(
            start_params, start_stats, self.opt_state,
            torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev),
            torch.from_numpy(np.asarray(y)).to(dev),
            torch.from_numpy(step_mask).to(dev),
            cfg.opt.lr_at(self.round_idx), self.generator,
        )
        self.params = {k: v[0] for k, v in out.params.items()}
        self.batch_stats = {k: v[0] for k, v in out.batch_stats.items()}
        self.opt_state = out.opt_state
        self.round_idx += 1
        self._sync()
        t1 = time.perf_counter()

        honest = lambda: flat_ops.to_flax_host(self.layout, {
            "params": {k: self.params[k] - start_params[k] for k in self.params},
            "batch_stats": {k: self.batch_stats[k] - start_stats[k] for k in self.batch_stats},
        })
        sent = start_host = None
        if atk is not None and atk.kind in ("sign_flip", "scale", "noise"):
            # Only the payload is poisoned: start + attack(honest delta) in
            # f32 on the host, fedtpu's rounding; our own state stays honest.
            start_host = flat_ops.to_flax_host(self.layout, {"params": start_params, "batch_stats": start_stats})
            hostile = self.chaos.apply_attack_delta(atk, honest(), self.identity, start_round)
            sent = wire.tree_map(lambda s, d: (s + d).astype(s.dtype), start_host, hostile)

        codec = codec_override or cfg.fed.compression
        if codec in LOSSY_CODECS and self.synced:
            delta = honest() if sent is None else wire.tree_map(lambda a, b: a - b, sent, start_host)
            t2 = time.perf_counter()
            extra = {"num_examples": np.float32(num_examples)}
            ef = cfg.fed.error_feedback
            if cfg.fed.delta_layout == "flat":
                enc_topk, enc_int8 = sparse.encode_topk_flat, sparse.encode_int8_flat
            else:
                enc_topk, enc_int8 = sparse.encode_topk, sparse.encode_int8
            # The sketch codecs' seed is a function of (round, rank): a
            # replayed round re-encodes byte for byte, distinct clients
            # draw distinct rotations and index sets.
            sketch_seed = (start_round << 16) | (rank & 0xFFFF)
            res = self.edge_residual if ef else None
            if codec == "topk":
                payload, residual = enc_topk(
                    delta, cfg.fed.topk_fraction, residuals=res, extra=extra, collect_residual=ef)
            elif codec == "int8":
                payload, residual = enc_int8(delta, residuals=res, extra=extra, collect_residual=ef)
            elif codec == "rotq":
                payload, residual = sparse.encode_rotq_flat(
                    delta, bits=cfg.fed.rotq_bits, residuals=res, extra=extra,
                    collect_residual=ef, seed=sketch_seed)
            else:  # randk
                payload, residual = sparse.encode_randk_flat(
                    delta, cfg.fed.topk_fraction, residuals=res, extra=extra,
                    collect_residual=ef, seed=sketch_seed)
            if ef:
                # A dense model-space tree: it carries unchanged across a
                # switch between lossy codecs.
                self.edge_residual = residual
            self.last_times = {"update_s": t1 - t0, "copy_s": t2 - t1, "encode_s": time.perf_counter() - t2}
            return payload

        tree = self.host_model() if sent is None else sent
        t2 = time.perf_counter()
        if self.edge_residual is not None and self.synced and cfg.fed.error_feedback:
            # A switch to the dense codec flushes the residual into this
            # round's weights, then resets it: dropped mass is never lost.
            tree = wire.tree_map(
                lambda w, r: (np.asarray(w) + np.asarray(r)).astype(np.asarray(w).dtype),
                tree, self.edge_residual,
            )
            self.edge_residual = None
        tree["num_examples"] = np.float32(num_examples)
        payload = wire.encode(tree, compress=codec != "none")
        self.last_times = {"update_s": t1 - t0, "copy_s": t2 - t1, "encode_s": time.perf_counter() - t2}
        return payload

    def set_global(self, data: bytes,
                   trace_ctx: Optional[propagate.TraceContext] = None) -> None:
        """Install the coordinator's global model (an FTP1 payload of
        ``{"params", "batch_stats"}``): decoded on the host into one row in
        the edge's order, copied to the device once, inside an
        ``install_global`` span carrying ``trace_ctx``'s args."""
        propagate.adopt(self.telemetry.tracer, trace_ctx)
        with self.telemetry.span("install_global", **propagate.span_args(trace_ctx)):
            tree = wire.decode(data, self._template)
            row = wire.model_row(tree, self.layout.sizes, self.layout.padded)
            tree_t = flat_ops.unpack_tree(self.layout, torch.from_numpy(row).to(self.device))
            self.params, self.batch_stats = tree_t["params"], tree_t["batch_stats"]
            self.synced = True
        self.telemetry.counter(
            "fedtpu_client_rx_bytes_total",
            "global-model broadcast bytes received by this client",
        ).inc(len(data))

    def evaluate(self) -> Tuple[float, float]:
        """Loss and accuracy of the installed model on the eval split, in
        whole batches of ``eval_batch_size`` (at least one)."""
        bs = self.cfg.data.eval_batch_size
        nb = max(1, len(self.eval_images) // bs)
        xs = np.asarray(self.eval_images[: nb * bs], np.float32).reshape(
            (nb, bs) + tuple(self.eval_images.shape[1:])
        )
        ys = np.asarray(self.eval_labels[: nb * bs]).reshape((nb, bs))
        loss, acc = self._evaluate(
            self.params, self.batch_stats,
            torch.from_numpy(xs).to(self.device),
            torch.from_numpy(ys.astype(np.int64)).to(self.device),
        )
        return float(loss), float(acc)
