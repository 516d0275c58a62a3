"""The client agent of the gRPC edge: the servicer a fedtpu_torch client
hosts for a coordinator to drive.

The port of ``fedtpu.transport.federation``'s ``ClientAgent`` and
``serve_client``, around :class:`fedtpu_torch.transport.trainer.
LocalTrainer`: StartTrain trains one round and replies with its payload,
SendModel installs the global model and evaluates it, HeartBeat answers
liveness. A coordinator-originated RPC whose fencing epoch is below the
highest this client has seen comes from a superseded primary, and is
aborted with ``FAILED_PRECONDITION`` and ``"STALE_COORDINATOR: ..."``.

A fedtpu ``PrimaryServer`` drives this agent exactly as it drives a fedtpu
client. The trace context a coordinator may attach as metadata is not
read (trace propagation is not ported yet); fault injection (``chaos``)
and the client's state on disk (``state_dir``) raise.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional, Tuple

import grpc
import numpy as np

from fedtpu_torch.config import RoundConfig, not_ported
from fedtpu_torch.transport import proto
from fedtpu_torch.transport.service import TrainerServicer, create_server
from fedtpu_torch.transport.trainer import LocalTrainer

__all__ = ["ClientAgent", "LocalTrainer", "serve_client"]

log = logging.getLogger("fedtpu_torch.federation")


class ClientAgent(TrainerServicer):
    """The servicer of one federated client."""

    def __init__(
        self,
        cfg: RoundConfig,
        seed: int = 0,
        state_dir: Optional[str] = None,
        device=None,
        data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        eval_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ):
        self.trainer = LocalTrainer(
            cfg, seed=seed, state_dir=state_dir, device=device, data=data, eval_data=eval_data
        )
        self.last_eval: Optional[Tuple[float, float]] = None
        # Fencing: the highest coordinator epoch seen (-1 until a peer
        # advertises one; pre-fencing coordinators are never rejected), and
        # the rejections by RPC.
        self._max_epoch = -1
        self._epoch_lock = threading.Lock()
        self.stale_rejected = {}

    def _fence_check(self, epoch: int, rpc: str, context) -> None:
        """Track the highest coordinator epoch; abort a stale sender
        (``context.abort`` raises)."""
        if epoch < 0:
            return
        with self._epoch_lock:
            if epoch >= self._max_epoch:
                self._max_epoch = epoch
                return
            newest = self._max_epoch
            self.stale_rejected[rpc] = self.stale_rejected.get(rpc, 0) + 1
        log.warning(
            "%s from stale coordinator epoch %d rejected (newest seen %d)",
            rpc, epoch, newest,
        )
        context.abort(
            grpc.StatusCode.FAILED_PRECONDITION,
            f"STALE_COORDINATOR: epoch {epoch} < {newest}",
        )

    def StartTrain(self, request: proto.TrainRequest, context) -> proto.TrainReply:
        self._fence_check(request.epoch, "StartTrain", context)
        payload = self.trainer.train_round(
            request.rank, request.world,
            coord_round=request.round,
            # 0 or an id this client does not know: the configured codec.
            codec_override=proto.CODEC_NAMES.get(request.codec),
        )
        return proto.TrainReply(message=payload)

    def SendModel(self, request: proto.SendModelRequest, context) -> proto.SendModelReply:
        self._fence_check(request.epoch, "SendModel", context)
        self.trainer.set_global(request.model)
        self.last_eval = self.trainer.evaluate()
        log.info("global model installed: eval %s", self.last_eval)
        return proto.SendModelReply(reply=f"{self.last_eval[1]:.4f}".encode())

    def HeartBeat(self, request: proto.Request, context) -> proto.HeartBeatResponse:
        return proto.HeartBeatResponse(status=1)

    def status_snapshot(self) -> dict:
        t = self.trainer
        return {
            "role": f"client:{t.identity}",
            "pid": os.getpid(),
            "round": t.round_idx,
            "synced": t.synced,
            "last_eval": (
                {"loss": self.last_eval[0], "acc": self.last_eval[1]}
                if self.last_eval else None
            ),
        }


def serve_client(
    address: str,
    cfg: RoundConfig,
    seed: int = 0,
    compress: bool = False,
    chaos=None,
    state_dir: Optional[str] = None,
    device=None,
    data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    eval_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
):
    """Build and start a client agent's server on ``address``; returns
    ``(server, agent)``. The client trains on the card unless ``device``
    names another; ``data`` / ``eval_data`` as in :class:`LocalTrainer`."""
    if chaos is not None:
        raise not_ported(
            "serve_client(chaos=...), fault injection and seeded attackers "
            "(fedtpu/ft/chaos.py)", "slice 6, part 2: the server side",
        )
    agent = ClientAgent(
        cfg, seed=seed, state_dir=state_dir, device=device, data=data, eval_data=eval_data
    )
    agent.trainer.identity = address
    server = create_server(address, agent, compress=compress)
    server.start()
    return server, agent
