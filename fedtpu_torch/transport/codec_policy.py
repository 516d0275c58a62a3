"""Per-client codec choice from what each codec costs on that client's
link: the port's own copy of ``fedtpu/transport/codec_policy.py``.

:class:`AdaptiveCodecPolicy` keeps, per client rank and codec, an EWMA of
``bytes_up x RTT``, the two numbers the coordinator has for every
StartTrain. While a client has a codec it never used, the first such
candidate is chosen (warmup, in candidate order); after that the cheapest,
candidate order breaking ties. No random draw: the choice is a function of
the observations. The coordinator sends it in ``TrainRequest.codec``; the
client keeps its error-feedback residual right across a switch (the
rescale-or-reset rule, :mod:`fedtpu_torch.transport.trainer`).

The RTT is wall time, so on real links two runs choose differently; the
arithmetic on a given sequence of observations is fedtpu's to the bit.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

# The warmup order and the tiebreak: cheapest to encode first.
DEFAULT_CANDIDATES: Tuple[str, ...] = ("none", "int8", "topk", "rotq", "randk")

# EWMA weight of a new observation (about a 3-round memory).
_ALPHA = 0.3


class AdaptiveCodecPolicy:
    """Per-client codec chooser over EWMA(bytes_up x RTT). Thread-safe:
    collect workers ``observe`` while the round thread may ``choose``."""

    def __init__(self, candidates: Sequence[str] = DEFAULT_CANDIDATES):
        if not candidates:
            raise ValueError("adaptive codec policy needs >= 1 candidate")
        self.candidates: Tuple[str, ...] = tuple(candidates)
        # rank -> codec -> (ewma cost, observations)
        self._stats: Dict[int, Dict[str, Tuple[float, int]]] = {}
        self._lock = threading.Lock()

    def observe(self, rank: int, codec: str, bytes_up: int, rtt_s: float) -> None:
        """Fold one StartTrain into the client's costs. ``codec`` is the
        one the reply used (its record kind), which a client that ignores
        the request may not have been asked for."""
        if codec not in self.candidates:
            return
        # Floors: no codec looks free from a zero RTT or an empty reply.
        cost = float(max(bytes_up, 1)) * max(float(rtt_s), 1e-4)
        with self._lock:
            per = self._stats.setdefault(rank, {})
            old, n = per.get(codec, (cost, 0))
            per[codec] = (old + _ALPHA * (cost - old), n + 1)

    def choose(self, rank: int) -> Optional[str]:
        """The client's codec for its next round: the first candidate it
        never used, else the cheapest."""
        with self._lock:
            per = self._stats.get(rank, {})
            for c in self.candidates:
                if per.get(c, (0.0, 0))[1] == 0:
                    return c
            return min(self.candidates, key=lambda c: (per[c][0], self.candidates.index(c)))

    def snapshot(self) -> Dict[str, Dict[str, dict]]:
        """The cost table: rank -> codec -> ``{"ewma_cost", "observations"}``."""
        with self._lock:
            return {
                str(rank): {c: {"ewma_cost": cost, "observations": n} for c, (cost, n) in sorted(per.items())}
                for rank, per in sorted(self._stats.items())
            }
