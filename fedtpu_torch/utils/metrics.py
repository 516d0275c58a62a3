"""Round records as JSON lines: the port's own copy of
``fedtpu.utils.metrics.MetricsLogger``."""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Round-level sink: one JSON object a record, appended to ``path``
    and/or echoed to stderr. Numbers become floats; other values are
    written as they are."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self._echo = echo
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, step: int, **metrics: Any) -> None:
        rec: Dict[str, Any] = {"step": int(step), "t": round(time.time() - self._t0, 4)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
