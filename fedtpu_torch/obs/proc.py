"""Process-level resource observations for the leak gauges: the port's
own copy of ``fedtpu/obs/proc.py``.

A leak check needs the process's *current* resident set, sampled per
round; ``getrusage``'s ``ru_maxrss`` is a high-water mark and never shows a
plateau. On Linux the current value is ``VmRSS`` in ``/proc/self/status``;
elsewhere the high-water mark stands in.
"""

from __future__ import annotations

import os
import resource
import sys


def process_rss_bytes() -> int:
    """Current resident-set size of this process in bytes (best effort:
    0 when no source is readable)."""
    try:
        with open("/proc/self/status", encoding="ascii", errors="replace") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024  # kB
    except OSError:
        pass
    try:
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # Linux reports kB, macOS bytes — only reached off-Linux.
        return peak if sys.platform == "darwin" else peak * 1024
    except Exception:
        return 0


def process_fd_count() -> int:
    """Open file descriptors (a second leak axis: channels/sockets under
    churn). 0 when /proc is unavailable."""
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return 0
