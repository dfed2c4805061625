"""Attributable console output for multi-process runs.

The reference prints anonymously (`/root/reference/attack.py:318-330`,
`main.py:186-187`); under an N-process SPMD driver those lines interleave
with no way to tell which process said what. `log()` is the framework-wide
`print` replacement: every line is prefixed with the process index and the
wall time since process start, so a four-way interleaved log is still
attributable post-mortem.

Port of `dorpatch_tpu.observe.console`. The process index defaults to 0;
a multi-process driver sets it once with `set_process_index`.
"""

from __future__ import annotations

import sys
import time

_T0 = time.monotonic()
_PROCESS_INDEX = 0


def set_process_index(index: int) -> None:
    """Record this process's index (a multi-process driver calls this once)."""
    global _PROCESS_INDEX
    _PROCESS_INDEX = int(index)


def process_index() -> int:
    return _PROCESS_INDEX


def elapsed() -> float:
    """Seconds since process start (well, since this module imported)."""
    return time.monotonic() - _T0


def log(msg, *, file=None, flush: bool = True) -> None:
    """`print` with a `[pN +T.Ts]` attribution prefix.

    `file` defaults to stdout (capsys-visible in tests); pass
    `sys.stderr` for diagnostics that must not pollute parseable stdout.
    """
    print(f"[p{_PROCESS_INDEX} +{elapsed():.1f}s] {msg}",
          file=file if file is not None else sys.stdout, flush=flush)
