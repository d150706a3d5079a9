"""Structured observability (SURVEY §5.5).

The reference logs nothing beyond stdout debug printers; production tree
searches need a record of the likelihood trajectory and move acceptance.
``RunLog`` appends JSON lines (one event per line) — cheap, greppable, and
safe to leave enabled.

Counterpart: ``libpll_tpu/utils/logging.py``, copied.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional


class RunLog:
    """JSON-lines event log for optimization/search runs."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self._fh = open(path, "a") if path else None
        self._echo = echo
        self._t0 = time.time()

    def event(self, kind: str, **fields) -> None:
        rec = {"t": round(time.time() - self._t0, 6), "kind": kind, **fields}
        line = json.dumps(rec, default=float)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=sys.stderr)

    def logl(self, value: float, **fields) -> None:
        self.event("logl", value=float(value), **fields)

    def move(self, move: str, accepted: bool, logl: float, **fields) -> None:
        self.event("move", move=move, accepted=bool(accepted),
                   logl=float(logl), **fields)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
