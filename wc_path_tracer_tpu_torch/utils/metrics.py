"""Structured metrics logging: stdout + JSONL (port of the JAX package's
utils/metrics.py).

Every run can emit structured per-step records (Mrays/s, loss, grad norm)
to a JSONL file for later analysis.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None,
                 echo: bool = True):
        self._file = open(path, "a") if path else None
        self._stream = stream
        self._echo = echo
        self._t0 = time.perf_counter()

    def log(self, event: str, **fields):
        rec = {"event": event, "t": round(time.perf_counter() - self._t0, 4),
               **fields}
        line = json.dumps(rec)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._stream:
            self._stream.write(line + "\n")
        elif self._echo:
            print(line, file=sys.stderr)
        return rec

    def close(self):
        if self._file:
            self._file.close()


def mrays(width: int, height: int, samples: int, bounces: int,
          seconds: float) -> float:
    """Path segments per second in Mrays/s (segments = W*H*spp*(bounces+1),
    every pixel through every segment, as the reference dispatches)."""
    return width * height * samples * (bounces + 1) / seconds / 1e6
