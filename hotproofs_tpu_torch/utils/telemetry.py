"""Named counters and spans (the port's counterpart of
hotproofs_tpu/utils/telemetry.py): `ivc/folds` counts folds; the segments
path (parallel/segments.py) counts `segments/proved`, `segments/resumed`
and `segments/retried`, and marks each `segments/lockstep_wave`."""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator


@dataclass
class Metrics:
    """Process-wide registry of named counters."""

    counters: Dict[str, float] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.counters)


metrics = Metrics()
count = metrics.count


@dataclass
class Span:
    """A span's duration: `s` seconds once its block has ended."""

    s: float = 0.0


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[Span]:
    """Mark a phase on a running torch.profiler timeline (as `name` with
    its attributes) and time it into the yielded Span."""
    import torch.profiler

    label = name + "".join(f" {k}={v}" for k, v in sorted(attrs.items()))
    out = Span()
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(label):
            yield out
    finally:
        out.s = time.perf_counter() - t0
