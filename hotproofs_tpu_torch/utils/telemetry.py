"""Named counters (the port's counterpart of
hotproofs_tpu/utils/telemetry.py): `ivc/folds` counts folds."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict


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
