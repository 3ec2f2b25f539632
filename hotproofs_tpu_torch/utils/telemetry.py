"""Named counters, span timers and on-demand profiler capture (the port's
counterpart of hotproofs_tpu/utils/telemetry.py, with the same API and the
same snapshot and report).

`ivc/folds` counts folds; the segments path (parallel/segments.py) counts
`segments/proved`, `segments/resumed` and `segments/retried`, and times
each `segments/lockstep_wave` and `segments/prove_one`. A span marks a
running torch.profiler timeline (`record_function`), so host phases line up
with the card's kernels in a captured trace.

Usage:
    from hotproofs_tpu_torch.utils import telemetry as T
    with T.span("ivc/fold_chunk", steps=16):
        ...
    T.count("ivc/folds", 16)
    print(T.metrics.report())        # or .snapshot() for the raw dict
    T.start_trace("prof")            # torch.profiler capture on demand
    ...
    T.stop_trace()                   # writes a Chrome trace into prof/
    T.last_capture.lost              # kernel launches with no record
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple


@dataclass
class _Timer:
    calls: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.calls += 1
        self.total_s += dt
        if dt > self.max_s:
            self.max_s = dt


@dataclass
class Metrics:
    """Process-wide registry of named counters and span timers."""

    counters: Dict[str, float] = field(default_factory=dict)
    timers: Dict[str, _Timer] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def observe(self, name: str, dt: float) -> None:
        with self._lock:
            self.timers.setdefault(name, _Timer()).add(dt)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "timers": {k: {"calls": t.calls,
                               "total_s": round(t.total_s, 6),
                               "mean_s": round(t.total_s / t.calls, 6),
                               "max_s": round(t.max_s, 6)}
                           for k, t in self.timers.items()},
            }

    def report(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.timers.clear()


metrics = Metrics()
count = metrics.count


@dataclass
class Span:
    """A span's duration: `s` seconds once its block has ended."""

    s: float = 0.0


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[Span]:
    """Time a phase into the metrics (timer `name`, also when the block
    raises) and mark it on a running torch.profiler timeline as `name`
    with its attributes. Yields a Span that holds the duration after the
    block."""
    import torch.profiler

    label = name + "".join(f" {k}={v}" for k, v in sorted(attrs.items()))
    out = Span()
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(label):
            yield out
    finally:
        out.s = time.perf_counter() - t0
        metrics.observe(name, out.s)


@dataclass
class Capture:
    """What stop_trace found in the trace it wrote: the kernel launches
    that the host side recorded in the window, and how many of them have
    their kernel's record (the same correlation id) in the trace."""

    path: str
    launches: int
    kernels: int

    @property
    def lost(self) -> int:
        return self.launches - self.kernels


def count_kernels(events: Iterable[dict]) -> Tuple[int, int]:
    """(launches, kernels) of a Chrome trace's events: the kernel launch
    calls of the CUDA runtime or driver, and how many of those the trace
    holds a kernel record for."""
    launch, kern = set(), set()
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        corr = e.get("args", {}).get("correlation")
        if cat in ("cuda_runtime", "cuda_driver") and "Launch" in name \
                and "Kernel" in name:
            launch.add(corr)
        elif cat == "kernel":
            kern.add(corr)
    return len(launch), len(launch & kern)


_trace_lock = threading.Lock()
_trace: Optional[tuple] = None      # (torch.profiler.profile, log_dir)
last_capture: Optional[Capture] = None


def start_trace(log_dir: str) -> None:
    """Start an on-demand torch.profiler capture: host activity, and the
    card's kernels when a CUDA device is present. A no-op while a capture
    is running."""
    global _trace
    import torch
    import torch.profiler as tp

    with _trace_lock:
        if _trace is None:
            acts = [tp.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(tp.ProfilerActivity.CUDA)
            prof = tp.profile(activities=acts)
            prof.start()
            _trace = (prof, log_dir)


def stop_trace() -> Optional[str]:
    """Stop the running capture and write it into its log dir as a Chrome
    trace (`trace_<pid>_<ms>.json`, for chrome://tracing or Perfetto);
    returns the log dir, None if no capture was running.

    Then reads the trace back into `last_capture`, and warns when kernel
    launches of the window have no kernel record: in a process that has
    run for minutes the profiler can drop them (PERF.md §7), so a busy
    time or a launch count read from such a trace is short."""
    global _trace, last_capture
    with _trace_lock:
        t, _trace = _trace, None
        if t is None:
            return None
        prof, log_dir = t
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(
            log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        last_capture = Capture(path, *count_kernels(events))
        if last_capture.lost:
            warnings.warn(f"stop_trace: {last_capture.lost} of "
                          f"{last_capture.launches} kernel launches have no "
                          f"kernel record in {path}", RuntimeWarning)
        return log_dir
