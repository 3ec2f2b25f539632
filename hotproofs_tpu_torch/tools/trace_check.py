"""Checks that an on-demand capture (utils/telemetry: start_trace and
stop_trace) records the card's kernels and the host's spans.

    python -m hotproofs_tpu_torch.tools.trace_check

Each of three trials captures one launch of poseidon_permute (1,024
states of the Pallas scalar field) inside T.span("trace_check/poseidon")
into a new directory, then reads the Chrome trace back: it must name the
kernel (k_poseidon) and the span, stop_trace must have found a kernel
record for every launch (T.last_capture), the span's timer must have
counted the trial once, and stop_trace must have returned the directory.
Prints one JSON line, a record a trial; the exit code is 0 only if every
trial passed. It needs a card.

A capture taken minutes into a process can lose kernel records (PERF.md
§7), so chip_smoke.py runs this tool as a process of its own.
"""

from __future__ import annotations

import glob
import json
import os
import tempfile

import torch

from ..ops import cuda_lib
from ..ops import poseidon as P
from ..utils import telemetry as T
from ..utils.config import require_device

SPAN = "trace_check/poseidon"
KERNEL = "k_poseidon"
TRIALS = 3


def capture_once(state: torch.Tensor, span: str = SPAN) -> dict:
    """One permute of `state` (Pallas scalar states) under a capture and a
    span; what the written trace holds. `launched` is the wrapper's count
    of poseidon_permute launches in the window; `launches`, `kernels` and
    `lost` are stop_trace's reading of the trace (T.last_capture)."""
    spec = P.make_spec("pallas_scalar")
    calls = lambda: T.metrics.snapshot()["timers"].get(
        span, {"calls": 0})["calls"]
    before, launched = calls(), cuda_lib.launches["poseidon_permute"]
    with tempfile.TemporaryDirectory() as tmp:
        T.start_trace(tmp)
        with T.span(span, n=str(state.shape[0])):
            P.permute(spec, state)
            if state.is_cuda:
                torch.cuda.synchronize(state.device)
        returned = T.stop_trace() == tmp
        files = glob.glob(os.path.join(tmp, "*.json"))
        text = open(files[0]).read() if len(files) == 1 else ""
    cap = T.last_capture
    return {"kernel": KERNEL in text, "span": span in text,
            "timed": calls() == before + 1, "returned": returned,
            "launched": cuda_lib.launches["poseidon_permute"] - launched,
            "launches": cap.launches, "kernels": cap.kernels,
            "lost": cap.lost, "bytes": len(text)}


def passed(trial: dict) -> bool:
    return all(trial[k] for k in ("kernel", "span", "timed", "returned")) \
        and trial["lost"] == 0


def run(device: torch.device) -> list:
    state = torch.zeros((1024, 3, 32), dtype=torch.int32, device=device)
    return [capture_once(state) for _ in range(TRIALS)]


def main() -> int:
    dev = require_device("cuda")
    res = run(dev)
    print(json.dumps({"device": str(dev), "trials": res}))
    return 0 if all(map(passed, res)) else 1


if __name__ == "__main__":
    raise SystemExit(main())
