"""The port's telemetry (hotproofs_tpu_torch.utils.telemetry) against the
reference's hotproofs_tpu.utils.telemetry: the same counters and span
timers give the same snapshot and report; a span records its time even
when its block raises; the on-demand capture writes a Chrome trace, and
tools/trace_check.py reads one back; the thread-pool path of
prove_segments times one `segments/prove_one` a segment."""

import glob
import json
import os

import pytest
import torch

from hotproofs_tpu.circuits.dsl import compile_circuit
from hotproofs_tpu.utils import telemetry as RT
from hotproofs_tpu_torch.nova.ivc import IVC
from hotproofs_tpu_torch.nova.pedersen import CommitmentKey
from hotproofs_tpu_torch.nova.r1cs import ShapeDevice
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.parallel import segments as S
from hotproofs_tpu_torch.tools import trace_check as TC
from hotproofs_tpu_torch.utils import telemetry as T
from torch_toy_chain import CONST, P, toy_step
from torch_toy_chain import chain as _chain
from torch_toy_chain import toy_gens as _toy_gens

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

# (op, name, value): counts and observed durations, in seconds, chosen so
# that the rounding to 6 places shows (1e-7, 2.5e-7), with a counter of
# floats and a timer whose mean is not its first value.
SEQUENCE = [("count", "ivc/folds", 16), ("count", "ivc/folds", 1),
            ("count", "segments/proved", 1), ("count", "bytes", 0.5),
            ("observe", "segments/prove_one", 0.125),
            ("observe", "segments/prove_one", 1e-7),
            ("observe", "segments/prove_one", 2.5e-7),
            ("observe", "segments/lockstep_wave", 3.0),
            ("count", "bytes", 2.25), ("observe", "ivc/fold_chunk", 1 / 3)]


def _replay(metrics):
    for op, name, v in SEQUENCE:
        getattr(metrics, op)(name, v)
    return metrics


@pytest.mark.parametrize("cut", [0, 1, 4, len(SEQUENCE)])
def test_snapshot_and_report_equal_the_reference(cut):
    ours, ref = T.Metrics(), RT.Metrics()
    for op, name, v in SEQUENCE[:cut]:
        getattr(ours, op)(name, v)
        getattr(ref, op)(name, v)
    assert ours.snapshot() == ref.snapshot()
    assert ours.report() == ref.report()
    snap = ours.snapshot()
    assert set(snap) == {"counters", "timers"}
    for t in snap["timers"].values():
        assert set(t) == {"calls", "total_s", "mean_s", "max_s"}
    ours.reset()
    ref.reset()
    assert ours.snapshot() == ref.snapshot() == {"counters": {},
                                                 "timers": {}}


def test_full_sequence_values():
    snap = _replay(T.Metrics()).snapshot()
    assert snap["counters"] == {"ivc/folds": 17, "segments/proved": 1,
                                "bytes": 2.75}
    one = snap["timers"]["segments/prove_one"]
    assert one == {"calls": 3, "total_s": 0.125, "mean_s": 0.041667,
                   "max_s": 0.125}
    assert json.loads(T.Metrics().report()) == {"counters": {},
                                                "timers": {}}


def test_span_records_even_when_its_block_raises():
    before = T.metrics.snapshot()["timers"].get(
        "unit/raises", {"calls": 0})["calls"]
    with pytest.raises(ValueError):
        with T.span("unit/raises", k="1") as sp:
            raise ValueError("boom")
    snap = T.metrics.snapshot()["timers"]["unit/raises"]
    assert snap["calls"] == before + 1
    assert sp.s >= 0 and snap["max_s"] >= round(sp.s, 6)
    with T.span("unit/ok") as sp:
        pass
    assert T.metrics.snapshot()["timers"]["unit/ok"]["calls"] >= 1


def test_on_demand_trace_on_the_cpu(tmp_path):
    log = str(tmp_path / "prof")
    assert T.stop_trace() is None                  # nothing running
    T.start_trace(log)
    T.start_trace(str(tmp_path / "other"))         # a second start: no-op
    with T.span("unit/traced", n="3"):
        torch.ones(3).add_(1)
    assert T.stop_trace() == log
    assert T.stop_trace() is None
    files = glob.glob(os.path.join(log, "*.json"))
    assert len(files) == 1
    assert not os.path.exists(tmp_path / "other")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "unit/traced n=3" for e in events)


def test_trace_check_tool_on_the_cpu():
    """tools/trace_check.py's capture: the span named and timed, the
    directory returned, no launch in the trace; on the CPU the plain
    version runs, so no kernel is named and no trial passes (the tool's
    entry point needs a card: tests/test_torch_port_boundary.py)."""
    state = torch.zeros((2, 3, 32), dtype=torch.int32)
    got = TC.capture_once(state, "unit/trace_check")
    assert got["span"] and got["timed"] and got["returned"]
    assert not got["kernel"] and got["bytes"] > 0
    assert (got["launched"], got["launches"], got["lost"]) == (0, 0, 0)
    res = TC.run(torch.device("cpu"))
    assert len(res) == TC.TRIALS and not any(map(TC.passed, res))


def _launch(corr, name="cudaLaunchKernel", cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": name,
            "args": {"correlation": corr}}


def _kernel(corr, name="k_poseidon<3>"):
    return {"ph": "X", "cat": "kernel", "name": name,
            "args": {"correlation": corr}}


@pytest.mark.parametrize("events, want", [
    ([], (0, 0)),
    ([_launch(1), _kernel(1)], (1, 1)),
    ([_launch(1), _launch(2, "cuLaunchKernel", "cuda_driver"), _kernel(2)],
     (2, 1)),
    ([_launch(7)], (1, 0)),
    ([_launch(1, "cudaLaunchHostFunc"), _launch(2, "cudaMemcpyAsync"),
      {"cat": "ac2g", "name": "ac2g", "args": {"correlation": 3}},
      _kernel(9), {"cat": "cpu_op", "name": "aten::add_"}], (0, 0)),
])
def test_count_kernels_matches_launches_to_kernel_records(events, want):
    assert T.count_kernels(events) == want


def test_stop_trace_reads_its_capture(tmp_path):
    """stop_trace fills last_capture from the trace it wrote, and warns
    when a launch has no kernel record (a lossy trace, faked here by a
    profiler whose export writes one)."""
    T.start_trace(str(tmp_path / "a"))
    torch.ones(3).add_(1)
    assert T.stop_trace() == str(tmp_path / "a")
    cap = T.last_capture
    assert os.path.dirname(cap.path) == str(tmp_path / "a")
    assert (cap.launches, cap.kernels, cap.lost) == (0, 0, 0)

    class Lossy:
        def stop(self):
            pass

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": [_launch(1), _launch(2),
                                           _kernel(2)]}, f)

    T._trace = (Lossy(), str(tmp_path / "b"))
    with pytest.warns(RuntimeWarning, match="1 of 2 kernel launches"):
        assert T.stop_trace() == str(tmp_path / "b")
    assert (T.last_capture.launches, T.last_capture.lost) == (2, 1)


def test_pool_path_times_one_prove_one_a_segment():
    """The toy chain of tests/test_torch_segments.py (8 steps, 3 segments)
    on the thread pool: one `segments/prove_one` a segment; lockstep: one
    `segments/lockstep_wave` a wave and no prove_one."""
    r1cs, layout = compile_circuit(toy_step, P)
    shape = ShapeDevice.from_dsl(r1cs)
    n = max(shape.n_wit, shape.n_cons)
    ivc = IVC(shape, C.PALLAS, CommitmentKey(C.PALLAS, n, _toy_gens(n),
                                             b"toy"), None)
    canon, X, _ = _chain(layout, 3, 8)
    zs = [[3]]
    for _ in range(8):
        zs.append([(pow(zs[-1][0], 3, P) + CONST) % P])
    calls = lambda k: T.metrics.snapshot()["timers"].get(
        k, {"calls": 0})["calls"]
    one, wave = calls("segments/prove_one"), calls("segments/lockstep_wave")
    pool = S.prove_segments(ivc, zs, canon, X, 3, lockstep=False)
    assert calls("segments/prove_one") == one + 3
    assert calls("segments/lockstep_wave") == wave
    lock = S.prove_segments(ivc, zs, canon, X, 3, lockstep=True,
                            lockstep_group=2)
    assert calls("segments/lockstep_wave") == wave + 2
    assert calls("segments/prove_one") == one + 3
    assert json.dumps(pool.to_dict()) == json.dumps(lock.to_dict())
