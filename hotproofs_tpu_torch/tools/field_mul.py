"""The field multiply and its pieces, checked and timed on the card (port of
the TPU tools tools/bench_pallas_mont.py, tools/bench_pallas_bisect.py,
tools/bench_pallas_parts.py and tools/bench_mxu_msm.py).

Four parts, on seeded canonical elements of the Pallas base field, at
N = 16,384 and 131,072 elements:

  mont    (bench_pallas_mont.py) the mont_mul kernel on limb-major digits
          equal to its plain version and to Python ints, then its time, the
          plain version's, and the element-major and word entry points';
  bisect  (bench_pallas_bisect.py) mont_mul_stage, stages 1..5: each equal
          to its plain version, stage 5 to the product, and their times;
  parts   (bench_pallas_parts.py) mont_mul_part conv, conv3 and norm, the
          full product, and conv_mma, the convolution on the tensor cores,
          with the line that says whether it matches the conv part; then
          the one PyTorch call that computes conv_mma's columns (a grouped
          float32 conv1d, library_conv), timed the same way, and whether
          its columns equal conv_mma's;
  msm     (bench_mxu_msm.py) the multiply rate at N = 2^17, then msm_many
          at the comm_T and comm_W shapes over the real key: its time and
          its result equal, as an affine point, to the host's sum (the port
          has no second device MSM to compare with).

Each line gives the kernel's time (the mean of 20 calls captured in one CUDA
graph and replayed between two events, after a warm-up, on operand sets
taken in turn that together exceed the L2 cache), the plain version's (one
run), and the bound: the least time the card could take, the
larger of the bytes moved (each input read once, each output written once)
over the memory rate and the integer multiplies over the multiply rate.

    python -m hotproofs_tpu_torch.tools.field_mul [--device cuda] [--seed 0]

The functions are importable (chip_smoke.py runs them in its phase 7).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..nova.pedersen import CommitmentKey
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm_pallas as MP
from ..ops import pallas_field as PF
from ..utils.config import require_device
from .msm_designs import random_scalars, timer

SPEC = F.pallas_base
NS = (16384, 131072)
MSM_SHAPES = {"comm_T": (16162, 256), "comm_W": (15922, 40)}
REPS = 20               # timed calls per measurement, after a warm-up

# Work per element, for the bounds. Bytes: two operands and the result,
# 128 each as int32 digits, 32 each as words. 32-bit integer multiplies:
# a 32 x 32 -> 64 word product is two (low and high half). CIOS: 2 x (64 +
# 64) + 8 reduction factors. Staged: T 128, m = T mu mod R 64 (36 low, 28
# high), m p 128. The lazy columns and the convolutions are defined on
# digits: 528 byte products for 32 columns.
DIGIT_BYTES, WORD_BYTES = 3 * 128, 3 * 32
MULS = {"mont_mul": 264, "stage 1": 128, "stage 2": 192, "stage 3": 192 + 528,
        "stage 4": 320, "stage 5": 320, "conv": 528, "conv3": 3 * 528,
        "norm": 32, "conv_mma": 528}
# conv_mma's tensor-core work, counted as the function's: its 528 byte
# products, a multiply and an add each, at the dense int8 rate.
MMA_OPS = 2 * 528
HBM_BYTES_PER_S = 3.35e12
IMUL_PER_CLOCK_SM = 64      # 32-bit integer multiplies, compute capability 9.0
TENSOR_INT8_OPS_PER_S = 1.979e15


def imul_rate(device: torch.device) -> Optional[float]:
    """32-bit integer multiplies per second of the card: SMs x 64 per clock
    x the maximum SM clock nvidia-smi reports. None on the CPU."""
    if device.type != "cuda":
        return None
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    mhz = float(subprocess.run(
        ["nvidia-smi", f"--id={idx}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    return sms * IMUL_PER_CLOCK_SM * mhz * 1e6


def bound(n: int, muls: int, nbytes: int, rate: Optional[float],
          mma_ops: int = 0) -> Tuple[Optional[float], str]:
    """(bound_ms, bound_by) of a call on n elements doing `muls` integer
    multiplies (and mma_ops tensor-core operations) and moving `nbytes`
    bytes an element; (None, "") without a rate (on the CPU)."""
    if rate is None:
        return None, ""
    mem = n * nbytes / HBM_BYTES_PER_S * 1e3
    ops = max(n * muls / rate, n * mma_ops / TENSOR_INT8_OPS_PER_S) * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def random_elements(rng: np.random.Generator, spec: F.FieldSpec, n: int,
                    device) -> torch.Tensor:
    """(n, 32) digits of seeded canonical elements: uniform below the
    largest power of two under p."""
    raw = rng.integers(0, 256, size=(n, F.N_LIMBS), dtype=np.int64)
    top = spec.p.bit_length() - 1 - 8 * (F.N_LIMBS - 1)
    raw[:, -1] &= (1 << top) - 1
    return torch.from_numpy(raw.astype(np.int32)).to(device)


def _ints_ok(spec: F.FieldSpec, a, b, got_em, stride: int) -> bool:
    """got_em[i] == a[i] * b[i] / R mod p as Python ints, every stride-th
    element."""
    idx = list(range(0, a.shape[0], stride))
    rinv = pow(1 << 256, -1, spec.p)
    av, bv, gv = (spec.limbs_to_ints(t[idx].cpu().numpy()).tolist()
                  for t in (a, b, got_em))
    return all(x * y * rinv % spec.p == g for x, y, g in zip(av, bv, gv))


class _Lines:
    """Formats and emits one result line per measurement and keeps them."""

    def __init__(self, n: int, rate: Optional[float], out):
        self.n, self.rate, self.out, self.rows = n, rate, out, {}

    def add(self, name: str, ms: float, plain_ms: Optional[float], ok: bool,
            check: str, muls: int, nbytes: int = DIGIT_BYTES,
            mma_ops: int = 0) -> None:
        b_ms, by = bound(self.n, muls, nbytes, self.rate, mma_ops)
        self.rows[name] = {"ms": ms, "plain_ms": plain_ms, "ok": bool(ok),
                           "bound_ms": b_ms, "bound_by": by}
        plain = "" if plain_ms is None else f", plain {plain_ms:.3f} ms"
        bnd = "" if b_ms is None else f", bound {b_ms:.4f} ms by {by}"
        self.out(f"N={self.n} {name}: {ms:.4f} ms "
                 f"({self.n / ms / 1e3:.1f} M/s){plain}{bnd}, {check} "
                 f"{'OK' if ok else 'FAILED'}")


def kernel_ms(device: torch.device, call, reps: int) -> float:
    """ms per call of call(i), i = 0 .. reps - 1. On the card the reps calls
    are captured into one CUDA graph after a warm-up and its replay is timed
    with events: the device's time for the kernels back to back, not the
    rate at which the host can enqueue them (a wrapper call costs the host
    more than these kernels run). On the CPU, the host clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(reps):
            call(i)
        return (time.perf_counter() - t0) * 1e3 / reps
    call(0)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            call(i)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


COLD_BYTES = 128 << 20      # more than twice the card's 50 MB L2 cache


class Inputs:
    """Seeded operand sets of n elements each, in all three formats. The
    timed calls take the sets in turn, and together the sets exceed
    COLD_BYTES, so no call finds its operands in the L2 cache; the checks
    use set 0."""

    def __init__(self, rng: np.random.Generator, n: int, device):
        self.n = n
        self.sets = k = max(1, min(32, -(-COLD_BYTES // (n * DIGIT_BYTES))))
        self.a, self.b = (random_elements(rng, SPEC, k * n, device).reshape(
            k, n, F.N_LIMBS) for _ in range(2))
        self.at, self.bt = (x.transpose(1, 2).contiguous()
                            for x in (self.a, self.b))
        self.aw, self.bw = (F.digits_to_words(x) for x in (self.a, self.b))

    def timed(self, fn, *names: str):
        """call(i) for kernel_ms: fn on set i mod sets of the named
        operands."""
        ops = [getattr(self, name) for name in names]
        return lambda i: fn(*(x[i % self.sets] for x in ops))


def part_mont(lines: _Lines, inp: Inputs, reps: int) -> None:
    """bench_pallas_mont.py: exactness, then the kernel's, the plain
    version's, the element-major and the word entry points' times."""
    dev = inp.a.device
    plain_timer = timer(dev)
    ms = lambda fn, *names: kernel_ms(dev, inp.timed(fn, *names), reps)
    a, b, at, bt, aw, bw = (x[0] for x in (inp.a, inp.b, inp.at, inp.bt,
                                           inp.aw, inp.bw))
    want = PF.mont_mul_em_plain(SPEC, a, b)
    got = PF.mont_mul_lm(SPEC, at, bt)
    ok = torch.equal(got.T, want) and _ints_ok(SPEC, a, b, got.T,
                                               max(1, lines.n // 64))
    lines.add("mont_mul_lm",
              ms(lambda x, y: PF.mont_mul_lm(SPEC, x, y), "at", "bt"),
              plain_timer(lambda: PF.mont_mul_lm_plain(SPEC, at, bt), 1),
              ok, "== plain and ints", MULS["mont_mul"])
    lines.add("mont_mul_em",
              ms(lambda x, y: PF.mont_mul_em(SPEC, x, y), "a", "b"),
              plain_timer(lambda: PF.mont_mul_em_plain(SPEC, a, b), 1),
              torch.equal(PF.mont_mul_em(SPEC, a, b), want), "== plain",
              MULS["mont_mul"])
    r2 = PF.const_digits(SPEC, "r2", dev)
    lines.add("to_mont (em, constant operand)",
              ms(lambda x: F.to_mont(SPEC, x), "a"), None,
              torch.equal(F.to_mont(SPEC, a),
                          PF.mont_mul_em_plain(SPEC, a, r2)), "== plain",
              MULS["mont_mul"], 2 * 128)
    lines.add("mont_mul_words",
              ms(lambda x, y: PF.mont_mul_words(SPEC, x, y), "aw", "bw"),
              plain_timer(lambda: PF.mont_mul_words_plain(SPEC, aw, bw), 1),
              torch.equal(F.words_to_digits(PF.mont_mul_words(SPEC, aw, bw)),
                          want), "== plain", MULS["mont_mul"], WORD_BYTES)


def _checked(kern, plain) -> Tuple[bool, float]:
    """(kern() == plain(), ms of the one plain run on the host's clock)."""
    got = kern()
    t0 = time.perf_counter()
    ok = torch.equal(got, plain())          # .equal waits for the device
    return ok, (time.perf_counter() - t0) * 1e3


def part_bisect(lines: _Lines, inp: Inputs, reps: int) -> None:
    """bench_pallas_bisect.py: the staged product cut after stages 1..5."""
    at, bt = inp.at[0], inp.bt[0]
    for stage in PF.STAGES:
        kern = lambda x, y: PF.mont_mul_stage(SPEC, x, y, stage)
        ok, plain_ms = _checked(
            lambda: kern(at, bt),
            lambda: PF.mont_mul_stage_plain(SPEC, at, bt, stage))
        if stage == 5:
            ok = ok and torch.equal(kern(at, bt),
                                    PF.mont_mul_lm(SPEC, at, bt))
        lines.add(f"stage {stage}",
                  kernel_ms(at.device, inp.timed(kern, "at", "bt"), reps),
                  plain_ms, ok,
                  "== plain" + (" == mont_mul" if stage == 5 else ""),
                  MULS[f"stage {stage}"])


def part_parts(lines: _Lines, inp: Inputs, reps: int) -> None:
    """bench_pallas_parts.py: conv, conv3, norm, the full product, and the
    convolution on the tensor cores with its match line."""
    at, bt = inp.at[0], inp.bt[0]
    ms = lambda fn: kernel_ms(at.device, inp.timed(fn, "at", "bt"), reps)
    for part in PF.PARTS:
        kern = lambda x, y: PF.mont_mul_part(SPEC, x, y, part)
        ok, plain_ms = _checked(
            lambda: kern(at, bt),
            lambda: PF.mont_mul_part_plain(SPEC, at, bt, part))
        lines.add(part, ms(kern), plain_ms, ok, "== plain", MULS[part])
    lines.add("full mont_mul", ms(lambda x, y: PF.mont_mul_lm(SPEC, x, y)),
              None, True, "(checked above)", MULS["mont_mul"])
    ok, plain_ms = _checked(lambda: PF.conv_mma(at, bt),
                            lambda: PF.conv_mma_plain(at, bt))
    got = PF.conv_mma(at, bt)
    match = torch.equal(got & 0xFF, PF.mont_mul_part(SPEC, at, bt, "conv"))
    lines.add("conv_mma", ms(PF.conv_mma), plain_ms, ok and match,
              f"== plain, mma conv match: {match}", MULS["conv_mma"],
              mma_ops=MMA_OPS)
    library_conv(lines, inp, reps, got)


def library_conv(lines: _Lines, inp: Inputs, reps: int,
                 mma: torch.Tensor) -> None:
    """The one PyTorch call that computes conv_mma's function, timed as
    conv_mma is, for its library_ms (the port never calls it): a grouped
    float32 conv1d, a group per element, over a digits padded with 31
    zeros on the left and a 32-tap kernel of b's digits flipped, which
    gives column c = sum_{j+k=c} a_j b_k for c < 32. Every column is at
    most 32 * 255^2 < 2^24, so float32 holds it exactly when no TF32 is
    allowed (cuDNN allows it by default for convolutions). The inputs are
    converted before the timing; the line's check says whether the columns
    equal mma, conv_mma's output on operand set 0."""
    dev = inp.at.device
    xs = torch.nn.functional.pad(
        inp.at.float().transpose(1, 2), (F.N_LIMBS - 1, 0)).contiguous()
    ws = inp.bt.float().transpose(1, 2).flip(-1).unsqueeze(2).contiguous()
    conv = lambda x, w: torch.nn.functional.conv1d(x[None], w,
                                                   groups=inp.n)[0]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        got = conv(xs[0], ws[0])
        exact = torch.equal(got.T.to(torch.int32), mma)
        ms = kernel_ms(dev, lambda i: conv(xs[i % inp.sets],
                                           ws[i % inp.sets]), reps)
    lines.add("conv1d (library)", ms, None, True,
              f"columns == conv_mma: {exact}", MULS["conv_mma"])
    lines.rows["conv1d (library)"]["exact"] = exact


def host_msm_windowed(spec: C.CurveSpec, scalars: Sequence[int],
                      points: Sequence[Tuple[int, int]], window: int = 8):
    """C.host_msm's sum, on the host's ints with the same projective
    addition, by 8-bit windows and buckets: some 60 times fewer additions
    at 16k points of 256 bits. Affine (x, y), or None for the identity."""
    add = lambda p, q: C._host_proj_add(spec, p, q)
    ident, mask = (0, 1, 0), (1 << window) - 1
    pts = [(x, y, 1) for x, y in points]
    bits = max((int(k).bit_length() for k in scalars), default=0)
    total = ident
    for w in reversed(range(-(-bits // window))):
        for _ in range(window):
            total = add(total, total)
        buckets = [ident] * (mask + 1)
        for k, p in zip(scalars, pts):
            d = (int(k) >> (window * w)) & mask
            if d:
                buckets[d] = add(buckets[d], p)
        run = acc = ident
        for d in range(mask, 0, -1):
            run = add(run, buckets[d])
            acc = add(acc, run)
        total = add(total, acc)
    X, Y, Z = total
    if Z == 0:
        return None
    m = spec.base.p
    zi = pow(Z, m - 2, m)
    return (X * zi % m, Y * zi % m)


def part_msm(ck: CommitmentKey, rng: np.random.Generator, rate, reps: int,
             n: int, shapes: Dict[str, Tuple[int, int]],
             out) -> Dict[str, object]:
    """bench_mxu_msm.py: the multiply rate on n fresh elements (2^17 in the
    tool's own run), then msm_many at each (m, bits) of shapes over ck's
    first m generators: its time, and its result against the host's sum as
    affine points."""
    dev = ck.device
    ms = timer(dev)
    inp = Inputs(rng, n, dev)
    lines = _Lines(n, rate, out)
    lines.add("mont_mul_lm rate", kernel_ms(dev, inp.timed(
        lambda x, y: PF.mont_mul_lm(SPEC, x, y), "at", "bt"), reps), None,
        True, "(checked above)", MULS["mont_mul"])
    del inp
    res: Dict[str, object] = dict(lines.rows)
    f = ck.spec.base
    rinv = pow(f.r_mod_p, -1, f.p)
    for tag, (m, bits) in shapes.items():
        sc = random_scalars(rng, 1, m, bits, dev)
        bases, lm = ck.bases(m, bits), ck.bases_lm(m, bits)
        whole = lambda: MP.msm_many(ck.spec, sc, bases, m, bits, bases_lm=lm)
        got = ck.affine(whole())[0]
        t_ms = ms(whole, max(1, reps // 4))
        gens = [(x * rinv % f.p, y * rinv % f.p) for x, y in
                f.limbs_to_ints(ck.gens_affine[:m]).tolist()]
        t0 = time.perf_counter()
        want = host_msm_windowed(
            ck.spec, f.limbs_to_ints(sc[0].cpu().numpy()).tolist(), gens)
        host_s = time.perf_counter() - t0
        ok = got == want
        res[tag] = {"m": m, "bits": bits, "ms": t_ms, "ok": bool(ok)}
        out(f"{tag} (m={m}, {bits} bits): msm_many {t_ms:.3f} ms = "
            f"{m / t_ms / 1e3:.2f} M points/s; parity vs the host's sum "
            f"({host_s:.1f} s): {ok}")
    return res


def run(device, rng: np.random.Generator, ns: Sequence[int] = NS,
        reps: int = REPS, ck: Optional[CommitmentKey] = None,
        msm_shapes: Optional[Dict[str, Tuple[int, int]]] = None,
        out=print) -> Dict[str, object]:
    """The four parts: mont, bisect and parts at every N of ns, then msm
    over ck (skipped if ck is None). One line per measurement goes to out;
    returns {"N=...": {line name: {ms, plain_ms, ok, bound_ms, bound_by}},
    "msm": {...}}."""
    device = torch.device(device)
    rate = imul_rate(device)
    results: Dict[str, object] = {}
    for n in ns:
        inp = Inputs(rng, n, device)
        lines = _Lines(n, rate, out)
        part_mont(lines, inp, reps)
        part_bisect(lines, inp, reps)
        part_parts(lines, inp, reps)
        results[f"N={n}"] = lines.rows
        del inp
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if ck is not None:
        results["msm"] = part_msm(ck, rng, rate, reps, max(ns),
                                  msm_shapes or MSM_SHAPES, out)
    return results


def all_ok(results: Dict[str, object]) -> bool:
    return all(row["ok"] for part in results.values()
               for row in part.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: %(default)s)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device {dev}: {name}", flush=True)
    rng = np.random.default_rng(args.seed)
    ck = CommitmentKey.create(C.PALLAS, b"blake3-nova", 16384, dev)
    results = run(dev, rng, ck=ck, out=lambda line: print(line, flush=True))
    print(json.dumps(results))
    return 0 if all_ok(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
