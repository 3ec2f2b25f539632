"""What a mixed add, a doubling and the tensor-core convolution cost on the
card: msm_chain, h_tables, scale16 and conv_mma timed, with the
instructions of their loops counted from the machine code.

    PYTHONPATH=TREE python hotproofs_tpu_torch/tools/add_cost.py [--out F]
    PYTHONPATH=. python hotproofs_tpu_torch/tools/add_cost.py --counts \
        --device cpu

It measures the package that PYTHONPATH names first, through its public
wrappers only, so one copy of this file times an older tree's kernels the
same way (tools/designs_ab.py runs it over each tree in turns; it is run by
path, not with -m, for that reason). On that tree's card build it:

  * dumps the machine code of the library (cuobjdump -sass), takes
    k_msm_chain's add loop (one base load and one mixed add) and
    k_h_tables' walk loop (the digit scan, a base gather, a mixed add) and
    counts their instructions by class;
  * times msm_chain (CUDA events, mean of REPS after a warm-up) on seeded
    bases of B = 64 steps at 32 lanes (one warp: the latency of 64
    dependent adds) and at 132 x 128 x {1, 2, 4, 8} lanes (1, 2, 4 and 8
    blocks of 128 threads an SM), at every split H the wrapper takes
    (a tree without the split is H = 1), and prints the SM cycles a
    warp-step, time x clock x SMs / (warps x B / H) over the SMs that
    hold a block; the issue time, the loop's instructions x warp-steps
    over 4 issues a clock on those SMs (a loop inside the add, such as a
    rolled CIOS round, counts once, so for such a build it is a floor),
    beside the multiply bound (chip_smoke.py's count: 11 CIOS products of
    264 multiplies a mixed add, 64 multiplies a clock on each of 132 SMs);
    and the affine lane sums' sha256 (the bases are field elements, not
    points, so H changes the sums; trees must agree at each H);
  * builds the BLAKE3 recursive SNARK's two shapes
    (ChunkProver(...).recursive: the primary at m = 65,536 on Pallas, the
    secondary at 32,768 on Vesta) and their matrix tables' CSR
    (ops/tables: table_csr), and times h_tables on each over its key's
    prepared bases (ck.bases_lm), and again with every column taken mod
    NEAR_COLS (bases the L2 holds), beside the lane maps' warp-steps
    (walk_counts); the affine tables' sha256 (to_affine on the card) must
    agree between trees;
  * times the main path's to_affine (1,034,368 points) and mont_mul (the
    prover's to_mont shape, 255,248 elements; 20 calls in a CUDA graph) on
    seeded inputs;
  * counts k_scale16's doubling loop by class (the longest loop that
    touches no global memory; a tree whose compiler unrolled it gives its
    window loop, the doublings and a store) and times scale16 at W4 = 64
    on 32 points (one warp: the latency of the 252-doubling chain), on the
    key's 16,384 and on the tables' 49,152: seeded curve points P_i = (i +
    1) G, each at a seeded Z != 1. It prints the SM cycles a doubling a
    warp-step (at the maximum clock), the SM clock and power draw that
    nvidia-smi samples while it runs for half a second, time x clock x SMs / (warps x 4 (W4 - 1)) over the SMs
    that hold a block, beside chip_smoke.py's bound (Jacobian doublings, 2
    products and 5 squarings, and 2 products a stored window), and the
    sha256 of the affine output (to_affine on the card), which every tree
    must give;
  * times conv_mma at N = 16,384 and 131,072 on seeded digits, as
    tools/field_mul.py times it (20 calls in a CUDA graph, over operand
    sets that together exceed the L2 cache), checked against its plain
    version and the conv part, beside its bound (3 x 128 bytes an
    element).

--parts picks a subset (default: all). Prints one line per measurement
and, last, one JSON object (also written to --out). Needs a card, but for
--counts, which prints the tables' lane-map counts alone (walk_counts: the
half-warp map, a balanced warp, the kernel's; about 15 s on a CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import inspect
import json
import os
import re
import subprocess
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from hotproofs_tpu_torch.ops import cuda_lib
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.ops import field as F
from hotproofs_tpu_torch.ops import msm_pallas as MP

B = 64                  # steps of a chain (msm_bucket's B)
SMS, BLOCK = 132, 128   # the H100's SMs; threads of a msm_chain block
LANES = (32,) + tuple(SMS * BLOCK * k for k in (1, 2, 4, 8))
SPLITS = (1, 2, 4, 8)
REPS = 5
AFFINE_POINTS = 1034368     # the blake3-nova key's prepared bases
TO_MONT = 255248            # the prover's to_mont call
ISSUE_PER_CLOCK_SM = 4      # warp instructions an SM issues a clock
# The multiply bound's count (chip_smoke.py): a mixed add's 11 CIOS
# products of 264 32-bit multiplies, at 64 a clock an SM.
MUL32_PER_MIXED_ADD = 11 * 264
IMUL_PER_CLOCK_SM = 64
PTXAS_KERNELS = ("k_msm_chain", "k_h_tables", "k_scale16",
                 "k_conv_mma")                  # printed; all are kept
PARTS = ("sass", "chain", "tables", "main", "scale16", "conv")
SCALE_POINTS = (32, 16384, 49152)   # one warp, the key's, the tables'
SCALE_W4 = 64
POINT_BLOCK = 128                   # threads of a scale16 block
# chip_smoke.py's count for scale16, in CIOS products of 264 multiplies: a
# Jacobian doubling's 2 products and 5 squarings of 208, and 2 products a
# stored window (x Z and Z^3).
MONT_PER_DOUBLE = 2 + 5 * 208 / 264
MONT_PER_WINDOW = 2
CONV_NS = (16384, 131072)
CONV_BYTES = 3 * 128                # a, b in and the columns out an element
COLD_BYTES = 128 << 20              # operand sets: over twice the L2
HBM_BYTES_PER_S = 3.35e12
# h_tables again with every column taken mod NEAR_COLS: the same adds, their
# bases gathered from 64 x NEAR_COLS points (the L2 holds them) instead of
# the whole key, which splits the gathers' cost from the adds'.
NEAR_COLS = 256
# Instruction classes of the loop count, by opcode (the part before the
# first dot); what no class names is "other".
CLASSES = {
    "IMAD": ("IMAD",), "IADD3": ("IADD3",), "ISETP/SEL": ("ISETP", "SEL"),
    "LOP3/SHF": ("LOP3", "SHF", "LEA"), "MOV": ("MOV",),
    "branch": ("BRA", "BSSY", "BSYNC", "EXIT", "RET", "CALL", "WARPSYNC"),
    "LDG": ("LDG",), "STG": ("STG",), "LDL/STL": ("LDL", "STL"),
}


def card_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip()
    return float(out) * 1e6


def cuda_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def under_load(fn, seconds: float = 0.5) -> Dict[str, float]:
    """The card's SM clock (MHz, median) and power draw (W, largest) that
    nvidia-smi samples every 20 ms while fn runs back to back for about
    `seconds`."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    t1.synchronize()
    reps = max(1, int(seconds * 1e3 / max(t0.elapsed_time(t1), 1e-3)))
    smi = subprocess.Popen(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        text = smi.communicate()[0]
    rows = [[float(v) for v in line.split(",")] for line in
            text.strip().splitlines() if line.count(",") == 1]
    if not rows:
        return {"clock_mhz": float("nan"), "power_w": float("nan")}
    clocks = sorted(r[0] for r in rows)
    return {"clock_mhz": clocks[len(clocks) // 2],
            "power_w": max(r[1] for r in rows)}


def graph_ms(fn, reps: int) -> float:
    """ms per call of fn, reps calls captured in one CUDA graph (a call
    this short costs the host more than the card: tools/field_mul.py)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rand_words(rng: np.random.Generator, shape, dev) -> torch.Tensor:
    """Seeded canonical words below 2^252 (under every field's p). They
    are field elements, not curve points: the formulas are total, and the
    sums are compared only between trees and against plain versions."""
    w = rng.integers(0, 1 << 32, size=tuple(shape) + (8,), dtype=np.uint64)
    w[..., 7] &= 0x0FFFFFFF
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)


def sass_loops(lib_path: str, kernel: str):
    """`kernel`'s loops in cuobjdump -sass of the library: for every
    backward branch, the opcodes from its target to it."""
    tool = os.path.join(os.path.dirname(cuda_lib.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = next((f for f in funcs[1:] if kernel in f.split("\n", 1)[0]),
                None)
    if body is None:
        raise RuntimeError(f"{kernel} not found in the SASS of {lib_path}")
    ins = []   # (address, opcode, text)
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            txt = m.group(2).strip()
            op = re.sub(r"^@!?U?P[T0-9]+\s+", "", txt).split()[0]
            ins.append((int(m.group(1), 16), op, txt))
    loops = []
    for addr, op, txt in ins:
        t = re.search(r"0x([0-9a-f]+)", txt)
        if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
            loops.append([o for a, o, _ in ins
                          if int(t.group(1), 16) <= a <= addr])
    return ins, loops


def class_counts(loop: List[str]) -> Dict[str, object]:
    counts = {k: 0 for k in CLASSES}
    counts["other"] = 0
    other: Dict[str, int] = {}
    for op in loop:
        head = op.split(".")[0]
        k = next((k for k, ops in CLASSES.items() if head in ops), "other")
        counts[k] += 1
        if k == "other":
            other[head] = other.get(head, 0) + 1
    return {"classes": counts,
            "other_ops": dict(sorted(other.items(), key=lambda kv: -kv[1])
                              [:8]),
            "IMAD.WIDE": sum(op.startswith("IMAD.WIDE") for op in loop),
            "IMAD.HI": sum(op.startswith("IMAD.HI") for op in loop),
            "carry (.X)": sum(op.startswith("IADD3.X")
                              or op.startswith("IMAD.X") for op in loop)}


def sass_loop_counts(lib_path: str, kernel: str) -> Dict[str, object]:
    """Instructions of `kernel`'s add loop by class, from cuobjdump -sass
    of the library: the longest span from a backward branch's target to
    the branch that loads from global memory and shuffles nothing (the
    chain's loop, not its join). A loop the compiler unrolled holds more
    than one add: loads / 16 (one affine base is 16 words)."""
    ins, loops = sass_loops(lib_path, kernel)
    best = None
    for ops in loops:
        if any(o.startswith("LDG") for o in ops) and \
                not any(o.startswith("SHFL") for o in ops) and \
                (best is None or len(ops) > len(best)):
            best = ops
    if best is None:
        raise RuntimeError(f"{kernel}: no loop of loads found")
    loop = best
    words = sum(4 if ".128" in op else 2 if ".64" in op else 1
                for op in loop if op.startswith("LDG"))
    adds = max(words // 16, 1)
    return {"kernel": kernel, "instructions": len(loop), "adds": adds,
            "instructions_per_add": len(loop) / adds,
            "function_instructions": len(ins), **class_counts(loop)}


def sass_doubling_loop(lib_path: str, kernel: str) -> Dict[str, object]:
    """`kernel`'s (a k_scale16) doubling loop by class: the longest loop
    that reads and writes no global memory (the 4 doublings between two
    stored windows, with the rolled rounds of their products inside it);
    where the compiler unrolled it, the longest loop that stores (the
    window loop: the doublings and the store). A rolled round inside
    counts once."""
    ins, loops = sass_loops(lib_path, kernel)
    mem = ("LDG", "STG")
    inner = [ops for ops in loops
             if not any(o.startswith(mem) for o in ops)]
    which = "doubling loop"
    if not inner:
        inner = [ops for ops in loops if any(o.startswith("STG")
                                             for o in ops)]
        which = "window loop"
    if not inner:
        raise RuntimeError("k_scale16: no loop found")
    loop = max(inner, key=len)
    return {"kernel": kernel, "loop": which,
            "instructions": len(loop), "loops": len(loops),
            "function_instructions": len(ins), **class_counts(loop)}


def chain_splits() -> List[Optional[int]]:
    """The H values this tree's msm_chain takes ([None]: no split)."""
    if "H" not in inspect.signature(MP.msm_chain).parameters:
        return [None]
    return list(SPLITS)


def chain_times(dev, rng, clock: float, out, loop_instructions: int
                ) -> List[dict]:
    spec = C.PALLAS
    rows = []
    for L in LANES:
        bases = rand_words(rng, (B, 2, L), dev).permute(0, 1, 3, 2) \
            .contiguous()                       # (B, 2, 8, L)
        for H in chain_splits():
            kw = {} if H is None else {"H": H}
            got = MP.msm_chain(spec, bases, 1, **kw)
            torch.cuda.synchronize()
            aff = affine_sha(spec, got[0].permute(2, 0, 1).contiguous())
            ms = cuda_ms(lambda: MP.msm_chain(spec, bases, 1, **kw))
            h = H or 1
            warps = -(-L * h // 32)
            sms = min(SMS, -(-L * h // BLOCK))     # SMs that hold a block
            steps = warps * (B // h)
            cyc = ms * 1e-3 * clock * sms / steps
            issue = loop_instructions * steps / (
                ISSUE_PER_CLOCK_SM * sms * clock) * 1e3
            bound = MUL32_PER_MIXED_ADD * L * B / (
                IMUL_PER_CLOCK_SM * SMS * clock) * 1e3
            row = {"lanes": L, "H": h, "ms": ms, "warps": warps, "sms": sms,
                   "warp_steps": steps, "cycles_per_warp_step": cyc,
                   "warps_per_sm": warps / SMS, "issue_ms": issue,
                   "bound_ms": bound, "affine_sha": aff}
            rows.append(row)
            out(f"msm_chain lanes {L} H {h}: {ms:.4f} ms, {warps} warps "
                f"({warps / SMS:.2f} an SM), {cyc:.0f} SM cycles a "
                f"warp-step; issue {issue:.4f} ms, bound {bound:.4f} ms; "
                f"affine sha256 {aff[:16]}")
        del bases
    return rows


def affine_sha(spec, pts: torch.Tensor) -> str:
    """sha256 of the affine words of (N, 3, 8) projective points (to_affine
    on the card)."""
    x, y = MP.to_affine_words(spec, *(pts[:, c].contiguous()
                                      for c in range(3)))
    h = hashlib.sha256()
    h.update(x.cpu().numpy().tobytes())
    h.update(y.cpu().numpy().tobytes())
    return h.hexdigest()


def table_times(dev, out) -> Dict[str, dict]:
    """h_tables on the BLAKE3 recursive SNARK's two sides' tables over
    their keys' prepared bases (the generators derived on the host the
    first time, then cached), as setup_compressed builds them."""
    from hotproofs_tpu_torch.ops import tables as TB

    res = {}
    for name, side, csr, nz in table_shapes(dev):
        _, lpw, _, _ = MP.plan(nz, 256)
        bl = side.ck.bases_lm(nz, 256)
        got = TB.h_tables(side.curve, csr, bl, lpw)
        torch.cuda.synchronize()
        sha = affine_sha(side.curve, got)
        ms = cuda_ms(lambda: TB.h_tables(side.curve, csr, bl, lpw), 3)
        near = dataclasses.replace(csr, cols=(csr.cols % NEAR_COLS)
                                   .contiguous())
        ms_near = cuda_ms(lambda: TB.h_tables(side.curve, near, bl, lpw), 3)
        counts = walk_counts(csr)
        res[name] = {"rows": csr.rows, "nonzeros": int(csr.cols.shape[0]),
                     "ms": ms, "affine_sha": sha, "near_cols_ms": ms_near,
                     **counts}
        out(f"h_tables {name} ({csr.rows} rows, {csr.cols.shape[0]} "
            f"nonzeros): {ms:.3f} ms ({ms_near:.3f} ms with every column "
            f"< {NEAR_COLS}), affine sha256 {sha[:16]}; "
            + json.dumps(counts))
        del csr, near, got
        torch.cuda.empty_cache()
    return res


def walk_counts(csr) -> Dict[str, int]:
    """Walk warp-steps of h_tables' lane maps on csr, counted on any
    device: the half-warp map the kernel had before its lanes were
    balanced (lane v of each half-warp the bucket of digit value v + 1
    over alternate nonzeros, a row as long as its busiest lane), and a
    perfectly balanced warp (ceil(digits / 32) a row); with
    ops/tables.table_steps' (walk, join) of the kernel's map where the
    tree has it."""
    from hotproofs_tpu_torch.ops import tables as TB
    start = csr.row_ptr.to(torch.int64)
    R = csr.rows
    row = torch.repeat_interleave(torch.arange(R, device=start.device),
                                  start[1:] - start[:-1])
    half = (torch.arange(row.shape[0], device=row.device) - start[row]) % 2
    n = torch.zeros(R * 32, dtype=torch.int64, device=row.device)
    sh = torch.arange(0, 32, 4, device=row.device)
    for i in range(8):
        d = (csr.mag[:, i].to(torch.int64)[:, None] >> sh) & 15
        idx = ((row * 2 + half)[:, None] * 16 + d)[d > 0]
        n.index_add_(0, idx, torch.ones_like(idx))
    n = n.reshape(R, 32)
    out = {"walk_halves": int(n.amax(dim=1).sum()),
           "walk_balanced": int((-(-n.sum(dim=1) // 32)).sum()),
           "digits": int(n.sum())}
    if hasattr(TB, "table_steps"):
        out["walk"], out["join"] = TB.table_steps(csr)
    return out


def table_shapes(dev):
    """(name, curve, csr, nz) of the BLAKE3 recursive SNARK's two sides'
    matrix tables (ChunkProver(...).recursive's shapes)."""
    from hotproofs_tpu_torch.models.chunk_prover import ChunkProver
    from hotproofs_tpu_torch.ops import tables as TB

    snark = ChunkProver(device=dev).recursive
    for name, side in (("primary", snark.side1), ("secondary",
                                                   snark.side2)):
        sh = side.shape
        m = 1 << (sh.n_cons - 1).bit_length()
        nz = 1 << (sh.n_vars - 1).bit_length()
        csr = TB.table_csr(sh.field, [
            (d.rows, d.cols, d.vals)
            for d in (sh.dev[k] for k in ("A", "B", "C"))], m)
        yield name, side, csr, nz


def main_path_times(dev, rng, out) -> Dict[str, float]:
    spec = C.PALLAS
    X, Y = (rand_words(rng, (AFFINE_POINTS,), dev) for _ in range(2))
    Z = rand_words(rng, (AFFINE_POINTS,), dev)
    t_aff = cuda_ms(lambda: MP.to_affine_words(spec, X, Y, Z), 3)
    a = rand_words(rng, (TO_MONT,), dev)
    bb = rand_words(rng, (TO_MONT,), dev)
    da, db = F.words_to_digits(a), F.words_to_digits(bb)
    t_mm = graph_ms(lambda: F.mont_mul(spec.base, da, db), 20)
    out(f"to_affine {AFFINE_POINTS} points {t_aff:.4f} ms; mont_mul "
        f"{TO_MONT} elements {t_mm:.4f} ms")
    return {"to_affine": t_aff, "mont_mul": t_mm}


def seeded_points(spec, n: int, rng) -> torch.Tensor:
    """(n, 3, 8) projective Montgomery words of P_i = (i + 1) G, each at a
    seeded Z != 1 ((lam x, lam y, lam) for a seeded lam), built on the
    host's ints."""
    f = spec.base
    pts, p = [], None
    for _ in range(n):
        p = C.host_add(spec, p, spec.gen)
        pts.append(p)
    lam = [int(v) for v in rng.integers(2, 1 << 62, n)]
    words = np.zeros((n, 3, 8), np.uint32)
    for i, ((x, y), k) in enumerate(zip(pts, lam)):
        for c, v in enumerate((x * k, y * k, k)):
            m = f.to_mont_int(v % f.p)
            words[i, c] = [(m >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
    return torch.from_numpy(words.view(np.int32))


def scale16_times(dev, rng, clock: float, out) -> List[dict]:
    """scale16 at W4 = 64 on SCALE_POINTS seeded points: ms, SM cycles a
    doubling a warp-step, the bound, and the affine output's sha256."""
    spec = C.PALLAS
    pool = seeded_points(spec, max(SCALE_POINTS), rng).to(dev)
    rate = IMUL_PER_CLOCK_SM * SMS * clock
    rows = []
    for n in SCALE_POINTS:
        pts = pool[:n].contiguous()
        got = MP.scale16(spec, pts, SCALE_W4)
        torch.cuda.synchronize()
        aff = affine_sha(spec, got.reshape(-1, 3, 8))
        ms = cuda_ms(lambda: MP.scale16(spec, pts, SCALE_W4))
        doublings = 4 * (SCALE_W4 - 1)
        warps = -(-n // 32)
        sms = min(SMS, -(-n // POINT_BLOCK))
        cyc = ms * 1e-3 * clock * sms / (warps * doublings)
        load = under_load(lambda: MP.scale16(spec, pts, SCALE_W4))
        monts = n * (SCALE_W4 - 1) * (4 * MONT_PER_DOUBLE + MONT_PER_WINDOW)
        nbytes = (pts.numel() + got.numel()) * 4
        bound = max(monts * 264 / rate, nbytes / HBM_BYTES_PER_S) * 1e3
        row = {"points": n, "windows": SCALE_W4, "ms": ms, "warps": warps,
               "sms": sms, "cycles_per_doubling_warp_step": cyc,
               "bound_ms": bound, "bound_share": bound / ms,
               "affine_sha": aff, **load}
        rows.append(row)
        out(f"scale16 {n} points W4 {SCALE_W4}: {ms:.4f} ms, {warps} warps "
            f"({warps / SMS:.2f} an SM), {cyc:.0f} SM cycles a doubling a "
            f"warp-step at the maximum clock; under load {load['clock_mhz']:.0f}"
            f" MHz, {load['power_w']:.0f} W; bound {bound:.4f} ms "
            f"({100 * bound / ms:.1f} %); affine sha256 {aff[:16]}")
        del got
    return rows


def conv_times(dev, out) -> List[dict]:
    """conv_mma at CONV_NS on seeded digits (torch.Generator, seed 0): the
    mean of 20 calls in one CUDA graph over operand sets that exceed the
    L2 together; == plain, and & 0xFF == the conv part, on set 0."""
    from hotproofs_tpu_torch.ops import pallas_field as PF
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for n in CONV_NS:
        sets = max(1, min(32, -(-COLD_BYTES // (n * CONV_BYTES))))
        a, b = (torch.randint(0, 256, (sets, 32, n), generator=gen,
                              device=dev, dtype=torch.int32)
                for _ in range(2))
        a[0, :, :3] = 255
        b[0, :, :3] = 255
        got = PF.conv_mma(a[0], b[0])
        ok = torch.equal(got, PF.conv_mma_plain(a[0], b[0])) and \
            torch.equal(got & 0xFF, PF.mont_mul_part(
                F.pallas_base, a[0], b[0], "conv"))
        i = iter(range(1 << 30))
        ms = graph_ms(lambda: PF.conv_mma(*(x[next(i) % sets]
                                           for x in (a, b))), 20)
        bound = n * CONV_BYTES / HBM_BYTES_PER_S * 1e3
        rows.append({"n": n, "ms": ms, "ok": bool(ok), "bound_ms": bound,
                     "bound_share": bound / ms})
        out(f"conv_mma N={n}: {ms:.4f} ms, == plain and conv part: {ok}; "
            f"bound {bound:.4f} ms by bytes ({100 * bound / ms:.1f} %)")
        del a, b, got
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--counts", action="store_true",
                    help="print the tables' lane-map counts alone (any "
                         "device; with --device cpu, no card)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated subset of " + ",".join(PARTS))
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    if parts - set(PARTS):
        raise SystemExit(f"add_cost: unknown parts {parts - set(PARTS)}")
    if args.counts:
        for name, _, csr, _ in table_shapes(torch.device(args.device)):
            print(f"{name}: {json.dumps(walk_counts(csr))}", flush=True)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("add_cost: needs a CUDA card")
    dev = torch.device("cuda")
    say = lambda line: print(line, flush=True)
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    clock = card_clock_hz()
    say(f"card: {smi}, max SM clock {clock / 1e6:.0f} MHz; package "
        f"{os.path.dirname(os.path.dirname(cuda_lib.CSRC))}")
    cuda_lib.lib()
    doc = {"card": smi, "clock_hz": clock,
           "package": os.path.dirname(cuda_lib.CSRC), "ptxas": []}
    show = False
    for line in cuda_lib.build_info.get("ptxas", "").splitlines():
        if "Compiling entry" in line:
            show = any(k in line for k in PTXAS_KERNELS)
        if "Compiling entry" in line or "registers" in line \
                or "stack frame" in line:
            doc["ptxas"].append(line.strip())
            if show:
                say(f"ptxas: {line.strip()}")
    if "sass" in parts or "chain" in parts:
        doc["sass"] = sass_loop_counts(cuda_lib.build(), "k_msm_chain")
        say("k_msm_chain loop: " + json.dumps(doc["sass"]))
    if "sass" in parts:
        doc["sass_tables"] = sass_loop_counts(cuda_lib.build(),
                                              "k_h_tables")
        say("k_h_tables loop: " + json.dumps(doc["sass_tables"]))
        doc["sass_scale16"] = sass_doubling_loop(cuda_lib.build(),
                                                 "k_scale16")
        say("k_scale16 loop: " + json.dumps(doc["sass_scale16"]))
    rng = np.random.default_rng(args.seed)
    if "chain" in parts:
        doc["chain"] = chain_times(dev, rng, clock, say,
                                   doc["sass"]["instructions"])
    if "tables" in parts:
        doc["tables"] = table_times(dev, say)
    if "main" in parts:
        doc["main"] = main_path_times(dev, rng, say)
    if "scale16" in parts:
        doc["scale16"] = scale16_times(dev, np.random.default_rng(args.seed),
                                       clock, say)
    if "conv" in parts:
        doc["conv"] = conv_times(dev, say)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f)
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
