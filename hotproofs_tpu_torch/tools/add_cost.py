"""What a mixed add costs on the card: msm_chain and h_tables timed, with
the instructions of their loops counted from the machine code.

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
    seeded inputs.

Prints one line per measurement and, last, one JSON object (also written
to --out). Needs a card, but for --counts, which prints the tables'
lane-map counts alone (walk_counts: the half-warp map, a balanced
warp, the kernel's; about 15 s on a CPU).
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
PTXAS_KERNELS = ("k_msm_chain", "k_h_tables")   # printed; all are kept
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


def sass_loop_counts(lib_path: str, kernel: str) -> Dict[str, object]:
    """Instructions of `kernel`'s add loop by class, from cuobjdump -sass
    of the library: the longest span from a backward branch's target to
    the branch that loads from global memory and shuffles nothing (the
    chain's loop, not its join). A loop the compiler unrolled holds more
    than one add: loads / 16 (one affine base is 16 words)."""
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
    best = None
    for addr, op, txt in ins:
        t = re.search(r"0x([0-9a-f]+)", txt)
        if not (op.startswith("BRA") and t and int(t.group(1), 16) < addr):
            continue
        ops = [o for a, o, _ in ins if int(t.group(1), 16) <= a <= addr]
        if any(o.startswith("LDG") for o in ops) and \
                not any(o.startswith("SHFL") for o in ops) and \
                (best is None or len(ops) > len(best)):
            best = ops
    if best is None:
        raise RuntimeError(f"{kernel}: no loop of loads found")
    loop = best
    counts = {k: 0 for k in CLASSES}
    counts["other"] = 0
    other: Dict[str, int] = {}
    for op in loop:
        head = op.split(".")[0]
        k = next((k for k, ops in CLASSES.items() if head in ops), "other")
        counts[k] += 1
        if k == "other":
            other[head] = other.get(head, 0) + 1
    wide = sum(op.startswith("IMAD.WIDE") for op in loop)
    hi = sum(op.startswith("IMAD.HI") for op in loop)
    x = sum(op.startswith("IADD3.X") or op.startswith("IMAD.X")
            for op in loop)
    words = sum(4 if ".128" in op else 2 if ".64" in op else 1
                for op in loop if op.startswith("LDG"))
    adds = max(words // 16, 1)
    return {"kernel": kernel, "instructions": len(loop), "adds": adds,
            "instructions_per_add": len(loop) / adds,
            "function_instructions": len(ins), "classes": counts,
            "other_ops": dict(sorted(other.items(), key=lambda kv: -kv[1])
                              [:8]),
            "IMAD.WIDE": wide, "IMAD.HI": hi, "carry (.X)": x}


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
    args = ap.parse_args(argv)
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
    doc["sass"] = sass_loop_counts(cuda_lib.build(), "k_msm_chain")
    say("k_msm_chain loop: " + json.dumps(doc["sass"]))
    doc["sass_tables"] = sass_loop_counts(cuda_lib.build(), "k_h_tables")
    say("k_h_tables loop: " + json.dumps(doc["sass_tables"]))
    rng = np.random.default_rng(args.seed)
    doc["chain"] = chain_times(dev, rng, clock, say,
                               doc["sass"]["instructions"])
    doc["tables"] = table_times(dev, say)
    doc["main"] = main_path_times(dev, rng, say)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f)
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
