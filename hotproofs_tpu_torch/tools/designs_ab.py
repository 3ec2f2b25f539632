"""The bucket designs, msm_chain, h_tables, scale16 and conv_mma of two or
more source trees, timed in turns on one card.

Each TREE is an unpacked copy of the repository (for example `git archive`
of the parent commit and of the change, unpacked into a git-ignored
directory). For each tree, in the order forward then backward (parent,
change, change, parent for two trees), this runs that tree's own `python -m
hotproofs_tpu_torch.tools.msm_designs` (its kernels, its wrappers, its
seeded data) and then this tree's `tools/add_cost.py` over that tree's
package (msm_chain at 32 lanes and 132 x 128 x {1, 2, 4, 8}, h_tables on
the BLAKE3 recursive SNARK's two tables, to_affine and mont_mul, scale16
at 32, 16,384 and 49,152 points and conv_mma at N = 16,384 and 131,072;
it uses only public wrappers, so it times an older tree the same way;
--add-parts passes its --parts), so every
tree is timed within one call on the same card; a spread between runs of
one tree shows what a difference between trees must exceed. First every
tree's kernels are built (the trees in parallel), and the ptxas lines
(registers, stack, spills) of the kernels of PTXAS_KERNELS are printed,
with the main path's kernels compared line for line between trees (a
tree whose library is built already prints none). The affine outputs of
h_tables, msm_chain and scale16 must agree across runs, and conv_mma must
equal its plain version in each. A run that fails is reported and the
others go on.

    python -m hotproofs_tpu_torch.tools.designs_ab TREE [TREE ...] [--out FILE]
        [--no-designs] [--add-parts scale16,conv,...]

Prints the card's name and power limit, the ptxas lines, one line per
shape and run with msm_bucket, msm_merge, msm_wsum and msm_many and every
design's kernel and whole ms, add_cost's lines, then one JSON object (also
written to --out). Needs a card: the tools of each tree raise without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

# Kernels whose ptxas lines are printed; MAIN_KERNELS' (the main path's)
# must not differ between trees when a change touches only the designs',
# the tables', the key preparation's or the field tools' kernels.
MAIN_KERNELS = ("k_msm_bucket", "k_msm_merge", "k_msm_wsum", "k_to_affine",
                "k_mont_mul", "k_mont_mul_em")
PTXAS_KERNELS = MAIN_KERNELS + ("k_msm_bucket_tsplit", "k_msm_bucket_signed",
                                "k_split_walk", "k_msm_chain", "k_h_tables",
                                "k_scale16", "k_conv_mma")
ADD_COST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "add_cost.py")


def card() -> str:
    """nvidia-smi's name and power limit of card 0."""
    return subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def build(tree: str) -> List[str]:
    """Build tree's kernels (its own cuda_lib) and return the ptxas lines of
    the kernels of PTXAS_KERNELS: each entry's name line and the register
    / stack lines that follow it."""
    code = ("from hotproofs_tpu_torch.ops import cuda_lib; cuda_lib.lib(); "
            "print(cuda_lib.build_info.get('ptxas', ''))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, check=True).stdout
    keep, lines = False, []
    for line in out.splitlines():
        if "Compiling entry" in line:
            keep = kernel_name(line) in PTXAS_KERNELS
        if keep and ("Compiling entry" in line or "registers" in line
                     or "stack frame" in line):
            lines.append(line.strip())
    return lines


def run_designs(tree: str) -> Dict[str, object]:
    """tree's msm_designs tool (its default seed): its JSON result, the
    last line it prints."""
    r = subprocess.run([sys.executable, "-m",
                        "hotproofs_tpu_torch.tools.msm_designs"], cwd=tree,
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"msm_designs in {tree} failed ({r.returncode}):"
                           f"\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def run_add_cost(tree: str, parts: Optional[str]) -> Dict[str, object]:
    """add_cost.py of this tree over tree's package (all its parts, or
    --parts): its JSON result."""
    env = dict(os.environ, PYTHONPATH=tree)
    r = subprocess.run([sys.executable, ADD_COST]
                       + (["--parts", parts] if parts else []),
                       cwd=tree, env=env, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"add_cost in {tree} failed ({r.returncode}):"
                           f"\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def kernel_name(line: str) -> str:
    """The kernel's own name in a ptxas "Compiling entry" line (the
    Itanium mangling's length-prefixed first name)."""
    m = re.search(r"_Z(\d+)(\w+)", line)
    return m.group(2)[:int(m.group(1))] if m else ""


def main_ptxas(lines: List[str]) -> Dict[str, List[str]]:
    """The ptxas lines of each kernel of MAIN_KERNELS (entry -> lines)."""
    out: Dict[str, List[str]] = {}
    cur = None
    for line in lines:
        if "Compiling entry" in line:
            cur = kernel_name(line)
            cur = cur if cur in MAIN_KERNELS else None
            if cur:
                out.setdefault(cur, [])
        if cur:
            out[cur].append(line.split("ptxas info")[-1])
    return out


def add_summary(name: str, res: Dict[str, object]) -> List[str]:
    """add_cost's times in a few lines."""
    lines = []
    if "chain" in res:
        lines.append(f"{name} msm_chain ms (lanes/H): " + ", ".join(
            f"{r['lanes']}/{r['H']} {r['ms']:.4f} "
            f"({r['cycles_per_warp_step']:.0f} cyc, issue "
            f"{r['issue_ms']:.4f}, bound {r['bound_ms']:.4f})"
            for r in res["chain"]))
    for side, t in res.get("tables", {}).items():
        lines.append(f"{name} h_tables {side} {t['ms']:.3f} ms (columns "
                     f"near {t['near_cols_ms']:.3f}), affine sha256 "
                     f"{t['affine_sha'][:16]}")
    if "main" in res:
        lines.append(f"{name} to_affine {res['main']['to_affine']:.4f} ms, "
                     f"mont_mul {res['main']['mont_mul']:.4f} ms")
    if "scale16" in res:
        lines.append(f"{name} scale16 ms (points): " + ", ".join(
            f"{r['points']} {r['ms']:.4f} "
            f"({r['cycles_per_doubling_warp_step']:.0f} cyc a doubling, "
            f"{r['clock_mhz']:.0f} MHz {r['power_w']:.0f} W under load, "
            f"bound {r['bound_ms']:.4f}, {100 * r['bound_share']:.1f} %)"
            for r in res["scale16"]))
    if "conv" in res:
        lines.append(f"{name} conv_mma ms (N): " + ", ".join(
            f"{r['n']} {r['ms']:.4f} ({'ok' if r['ok'] else 'FAILED'}, "
            f"bound {r['bound_ms']:.4f}, {100 * r['bound_share']:.1f} %)"
            for r in res["conv"]))
    for k in ("sass", "sass_tables", "sass_scale16"):
        if k in res:
            lines.append(f"{name} {res[k]['kernel']} loop: "
                         f"{json.dumps(res[k])}")
    return lines


def summary(name: str, res: Dict[str, object]) -> List[str]:
    """One line per shape: the production stages and every design."""
    lines = []
    for tag, row in res.items():
        if tag == "host":
            continue
        designs = ", ".join(
            f"{d} {v['kernel_ms']:.4f} / {v['ms']:.4f}"
            f"{'' if v['ok'] else ' FAILED'}"
            for d, v in row["designs"].items())
        lines.append(
            f"{name} {tag}: msm_bucket {row['msm_bucket']:.4f}, msm_merge "
            f"{row['msm_merge']:.4f}, msm_wsum {row['msm_wsum']:.4f}, "
            f"msm_many {row['msm_many']:.4f} ms; designs kernel / whole ms: "
            + designs)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("trees", nargs="+", help="unpacked source trees")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--no-designs", action="store_true",
                    help="skip each tree's msm_designs")
    ap.add_argument("--add-parts", default=None,
                    help="add_cost.py's --parts (default: all)")
    args = ap.parse_args(argv)
    trees = [os.path.abspath(t) for t in args.trees]
    order = list(range(len(trees))) + list(reversed(range(len(trees))))
    smi = card()
    print(f"card: {smi}", flush=True)
    doc: Dict[str, object] = {"card": smi, "trees": trees, "order": order,
                              "ptxas": {}, "runs": []}
    with ThreadPoolExecutor(len(trees)) as pool:
        for i, lines in enumerate(pool.map(build, trees)):
            doc["ptxas"][i] = lines
            for line in lines:
                print(f"tree {i} ptxas: {line}", flush=True)
    built = [main_ptxas(doc["ptxas"][i]) for i in range(len(trees))]
    if all(built):
        same = all(b == built[0] for b in built)
        doc["main_ptxas_same"] = same
        print(f"main-path kernels' ptxas lines "
              f"{'identical' if same else 'DIFFER'} across trees "
              f"({', '.join(sorted(built[0]))})", flush=True)
    ok = True
    for k, i in enumerate(order):
        run: Dict[str, object] = {"tree": i}
        try:
            if not args.no_designs:
                res = run_designs(trees[i])
                run["result"] = res
                for line in summary(f"run {k} (tree {i})", res):
                    print(line, flush=True)
                ok = ok and all(d["ok"] for tag, row in res.items()
                                if tag != "host"
                                for d in row["designs"].values())
            add = run_add_cost(trees[i], args.add_parts)
            run["add_cost"] = add
            for line in add_summary(f"run {k} (tree {i})", add):
                print(line, flush=True)

        except RuntimeError as e:
            print(f"run {k} (tree {i}): {e}", flush=True)
            run["error"] = str(e)
            ok = False
        doc["runs"].append(run)
    shas = {(side, t["affine_sha"]) for run in doc["runs"]
            for side, t in run.get("add_cost", {}).get("tables", {}).items()}
    shas |= {((r["lanes"], r["H"]), r["affine_sha"]) for run in doc["runs"]
             for r in run.get("add_cost", {}).get("chain", [])}
    shas |= {(("scale16", r["points"]), r["affine_sha"])
             for run in doc["runs"]
             for r in run.get("add_cost", {}).get("scale16", [])}
    if shas:
        agree = len(shas) == len({key for key, _ in shas})
        doc["sums_agree"] = agree
        print(f"h_tables' affine tables, msm_chain's affine lane sums and "
              f"scale16's affine windows {'agree' if agree else 'DIFFER'} "
              f"across runs", flush=True)
        ok = ok and agree
    ok = ok and all(r["ok"] for run in doc["runs"]
                    for r in run.get("add_cost", {}).get("conv", []))
    print(f"card: {card()}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f)
    print(json.dumps({"ok": ok, "runs": len(order)}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
