"""The bucket designs of two or more source trees, timed in turns on one card.

Each TREE is an unpacked copy of the repository (for example `git archive`
of the parent commit and of the change, unpacked into a git-ignored
directory). For each tree, in the order forward then backward (parent,
change, change, parent for two trees), this runs that tree's own `python -m hotproofs_tpu_torch.tools.msm_designs`
(its kernels, its wrappers, its seeded data), so every tree is timed by
the code it ships, on the same card within one call; a spread between
runs of one tree shows what a difference between trees must exceed. First
every tree's kernels are built (the trees in parallel), and the ptxas
lines (registers, stack, spills) of its bucket kernels are printed (a
tree whose library is built already prints none). A run that fails is
reported and the others go on.

    python -m hotproofs_tpu_torch.tools.designs_ab TREE [TREE ...] [--out FILE]

Prints the card's name and power limit, the ptxas lines, one line per
shape and run with msm_bucket, msm_merge, msm_wsum and msm_many and every
design's kernel and whole ms, then one JSON object (also written to
--out). Needs a card: the tool of each tree raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

BUCKET_KERNELS = ("k_msm_bucket", "k_msm_bucket_tsplit", "k_msm_bucket_signed",
                  "k_split_walk", "k_msm_chain")


def card() -> str:
    """nvidia-smi's name and power limit of card 0."""
    return subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def build(tree: str) -> List[str]:
    """Build tree's kernels (its own cuda_lib) and return the ptxas lines of
    its bucket kernels: each entry's name line and the register / stack
    lines that follow it."""
    code = ("from hotproofs_tpu_torch.ops import cuda_lib; cuda_lib.lib(); "
            "print(cuda_lib.build_info.get('ptxas', ''))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, check=True).stdout
    keep, lines = False, []
    for line in out.splitlines():
        if "Compiling entry" in line:
            keep = any(k in line for k in BUCKET_KERNELS)
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
    ok = True
    for k, i in enumerate(order):
        try:
            res = run_designs(trees[i])
        except RuntimeError as e:
            print(f"run {k} (tree {i}): {e}", flush=True)
            doc["runs"].append({"tree": i, "error": str(e)})
            ok = False
            continue
        doc["runs"].append({"tree": i, "result": res})
        for line in summary(f"run {k} (tree {i})", res):
            print(line, flush=True)
        ok = ok and all(d["ok"] for tag, row in res.items() if tag != "host"
                        for d in row["designs"].values())
    print(f"card: {card()}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f)
    print(json.dumps({"ok": ok, "runs": len(order)}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
