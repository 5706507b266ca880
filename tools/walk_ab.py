"""A/B timing of the sweep's cursor walks for two checkouts of the port.

    python3 tools/walk_ab.py A_ROOT B_ROOT [--order abba]

For each letter of ``--order`` (``a``: A_ROOT, ``b``: B_ROOT) one process
runs with that checkout's ``src`` on the path, builds its kernels from that
checkout's sources, captures outer iteration 40 of the full paper grid
(108 cells x 1000 runs, seed 0) and of the mixed-law grid (216 cells x
1000 runs, seed 5) and times their walks (skip, pop, strike) with that
checkout's own ``chip_smoke.time_walks``: the kernel over restored input
copies in a CUDA graph, median of replays.  Both checkouts walk the same
lanes (the captured iteration does not depend on the walks' code), so the
two times of a walk compare the kernels alone.  Needs one CUDA card;
prints the card's name and power limit, then one JSON line per run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch
import chip_smoke as S
from repro_torch.kernels import build
from repro_torch.kernels import sim_step as K
from repro_torch.experiments import GridSpec, paper_grid_cells

build.build_all()
dev = torch.device("cuda", 0)
full = GridSpec(tuple(paper_grid_cells("full")), n_runs=S.RUNS_PER_CELL, seed=0)
mixed, _ = S.mixed_grid("bench", S.RUNS_PER_CELL)
out = {}
for name, grid, indexed in (("full", full, False), ("mixed", mixed, True)):
    cap = S.capture_walks(grid, dev, S.CAPTURE_ITER)
    times = S.time_walks(K, cap, None, indexed, name)
    out[name] = {w: {k: t[k] for k in ("ms", "draws", "walking_lanes")}
                 for w, t in times.items()}
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a_root")
    ap.add_argument("b_root")
    ap.add_argument("--order", default="abba")
    args = ap.parse_args()
    roots = {"a": Path(args.a_root).resolve(), "b": Path(args.b_root).resolve()}
    for root in roots.values():
        if not (root / "src" / "repro_torch").is_dir():
            print(f"walk_ab: {root} has no src/repro_torch", file=sys.stderr)
            return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for letter in args.order:
        root = roots[letter]
        p = subprocess.run([sys.executable, "-c", CHILD], cwd=root, capture_output=True,
                           text=True)
        if p.returncode != 0:
            print(p.stdout + p.stderr, file=sys.stderr)
            return p.returncode
        res = json.loads(p.stdout.strip().splitlines()[-1])
        print(json.dumps({"root": str(root), "run": letter, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
