#!/usr/bin/env python3
"""Chosen phases of `chip_smoke.py` from several checkouts, in turns, on one card.

    python3 ab_smoke.py --phases train,serving PARENT_DIR . . PARENT_DIR

Holds a change against its parent on the same card in one run: unpack the
parent (`git archive <commit> | tar -x -C DIR`) into a directory that
.gitignore lists and name it and the repo root in turns (parent, change,
change, parent), so that the card's drift over the run falls on both
alike. Each checkout runs in a process of its own, from its own
directory, with its own `chip_smoke.py` and `poco_tpu_torch/` (its kernels
built into its own `_build/`): phases 1 (environment), 2 (build) and 4
(the POCO-CLIFF main path) always, 4b (POCO-PARE) before `train`, then
the chosen ones in this order: `train` (4f), `serving` (4h), `dist` (4i,
in a checkout that has it), `demo` (4j, likewise), `losses` (4k-4m, on
4f's synthetic samples, in a checkout that has them). Every line a run prints is printed with
`[i dir]` before it. Exits 1 if any run failed, after all have run.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

PHASES = ("train", "serving", "dist", "demo", "losses")

RUN = """
import sys
import chip_smoke as cs

phases, seed = sys.argv[1].split(","), int(sys.argv[2])
card, _ = cs.phase_environment()
cs.phase_build()
ctx = cs.phase_main_path(seed)
if "train" in phases:
    cs.phase_train(ctx, cs.phase_pare(ctx, seed), seed, card)["tmp"].cleanup()
if "serving" in phases:
    cs.phase_serving(ctx, card)
if "dist" in phases:
    cs.phase_dist(ctx, seed, card)
if "demo" in phases:
    cs.phase_demo(ctx, seed, card)
if "losses" in phases:
    data = cs.SyntheticTrainSet(10 * 64, seed + 31, ctx["smpl"].to("cpu"))
    train = {"data": data, "host": cs.collate([data[i] for i in range(64)])}
    cs.phase_render_losses(ctx, cs.phase_pare(ctx, seed), train, card)
    cs.phase_train_images(ctx, train, card)
    cs.phase_launchers(card)
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", required=True,
                        help=f"comma-separated, of {', '.join(PHASES)}")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("trees", nargs="+", help="checkout directories, run in this order")
    args = parser.parse_args()
    unknown = set(args.phases.split(",")) - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")
    failed = []
    for i, tree in enumerate(args.trees):
        prefix = f"[{i} {tree}]"
        print(f"{prefix} phases {args.phases}", flush=True)
        # `-c` puts the checkout's directory first on sys.path
        proc = subprocess.Popen([sys.executable, "-c", RUN, args.phases, str(args.seed)],
                                cwd=Path(tree).resolve(), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            print(f"{prefix} {line}", end="", flush=True)
        if proc.wait() != 0:
            failed.append(i)
            print(f"{prefix} failed (exit {proc.returncode})", flush=True)
    print(f"runs failed: {failed}" if failed else f"all {len(args.trees)} runs passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
