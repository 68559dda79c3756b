"""The readings that the limits of ``correct`` are set from (perfbench/limits/).

For each seed, in one process: one run of the cell (``--seconds`` of
window, the cell's own traffic, sizes and sample), whose numbers are the
program's readings, and beside it the control: the plain reference
computed with its values stored in the next precision below the
configuration's (``float8_e4m3fn`` for ``bfloat16``) and put in the
program's place over the same sample and bootstrap frame. Prints one JSON
line a seed and writes them to ``--out``:

    python3 perfbench/control.py --workload tum256.handheld --seeds 1 2 3 --seconds 3

The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

# the next storage precision below the configuration's
BELOW = {"bfloat16": "float8_e4m3fn"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from harness import cell, data

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    bench = data.benchmark()
    _, cfg, traffic, limits = data.cell(bench, args.workload)
    below = BELOW[cfg["fusion"]["storage_dtype"]]
    lines = []
    for seed in args.seeds:
        res = cell.run(cfg, traffic, limits, seed, args.seconds, False, {}, controls=(below,))
        line = dict(workload=args.workload, seed=seed, correct=res["correct"],
                    program={k: v["value"] for k, v in res["limits"].items()},
                    control={below: res["controls"][below]}, metrics=res["metrics"])
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"control-{args.workload}.jsonl"), "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
