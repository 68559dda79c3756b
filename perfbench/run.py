"""The benchmark of the PyTorch and CUDA port (tracking_sdf_tpu_torch): one
run of one cell.

    python3 perfbench/run.py --workload tum256.handheld --seed 7 --seconds 10 --trace 0

Run from the root of a checkout on a machine with the cards the cell asks
for. The last line of standard output is the result (JSON): ``correct``,
``attempted`` and ``failed`` frames, the metrics (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``), the
device, with ``--trace 1`` a ``breakdown``, and last the numbers that
decided ``correct`` beside their limits, which are also the last lines of
standard error. A metric whose BENCHMARK.json entry lists ``workloads``
belongs to those cells alone. The run exits non-zero and prints no result
without the cards, or when the JAX package or JAX was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
# keep libraries that can load JAX by themselves from doing so
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "tracking_sdf_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    t_torch = time.perf_counter()
    from harness import cell, data

    bench = data.benchmark()
    wl = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not wl:
        print(f"error: no workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = wl[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    try:
        import tracking_sdf_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"error: the program (tracking_sdf_tpu_torch) is not in this checkout: {e}",
              file=sys.stderr)
        return 2
    _, cfg, traffic, limits = data.cell(bench, args.workload)
    e2e, names = data.cell_metrics(bench, args.workload)
    readers = data.metric_readers([m["name"] for m in names])
    metrics = {m["name"]: (readers[m["name"]], m["unit"]) for m in names} if args.trace else {}
    print(f"set-up marks: torch imported {t_torch - T_START:.3f} s, the card and the program "
          f"found {time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    res = cell.run(cfg, traffic, limits, args.seed, args.seconds, bool(args.trace), metrics,
                   t_start=T_START)
    if not args.trace:  # the end-to-end metrics of this cell alone
        res["metrics"] = {k: v for k, v in res["metrics"].items() if k in e2e}
    bad = loaded_forbidden()
    if bad:
        print(f"error: loaded {bad} in the process that measures", file=sys.stderr)
        return 3
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
