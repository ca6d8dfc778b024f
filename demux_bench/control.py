"""The control of ``correct``: the reference computed in bfloat16 (the
precision below the float32 that the cells' device decoders state) put in
the program's place, over a cell's whole pool, held to the float64
reference by the run's own comparison. The benchmark's runs never run it.

    python3 -m demux_bench.control --workload <cell> --seeds 1,2,3

prints one JSON line a seed: the numbers compared and the cell's limits.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import cells, check, traffic


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m demux_bench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--sent-batches", type=int, default=60,
                        help="batches the counts are taken over (replays of the pool)")
    args = parser.parse_args(argv)
    cell = cells.load(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        start = time.perf_counter()
        inst = traffic.instrument(cell.config, seed, cell.traffic)
        batches = traffic.pool(inst, cell.traffic, seed)
        numbers, seen = check.control(inst, batches, cell.traffic["check"], args.sent_batches, device=device)
        limits = cell.traffic["check"]["limits"]
        print(json.dumps({
            "workload": cell.name, "seed": seed, "numbers": numbers, "compared": seen,
            "fails": [name for name in numbers if numbers[name] > limits[name]],
            "seconds": round(time.perf_counter() - start, 3),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
