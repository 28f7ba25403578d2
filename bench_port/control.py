"""The control of the check, read on the chip (the benchmark's own runs do
not run it):

    python3 -m bench_port.control --workload <cell> --seeds 1,2,3 --seconds 3 [--traffic <mix>]

For each seed, one run of the cell with a short window at the cell's own
load, then on its checked frames the numbers of ``compare.py`` twice: the
program against the reference (the lower readings) and the control, the
reference computed in TF32 (the nearest precision below the configuration's
float32 with TF32 off), against the reference (the upper readings). One
JSON line a seed, and last the worst of each. ``--traffic`` runs the cell's
configuration under another mix of ``traffic/``."""

from __future__ import annotations

import argparse
import json
import sys
import time

from bench_port import run, spec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--traffic", default=None, help="another traffic mix for the cell")
    args = parser.parse_args(argv)
    cell = spec.load(args.workload, run.ROOT, mix=args.traffic)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} takes {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    lows, highs = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(cell, seed, args.seconds, False, devices, time.perf_counter(),
                              control=True)
        lows += res["readings"]
        highs += res["control"]
        print(json.dumps({"seed": seed, "correct": res["correct"], "program": res["readings"],
                          "control": res["control"]}), flush=True)
        torch.cuda.empty_cache()
    worst = {name: {"program_max": max(r[name] for r in lows),
                    "control_min": min(r[name] for r in highs)}
             for name in lows[0]}
    print(json.dumps({"workload": cell.name, "traffic": args.traffic, "worst": worst}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
