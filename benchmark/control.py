"""The control of a cell's check, run on the card; not part of a run.

    python -m benchmark.control --workload <cell> --seeds 1,2,3 --seconds <s>

For each seed, the cell's run with the reference's control in the
program's place: for a decode or a load, the generated graph with every
successor id cut by its lowest bit (a lossy decode: the one guarantee the
configurations state); for HyperBall, the reference run with its estimates
and their sums in float32, the precision below the float64 the
configuration states.  Each seed prints one JSON line with what the check
compared; the control has to come out not correct.
"""

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    import torch

    from .harness import load_bench, run_cell
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 2
    bench = load_bench()
    wrong = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = run_cell(bench, args.workload, seed, args.seconds, False,
                     torch.device("cuda", 0), t0, control=True)
        wrong += not r["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"], "checks": r["checks"]}),
              flush=True)
    return 0 if wrong == len(args.seeds.split(",")) else 1


if __name__ == "__main__":
    sys.exit(main())
