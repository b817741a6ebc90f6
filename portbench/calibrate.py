"""Readings that set a cell's limits; not part of a benchmark run.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 \
        --seconds <s> [--control] [--half]

For each seed, in one process: the cell's set-up and a window of
``--seconds`` at its own load, then the compared numbers of the program
(the lower reading's runs); with ``--control`` the same numbers with the
plain reference computed in bfloat16 put in the program's place (the
control, the upper reading); with ``--half`` the reference over half of
the samples of each pixel (render cells) or of each step (the invert cell)
put there: the half-batch fault.
One JSON line a seed on standard output.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--half", action="store_true")
    args = ap.parse_args(argv)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.resolve_cell(ROOT, args.workload)
    loop = harness.load_loop(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        st = loop.setup(cell, seed, torch.device("cuda"))
        result = loop.window(st, args.seconds)
        c = time.perf_counter()
        out = {"seed": seed, "attempted": result["attempted"],
               "values": result["values"], "program": loop.check(st),
               "check_s": time.perf_counter() - c}
        if args.control:
            out["control"] = loop.check(st, control=True)
        if args.half:
            out["half"] = loop.check(st, half=True)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
