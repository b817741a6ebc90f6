"""Run one cell of the PyTorch port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port ``tuturenderer_tpu_torch/``. Set-up (imports, the CUDA
context, the kernels' build or load, the scene and its tables, the warm-up)
is timed as ``setup_s``; then the cell's loop runs for ``--seconds``; then
what the window produced is compared with the plain reference. The last
line of standard output is the result as JSON; the last lines of standard
error are the compared numbers with their limits. ``--trace 1`` reports
the per-layer metrics, read from a profiler trace of a few passes or steps
before the window.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one process with few threads: the host loop is the program's own
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    return harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
