"""Run one cell of the benchmark once and print its result line.

    python3 rcwa_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell asks
for.  Set-up (imports, the CUDA context, the kernel library, the inputs from
the seed, the warm-up of the cell's own shapes) counts as ``setup_s``; then
the window runs for ``--seconds``.  With ``--trace 0`` the last line holds
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics from
spans and a profiler trace of the window.  The numbers compared with the
plain reference are printed beside their limits, last on standard error and
last in the result line.  Without a CUDA card, or with fewer than the cell
asks for, the run exits 1 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from rcwa_bench import harness
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), root=os.getcwd(),
                               t_start=T_START)
    except harness.CellError as e:
        print(f'rcwa_bench: {e}', file=sys.stderr)
        return 1
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
