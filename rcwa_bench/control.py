"""The control of a cell's comparison, and the program's readings beside it.

    python3 rcwa_bench/control.py --workload <cell> --seeds 1,2,3 \
        [--program-seeds 4,5,...] [--seconds 5] [--answers 40]

For each of ``--program-seeds`` a short run of the cell itself
(``--seconds`` of window) gives the program's readings.  For each of
``--seeds`` the reference, computed with TF32 products (complex64), is put
in the program's place for the answers a run compares (``--answers`` of
them from the window's start), and judged by the cell's limits as a run is
(``harness.judge``).  One JSON line per seed, with its readings and
``correct``.  Exits 1 if any control reads correct.  The benchmark's own
runs do not run this; it is how the limits in ``limits/<cell>.json`` were
set and how they are shown to fail the control.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from rcwa_bench import harness  # noqa: E402


def control_readings(cell, seed, answers, device):
    """The comparison's numbers with the control in the program's place."""
    mod, ref = cell.compare(), cell.reference()
    rec = mod.control(mod.control_record(cell.config, cell.traffic, seed,
                                         answers),
                      ref, cell.config, cell.traffic, device)
    return cell.readings(rec, device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', default='')
    p.add_argument('--program-seeds', default='')
    p.add_argument('--seconds', type=float, default=5.)
    p.add_argument('--answers', type=int, default=40)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(',') if s]
    prog = [int(s) for s in args.program_seeds.split(',') if s]
    root = os.getcwd()
    cell = harness.Cell(args.workload,
                        harness.load_json(os.path.join(root,
                                                       'BENCHMARK.json')),
                        root)
    device = torch.device('cuda')
    for s in prog:
        out = harness.run_cell(args.workload, s, args.seconds, False,
                               root=root, device=device)
        print(json.dumps({'side': 'program', 'seed': s,
                          'attempted': out['attempted'],
                          'correct': out['correct'],
                          'readings': {k: v['value'] for k, v in
                                       out['checks'].items()}}), flush=True)
    passed = []
    for s in seeds:
        got = control_readings(cell, s, args.answers, device)
        correct, _ = harness.judge(got, cell.limits)
        if correct:
            passed.append(s)
        print(json.dumps({'side': 'control', 'seed': s, 'correct': correct,
                          'readings': got}), flush=True)
    if passed:
        print(f'control read correct on seeds {passed}', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
