"""One benchmark cell with the port's own tracer on, and the tracer's cost.

    python3 scripts/trace_cell.py --workload <cell> --seed <n> \
        [--cost-units K] [--device cuda]

From the root of a checkout, on a machine with a CUDA card.  It runs the
cell as ``rcwa_bench/run.py --trace 1`` does (set-up, then a phase of the
traffic's ``trace_units`` units with the benchmark's spans, then one
under ``torch.profiler``), with ``torcwa_tpu_torch.utils.timing.tracing``
on from before set-up: set-up's spans and the spans phase's are collected
apart (each unit of the phase is ``timing.unit(k)``), and the tracer stays
on through the profiled phase.  It prints the readings of the cell's
per-layer readers, the benchmark's older ones and the four that read the
port's spans (``hess_idle_share``, ``refine_ms``, ``schur_sweeps``,
``setup_eig_s``, given ``ctx.program``), the profiled phase's idle gaps
by what the host did, the tracer's reports of set-up and of the spans
phase, and, on the large route, the AED pass: the ``ms_aed`` launches'
device time in the profiled window per launch and per rotation of the
window QR (the ``eig.schur`` spans' ``aed_rotations`` in that phase) of
one lane's chain, with the lanes in flight (``sweeps`` over
``lockstep_sweeps``).

With ``--cost-units K`` it then runs six blocks of K units each, tracer
off, on, on, off, off, on, and prints each block's mean unit time (host
clock; a unit ends with a host read of its result).  The last line is one
JSON record of all of it.
"""

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PORT_READERS = ('hess_idle_share', 'refine_ms', 'schur_sweeps',
                'setup_eig_s')


def _units(run, tracer_on, k, timing, sync, device):
    """k units, the tracer on or off; their mean time in seconds."""
    t0 = time.perf_counter()
    if tracer_on:
        with timing.tracing() as tr:
            for _ in range(k):
                run.unit()
            sync(device)
            tr.collect()
    else:
        for _ in range(k):
            run.unit()
    return (time.perf_counter() - t0) / k


def aed_pass(trace, schur_spans):
    """ms_aed's device time in the profiled window: launches, rotations,
    the lanes in flight (the spans' sweeps over their lock-step sweeps, 1
    where a span does not count these) and the time a launch (ms) and a
    rotation of one lane's chain (ns: the time over the rotations a lane in
    flight, since a launch runs its lanes side by side); None off the large
    route."""
    lo, hi = trace.window
    ns = [min(b, hi) - max(a, lo) for a, b, name in trace.device_ops
          if 'ms_aed' in name and b > lo and a < hi]
    rot = sum(s.counters.get('aed_rotations', 0) for s in schur_spans)
    if not ns or not rot:
        return None
    sweeps = sum(s.counters.get('sweeps', 0) for s in schur_spans)
    steps = sum(s.counters.get('lockstep_sweeps', s.counters.get('sweeps', 0))
                for s in schur_spans)
    lanes = sweeps / steps if steps else 1.
    return {'launches': len(ns), 'rotations': rot, 'lanes_in_flight': lanes,
            'ms_a_pass': sum(ns) / len(ns) / 1e6,
            'ns_a_rotation': sum(ns) * lanes / rot}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, default=51.)
    p.add_argument('--cost-units', type=int, default=0)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)

    import torch
    from rcwa_bench import harness, trace
    from torcwa_tpu_torch.utils import timing

    bench = harness.load_json(os.path.join(ROOT, 'BENCHMARK.json'))
    cell = harness.Cell(args.workload, bench, ROOT)
    device = torch.device(args.device)
    sync = harness.sync
    torch.set_num_threads(1)
    spans = trace.Spans(device)
    run = cell.driver().Run(cell.config, cell.traffic, args.seed, device,
                            spans)
    with timing.tracing() as tr:
        run.setup()
        sync(device)
        setup = tr.collect()
        setup_report = tr.report()
    setup_s = time.perf_counter() - T_START
    spans.records.clear()
    pin = cell.traffic.get('pin_host') and device.type == 'cuda'
    unpin = harness.pin_host_threads() if pin else (lambda: None)
    n = int(cell.traffic['trace_units'])
    units = []
    undo = trace.install(spans)
    try:
        with timing.tracing() as tr:
            for k in range(n):
                timing.unit(k)
                units.append(run.unit())
            sync(device)
            window = tr.collect()
            report = tr.report()
            traced_spans, spans.records = spans.records, {}
            prof = torch.profiler.profile(
                activities=harness.profiler_activities(device))
            prof.start()
            try:
                harness.window(run, [], [], time.perf_counter(),
                               args.seconds, n)
            finally:
                prof.stop()
            sync(device)
            profiled_port = tr.collect()
        profiled_spans, spans.records = spans.records, traced_spans
    finally:
        undo()

    tr_ = trace.Trace.from_profiler(prof)
    del prof
    ctx = harness.Context(spans, tr_, profiled_spans, units)
    ctx.program = {'setup': setup, 'window': window}
    readings = {}
    for m in cell.per_layer:
        mod = cell.module('metrics', m['name'].split('.')[0])
        readings[m['name']] = mod.read(ctx, m['name'])
    for name in PORT_READERS:
        readings[name] = cell.module('metrics', name).read(ctx, name)
    out = {'workload': args.workload, 'seed': args.seed,
           'setup_s': setup_s, 'readings': readings,
           'busy_s': tr_.busy_ns() / 1e9 if tr_.window else None,
           'window_s': tr_.window_ns() / 1e9 if tr_.window else None,
           'idle_gaps': tr_.breakdown()['idle_gaps'] if tr_.window else None,
           'aed_pass': aed_pass(tr_, [s for s in profiled_port
                                      if s.name == 'eig.schur'])
           if tr_.window else None,
           'card': harness.power_limit()}
    print(f'{args.workload} seed {args.seed}: card {out["card"]}')
    print(f'set-up:\n{setup_report}\nthe spans phase:\n{report}')
    for k, v in readings.items():
        print(f'  {k} {v!r}')
    print(f'  aed_pass {out["aed_pass"]!r}')
    if args.cost_units:
        blocks = []
        for on in (False, True, True, False, False, True):
            blocks.append((on, _units(run, on, args.cost_units, timing,
                                      sync, device)))
            print(f'  tracer {"on " if on else "off"}: '
                  f'{blocks[-1][1]:.6f} s/unit')
        out['cost'] = blocks
    unpin()
    run.release()
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
