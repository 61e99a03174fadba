"""One run of one benchmark cell: set-up, the measured window, the per-layer
metrics of a traced run, the comparison with the plain reference, and the
result line.

Everything particular to a cell is found by name (see README.md):

* ``BENCHMARK.json`` (the checkout's root): the cell's configuration and
  traffic, the metrics and which cells report them;
* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the traffic's parameters; its ``driver``
  names ``drivers/<driver>.py``;
* ``metrics/<name before the first dot>.py``: a per-layer metric's reader;
* ``compare/<driver>.py``: the comparison of that driver's answers with the
  reference, and its control;
* ``reference/<config>.py``: the configuration's physics in the plain
  reference, which the comparison calls;
* ``limits/<cell>.json``: the limit of each number compared.
"""

import importlib
import json
import math
import os
import subprocess
import sys
import time

import torch

from . import trace

HERE = os.path.dirname(os.path.abspath(__file__))
# modules that may not be loaded in the process that prints a result,
# compared by whole top-level names
BANNED = ('jax', 'jaxlib', 'flax', 'torcwa_tpu')


class CellError(RuntimeError):
    """The run cannot give a result (no card, unknown cell, bad files)."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic and
    limits, read from the files the names point to."""

    def __init__(self, name, bench, root, here=HERE):
        cells = {w['name']: w for w in bench['workloads']}
        if name not in cells:
            raise CellError(f'no workload {name!r} in BENCHMARK.json')
        self.name = name
        self.entry = cells[name]
        configs = {c['name']: c for c in bench['configs']}
        self.config_name = self.entry['config']
        self.config = load_json(os.path.join(
            root, configs[self.config_name]['file']))
        self.traffic_name = self.entry['traffic']
        self.traffic = load_json(os.path.join(
            here, 'traffic', self.traffic_name + '.json'))
        self.limits = load_json(os.path.join(here, 'limits', name + '.json'))
        self.here = here
        self.end_to_end = [m for m in bench['end_to_end']
                           if name in m.get('workloads', [name])]
        self.per_layer = [m for m in bench['per_layer']
                          if name in m.get('workloads', [name])]
        self.chips = int(self.entry['chips'])

    def module(self, kind, name):
        """drivers/<name>.py, metrics/<name>.py or compare/<name>.py of
        the folder the cell was read from."""
        path = os.path.join(self.here, kind, name + '.py')
        if not os.path.exists(path):
            raise CellError(f'{kind}/{name}.py not found')
        mod_name = '_rcwa_bench_%s_%s_%x' % (kind, name, hash(
            os.path.realpath(path)) & 0xffffffff)
        if mod_name not in sys.modules:
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = mod
            spec.loader.exec_module(mod)
        return sys.modules[mod_name]

    def driver(self):
        return self.module('drivers', self.traffic['driver'])

    def compare(self):
        return self.module('compare', self.traffic['driver'])

    def reference(self):
        return self.module('reference', self.config_name)

    def readings(self, record, device):
        """The numbers the comparison gives for a run's record."""
        return self.compare().readings(record, self.reference(), self.config,
                                       self.traffic, device)


def judge(readings, limits):
    """(correct, checks): each number of ``limits`` with its reading and
    its limit; correct where every reading is finite and within its limit.
    A number without a reading reads inf; one without a limit is a fault of
    the cell's files."""
    extra = set(readings) - set(limits)
    if extra:
        raise CellError('no limit for ' + ', '.join(sorted(extra)))
    checks = {k: {'value': float(readings.get(k, math.inf)), 'limit': lim}
              for k, lim in limits.items()}
    correct = bool(checks) and all(
        math.isfinite(c['value']) and c['value'] <= c['limit']
        for c in checks.values())
    return correct, checks


def banned_modules():
    """Top-level names among the loaded modules that may not be there."""
    return sorted({m.split('.')[0] for m in sys.modules}
                  & set(BANNED))


def pin_host_threads():
    """Hold every thread of this process to one CPU, the last this process
    may use; returns the undo.  For cells whose host paces the device."""
    allowed = os.sched_getaffinity(0)
    cpu = {max(allowed)}
    tids = [int(t) for t in os.listdir('/proc/self/task')]
    saved = {}
    for t in tids:
        try:
            saved[t] = os.sched_getaffinity(t)
            os.sched_setaffinity(t, cpu)
        except OSError:         # the thread has ended
            pass

    def undo():
        for t, mask in saved.items():
            try:
                os.sched_setaffinity(t, mask)
            except OSError:
                pass
    return undo


def power_limit():
    """The card's name and power limit as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


class Context:
    """What a per-layer metric's reader gets: the spans of the traced run's
    first phase (no profiler) and its units, and the profiled phase's
    trace and spans (a dict of name -> [(ms, meta)])."""

    def __init__(self, spans, trace_, trace_spans, units):
        self.spans = spans
        self.trace = trace_
        self.trace_spans = trace_spans
        self.units = units


def window(run, units, ends, t0, seconds, max_units=None):
    """Run units from t0 until ``seconds`` have passed (the unit running
    then completes and counts) or ``max_units`` are done."""
    with torch.profiler.record_function(trace.WINDOW):
        while time.perf_counter() - t0 < seconds and (
                max_units is None or len(units) < max_units):
            units.append(run.unit())
            ends.append(time.perf_counter())


def run_cell(name, seed, seconds, traced, root='.', device='cuda',
             here=HERE, t_start=None, log=sys.stderr):
    """One run of the cell; returns the result dict (the last line)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_json(os.path.join(root, 'BENCHMARK.json'))
    cell = Cell(name, bench, root, here)
    cell.compare(), cell.reference()    # found before set-up, or no run
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise CellError('no CUDA card: torch.cuda.is_available() is '
                            'false')
        if torch.cuda.device_count() < cell.chips:
            raise CellError(f'{cell.chips} cards asked for, '
                            f'{torch.cuda.device_count()} found')
    # one host thread for set-up and the window: the host paces the large
    # route, and idle worker threads only add jitter; the reference after
    # the window gets the threads back
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    spans = trace.Spans(device) if traced else trace.NoSpans()
    run = cell.driver().Run(cell.config, cell.traffic, seed, device, spans)
    run.setup()
    sync(device)
    if traced:
        spans.records.clear()       # set-up's spans are not the window's

    unpin = (pin_host_threads() if cell.traffic.get('pin_host')
             else lambda: None)
    units, ends = [], []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    if traced:
        # the spans' phase, then the profiler's: the profiler's own cost
        # on every host operation would otherwise be in the spans' times
        undo = trace.install(spans)
        try:
            window(run, units, ends, t0, seconds, cell.traffic['trace_units'])
            traced_spans = spans.records
            spans.records = {}
            prof = torch.profiler.profile(
                activities=profiler_activities(device))
            prof.start()
            try:
                window(run, [], [], time.perf_counter(), seconds,
                       cell.traffic['trace_units'])
            finally:
                prof.stop()
            profiled_spans, spans.records = spans.records, traced_spans
        finally:
            undo()
    else:
        window(run, units, ends, t0, seconds)
    unpin()
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == 'cuda' else 0)

    metrics, device_info, breakdown = {}, device_record(device, cell,
                                                        memory_peak), None
    if traced:
        tr = trace.Trace.from_profiler(prof)
        del prof
        ctx = Context(spans, tr, profiled_spans, units)
        for m in cell.per_layer:
            value = cell.module('metrics', m['name'].split('.')[0]).read(
                ctx, m['name'])
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        if tr.window is not None:
            device_info['busy_s'] = tr.busy_ns() / 1e9
            device_info['window_s'] = tr.window_ns() / 1e9
            breakdown = tr.breakdown()
        limit = power_limit()
        if limit:
            device_info['power_limit'] = limit
            print(f'card and power limit: {limit}', file=log)
    else:
        e2e = run.end_to_end(units, t0, ends)
        for m in cell.end_to_end:
            if m['name'] == 'setup_s':
                metrics['setup_s'] = {'value': setup_s, 'unit': m['unit']}
            elif e2e.get(m['name']) is not None:
                metrics[m['name']] = {'value': e2e[m['name']],
                                      'unit': m['unit']}

    torch.set_num_threads(threads)
    attempted, failed = run.counts()
    record = run.record()
    run.release()
    del run
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    correct, checks = judge(cell.readings(record, device), cell.limits)
    # last, once everything that makes the result line has run: the
    # metric readers, the comparison and the reference
    found = banned_modules()
    if found:
        raise CellError('modules loaded that may not be: '
                        + ', '.join(found))
    for k, c in checks.items():
        print(f'{k} {c["value"]!r} limit {c["limit"]!r}', file=log)
    out = {'correct': correct, 'attempted': attempted, 'failed': failed,
           'metrics': metrics, 'device': device_info}
    if breakdown is not None:
        out['breakdown'] = breakdown
    out['checks'] = checks
    return out


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def profiler_activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def device_record(device, cell, memory_peak):
    if device.type == 'cuda':
        return {'platform': 'gpu',
                'kind': torch.cuda.get_device_name(device),
                'count': cell.chips, 'memory_peak_bytes': memory_peak}
    return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
            'memory_peak_bytes': memory_peak}
