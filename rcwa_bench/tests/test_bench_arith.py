"""The harness's arithmetic on the CPU: rates, the idle share, the roofline
share, and finding cells, traffic and metrics by name."""

import json
import os

import pytest

from rcwa_bench import harness, peaks, trace
from rcwa_bench.drivers import adam, sweep


def test_rate_over_a_window_that_ends_mid_batch():
    # three batches of 61 end at 0.4, 0.8 and 1.3 s; the window of 1 s
    # closed during the third, which still completes and counts
    out = sweep.Run.end_to_end(None, [61, 61, 61], 10.0, [10.4, 10.8, 11.3])
    assert out['solves_per_s'] == pytest.approx(183 / 1.3)
    assert sweep.Run.end_to_end(None, [], 10.0, []) == {}


def test_iter_s_is_the_window_over_its_steps():
    out = adam.Run.end_to_end(None, [1] * 4, 2.0, [2.9, 3.7, 4.6, 5.2])
    assert out['iter_s'] == pytest.approx(3.2 / 4)


def test_idle_share_counts_overlapping_kernels_once():
    # window [0, 100]; kernels [10, 40] and [30, 50] overlap, [60, 70] and
    # [95, 120] (clipped to 100) do not: busy 40 + 10 + 5 = 55
    dev = [(10, 40, 'a'), (30, 50, 'b'), (60, 70, 'a'), (95, 120, 'c')]
    tr = trace.Trace(dev, [], (0, 100))
    assert tr.busy_ns() == 55
    ctx = harness.Context(trace.Spans('cpu'), tr, {}, [1])
    from rcwa_bench.metrics import idle_share
    assert idle_share.read(ctx, 'idle_share.sweep') == pytest.approx(0.45)
    assert trace.idle_gaps(dev, 0, 100) == [(0, 10), (50, 60), (70, 95)]


def test_breakdown_names_ops_and_what_the_host_did_in_gaps():
    dev = [(10, 40, 'k1'), (60, 70, 'k2')]
    host = [(0, 100, 'span:hess_large'), (42, 58, 'aten::linalg_solve')]
    bd = trace.Trace(dev, host, (0, 100)).breakdown()
    assert bd['device_ops'] == [['k1', 30e-9], ['k2', 10e-9]]
    got = dict((k, v) for k, v in bd['idle_gaps'])
    assert got['hess_large > aten::linalg_solve'] == pytest.approx(20e-9)
    assert got['hess_large > no operator'] == pytest.approx(40e-9)


def test_roofline_share_from_n_batch_and_time():
    n, B = 450, 61
    least = peaks.schur_least_seconds(n, B)
    flops = B * 10 * n ** 3 * 8
    assert least == pytest.approx(max(flops / 67e12,
                                      B * 4 * n * n * 8 / 3.35e12))
    # one Schur span of 0.2 s of device work inside [0, 0.3 s]
    profiled = {'schur': [(300., dict(n=n, batch=B))]}
    tr = trace.Trace([(int(0.05e9), int(0.25e9), 'schur_qr_kernel')],
                     [(0, int(0.3e9), 'span:schur')], (0, int(0.3e9)))
    from rcwa_bench.metrics import roofline_schur
    ctx = harness.Context(trace.Spans('cpu'), tr, profiled, [B])
    assert roofline_schur.read(ctx, 'roofline_schur.sweep') == \
        pytest.approx(100 * least / 0.2)
    # no span: nothing to read, and no 0
    ctx = harness.Context(trace.Spans('cpu'), tr, {}, [B])
    assert roofline_schur.read(ctx, 'roofline_schur.sweep') is None


def test_span_metrics_subtract_nested_spans():
    from rcwa_bench.metrics import backward_ms, fmm_rest_ms, hess_large_ms
    spans = trace.Spans('cpu')
    spans.records = {'solve': [(100., {}), (120., {})],
                     'eig': [(70., {}), (80., {})],
                     'hess_large': [(40., {}), (50., {})],
                     'value_and_grad': [(150., {}), (170., {})]}
    ctx = harness.Context(spans, None, {}, [1, 1])
    assert fmm_rest_ms.read(ctx, 'fmm_rest_ms.iter') == pytest.approx(35.)
    assert hess_large_ms.read(ctx, 'hess_large_ms.iter') == pytest.approx(45.)
    assert backward_ms.read(ctx, 'backward_ms.iter') == pytest.approx(50.)
    spans.records['backward'] = [(30., {})]
    assert backward_ms.read(ctx, 'backward_ms.sweep') == pytest.approx(30.)


def test_every_benchmark_name_resolves_to_its_files():
    root = harness.os.path.dirname(harness.HERE)
    bench = harness.load_json(os.path.join(root, 'BENCHMARK.json'))
    for w in bench['workloads']:
        cell = harness.Cell(w['name'], bench, root)
        assert cell.driver().Run
        assert cell.compare().readings and cell.compare().control_record
        assert cell.reference()
        assert set(cell.limits) and cell.per_layer and cell.end_to_end
        for m in cell.per_layer:
            cell.module('metrics', m['name'].split('.')[0]).read
    for m in bench['per_layer']:
        assert m['moves'] in {e['name'] for e in bench['end_to_end']}


def test_a_cell_traffic_and_metric_added_as_files_are_found(tiny):
    root, here = tiny
    # a new traffic mix and a new per-layer metric, as files of their own
    with open(os.path.join(here, 'traffic', 'sweep_o1_b3.json'), 'w') as f:
        json.dump({'driver': 'sweep', 'order': 1, 'batch': 3,
                   'offset_nm': [0., 2.5], 'check_sample': 2,
                   'ref_block': 3, 'trace_units': 2}, f)
    with open(os.path.join(here, 'metrics', 'units_done.py'), 'w') as f:
        f.write('def read(ctx, name):\n    return float(sum(ctx.units))\n')
    with open(os.path.join(here, 'limits', 'new_cell.json'), 'w') as f:
        json.dump({'txx_gap': 5e-5, 'missing': 0}, f)
    path = os.path.join(root, 'BENCHMARK.json')
    bench = harness.load_json(path)
    bench['workloads'].append({'name': 'new_cell',
                               'config': 'example1_meta_atom',
                               'traffic': 'sweep_o1_b3', 'chips': 1,
                               'why': 'test'})
    bench['per_layer'].append({'name': 'units_done.sweep', 'unit': 'solves',
                               'better': 'higher', 'source': 'program_counter',
                               'layer': 'test', 'moves': 'solves_per_s',
                               'workloads': ['new_cell']})
    bench['end_to_end'][0]['workloads'].append('new_cell')
    with open(path, 'w') as f:
        json.dump(bench, f)
    out = harness.run_cell('new_cell', 7, 0.5, True, root=root,
                           device='cpu', here=here)
    assert out['correct']
    # the spans' phase ran one or two batches of 3, the profiled phase too
    assert out['metrics']['units_done.sweep']['value'] in (3., 6.)
    assert out['attempted'] in (6, 9, 12)
    out = harness.run_cell('new_cell', 7, 0.5, False, root=root,
                           device='cpu', here=here)
    assert set(out['metrics']) == {'solves_per_s', 'setup_s'}
    assert list(out)[-1] == 'checks'


def test_a_driver_without_its_comparison_gives_no_result(tiny):
    """A new kind of run is judged by its own compare/<driver>.py: without
    that file the cell fails, and never falls to another driver's rule."""
    root, here = tiny
    with open(os.path.join(here, 'drivers', 'sweep2.py'), 'w') as f:
        f.write('from rcwa_bench.drivers.sweep import Run  # noqa: F401\n')
    with open(os.path.join(here, 'traffic', 'sweep_o1_b3.json'), 'w') as f:
        json.dump({'driver': 'sweep2', 'order': 1, 'batch': 3,
                   'offset_nm': [0., 2.5], 'check_sample': 2,
                   'ref_block': 3, 'trace_units': 2}, f)
    path = os.path.join(root, 'BENCHMARK.json')
    bench = harness.load_json(path)
    for w in bench['workloads']:
        if w['name'] == 'ex1_sweep_o7':
            w['traffic'] = 'sweep_o1_b3'
    with open(path, 'w') as f:
        json.dump(bench, f)
    with pytest.raises(harness.CellError, match='compare/sweep2.py'):
        harness.run_cell('ex1_sweep_o7', 3, 0.2, False, root=root,
                         device='cpu', here=here)


def test_judge_needs_every_number_within_its_limit():
    lim = {'a': 1e-3, 'b': 0}
    assert harness.judge({'a': 5e-4, 'b': 0.}, lim)[0]
    assert not harness.judge({'a': 2e-3, 'b': 0.}, lim)[0]
    assert not harness.judge({'a': float('nan'), 'b': 0.}, lim)[0]
    correct, checks = harness.judge({'a': 5e-4}, lim)      # b never came
    assert not correct and checks['b']['value'] == float('inf')
    with pytest.raises(harness.CellError):
        harness.judge({'a': 0., 'b': 0., 'c': 0.}, lim)


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(harness.torch.cuda, 'is_available', lambda: False)
    root = os.path.dirname(harness.HERE)
    with pytest.raises(harness.CellError):
        harness.run_cell('ex1_sweep_o7', 1, 1.0, False, root=root)


def test_a_bare_checkout_gives_no_result(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: the port is not
    there, so the run fails and prints no result line."""
    import shutil
    import subprocess
    import sys
    root = os.path.dirname(harness.HERE)
    shutil.copy(os.path.join(root, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / 'rcwa_bench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    p = subprocess.run([sys.executable, 'rcwa_bench/run.py', '--workload',
                        'ex1_sweep_o7', '--seed', '1', '--seconds', '1'],
                       cwd=tmp_path, capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ''
