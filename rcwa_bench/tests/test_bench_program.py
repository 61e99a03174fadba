"""The readers of the port's own spans on synthetic records: the idle time
under the port's ``eig.hess`` spans, the refinement's device time, the
Schur stage's sweeps a matrix and set-up's cold eig, none reading anything
from a run without the port's spans; and the benchmark's older readers,
which read the same values with the port's spans beside their own."""

import types

import pytest

from rcwa_bench import harness, trace
from rcwa_bench.metrics import (backward_ms, eig_small_ms, fmm_rest_ms,
                                hess_idle_share, hess_large_ms, idle_share,
                                refine_ms, roofline_schur, schur_sweeps,
                                setup_eig_s)

OLD = {idle_share: 'idle_share.iter', roofline_schur: 'roofline_schur.iter',
       hess_large_ms: 'hess_large_ms.iter', fmm_rest_ms: 'fmm_rest_ms.iter',
       backward_ms: 'backward_ms.iter', eig_small_ms: 'eig_small_ms.sweep'}
NEW = {hess_idle_share: 'hess_idle_share.iter', refine_ms: 'refine_ms.iter',
       schur_sweeps: 'schur_sweeps.iter', setup_eig_s: 'setup_eig_s'}

# a step on [0, 1000] ns: the benchmark's spans (synchronized, around the
# port's functions) with the device's operations
BENCH_HOST = [(0, 1000, 'span:value_and_grad'), (10, 700, 'span:solve'),
              (20, 600, 'span:eig'), (30, 400, 'span:hess_large'),
              (410, 590, 'span:schur'), (720, 760, 'aten::mm')]
DEVICE = [(40, 60, 'gemv'), (150, 160, 'gemm'), (420, 580, 'ms_aed'),
          (800, 900, 'solve')]
# the port's spans inside them: the Hessenberg reduction in two panels
PORT_HOST = [(25, 595, 'span:eig'), (31, 399, 'span:eig.hess'),
             (35, 140, 'span:eig.hess.columns'),
             (140, 200, 'span:eig.hess.update'),
             (200, 330, 'span:eig.hess.columns'),
             (330, 395, 'span:eig.hess.update'),
             (410, 590, 'span:eig.schur'), (12, 18, 'span:fmm.conv')]


def _span(name, parent=None, host=1., device=None, **counters):
    return types.SimpleNamespace(name=name, parent=parent, host_ms=host,
                                 device_ms=device, counters=counters,
                                 meta={}, unit=0)


def _ctx(host, program=None):
    spans = trace.Spans('cpu')
    spans.records = {'solve': [(100., {})], 'eig': [(70., {})],
                     'hess_large': [(40., {})], 'eig_small': [(60., {})],
                     'value_and_grad': [(150., {})]}
    tr = trace.Trace(DEVICE, host, (0, 1000))
    profiled = {'schur': [(0.2, dict(n=882, batch=1))]}
    ctx = harness.Context(spans, tr, profiled, [1])
    if program is not None:
        ctx.program = program
    return ctx


def test_hess_idle_share_counts_only_idle_time_under_the_ports_hess():
    ctx = _ctx(BENCH_HOST + PORT_HOST)
    # idle under eig.hess and its panels: [31, 40), [60, 150), [160, 399);
    # idle elsewhere ([0, 31), [399, 420), [580, 800), [900, 1000)) is not
    assert hess_idle_share.read(ctx, 'hess_idle_share.iter') == \
        pytest.approx((9 + 90 + 239) / 1000)
    # a span opened inside eig.hess that is not its own takes its time out
    ctx = _ctx(BENCH_HOST + PORT_HOST + [(250, 300, 'span:kernels.load')])
    assert hess_idle_share.read(ctx, 'hess_idle_share.iter') == \
        pytest.approx((9 + 90 + 239 - 50) / 1000)
    # the benchmark's own spans alone name no port span: nothing to read
    assert hess_idle_share.read(_ctx(BENCH_HOST), 'x') is None


def test_innermost_pieces_follow_the_nesting():
    got = hess_idle_share.innermost(
        [(0, 10, 'a'), (2, 4, 'b'), (3, 4, 'c'), (6, 8, 'd'), (6, 7, 'f'),
         (12, 13, 'e')])
    assert got == [(0, 2, 'a'), (2, 3, 'b'), (3, 4, 'c'), (4, 6, 'a'),
                   (6, 7, 'f'), (7, 8, 'd'), (8, 10, 'a'), (12, 13, 'e')]


def test_program_span_readers():
    eig = [_span('eig'), _span('eig')]
    window = eig + [
        _span('eig.refine', eig[0], device=12.), _span('eig.schur', eig[0],
                                                       sweeps=900,
                                                       matrices=61),
        _span('eig.refine', eig[1], device=14.), _span('eig.schur', eig[1],
                                                       sweeps=930,
                                                       matrices=61)]
    setup = [_span('fmm.solve', host=9000.), _span('eig', host=7250.5),
             _span('eig', host=300.)]
    ctx = _ctx(BENCH_HOST, {'setup': setup, 'window': window})
    assert refine_ms.read(ctx, 'refine_ms.sweep') == pytest.approx(13.)
    assert schur_sweeps.read(ctx, 'schur_sweeps.sweep') == \
        pytest.approx(1830 / 122)
    assert setup_eig_s.read(ctx, 'setup_eig_s') == pytest.approx(7.2505)
    # no CUDA events: no device time to read
    window[2].device_ms = None
    assert refine_ms.read(ctx, 'refine_ms.sweep') is None


def test_new_readers_read_nothing_from_a_run_without_the_ports_spans():
    ctx = _ctx(BENCH_HOST)
    assert not hasattr(ctx, 'program')
    for mod, name in NEW.items():
        assert mod.read(ctx, name) is None
    ctx.program = {'setup': [], 'window': []}
    for mod, name in NEW.items():
        assert mod.read(ctx, name) is None


def test_older_readers_are_unchanged_by_the_ports_spans():
    before = {m: m.read(_ctx(BENCH_HOST), n) for m, n in OLD.items()}
    program = {'setup': [_span('eig')], 'window': [_span('eig')]}
    after = {m: m.read(_ctx(BENCH_HOST + PORT_HOST, program), n)
             for m, n in OLD.items()}
    assert None not in before.values()
    assert after == before
