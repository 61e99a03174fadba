"""The port's spans and counters (``utils.timing``: ``tracing``, ``span``,
``unit``, ``Recorder``) on the CPU.

Off, every span site gets the one shared no-op context and nothing is
recorded; on, one ADAM step of a small solve (order (1, 1), 2N = 18, the
small route's plain versions) gives the span tree of the port's layers
with the caller's unit on every span; the ``sweeps`` counters of both Schur
stages are the stages' own counts; the names reach a ``torch.profiler``
trace and the benchmark's ``Trace``; and the recorder's device path, run
here on stand-in CUDA events, neither synchronizes nor reads an event
before ``collect``.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import torcwa_tpu_torch as tp  # noqa: E402
from torcwa_tpu_torch import optim  # noqa: E402
from torcwa_tpu_torch.ops import _build  # noqa: E402
from torcwa_tpu_torch.ops import eig_kernels as ek  # noqa: E402
from torcwa_tpu_torch.ops import eig_qr as eq  # noqa: E402
from torcwa_tpu_torch.ops import schur_ms as sm  # noqa: E402
from torcwa_tpu_torch.ops.hess_blocked import hessenberg_blocked  # noqa: E402
from torcwa_tpu_torch.utils import timing  # noqa: E402

torch.set_num_threads(2)

SPEC = tp.StackSpec(order=(1, 1), L=(300., 300.), n_layers=1,
                    has_input=True)
FREQS = (1 / 500., 1 / 650.)

# one ADAM step: its spans, each with the span open around it
STEP_TREE = {
    'adam.step': None,
    'adam.value_and_grad': 'adam.step',
    'fmm.solve': 'adam.value_and_grad',
    'fmm.conv': 'fmm.solve',
    'fmm.layer': 'fmm.solve',
    'eig': 'fmm.layer',
    'eig.hess': 'eig',
    'eig.schur': 'eig',
    'eig.vectors': 'eig',
    'eig.refine': 'eig',
    'fmm.fold': 'fmm.solve',
    'fmm.sparam': 'adam.value_and_grad',
    'adam.backward': 'adam.value_and_grad',
    'eig.backward': 'adam.backward',
    'adam.update': 'adam.step',
    'adam.read': 'adam.step',
}


def _fom(w):
    """Mean |t_xx|^2 over two wavelengths of a bar of half-width w."""
    x = torch.linspace(-1., 1., 12, dtype=torch.float64)
    occ = torch.sigmoid(20 * (w - x.abs()))[:, None] * torch.sigmoid(
        20 * (0.5 - x.abs()))[None, :]
    S, intr = tp.solve_stack_pair(
        SPEC, torch.tensor(FREQS, dtype=torch.float64), 0.1, 0.,
        (1. + 11. * occ)[None], [120.], eps_in=2.13)
    t = tp.sparam_xy_pair(S, intr['kx'], intr['ky'], 2.13, 1., SPEC.order,
                          [0, 0], [0, 0], 'xx')
    return (t.abs() ** 2).mean()


def _step():
    return optim.maximize_adam(_fom, torch.tensor(0.4, dtype=torch.float64),
                               1, lr=0.01)


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.as_tensor((0.3 * a).astype(np.complex64))


def test_off_records_nothing_and_every_site_gets_the_shared_noop(
        monkeypatch):
    got = []
    real = timing.span

    def spy(name, **meta):
        ctx = real(name, **meta)
        got.append((name, ctx))
        return ctx
    monkeypatch.setattr(timing, 'span', spy)
    with timing.tracing() as tr:
        pass
    assert timing._recorder is None
    _step()
    assert {n for n, _ in got} == set(STEP_TREE)
    assert all(ctx is timing.NOOP for _, ctx in got)
    assert tr.collect() == [] and tr.records == [] and tr.totals == {}
    with timing.NOOP as nothing:
        assert nothing is None


def test_one_adam_step_gives_the_span_tree_with_its_unit():
    with timing.tracing() as tr:
        timing.unit(7)
        _step()
        done = tr.collect()
    assert timing._recorder is None and done == tr.records
    spans = tr.records
    assert sorted(s.name for s in spans) == sorted(STEP_TREE)
    assert {s.name: s.parent and s.parent.name for s in spans} == STEP_TREE
    assert all(s.unit == 7 for s in spans)
    by = {s.name: s for s in spans}
    assert by['eig'].meta == dict(n=18, batch=2, route='small')
    for s in spans:
        # the host interval inside the parent's; no device events here
        assert s.host_ms >= 0 and s.device is None and s.device_ms is None
        if s.parent is not None:
            assert s.parent.host_ns[0] <= s.host_ns[0]
            assert s.host_ns[1] <= s.parent.host_ns[1]
    assert by['eig.schur'].counters['matrices'] == 2
    assert by['eig.schur'].counters['sweeps'] > 0
    # a StageTimer too: each name's calls and host seconds as they closed
    assert isinstance(tr, timing.StageTimer)
    assert tr.counts == {name: 1 for name in STEP_TREE}
    assert abs(tr.totals['eig'] - by['eig'].host_ms / 1e3) < 1e-9
    rows = {ln.split()[0]: ln.split() for ln in tr.report().splitlines()[1:]}
    assert set(rows) == set(STEP_TREE)
    assert rows['eig.schur'][5:] == [
        'matrices=2', f'sweeps={by["eig.schur"].counters["sweeps"]}']
    assert rows['eig'][1] == '1' and rows['eig'][3] == '-'
    tr.reset()
    assert tr.records == [] and tr.totals == {}


def test_large_route_spans_a_panel_at_a_time(monkeypatch):
    # hessenberg_blocked at n = 30 in panels of 8: four panels, a columns
    # span and an update span each; the route patched down to n = 32 runs
    # both lanes of a batch through it, then one schur_ms over the batch
    A = _rand((2, 64, 64), 3)
    with timing.tracing() as tr:
        hessenberg_blocked(A[0, :30, :30], panel=8)
        monkeypatch.setattr(eq, 'LARGE_MIN_N', 32)
        eq.eig_qr(A)
        tr.collect()
    first = tr.records[:9]
    assert [s.name for s in first] == ['eig.hess'] + [
        'eig.hess.columns', 'eig.hess.update'] * 4
    assert all(s.parent is first[0] for s in first[1:])
    eig, = [s for s in tr.records if s.name == 'eig']
    assert eig.meta == dict(n=64, batch=2, route='large')
    kids = [s.name for s in tr.records if s.parent is eig]
    assert kids == ['eig.hess'] * 2 + ['eig.schur', 'eig.vectors',
                                       'eig.refine']
    schur, = [s for s in tr.records if s.name == 'eig.schur']
    assert schur.counters['matrices'] == 2


def test_sweeps_counter_is_each_schur_stages_own_count():
    H, Q = ek.hessenberg_plain(_rand((1, 64, 64), 2))
    Hb, Qb = ek.hessenberg_plain(_rand((3, 24, 24), 5))
    with timing.tracing() as tr:
        _, _, st = sm.schur_ms(H[0], Q[0], m=8, kw=24, wb=128,
                               return_stats=True)
        _, _, stb = ek.schur_qr(Hb, Qb, return_stats=True)
        # the small route's count stays a tensor until collect
        large, small = tr._pending
        assert isinstance(small.counters['sweeps'], torch.Tensor)
        assert large.counters['sweeps'] == st[1]
        tr.collect()
    assert [s.name for s in tr.records] == ['eig.schur'] * 2
    assert large.counters == {'sweeps': st[1], 'matrices': 1,
                              'lockstep_sweeps': st[1]}
    assert small.counters == {'sweeps': int(stb[1].sum()), 'matrices': 3}
    assert st[1] > 0 and int(stb[1].min()) > 0


def test_span_names_reach_the_profiler_and_the_benchmark_trace():
    from rcwa_bench import trace as bench_trace
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with timing.tracing():
            _fom(torch.tensor(0.4, dtype=torch.float64))
    tr = bench_trace.Trace.from_profiler(prof)
    (s0, s1), = tr.spans('fmm.solve')
    (e0, e1), = tr.spans('eig')
    (h0, h1), = tr.spans('eig.hess')
    assert s0 <= e0 <= h0 < h1 <= e1 <= s1
    assert tr.spans('fmm.sparam') and tr.device_ops == []
    # the benchmark labels what the host did by the innermost span
    assert tr.host_at([(h0 + h1) // 2])[0].startswith('eig.hess > ')


class _Event:
    """Stand-in for torch.cuda.Event: a tick of a shared clock at each
    record; counts its instances and its reads."""
    clock = made = reads = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1
        self.t = None

    def record(self, stream=None):
        _Event.clock += 1
        self.t = _Event.clock

    def elapsed_time(self, end):
        _Event.reads += 1
        return float(end.t - self.t)

    def synchronize(self):
        raise AssertionError('an event was waited for')


def test_device_path_never_synchronizes_and_reads_events_at_collect(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError('the device was synchronized')
    monkeypatch.setattr(torch.cuda, 'synchronize', refuse)
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
    monkeypatch.setattr(torch.cuda, 'Event', _Event)
    monkeypatch.setattr(_Event, 'made', 0)
    monkeypatch.setattr(_Event, 'reads', 0)
    with timing.tracing() as tr:
        _step()
        assert _Event.reads == 0
        made = _Event.made
        first = tr.collect()
        assert _Event.reads == 2 * len(first)
        _step()
        second = tr.collect()
    # the second step's events come from the pool the first one filled
    assert _Event.made == made and len(second) == len(first)
    for s in tr.records:
        assert s.device_ms > 0
        if s.parent is not None:
            assert s.parent.device[0] < s.device[0]
            assert s.device[1] < s.parent.device[1]
    # self times add up to the roots' device time
    own = sum(float(ln.split()[4])
              for ln in tr.report().splitlines()[1:])
    roots = sum(s.device_ms for s in tr.records if s.parent is None)
    assert own == pytest.approx(roots)


def test_kernel_library_load_is_spanned_with_its_cache_state(monkeypatch):
    fake = types.SimpleNamespace(**{
        name: types.SimpleNamespace() for name in _build._SIGNATURES})
    monkeypatch.setattr(_build, '_lib', None)
    monkeypatch.setattr(_build, 'build', lambda: (
        _build.build_info.update(cached=True), 'lib.so')[1])
    monkeypatch.setattr(_build.ctypes, 'CDLL', lambda path: fake)
    monkeypatch.setattr(_build, 'build_info', {})
    with timing.tracing() as tr:
        assert _build.load() is fake
        assert _build.load() is fake
        tr.collect()
    load, = tr.records
    assert load.name == 'kernels.load' and load.meta == {'cached': True}
