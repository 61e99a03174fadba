"""Per-stage timing of the solve pipeline, and the port's own spans.

Counterpart of ``torcwa_tpu/utils/timing.py``.  ``StageTimer`` stops its
clock only after the stage's device work is done (the caller synchronizes
inside the block, or :meth:`StageTimer.wrap` does), so its numbers are
device time; ``eig_stage_flops`` is the nominal FLOP model of the eig
stages.

The port's layers open named spans (``fmm.solve``, ``eig.hess``, ...)
through :func:`span`.  They record nothing unless :func:`tracing` is on:

    with timing.tracing() as tr:
        ...                          # solves, ADAM steps
        torch.cuda.synchronize()
        tr.collect()
    print(tr.report())

While it is on, each span keeps its parent, the unit set by :func:`unit`,
its meta, its host interval (``time.perf_counter_ns``), its device
interval (a pair of CUDA events on the current stream) and its counters,
and opens ``torch.profiler.record_function('span:' + name)`` so that a
profiler puts it on the device trace's clock.  The recorder never
synchronizes and reads nothing back from the device until
:meth:`Recorder.collect`, which the caller runs after its own final sync.
"""

import contextlib
import functools
import time

import torch
import torch.utils._pytree as pytree

__all__ = ['StageTimer', 'eig_stage_flops', 'Recorder', 'Span', 'tracing',
           'span', 'spanned', 'unit', 'NOOP', 'SPAN']


# --- FLOP model for the eig pipeline (the solve's cost driver) -------------
#
# Convention: one complex multiply-add = 8 real flops (4 mul + 4 add).
# Counts are the standard dense nominal models (LAPACK working notes /
# Golub-Van Loan), NOT the kernels' actual op counts.
#
#   hess : zgehrd (10/3 n^3) + Q formation zunghr (4/3 n^3)
#   qr   : Hessenberg Schur QR with Schur-vector accumulation; nominal
#          ~10 n^3 complex madds (zhseqr with Z, LAWN 41 class estimate)
#   vec  : triangular eigenvector back-substitution (~n^3/6) + the
#          Z @ Y basis GEMM (n^3)
_CMADD = 8.0


def eig_stage_flops(n):
    """Nominal real-FLOP counts per eig stage for one n x n complex
    matrix (see module comment for the models)."""
    n3 = float(n) ** 3
    return {
        'hess': (10. / 3. + 4. / 3.) * n3 * _CMADD,
        'qr': 10. * n3 * _CMADD,
        'vec': (1. / 6. + 1.) * n3 * _CMADD,
    }


def _sync_outputs(out):
    """Wait for the devices of every CUDA tensor among the outputs."""
    for d in {x.device for x in pytree.tree_leaves(out)
              if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(d)


class StageTimer:
    """Accumulates wall-clock per named stage, device-synchronized.

    Usage:
        t = StageTimer()
        with t('conv'):
            conv = build_conv(...)
            torch.cuda.synchronize()
        eig = t.wrap('eig', tp.eig)
        w, v = eig(A)
        print(t.report())
    """

    def __init__(self):
        self.totals = {}
        self.counts = {}

    def _add(self, name, seconds):
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def __call__(self, name):
        """Context manager; the caller must wait for the stage's device
        work inside the block (or use :meth:`wrap`): CUDA launches return
        before their kernels finish."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._add(name, time.perf_counter() - t0)

    def wrap(self, name, fn):
        """Timed wrapper: synchronizes the device of every CUDA tensor
        among fn's outputs before stopping the clock, so the measurement
        is device time."""
        def timed(*args, **kwargs):
            with self(name):
                out = fn(*args, **kwargs)
                _sync_outputs(out)
            return out
        return timed

    def report(self):
        total = sum(self.totals.values()) or 1.0
        lines = ['stage              total_s   calls   share']
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f'{name:18s} {t:7.3f}  {self.counts[name]:6d}'
                         f'  {100 * t / total:5.1f}%')
        return '\n'.join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


# --- the port's spans ------------------------------------------------------

# prefix of a span's name on the profiler's timeline
SPAN = 'span:'
# what every span site gets while tracing is off
NOOP = contextlib.nullcontext()
# the recorder of the running tracing() scope, None while tracing is off
_recorder = None


def span(name, **meta):
    """The span ``name`` of the active recorder, to use as a context
    manager (it yields the :class:`Span`, whose ``count`` and ``meta`` the
    site may fill); :data:`NOOP`, yielding None, while tracing is off."""
    rec = _recorder
    if rec is None:
        return NOOP
    return rec(name, **meta)


def spanned(name):
    """Decorator: every call of the function runs inside :func:`span`
    (``name``)."""
    def decorate(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapped
    return decorate


def unit(k):
    """Mark the spans opened from now on as the caller's unit ``k`` (a
    solve, a batch, an optimisation step); nothing while tracing is off."""
    rec = _recorder
    if rec is not None:
        rec.unit = k


@contextlib.contextmanager
def tracing():
    """Turn the port's spans on for the scope; yields the
    :class:`Recorder` that holds them.  Scopes nest: the inner one's
    recorder takes the spans until it closes."""
    global _recorder
    rec, prev = Recorder(), _recorder
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = prev


class Span:
    """One opening of a named span.  ``parent`` is the span open around it
    (None at the top); ``host_ns`` its (open, close) on the host's
    ``perf_counter_ns``; ``device``, once collected, its (start, end) in ms
    on the card from the recorder's first event (None without CUDA
    events); ``counters`` what the site counted, host numbers once
    collected."""

    __slots__ = ('name', 'meta', 'parent', 'unit', 'counters', 'host_ns',
                 'device', '_rec', '_rf', '_ev')

    def __init__(self, rec, name, meta):
        self.name, self.meta, self._rec = name, meta, rec
        self.counters = {}
        self.device = None

    def count(self, key, value):
        """Add ``value`` (a number, or a 0-d tensor left on its device
        until the recorder collects it) to the counter ``key``."""
        self.counters[key] = self.counters.get(key, 0) + value

    @property
    def host_ms(self):
        return (self.host_ns[1] - self.host_ns[0]) / 1e6

    @property
    def device_ms(self):
        if self.device is None:
            return None
        return self.device[1] - self.device[0]

    @property
    def ms(self):
        """Device ms where the span has events, else host ms."""
        dev = self.device_ms
        return self.host_ms if dev is None else dev

    def __enter__(self):
        rec = self._rec
        self.parent = rec._stack[-1] if rec._stack else None
        self.unit = rec.unit
        rec._stack.append(self)
        rec._pending.append(self)
        self._rf = torch.profiler.record_function(SPAN + self.name)
        self._rf.__enter__()
        self._ev = rec._event_pair()
        if self._ev is not None:
            self._ev[0].record()
        self.host_ns = [time.perf_counter_ns(), None]
        return self

    def __exit__(self, *exc):
        if self._ev is not None:
            self._ev[1].record()
        self.host_ns[1] = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        self._rf = None
        rec = self._rec
        if rec._stack and rec._stack[-1] is self:
            rec._stack.pop()
        else:
            rec._stack.remove(self)
        rec._add(self.name, (self.host_ns[1] - self.host_ns[0]) / 1e9)
        return False


class Recorder(StageTimer):
    """A :class:`StageTimer` whose stages are the port's nested spans
    (:class:`Span`).  ``totals`` and ``counts`` hold each name's host
    seconds and calls as the spans close; :meth:`collect` moves the closed
    spans, with their device times and counters read, into ``records``.

    Spans are assumed to nest: one thread opens them at a time, as
    autograd's backward does while the thread that called it waits."""

    def __init__(self):
        super().__init__()
        self.records = []
        self.unit = None
        self._stack = []
        self._pending = []
        self._pool = []
        self._origin = None

    def __call__(self, name, **meta):
        return Span(self, name, meta)

    def _event_pair(self):
        """Two timing events from the pool, or None where CUDA is not in
        use; the first pair of the recorder's life also records the origin
        its device times are read against."""
        if not torch.cuda.is_initialized():
            return None
        while len(self._pool) < 2:
            self._pool.append(torch.cuda.Event(enable_timing=True))
        if self._origin is None:
            self._origin = torch.cuda.Event(enable_timing=True)
            self._origin.record()
        return self._pool.pop(), self._pool.pop()

    def collect(self):
        """Read the device interval and the device counters of every span
        closed since the last collect, once the caller has waited for the
        device; returns those spans, which are appended to ``records``."""
        done = [s for s in self._pending if s.host_ns[1] is not None]
        self._pending = [s for s in self._pending if s.host_ns[1] is None]
        for s in done:
            if s._ev is not None:
                s.device = tuple(self._origin.elapsed_time(e)
                                 for e in s._ev)
                self._pool.extend(s._ev)
            s._ev = s._rec = None
            s.counters = {k: v.item() if isinstance(v, torch.Tensor) else v
                          for k, v in s.counters.items()}
        self.records.extend(done)
        return done

    def report(self):
        """Per span name, of the collected spans: calls, host ms, device
        ms, self ms (the span less the spans opened inside it; on the
        device's clock where the span has events, else the host's) and the
        sum of each counter."""
        rows, child = {}, {}
        for s in self.records:
            if s.parent is not None:
                child[id(s.parent)] = child.get(id(s.parent), 0.) + s.ms
        for s in self.records:
            r = rows.setdefault(s.name, [0, 0., None, 0., {}])
            r[0] += 1
            r[1] += s.host_ms
            if s.device_ms is not None:
                r[2] = (r[2] or 0.) + s.device_ms
            r[3] += s.ms - child.get(id(s), 0.)
            for k, v in s.counters.items():
                r[4][k] = r[4].get(k, 0) + v
        lines = [f'{"span":24s} {"calls":>6s} {"host_ms":>10s} '
                 f'{"device_ms":>10s} {"self_ms":>10s}  counters']
        for name in sorted(rows):
            calls, host, dev, own, cnt = rows[name]
            dev = '-' if dev is None else f'{dev:.3f}'
            lines.append(f'{name:24s} {calls:6d} {host:10.3f} {dev:>10s} '
                         f'{own:10.3f}  ' + ' '.join(
                             f'{k}={v}' for k, v in sorted(cnt.items())))
        return '\n'.join(lines)

    def reset(self):
        super().reset()
        self.records.clear()
