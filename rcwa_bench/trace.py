"""Spans around the program's layers and the reading of a profiler trace.

Spans are recorded from the benchmark's own files: around the calls the
drivers make, and around the functions ``torcwa_tpu_torch.ops.eig_qr``,
``ops.eig`` and ``optim`` look up at call time (patched in the traced run
only, restored after).  A span synchronises the device when it opens and
before it closes (the pattern of the port's ``StageTimer``), so its time is
device time and the kernels it launched ran inside its interval on the
profiler's clock.  The untraced run installs none of this.
"""

import contextlib
import time

import torch

WINDOW = 'bench_window'
SPAN = 'span:'


class NoSpans:
    """The untraced run's spans: nothing is recorded."""

    @contextlib.contextmanager
    def __call__(self, name, **meta):
        yield


class Spans:
    """Named spans, each with its duration in ms and the meta given when
    it opened, in the order they opened."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.records = {}

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name, **meta):
        self._sync()
        with torch.profiler.record_function(SPAN + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._sync()
                ms = 1e3 * (time.perf_counter() - t0)
        self.records.setdefault(name, []).append((ms, meta))

    def ms(self, name):
        return [r[0] for r in self.records.get(name, [])]


def install(spans):
    """Wrap the port's layer functions in spans; returns the undo."""
    from torcwa_tpu_torch import optim
    from torcwa_tpu_torch.ops import eig as eig_mod
    from torcwa_tpu_torch.ops import eig_qr

    def wrap(mod, attr, name, meta=lambda *a: {}):
        fn = getattr(mod, attr)

        def wrapped(*args, **kwargs):
            with spans(name, **meta(*args)):
                return fn(*args, **kwargs)
        setattr(mod, attr, wrapped)
        return mod, attr, fn

    one = lambda H, *a: dict(n=H.shape[-1], batch=1)
    batched = lambda H, *a: dict(n=H.shape[-1], batch=H.shape[0])
    saved = [
        wrap(eig_mod, 'eig_qr', 'eig'),
        wrap(eig_qr, 'hessenberg_blocked', 'hess_large', one),
        wrap(eig_qr, 'schur_ms', 'schur', one),
        wrap(eig_qr, 'SMALL_SCHUR', 'schur', batched),
        wrap(eig_qr, 'eig_small', 'eig_small', batched),
        wrap(optim, '_value_and_grad', 'value_and_grad'),
    ]

    def undo():
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
    return undo


# --- the trace ---------------------------------------------------------

def _ns(e, which):
    """An event's start or end in ns, on the profiler's clock."""
    if hasattr(e, which + '_ns'):
        return int(getattr(e, which + '_ns')())
    if which == 'start':
        return int(e.start_us() * 1000)
    return int((e.start_us() + e.duration_us()) * 1000)


def _annotation(e):
    return bool(getattr(e, 'is_user_annotation', lambda: False)())


class Trace:
    """What the metrics read of one profiled window: device operations and
    the host's named intervals, as (start_ns, end_ns, name) lists."""

    def __init__(self, device_ops, host, window):
        self.device_ops = sorted(device_ops)
        self.host = sorted(host)
        self.window = window

    @classmethod
    def from_profiler(cls, prof):
        device, host, window = [], [], None
        for e in prof.profiler.kineto_results.events():
            iv = (_ns(e, 'start'), _ns(e, 'end'), e.name())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # the host's annotations mirrored on the device's timeline
                # are no operations
                if not (_annotation(e) or e.name() == WINDOW
                        or e.name().startswith(SPAN)):
                    device.append(iv)
            elif e.name() == WINDOW:
                window = iv[:2]
            elif e.name().startswith(SPAN) or e.name().startswith('aten::'):
                host.append(iv)
        return cls(device, host, window)

    def spans(self, name):
        """Host intervals of the span ``name``, in the order they opened."""
        return [(a, b) for a, b, n in self.host if n == SPAN + name]

    def busy_ns(self, lo=None, hi=None):
        """Length of the union of device operations clipped to [lo, hi]
        (default: the window)."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        return sum(b - a for a, b in union(self.device_ops, lo, hi))

    def window_ns(self):
        return self.window[1] - self.window[0]

    def breakdown(self, top=10):
        """The device operations that took most time, and the idle time
        summed by what the host was doing in each gap (the innermost span
        and operator open at the gap's middle), seconds each, the largest
        first."""
        lo, hi = self.window
        by_name = {}
        for a, b, n in self.device_ops:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                by_name[n] = by_name.get(n, 0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = idle_gaps(self.device_ops, lo, hi)
        by_host = {}
        for (a, b), label in zip(gaps, self.host_at(
                [(a + b) // 2 for a, b in gaps])):
            by_host[label] = by_host.get(label, 0) + (b - a)
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {'device_ops': [[n, v / 1e9] for n, v in ops],
                'idle_gaps': [[n, v / 1e9] for n, v in idle]}

    def host_at(self, times):
        """'span > operator' open on the host at each of the times: the
        innermost of each kind, in one pass over the host intervals."""
        order = sorted(range(len(times)), key=lambda i: times[i])
        labels = [None] * len(times)
        open_, k = [], 0
        for i in order:
            t = times[i]
            while k < len(self.host) and self.host[k][0] <= t:
                open_.append(self.host[k])
                k += 1
            open_ = [iv for iv in open_ if iv[1] > t]
            span = next((n[len(SPAN):] for _, _, n in reversed(open_)
                         if n.startswith(SPAN)), 'no span')
            op = next((n for _, _, n in reversed(open_)
                       if not n.startswith(SPAN)), 'no operator')
            labels[i] = f'{span} > {op}'
        return labels


def union(intervals, lo, hi):
    """Merged intervals of ``intervals`` ((start, end, ...) sorted by
    start) clipped to [lo, hi]."""
    out = []
    for iv in intervals:
        a, b = max(iv[0], lo), min(iv[1], hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(intervals, lo, hi):
    """The gaps in [lo, hi] where no device operation ran."""
    gaps, t = [], lo
    for a, b in union(intervals, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps
