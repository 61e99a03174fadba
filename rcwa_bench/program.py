"""The port's own spans (``torcwa_tpu_torch.utils.timing``), as the metric
readers find them.

A traced run that turns the port's tracer on hands its readers
``ctx.program``: a dict of the collected spans (``Recorder.collect()``)
by phase, ``'setup'`` (set-up's, the cold first calls among them) and
``'window'`` (the spans phase's).  Each span has ``name``, ``parent``,
``unit``, ``meta``, ``host_ms``, ``device_ms`` (None without CUDA events)
and ``counters``.  A run without them (the tracer off, or a program that
has no such spans) gives the readers nothing, and they read None.
"""


def spans(ctx, phase, name=None):
    """The program's spans of ``phase`` (those called ``name`` where
    given), in the order they opened; [] where the run has none."""
    out = (getattr(ctx, 'program', None) or {}).get(phase) or []
    return [s for s in out if name is None or s.name == name]
