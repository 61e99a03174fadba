"""The comparison of an ADAM loop (``drivers/adam.py``) with the plain
reference.

The configuration's own reference module (``reference/<config>.py``:
``fom_and_grad``) gives the figure of merit and its gradient; the ascent,
the schedule, the bias correction, sqrt(v_hat + eps) and the clamp are the
configuration's ``adam`` settings, applied here in float64.  Two parts of a
run are judged:

* the loop's first steps (those set-up drives through the window's own
  call), followed by the reference from the same start W0;
* one step of the window, drawn from the seed: the reference takes the
  program's state before it (W, m, v, step) and makes the step again.

Four numbers are compared:

* ``fom_gap``: each judged step's FoM against the reference's,
  |f - f_ref|, the worst step.  The FoM is a difference of two transmission
  amplitudes (at most 2), so its gap is on the scale of t itself; relative
  to the FoM it would swell where the rectangle is near square and the FoM
  near 0;
* ``grad_gap``: the first gradient's norm as the optimiser got it, worked
  out from the program's first moment after one step (m_1 = -(1 - beta1)
  g_1, the loop ascends), against the reference's, relative;
* ``step_gap``: the norm of the parameters' change over the first steps
  against the reference's, relative;
* ``win_step_gap``: the norm of the parameters' change in the window's
  step against the reference's from the same state, relative (0 where
  neither moves, as at a clamped corner).

``control`` puts the reference, computed with TF32 products (complex64),
in the program's place.
"""

import math

import numpy as np

from rcwa_bench.inputs import adam_start, sample
from rcwa_bench.reference import rcwa_ref as R


def adam_step(cfg, W, m, v, step, g):
    """The notebook's ascent step from the state (W, m, v, step) with the
    gradient g; returns (W, m, v), float64."""
    a = cfg['adam']
    W, m, v = (np.asarray(x, np.float64) for x in (W, m, v))
    lr = a['lr'] * (1. - step / a['steps'])
    m = a['beta1'] * m - (1 - a['beta1']) * g
    v = a['beta2'] * v + (1 - a['beta2']) * g * g
    m_hat = m / (1 - a['beta1'] ** (step + 1))
    v_hat = v / (1 - a['beta2'] ** (step + 1))
    den = (np.sqrt(v_hat + a['eps']) if a['eps_in_sqrt']
           else np.sqrt(v_hat) + a['eps'])
    W = np.clip(W - lr * m_hat / den, a['lower_nm'], a['upper_nm'])
    return W, m, v


def reference_step(ref, cfg, state, prec, device):
    """(fom, W, m, v, grad): the FoM at the state's W and the state after
    one step from (W, m, v, step)."""
    W, m, v, step = state
    f, g = ref.fom_and_grad(cfg, prec, np.asarray(W, np.float64), device)
    return (f, *adam_step(cfg, W, m, v, int(step), g), g)


def reference_steps(ref, cfg, W0, steps, prec, device):
    """(fom, W, m, v, grad) after each of the loop's first steps from W0
    and zero moments."""
    state = (np.asarray(W0, np.float64), np.zeros(2), np.zeros(2), 0)
    out = []
    for k in range(steps):
        f, W, m, v, g = reference_step(ref, cfg, state, prec, device)
        state = (W, m, v, k + 1)
        out.append((f, W.copy(), m.copy(), v.copy(), g))
    return out


def _rel_gap(a, b):
    """|a - b| / b for norms, 0 where both are 0."""
    if b == 0.:
        return 0. if a == 0. else math.inf
    return abs(a - b) / b


def readings(record, ref, cfg, traffic, device):
    steps, win = record['steps'], record['window']
    if not steps or win is None:
        return {'fom_gap': math.inf, 'grad_gap': math.inf,
                'step_gap': math.inf, 'win_step_gap': math.inf}
    exact = R.Precision('exact')
    beta1 = cfg['adam']['beta1']
    first = reference_steps(ref, cfg, record['W0'], len(steps), exact,
                            device)
    fom_gaps = [abs(p[0] - r[0]) for p, r in zip(steps, first)]
    g_prog = np.linalg.norm(np.asarray(steps[0][2], np.float64)) / (1 - beta1)
    g_ref = np.linalg.norm(first[0][4])
    W0 = np.asarray(record['W0'], np.float64)
    d_prog = np.linalg.norm(np.asarray(steps[-1][1], np.float64) - W0)
    d_ref = np.linalg.norm(first[-1][1] - W0)

    before, after = win['before'], win['after']
    f_w, W_w = reference_step(ref, cfg, before, exact, device)[:2]
    fom_gaps.append(abs(win['fom'] - f_w))
    Wb = np.asarray(before[0], np.float64)
    return {'fom_gap': float(max(fom_gaps)),
            'grad_gap': float(_rel_gap(g_prog, g_ref)),
            'step_gap': float(_rel_gap(d_prog, d_ref)),
            'win_step_gap': float(_rel_gap(
                np.linalg.norm(np.asarray(after[0], np.float64) - Wb),
                np.linalg.norm(W_w - Wb)))}


def control(record, ref, cfg, traffic, device):
    """The record with the reference, computed with TF32 products, in the
    program's place: the first steps from W0, and the window's step (at
    ``record['window_step']``) from the state those steps reached."""
    low = R.Precision('tf32')
    f32 = lambda x: np.asarray(x, np.float32)
    first = reference_steps(ref, cfg, record['W0'], len(record['steps']),
                            low, device)
    _, W, m, v, _ = first[-1]
    before = (f32(W), f32(m), f32(v), int(record['window_step']))
    f, W1, m1, v1, _ = reference_step(ref, cfg, before, low, device)
    return dict(record,
                steps=[(f_, f32(W_), f32(m_), f32(v_))
                       for f_, W_, m_, v_, _ in first],
                window={'before': before, 'fom': f,
                        'after': (f32(W1), f32(m1), f32(v1), before[3] + 1)})


def control_record(cfg, traffic, seed, answers):
    """A record with a run's inputs and no program answers: the loop's
    start, as many steps as set-up drives, and the window's step drawn from
    the seed among ``answers`` steps."""
    nan = np.full(2, np.nan, np.float32)
    k, = sample(seed, answers, 1)
    return {'seed': seed, 'W0': adam_start(traffic, seed),
            'steps': [(np.nan, nan, nan, nan)] * int(traffic['setup_steps']),
            'window': None, 'window_step': int(traffic['setup_steps']) + k}
