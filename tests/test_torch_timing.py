"""The port's ``utils.timing`` against ``torcwa_tpu.utils.timing`` on the
CPU: the nominal FLOP model, the MFU lines character for character,
``StageTimer``'s counts and report, and ``measured_gemm_peak`` on the CPU.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from torcwa_tpu.utils import timing as jt  # noqa: E402
from torcwa_tpu_torch import utils as tu  # noqa: E402
from torcwa_tpu_torch.utils import timing as pt  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize('n', [1, 162, 1922, 3362])
def test_eig_stage_flops_match_jax(n):
    assert pt.eig_stage_flops(n) == jt.eig_stage_flops(n)


@pytest.mark.parametrize('peak', [52.7, 0.])
def test_mfu_report_matches_jax_line_for_line(peak):
    # stages outside the model ('refine') and non-positive times are
    # skipped by both; a zero peak prints 0 %
    times = {'hess': 1.2345, 'qr': 0.5, 'vec': 0.0123, 'refine': 0.04,
             'eig': 0.}
    got = pt.mfu_report(times, 1922, peak)
    assert got == jt.mfu_report(times, 1922, peak)
    assert len(got) == 3 and got[0].startswith('hess ')


def test_stage_timer_counts_and_report():
    t, tj = pt.StageTimer(), jt.StageTimer()
    for timer in (t, tj):
        for _ in range(3):
            with timer('conv'):
                time.sleep(0.002)
        with timer('eig'):
            time.sleep(0.01)
    assert t.counts == tj.counts == {'conv': 3, 'eig': 1}
    assert t.totals['eig'] >= 0.01 and t.totals['conv'] >= 0.006
    lines = t.report().splitlines()
    assert lines[0] == tj.report().splitlines()[0]
    # stages by time, longest first, each with its calls and share
    assert [ln.split()[0] for ln in lines[1:]] == ['eig', 'conv']
    assert lines[2].split()[2] == '3'
    shares = [float(ln.split()[-1].rstrip('%')) for ln in lines[1:]]
    assert abs(sum(shares) - 100.) < 0.2
    # the same format as the JAX package's on the same totals
    tj.totals = dict(t.totals)
    assert t.report() == tj.report()
    # wrap: counts a call, returns what fn returns (nested outputs too)
    out = t.wrap('eig', lambda a: (a @ a, {'x': [a]}))(torch.eye(3))
    assert t.counts['eig'] == 2 and torch.equal(out[1]['x'][0], torch.eye(3))
    t.reset()
    assert t.totals == {} and t.counts == {}
    assert tu.StageTimer is pt.StageTimer


def test_measured_gemm_peak_on_the_cpu():
    peak = pt.measured_gemm_peak(64, reps=1, device='cpu')
    assert np.isfinite(peak) and peak > 0
