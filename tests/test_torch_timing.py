"""The port's ``utils.timing`` against ``torcwa_tpu.utils.timing`` on the
CPU: the nominal FLOP model and ``StageTimer``'s counts and report.
"""

import time

import pytest

torch = pytest.importorskip('torch')

from torcwa_tpu.utils import timing as jt  # noqa: E402
from torcwa_tpu_torch import utils as tu  # noqa: E402
from torcwa_tpu_torch.utils import timing as pt  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize('n', [1, 162, 1922, 3362])
def test_eig_stage_flops_match_jax(n):
    assert pt.eig_stage_flops(n) == jt.eig_stage_flops(n)


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
    # the order by time on totals set here, as a sleep may overrun by more
    # than the gap between the stages on a loaded host
    t.totals = {'conv': 0.0061, 'eig': 0.0123}
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

