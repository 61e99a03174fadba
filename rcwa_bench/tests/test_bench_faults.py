"""The comparison's power, on the tiny cells on the CPU: a sound run is
correct; the control (the reference with TF32 products in the program's
place) and a run with the timed path broken underneath are not."""

import json
import os
import subprocess
import sys

import pytest
import torch

import torcwa_tpu_torch as tp
from torcwa_tpu_torch import optim

from rcwa_bench import control, harness

CELLS = ['ex5_adam', 'ex1_sweep_o15', 'ex1_sweep_o7', 'ex1_band_grad_o7']


def _run(tiny, cell, seed=20240611):
    root, here = tiny
    return harness.run_cell(cell, seed, 0.3, False, root=root,
                            device='cpu', here=here)


@pytest.mark.parametrize('cell', CELLS)
def test_a_sound_run_is_correct_and_the_control_is_not(tiny, cell):
    out = _run(tiny, cell)
    assert out['correct'], out['checks']
    root, here = tiny
    c = harness.Cell(cell, harness.load_json(
        os.path.join(root, 'BENCHMARK.json')), root, here)
    got = control.control_readings(c, 2 ** 40 + 3, 10, torch.device('cpu'))
    correct, checks = harness.judge(got, c.limits)
    assert not correct, checks


def _alter_answer(monkeypatch):
    real = tp.sparam_xy_pair

    def altered(*a, **k):
        s = real(*a, **k)
        return s * (1 + 1e-3)
    monkeypatch.setattr(tp, 'sparam_xy_pair', altered)


def _half_batch(monkeypatch):
    real = tp.solve_stack_pair

    def half(spec, freq, inc, azi, eps, *a, **k):
        h = max(1, freq.shape[0] // 2)
        return real(spec, freq[:h], inc, azi, eps[:h], *a, **k)
    monkeypatch.setattr(tp, 'solve_stack_pair', half)


def _state_unchanged(monkeypatch):
    def unchanged(rho, grad, m, v, step, **k):
        return rho, m, v, int(step) + 1
    monkeypatch.setattr(optim, 'adam_update', unchanged)


# faults that act only once the loop is warm, past the steps set-up drives

def _state_unchanged_once_warm(monkeypatch):
    real = optim.adam_update

    def update(rho, grad, m, v, step, **k):
        if int(step) < 3:
            return real(rho, grad, m, v, step, **k)
        return rho, m, v, int(step) + 1
    monkeypatch.setattr(optim, 'adam_update', update)


def _rate_off_once_warm(monkeypatch):
    real = optim.adam_update

    def update(rho, grad, m, v, step, lr=0.02, **k):
        return real(rho, grad, m, v, step, lr=lr * (0.5 if int(step) >= 3
                                                     else 1.), **k)
    monkeypatch.setattr(optim, 'adam_update', update)


def _answer_altered_once_warm(monkeypatch):
    real = tp.sparam_xy_pair
    calls = [0]

    def altered(*a, **k):
        calls[0] += 1
        s = real(*a, **k)
        # two polarisations a step: calls 7 on are the window's
        return s * (1 + 1e-3) if calls[0] > 6 else s
    monkeypatch.setattr(tp, 'sparam_xy_pair', altered)


FAULTS = [('ex1_sweep_o15', _alter_answer), ('ex1_sweep_o15', _half_batch),
          ('ex1_sweep_o7', _alter_answer), ('ex1_sweep_o7', _half_batch),
          ('ex1_band_grad_o7', _alter_answer),
          ('ex1_band_grad_o7', _half_batch),
          ('ex5_adam', _alter_answer), ('ex5_adam', _state_unchanged),
          ('ex5_adam', _state_unchanged_once_warm),
          ('ex5_adam', _rate_off_once_warm),
          ('ex5_adam', _answer_altered_once_warm)]


@pytest.mark.parametrize('cell,fault', FAULTS,
                         ids=[f'{c}-{f.__name__[1:]}' for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = _run(tiny, cell)
    assert not out['correct'], out['checks']


@pytest.mark.cuda
def test_each_cell_runs_correct_on_the_card(tmp_path):
    """On the card: one short run of each cell from the repository root."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    root = os.path.dirname(harness.HERE)
    for cell in CELLS:
        p = subprocess.run([sys.executable, 'rcwa_bench/run.py',
                            '--workload', cell, '--seed', '3141592653589',
                            '--seconds', '2', '--trace', '0'], cwd=root,
                           capture_output=True, text=True, timeout=900)
        assert p.returncode == 0, p.stderr[-2000:]
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out['correct'], out['checks']
