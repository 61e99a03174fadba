"""The plain reference against the port on the CPU at small orders, in
float64: Example 1's t_xx over a few wavelengths (normal and tilted),
Example 5's FoM, its gradient in W and one ADAM update.  The port runs its
own path with ``eig_backend='torch'`` (its broadened VJP over
``torch.linalg.eig``); the reference shares no code with it."""

import math

import numpy as np
import pytest
import torch

import torcwa_tpu_torch as tp
from torcwa_tpu_torch.optim import adam_update

from rcwa_bench.compare import adam
from rcwa_bench.reference import example5_shape
from rcwa_bench.reference import rcwa_ref as R

F64, C128 = torch.float64, torch.complex128
SUB = 1.46 ** 2


def test_material_table_is_a_frozen_copy_of_the_ports():
    lam = np.array([400., 455.5, 532., 699.9])
    port = tp.aSiH(device='cpu').eps(torch.as_tensor(lam)).numpy()
    np.testing.assert_allclose(R.asih_eps(lam), port, rtol=1e-12)


@pytest.mark.parametrize('inc_deg', [0., 10.])
def test_example1_txx(inc_deg):
    order, n, L = (2, 2), 64, (300., 300.)
    lam = np.array([401.7, 512.0, 655.2])
    g = tp.geometry(Lx=300., Ly=300., nx=n, ny=n, edge_sharpness=1000.,
                    dtype=F64, device='cpu')
    occ = g.rectangle(180., 100., 150., 150.)
    freqs = torch.as_tensor(1 / lam)
    eps = occ * tp.aSiH(device='cpu').eps(1 / freqs).to(C128)[:, None, None] \
        + (1 - occ)
    spec = tp.StackSpec(order=order, L=L, n_layers=1, has_input=True)
    S, intr = tp.solve_stack_pair(spec, freqs, math.radians(inc_deg), 0.,
                                  eps[:, None], [300.], eps_in=SUB,
                                  eig_backend='torch')
    t = tp.sparam_xy_pair(S, intr['kx'], intr['ky'], SUB, 1., order,
                          [0, 0], [0, 0], 'xx')[..., 0]
    occ_r = R.rectangle(n, n, 300., 300., 180., 100., 1000., F64, 'cpu')
    eps_r = occ_r * torch.as_tensor(R.asih_eps(lam))[:, None, None] \
        + (1 - occ_r)
    t_r = R.transmission(R.Precision('exact'), eps_r, lam, order, L, 300.,
                         SUB, 1., inc_deg)['xx']
    assert (t - t_r).abs().max() < 1e-8
    # the control's TF32 products move t by far more
    t_c = R.transmission(R.Precision('tf32'), eps_r.to(torch.complex64),
                         lam, order, L, 300., SUB, 1., inc_deg)['xx']
    assert (t_c.to(C128) - t_r).abs().max() > 1e-4


def _ex5_cfg():
    return dict(grid=[64, 64], period_nm=[300., 300.], edge_sharpness=500.,
                wavelength_nm=532., order=[2, 2], thickness_nm=250.,
                substrate_eps=SUB, superstrate_eps=1., inc_deg=0.,
                azi_deg=0., adam=dict(lr=1., steps=400, beta1=0.9,
                                      beta2=0.999, eps=1e-8,
                                      eps_in_sqrt=True, lower_nm=50.,
                                      upper_nm=250.))


def _port_fom(cfg):
    spec = tp.StackSpec(order=tuple(cfg['order']), L=(300., 300.),
                        n_layers=1, has_input=True)
    si = tp.aSiH(device='cpu').eps(532.).to(C128)
    g = tp.geometry(Lx=300., Ly=300., nx=64, ny=64, edge_sharpness=500.,
                    dtype=F64, device='cpu')

    def fom(W):
        occ = g.rectangle(W[0], W[1], 150., 150.)
        eps = occ * si + (1 - occ)
        S, intr = tp.solve_stack_pair(spec, torch.tensor(1 / 532., dtype=F64),
                                      0., 0., eps[None], [250.], eps_in=SUB,
                                      eig_backend='torch')
        t = [tp.sparam_xy_pair(S, intr['kx'], intr['ky'], SUB, 1.,
                               spec.order, [0, 0], [0, 0], p)[0]
             for p in ('xx', 'yy')]
        return (t[1] - t[0]).abs()
    return fom


def test_example5_fom_gradient_and_one_adam_update():
    cfg = _ex5_cfg()
    W0 = np.array([123.4, 77.7])
    W = torch.tensor(W0, dtype=F64, requires_grad=True)
    f = _port_fom(cfg)(W)
    g, = torch.autograd.grad(f, W)
    # the port's own update, as maximize_adam makes it (ascent)
    W1, m1, v1, _ = adam_update(W.detach(), -g, torch.zeros(2, dtype=F64),
                                torch.zeros(2, dtype=F64), 0, lr=1.,
                                lower=50., upper=250., eps_in_sqrt=True)
    (f_r, W1_r, m1_r, v1_r, g_r), = adam.reference_steps(
        example5_shape, cfg, W0, 1, R.Precision('exact'), 'cpu')
    assert abs(float(f) - f_r) < 1e-9 * abs(f_r)
    np.testing.assert_allclose(g.numpy(), g_r, rtol=1e-6)
    np.testing.assert_allclose(W1.numpy(), W1_r, rtol=1e-12)
    np.testing.assert_allclose(m1.numpy(), m1_r, rtol=1e-6)
    np.testing.assert_allclose(v1.numpy(), v1_r, rtol=2e-6)


def test_one_adam_update_from_a_window_state():
    """The reference's step from a state deep in the loop (the window's
    step is judged so) against the port's update at that step's rate."""
    cfg = _ex5_cfg()
    W = np.array([181.3, 249.9])
    m = np.array([-3.1e-3, -2.2e-4])
    v = np.array([1.4e-5, 6.0e-8])
    g = np.array([-2.7e-3, 9.1e-4])
    step = 47
    W1, m1, v1, _ = adam_update(
        *(torch.tensor(x, dtype=F64) for x in (W, -g, m, v)), step,
        lr=1. - step / 400., lower=50., upper=250., eps_in_sqrt=True)
    W1_r, m1_r, v1_r = adam.adam_step(cfg, W, m, v, step, g)
    np.testing.assert_allclose(W1.numpy(), W1_r, rtol=1e-13)
    np.testing.assert_allclose(m1.numpy(), m1_r, rtol=1e-13)
    np.testing.assert_allclose(v1.numpy(), v1_r, rtol=1e-13)
    assert W1_r[1] == 250.                  # the clamp held


def test_reference_gradient_is_the_finite_difference():
    """The broadened VJP matches central differences along W, also at
    normal incidence (W keeps the cell's mirror symmetry)."""
    cfg = _ex5_cfg()
    W0 = np.array([140., 90.])
    exact = R.Precision('exact')
    f0, g = example5_shape.fom_and_grad(cfg, exact, W0, 'cpu')
    h = 1e-4
    fd = [(example5_shape.fom_and_grad(cfg, exact, W0 + h * e, 'cpu')[0]
           - example5_shape.fom_and_grad(cfg, exact, W0 - h * e, 'cpu')[0])
          / (2 * h) for e in np.eye(2)]
    np.testing.assert_allclose(g, fd, rtol=1e-5,
                               atol=1e-6 * np.abs(g).max())
