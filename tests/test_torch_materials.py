"""The port's dispersive materials against ``torcwa_tpu.materials``.

The same tables go through both packages on the CPU in float64: n, k, the
permittivity and its derivative in the wavelength at 20 wavelengths (some
outside the table, where both clamp) within 1e-12; then one class solve
with an a-Si:H layer through both packages (complex128, order (2, 2), eig by
LAPACK on both sides) within 1e-9.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torcwa_tpu as tt  # noqa: E402
from torcwa_tpu import materials as jm  # noqa: E402
import torcwa_tpu_torch as tp  # noqa: E402
from torcwa_tpu_torch import materials as pm  # noqa: E402

# 20 wavelengths in nm; the table covers 300-1000
LAMS = np.concatenate([[150., 299.5, 300., 1000., 1000.5, 1500.],
                       np.linspace(310., 990., 14) + 0.37])


def _jax_and_port(make):
    return make(jm, {}), make(pm, {'device': 'cpu'})


def _check(mj, mp, lams=LAMS):
    lam_t = torch.tensor(lams, requires_grad=True)
    for name in ('n', 'k'):
        ref = np.asarray(getattr(mj, name)(jnp.asarray(lams)))
        got = getattr(mp, name)(lam_t).detach().numpy()
        assert np.abs(got - ref).max() <= 1e-12, name
    eps_j = np.asarray(mj.eps(jnp.asarray(lams)))
    eps_t = mp.eps(lam_t)
    assert eps_t.dtype == torch.complex128
    assert np.abs(eps_t.detach().numpy() - eps_j).max() <= 1e-12
    for part in (jnp.real, jnp.imag):
        dj = np.asarray(jax.grad(lambda l: part(mj.eps(l)).sum())(
            jnp.asarray(lams)))
        tpart = torch.real if part is jnp.real else torch.imag
        dt, = torch.autograd.grad(tpart(mp.eps(lam_t)).sum(), lam_t)
        assert np.abs(dt.numpy() - dj).max() <= 1e-12 * max(
            1., np.abs(dj).max())


def test_asih_matches_jax():
    mj, mp = _jax_and_port(lambda m, kw: m.aSiH(**kw))
    _check(mj, mp)


def test_tabulated_from_arrays_matches_jax():
    # unsorted samples, and a table without k
    rng = np.random.default_rng(3)
    lam = rng.permutation(np.linspace(400., 800., 41))
    n = 3.0 + 0.5 * np.sin(lam / 100.)
    k = 0.1 * np.exp(-(lam - 500.) ** 2 / 1e4)
    lams = np.linspace(380., 820., 20)
    for kk in (k, None):
        mj, mp = _jax_and_port(
            lambda m, kw: m.TabulatedMaterial(lam, n, kk, **kw))
        _check(mj, mp, lams)


def test_entry_points_of_the_material(tmp_path):
    path = tmp_path / 'table.txt'
    lam = np.linspace(400., 800., 9)
    np.savetxt(path, np.stack([lam, 2. + lam / 1e3, lam / 1e4], 1),
               header='lambda n k')
    m = pm.TabulatedMaterial.from_file(str(path), device='cpu')
    mj = jm.TabulatedMaterial.from_file(str(path))
    x = torch.tensor([450., 612.5])
    assert x.dtype == torch.float32                # a float32 wavelength
    z = m.nk(x)
    assert torch.equal(m(x), z) and torch.equal(m.apply(x), z)
    assert torch.equal(m.eps(x), z ** 2)
    assert np.abs(z.numpy() - np.asarray(mj.nk(np.array([450., 612.5]))))\
        .max() <= 1e-6
    assert m.wl_min == 400. and m.wl_max == 800.
    with pytest.raises(FileNotFoundError):
        pm.aSiH(path=str(tmp_path / 'missing.txt'), device='cpu')
    assert tp.aSiH is pm.aSiH and tp.TabulatedMaterial is pm.TabulatedMaterial
    if not torch.cuda.is_available():
        # no device given: the card, which this host lacks
        with pytest.raises((RuntimeError, AssertionError)):
            pm.aSiH()


def test_class_solve_with_asih_matches_jax():
    lam = 532.
    g = tt.geometry(Lx=300., Ly=300., nx=32, ny=32, edge_sharpness=500.,
                    dtype=jnp.float64)
    occ = np.asarray(g.rectangle(160., 160., 150., 150.))
    out = []
    for mod, mat, kw in ((tt, jm.aSiH(), dict(dtype=jnp.complex128)),
                         (tp, pm.aSiH(device='cpu'),
                          dict(dtype=torch.complex128, device='cpu',
                               eig_backend='torch'))):
        si = complex(np.asarray(mat.eps(lam)))
        sim = mod.rcwa(freq=1 / lam, order=[2, 2], L=[300., 300.], **kw)
        sim.add_input_layer(eps=1.46 ** 2)
        sim.set_incident_angle(0.1, 0.)
        sim.add_layer(thickness=300., eps=occ * si + (1 - occ))
        sim.solve_global_smatrix()
        out.append(np.asarray(sim.S_parameters([[0, 0], [1, 0]],
                                               polarization='xx')))
    assert np.abs(out[0] - out[1]).max() <= 1e-9
