"""The port's class API ``torcwa_tpu_torch.rcwa`` against ``torcwa_tpu.rcwa``.

The same numpy inputs (rasters made with the JAX package's geometry) go
through the JAX class on the CPU in float64 (eig by host LAPACK, its own
'auto') and through the port's class on the CPU.  complex128 through
``eig_backend='torch'``: S-parameters within 1e-9 absolute; one case
through ``'auto'``, where the eig kernels' plain versions run: within
1e-8; gradients (torch autograd against jax.grad, f64, at a 10 degree
tilt) within 1e-6 relative.  Then the port alone at complex64 against the
goldens of the reference (``tests/golden``), at the JAX golden tests'
atol=4e-3 and, on the dominant orders, within 1e-2 relative.  Order (2, 2)
or (3, 3) against the JAX package; grid 32.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torcwa_tpu as tt  # noqa: E402
import torcwa_tpu_torch as tp  # noqa: E402
from torcwa_tpu_torch import _constants  # noqa: E402
from torcwa_tpu_torch.ops import eig_kernels  # noqa: E402

torch.set_num_threads(2)

L = [300., 300.]
LAM = 500.
GRID = 32
ORDERS = [[0, 0], [1, 0], [0, -1], [1, 1], [-1, 0]]
POLS = ['xx', 'yx', 'xy', 'yy', 'pp', 'sp', 'ps', 'ss']
PORTS = ['transmission', 'reflection']
DIRECTIONS = ['forward', 'backward']
TILT = 10. * np.pi / 180
AZI = 30. * np.pi / 180


def _geo():
    return tt.geometry(Lx=L[0], Ly=L[1], nx=GRID, ny=GRID,
                       edge_sharpness=500., dtype=jnp.float64)


def _rasters():
    g = _geo()
    rect = np.asarray(g.rectangle(160., 100., 150., 150., theta=0.2))
    circ = np.asarray(g.circle(70., 150., 150.))
    return rect, circ


def _mixed(mod, order=(2, 2), angle_layer='input', **kw):
    """Input and output claddings, a lossy patterned layer, a homogeneous
    spacer and a second patterned layer, at 10 deg incidence, 30 deg
    azimuth."""
    rect, circ = _rasters()
    sim = mod.rcwa(freq=1 / LAM, order=list(order), L=L, **kw)
    sim.add_input_layer(eps=1.46 ** 2)
    sim.add_output_layer(eps=1.2 ** 2)
    sim.set_incident_angle(TILT, AZI, angle_layer=angle_layer)
    sim.add_layer(thickness=200., eps=rect * (4.0 + 0.1j) + (1 - rect))
    sim.add_layer(thickness=100., eps=2.56)
    sim.add_layer(thickness=150., eps=circ * 2.0709 ** 2 + (1 - circ))
    sim.solve_global_smatrix()
    return sim


def _magnetic(mod, **kw):
    """Magnetic claddings, a homogeneous magnetic layer and a layer with
    both eps and mu patterned (the golden_magnetic stack at order 2)."""
    rect, _ = _rasters()
    sim = mod.rcwa(freq=1 / 620., order=[2, 2], L=L, **kw)
    sim.add_input_layer(eps=1.46 ** 2, mu=1.2)
    sim.add_output_layer(eps=1.1 ** 2, mu=0.9)
    sim.set_incident_angle(TILT, 35. * np.pi / 180)
    sim.add_layer(thickness=180., eps=2.25, mu=1.6)
    sim.add_layer(thickness=240., eps=rect * (4.2 + 0.25j) + (1 - rect),
                  mu=rect * (1.8 + 0.05j) + (1 - rect) * 1.1)
    sim.solve_global_smatrix()
    return sim


def _port(**kw):
    return dict(dtype=torch.complex128, device='cpu', eig_backend='torch',
                **kw)


@pytest.fixture(scope='module')
def mixed():
    return _mixed(tt, dtype=jnp.complex128), _mixed(tp, **_port())


@pytest.fixture(scope='module')
def magnetic():
    return _magnetic(tt, dtype=jnp.complex128), _magnetic(tp, **_port())


def _sp(sim, pol, port, direction, **kw):
    out = sim.S_parameters(ORDERS, direction=direction, port=port,
                           polarization=pol, **kw)
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


@pytest.mark.parametrize('pol', POLS)
def test_sparams_match_jax(mixed, pol):
    sj, st = mixed
    for port in PORTS:
        for direction in DIRECTIONS:
            ref = _sp(sj, pol, port, direction)
            got = _sp(st, pol, port, direction)
            assert np.abs(got - ref).max() <= 1e-9, (port, direction)
    ref = _sp(sj, pol, 'r', 'f', power_norm=False, ref_order=[1, 0])
    assert np.abs(_sp(st, pol, 'r', 'f', power_norm=False,
                      ref_order=[1, 0]) - ref).max() <= 1e-9


@pytest.mark.parametrize('pol', ['xx', 'yy', 'pp', 'ss'])
def test_angle_layer_output_matches_jax(pol):
    sj = _mixed(tt, angle_layer='o', dtype=jnp.complex128)
    st = _mixed(tp, angle_layer='o', **_port())
    assert st.angle_layer == 'output'
    for port in PORTS:
        for direction in DIRECTIONS:
            assert np.abs(_sp(st, pol, port, direction)
                          - _sp(sj, pol, port, direction)).max() <= 1e-9


@pytest.mark.parametrize('pols', [['xx', 'yx', 'xy', 'yy'],
                                  ['pp', 'sp', 'ps', 'ss']])
def test_magnetic_stack_matches_jax(magnetic, pols):
    sj, st = magnetic
    assert st._layer_is_bd == [True, False]
    for pol in pols:
        for port in PORTS:
            for direction in DIRECTIONS:
                assert np.abs(_sp(st, pol, port, direction)
                              - _sp(sj, pol, port, direction)).max() <= 1e-9


@pytest.mark.parametrize('layer', ['input', 'output'])
@pytest.mark.parametrize('unit', ['rad', 'deg'])
def test_diffraction_angle_matches_jax(mixed, layer, unit):
    sj, st = mixed
    for a, b in zip(sj.diffraction_angle(ORDERS, layer=layer, unit=unit),
                    st.diffraction_angle(ORDERS, layer=layer, unit=unit)):
        assert np.abs(b.numpy() - np.asarray(a)).max() <= 1e-9


def test_return_layer_matches_jax(magnetic):
    sj, st = magnetic
    for k in range(2):
        for a, b in zip(sj.return_layer(k, nx=24, ny=20),
                        st.return_layer(k, nx=24, ny=20)):
            assert b.shape == (24, 20)
            assert np.abs(b.numpy() - np.asarray(a)).max() <= 1e-9


@pytest.mark.parametrize('notation', ['xy', 'ps'])
@pytest.mark.parametrize('direction', DIRECTIONS)
def test_source_fourier_matches_jax(magnetic, notation, direction):
    sj, st = magnetic
    amp = [[1., 0.5j], [0.2, -0.3 + 0.1j]]
    for sim in (sj, st):
        sim.source_fourier(amplitude=amp, orders=[[0, 0], [1, -1]],
                           direction=direction, notation=notation)
    assert st.source_direction == direction
    assert st.E_i.shape == (2 * st.order_N, 1)
    assert np.abs(st.E_i.numpy() - np.asarray(sj.E_i)).max() <= 1e-12


def test_pinv_fallback_matches_jax():
    # a threshold below round-off sends every patterned layer to the
    # Q-based H of the fallback; the default threshold keeps P^-1
    kw = dict(avoid_Pinv_instability=True, max_Pinv_instability=1e-30)
    sj = _mixed(tt, dtype=jnp.complex128, **kw)
    st = _mixed(tp, **_port(**kw))
    low = _mixed(tp, **_port(avoid_Pinv_instability=True))
    assert len(st.Pinv_instability) == len(st.Qinv_instability) == 2
    assert len(sj.Pinv_instability) == 2
    for got, ref in ((st.Pinv_instability, sj.Pinv_instability),
                     (st.Qinv_instability, sj.Qinv_instability)):
        got = np.array([float(x) for x in got])
        ref = np.array([float(x) for x in ref])
        assert np.all(got > 1e-30) and np.all(got < 1e-9)
        assert np.abs(got - ref).max() <= 1e-9
    # the two branches take different H for the same layer...
    i = 0
    assert float((st.layers[i].H_eigvec - low.layers[i].H_eigvec).abs()
                 .max()) > 0
    # ...and give the same S-parameters as the JAX package's fallback
    for pol in ('xx', 'ps'):
        for port in PORTS:
            ref = _sp(sj, pol, port, 'forward')
            assert np.abs(_sp(st, pol, port, 'forward') - ref).max() <= 1e-9
            assert np.abs(_sp(low, pol, port, 'forward') - ref).max() <= 1e-9


def test_auto_backend_runs_the_kernels_plain_versions(mixed):
    # 'auto' means the hand-written kernels; on CPU tensors their wrappers
    # take the plain versions (no launch)
    sj, _ = mixed
    eig_kernels.reset_launch_counts()
    st = _mixed(tp, dtype=torch.complex128, device='cpu', eig_backend='auto')
    assert st.eig_backend == 'kernels'
    assert sum(eig_kernels.LAUNCHES.values()) == 0
    for pol in ('xx', 'pp'):
        for port in PORTS:
            ref = _sp(sj, pol, port, 'forward')
            assert np.abs(_sp(st, pol, port, 'forward') - ref).max() <= 1e-8


def _loss_jax(er, t1, t2):
    sim = tt.rcwa(freq=1 / LAM, order=[2, 2], L=L, dtype=jnp.complex128)
    sim.add_input_layer(eps=1.46 ** 2)
    sim.set_incident_angle(TILT, AZI)
    sim.add_layer(thickness=t1, eps=er)
    sim.add_layer(thickness=t2, eps=2.56)
    sim.solve_global_smatrix()
    t = sim.S_parameters([0, 0], polarization='xx')
    return (jnp.abs(t) ** 2)[0]


def _loss_torch(er, t1, t2):
    sim = tp.rcwa(freq=1 / LAM, order=[2, 2], L=L, **_port())
    sim.add_input_layer(eps=1.46 ** 2)
    sim.set_incident_angle(TILT, AZI)
    sim.add_layer(thickness=t1, eps=er)
    sim.add_layer(thickness=t2, eps=2.56)
    sim.solve_global_smatrix()
    t = sim.S_parameters([0, 0], polarization='xx')
    return (t.real ** 2 + t.imag ** 2)[0]


def test_raster_and_thickness_gradients_match_jax():
    rect, _ = _rasters()
    er = rect * 2.0709 ** 2 + (1 - rect)
    gj = jax.grad(_loss_jax, argnums=(0, 1, 2))(jnp.asarray(er), 200., 100.)
    args = [torch.tensor(er, requires_grad=True),
            torch.tensor(200., dtype=torch.float64, requires_grad=True),
            torch.tensor(100., dtype=torch.float64, requires_grad=True)]
    T = _loss_torch(*args)
    assert abs(T.item() - float(_loss_jax(er, 200., 100.))) <= 1e-9
    gt = torch.autograd.grad(T, args)
    g0 = np.asarray(gj[0])
    assert np.abs(gt[0].numpy() - g0).max() <= 1e-6 * np.abs(g0).max()
    for a, b in zip(gt[1:], gj[1:]):
        assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b))


# ---------------------------------------------------------------------------
# The class's own contract
# ---------------------------------------------------------------------------

def test_backend_names_and_device_default():
    kw = dict(freq=1 / LAM, order=[1, 1], L=L, device='cpu')
    for name, want in (('auto', 'kernels'), ('kernels', 'kernels'),
                       ('qr', 'kernels'), ('torch', 'torch'),
                       ('callback', 'torch')):
        assert tp.rcwa(eig_backend=name, **kw).eig_backend == want
    with pytest.raises(ValueError):
        tp.rcwa(eig_backend='lapack', **kw)
    sim = tp.rcwa(freq=1 / LAM, order=[1, 1], L=L, device='cpu')
    assert sim.eps_in.device.type == 'cpu'
    assert sim.eps_in.dtype == torch.complex64
    if not torch.cuda.is_available():
        # no device given: the card, which this host lacks
        with pytest.raises((RuntimeError, AssertionError)):
            tp.rcwa(freq=1 / LAM, order=[1, 1], L=L)
        with pytest.raises((RuntimeError, AssertionError)):
            tp.rcwa(freq=1 / LAM, order=[1, 1], L=L, device=None)


def test_pair_output_and_broadening_rule():
    sim = _mixed(tp, output='pair', **_port())
    ref = _mixed(tp, **_port())
    re, im = sim.S_parameters(ORDERS, polarization='xx')
    z = ref.S_parameters(ORDERS, polarization='xx')
    assert torch.equal(re, z.real) and torch.equal(im, z.imag)
    keep = tp.Eig.broadening_parameter
    try:
        assert sim._broadening == 'auto'          # the reference default
        tp.Eig.broadening_parameter = 1e-7
        assert sim._broadening == 1e-7
    finally:
        tp.Eig.broadening_parameter = keep


# ---------------------------------------------------------------------------
# IEEE f32 pinned in forward and backward, the caller's setting restored
# ---------------------------------------------------------------------------

_MATMULS = {'mm', 'bmm', 'addmm', 'baddbmm', 'mv', 'addmv', 'dot',
            'linalg_solve', 'linalg_solve_ex', 'linalg_inv', 'linalg_inv_ex',
            'linalg_lu_solve', 'linalg_lu_factor_ex'}


def test_f32_pin_covers_forward_and_backward_and_is_restored():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in _MATMULS:
                self.seen.append((name, _constants._switches()))
            return func(*args, **(kwargs or {}))

    tf32 = (True, True, 'high')
    keep = _constants._switches()
    rect, _ = _rasters()
    try:
        torch.set_float32_matmul_precision('high')
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        assert _constants._switches() == tf32
        er = torch.tensor(rect * 4. + (1 - rect), dtype=torch.float32,
                          requires_grad=True)
        phases = {}
        for name, loss in (
                ('class', lambda: _loss_torch_f32(er)),
                ('simulate_txx', lambda: tp.simulate_txx(
                    tp.StackSpec(order=(2, 2), L=tuple(L), n_layers=1),
                    torch.tensor([1 / 450., 1 / 620.]), er, 300.,
                    1.46 ** 2, eig_backend='torch', inc_ang=TILT).sum())):
            with Record() as fwd:
                T = loss()
            assert _constants._switches() == tf32
            with Record() as bwd:
                g, = torch.autograd.grad(T, er)
            assert _constants._switches() == tf32
            assert bool(torch.isfinite(g).all())
            phases[name] = (fwd.seen, bwd.seen)
        for name, (fwd, bwd) in phases.items():
            for seen in (fwd, bwd):
                names = {n for n, _ in seen}
                assert names & {'mm', 'bmm'} and names & {
                    'linalg_solve_ex', 'linalg_inv_ex', 'linalg_lu_solve',
                    'linalg_lu_factor_ex'}, (name, names)
                bad = [n for n, s in seen if s != (False, False, 'highest')]
                assert not bad, (name, bad)
    finally:
        torch.set_float32_matmul_precision(keep[2])
        torch.backends.cuda.matmul.allow_tf32 = keep[0]
        torch.backends.cudnn.allow_tf32 = keep[1]


def _loss_torch_f32(er):
    sim = tp.rcwa(freq=1 / LAM, order=[2, 2], L=L, device='cpu',
                  eig_backend='torch')
    sim.add_input_layer(eps=1.46 ** 2)
    sim.add_output_layer(eps=1.2 ** 2)
    sim.set_incident_angle(TILT, AZI)
    sim.add_layer(thickness=200., eps=er)
    sim.add_layer(thickness=100., eps=2.56)
    sim.solve_global_smatrix()
    t = sim.S_parameters([0, 0], polarization='xx')
    sim.source_planewave(amplitude=[1., 0.])
    E, _ = sim.field_xz(torch.linspace(0., 300., 4), [-20., 50., 250.], 150.)
    return (t.real ** 2 + t.imag ** 2)[0] + 1e-3 * E[0].abs().sum()


# ---------------------------------------------------------------------------
# Goldens of the reference, complex64 with eig_backend='torch' (LAPACK, as
# the JAX golden tests run theirs)
# ---------------------------------------------------------------------------

SUBSTRATE_EPS = 1.46 ** 2
SU8_EPS = 1.6 ** 2
ORDERS6 = [[0, 0], [1, 0], [0, 1], [-1, 0], [1, 1], [2, 0]]
# a-Si:H eps at the golden wavelengths, as tests/test_golden_solver.py
# records them (the reference's own interpolation of its measured table)
SI_EPS = {
    400.: 16.24464604339499 + 3.9697033465479983j,
    532.: 12.011610263133004 + 0.5259120147560001j,
    650.: 10.362267239174999 + 0.15362360819199997j,
    700.: 9.985966439994998 + 0.11010441325199999j,
}


def _golden_close(ours, ref, atol=4e-3, rel=1e-2):
    """The JAX golden tests' absolute check, and a relative one on the
    dominant orders (amplitude |ref| >= 0.1, 1% of the power or more)."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert np.allclose(ours, ref, atol=atol), np.abs(ours - ref).max()
    dom = np.abs(ref) >= 0.1
    assert np.all(np.abs(ours - ref)[dom] <= rel * np.abs(ref)[dom])


def _port32():
    return dict(dtype=torch.complex64, device='cpu', eig_backend='torch')


def _rcwa_geo(nx=256, sharp=1000.):
    geo = tp.geometry(Lx=L[0], Ly=L[1], nx=nx, ny=nx, edge_sharpness=sharp,
                      dtype=torch.float32, device='cpu')
    return geo


def test_golden_example0_fresnel(golden):
    g = golden('example0')
    angles = g['angles']
    for i in range(0, len(angles), 9):
        sim = tp.rcwa(freq=1 / 532., order=[7, 7], L=L, **_port32())
        sim.add_input_layer(eps=1.46 ** 2)
        sim.set_incident_angle(inc_ang=float(angles[i]), azi_ang=0.)
        sim.solve_global_smatrix()
        for pol, port, key in (('pp', 'reflection', 'r_pp'),
                               ('ss', 'reflection', 'r_ss'),
                               ('pp', 'transmission', 't_pp'),
                               ('ss', 'transmission', 't_ss')):
            ours = complex(sim.S_parameters(orders=[0, 0], port=port,
                                            polarization=pol)[0])
            assert np.allclose(ours, g[key][i], atol=2e-4), (i, key)


def test_golden_example1_sparams(golden):
    g = golden('example1')
    geom = torch.as_tensor(g['geom'])
    for il, lamb0 in enumerate(g['lambs']):
        si = SI_EPS[float(lamb0)]
        sim = tp.rcwa(freq=1 / float(lamb0), order=[5, 5], L=L, **_port32())
        sim.add_input_layer(eps=SUBSTRATE_EPS)
        sim.set_incident_angle(inc_ang=0., azi_ang=0.)
        sim.add_layer(thickness=300., eps=geom * si + (1. - geom))
        sim.solve_global_smatrix()
        for pol in ('xx', 'yy', 'xy', 'yx'):
            for port, pre in (('transmission', 't'), ('reflection', 'r')):
                _golden_close(sim.S_parameters(
                    orders=ORDERS6, port=port, polarization=pol),
                    g[f'{pre}{pol}_{il}'])
        for key, port in ((f'tb_xx_{il}', 'transmission'),
                          (f'rb_xx_{il}', 'reflection')):
            _golden_close(sim.S_parameters(orders=ORDERS6,
                                           direction='backward', port=port,
                                           polarization='xx'), g[key])
        if float(lamb0) == 532.:
            inc, azi = sim.diffraction_angle(ORDERS6, layer='output')
            assert np.allclose(inc.numpy(), g['diff_inc'], atol=1e-5)
            assert np.allclose(azi.numpy(), g['diff_azi'], atol=1e-5)
            eps_rec, _ = sim.return_layer(0, nx=64, ny=64)
            assert np.allclose(eps_rec.numpy(), g['eps_recover'], atol=2e-3)


def test_golden_example1_1_multilayer(golden):
    g = golden('example1_1')
    si = SI_EPS[650.]
    geo = _rcwa_geo()
    mk = lambda th: geo.rectangle(Wx=180., Wy=100., Cx=150., Cy=150.,
                                  theta=th)
    sim = tp.rcwa(freq=1 / 650., order=[3, 3], L=L, **_port32())
    sim.add_input_layer(eps=SUBSTRATE_EPS)
    sim.set_incident_angle(inc_ang=0., azi_ang=0.)
    for th, t in ((0., 200.), (None, 100.), (30 / 180 * np.pi, 200.),
                  (None, 100.), (60 / 180 * np.pi, 200.), (None, 100.)):
        if th is None:
            sim.add_layer(thickness=t, eps=SU8_EPS)
        else:
            geom = mk(th)
            sim.add_layer(thickness=t, eps=geom * si + (1. - geom) * SU8_EPS)
    sim.solve_global_smatrix()
    assert sim._layer_is_bd == [False, True] * 3
    for pol in ('xx', 'yx', 'xy', 'yy'):
        _golden_close(sim.S_parameters(orders=[0, 0], polarization=pol),
                      g[f't{pol}'])


def test_golden_example2_oblique_ps(golden):
    g = golden('example2')
    geom = _rcwa_geo().rectangle(Wx=120., Wy=120., Cx=150., Cy=150.)
    sim = tp.rcwa(freq=1 / 532., order=[4, 4], L=L, **_port32())
    sim.add_input_layer(eps=SUBSTRATE_EPS)
    sim.add_output_layer(eps=1.2 ** 2)
    sim.set_incident_angle(inc_ang=15. * np.pi / 180,
                           azi_ang=20. * np.pi / 180)
    sim.add_layer(thickness=300., eps=geom * SI_EPS[532.] + (1. - geom))
    sim.solve_global_smatrix()
    for pol in ('xx', 'yy', 'pp', 'ss', 'ps', 'sp'):
        for port, pre in (('transmission', 't'), ('reflection', 'r')):
            _golden_close(sim.S_parameters(orders=[[0, 0], [1, 0], [0, -1]],
                                           port=port, polarization=pol),
                          g[f'{pre}{pol}'])
    sim.source_planewave(amplitude=[1., 0.5j], notation='ps')
    assert np.allclose(sim.E_i.numpy(), g['E_i'], atol=1e-4)


def test_golden_magnetic(golden):
    g = golden('magnetic')
    geo = tp.geometry(Lx=L[0], Ly=L[1], nx=192, ny=192, edge_sharpness=1000.,
                      dtype=torch.float32, device='cpu')
    geom = geo.rectangle(150., 110., L[0] / 2., L[1] / 2., theta=0.3)
    sim = tp.rcwa(freq=1 / 620., order=[3, 3], L=L, **_port32())
    sim.add_input_layer(eps=1.46 ** 2, mu=1.2)
    sim.add_output_layer(eps=1.1 ** 2, mu=0.9)
    sim.set_incident_angle(inc_ang=10. * np.pi / 180,
                           azi_ang=35. * np.pi / 180)
    sim.add_layer(thickness=180., eps=2.25, mu=1.6)
    sim.add_layer(thickness=240., eps=geom * (4.2 + 0.25j) + (1. - geom),
                  mu=geom * (1.8 + 0.05j) + (1. - geom) * 1.1)
    sim.solve_global_smatrix()
    for pol in ('xx', 'yy', 'xy', 'yx', 'pp', 'ss'):
        for port, pre in (('transmission', 't'), ('reflection', 'r')):
            _golden_close(sim.S_parameters(orders=[[0, 0], [1, 0], [0, -1],
                                                   [1, 1]],
                                           port=port, polarization=pol),
                          g[f'{pre}{pol}'])


def _T_of_R(R, stable, broadening=1e-10):
    """|t_xx|^2 of a cylindrical SiN meta-atom against its radius at
    complex128, as tests/test_grad.py runs it (normal incidence: the
    golden's own setting, differentiated by the reference)."""
    g = tp.geometry(Lx=L[0], Ly=L[1], nx=400, ny=400, edge_sharpness=500.,
                    dtype=torch.float64, device='cpu')
    geom = g.circle(R, L[0] / 2., L[1] / 2.)
    tp.Eig.broadening_parameter = broadening
    sim = tp.rcwa(freq=1 / 473., order=[4, 4], L=L, dtype=torch.complex128,
                  device='cpu', eig_backend='torch', stable_eig_grad=stable)
    sim.add_input_layer(eps=1.46 ** 2)
    sim.set_incident_angle(inc_ang=0., azi_ang=0.)
    sim.add_layer(thickness=600., eps=geom * 2.0709 ** 2 + (1. - geom))
    sim.solve_global_smatrix()
    t = sim.S_parameters(orders=[0, 0], polarization='xx')
    return (t.real ** 2 + t.imag ** 2)[0]


def test_golden_example4_gradients(golden):
    g = golden('example4')
    keep = tp.Eig.broadening_parameter
    try:
        for i, R0 in enumerate(g['R']):
            R = torch.tensor(float(R0), dtype=torch.float64,
                             requires_grad=True)
            T = _T_of_R(R, stable=False)
            dT, = torch.autograd.grad(T, R)
            assert np.isclose(T.item(), g['T_exact'][i], rtol=1e-4)
            assert np.isclose(float(dT), g['dTdR_exact'][i], rtol=1e-3)
            assert np.isclose(float(dT), g['dTdR_fd'][i], rtol=5e-3)
            R = torch.tensor(float(R0), dtype=torch.float64,
                             requires_grad=True)
            dTb, = torch.autograd.grad(_T_of_R(R, stable=True), R)
            assert np.isclose(float(dTb), g['dTdR_broad'][i], rtol=1e-3)
    finally:
        tp.Eig.broadening_parameter = keep
