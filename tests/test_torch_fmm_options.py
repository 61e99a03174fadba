"""The functional path's options against the JAX package, on the CPU.

The same numpy rasters, made from a seed, go through ``torcwa_tpu.fmm`` (on
the CPU at float64, eig by host LAPACK) and ``torcwa_tpu_torch.fmm``
(float64, ``eig_backend='torch'``): a stack that mixes patterned and
homogeneous layers, a magnetic stack with magnetic claddings, the
mode-coupling blocks of ``with_modes``, the P-inverse fallback, the fold
named 'scan' against 'unroll', the ps S-parameters with evanescent orders,
both sources, ``layer_smatrix_pair`` and the two diagnostics aliases; then
the fields of a functional solve (``fields.fmm_field_adapter``) against the
class's.  S-blocks agree to 1e-9 of their largest entry.

Eigenvectors differ between two eig backends by a gauge (a phase per
column, an order, a basis inside a degenerate subspace), and so do the
rows of the mode-coupling blocks C.  The gauge-free products E Cf, E Cb,
H Cf and H Cb (the mode amplitudes turned back into fields) are compared
instead.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torcwa_tpu import fmm as jf  # noqa: E402
import torcwa_tpu_torch as tp  # noqa: E402
from torcwa_tpu_torch import convert  # noqa: E402

torch.set_num_threads(2)

ORDER = (2, 2)
L = (400., 400.)
GRID = 16
LAM = 530.
EPS_SUB = 1.46 ** 2
INC, AZI = 0.1, 0.3


def _rasters(n, seed, lo=1.5):
    rng = np.random.default_rng(seed)
    return lo + rng.random((n, GRID, GRID))


def _jpair(v):
    v = np.asarray(v, np.complex128)
    return jnp.asarray(v.real), jnp.asarray(v.imag)


def _np(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _close(got, ref, tol=1e-9):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), (
        np.abs(got - ref).max(), np.abs(ref).max())


def _solve_both(spec, eps, thick, e_in=EPS_SUB, e_out=None, mu=None,
                eps_s=None, mu_s=None, mu_in=None, mu_out=None, ref=True,
                **kw):
    """The stack through both packages (through the port alone without
    ``ref``); returns (S, intr, S_ref, intr_ref), the JAX side's blocks as
    complex numpy arrays."""
    def jax_solve(e, m):
        return jf.solve_stack_pair(
            spec, jnp.asarray(1 / LAM), jnp.asarray(INC), jnp.asarray(AZI),
            (e, jnp.zeros(e.shape)), jnp.asarray(thick),
            eps_in=_jpair(e_in), eps_out=None if e_out is None else
            _jpair(e_out), mu_grids=None if m is None else
            (m, jnp.zeros(m.shape)), eps_scalars=None if eps_s is None else
            _jpair(eps_s), mu_scalars=None if mu_s is None else _jpair(mu_s),
            mu_in=None if mu_in is None else _jpair(mu_in),
            mu_out=None if mu_out is None else _jpair(mu_out), **kw)
    t = lambda v: None if v is None else torch.as_tensor(
        np.asarray(v, np.complex128))
    S, intr = tp.solve_stack_pair(
        spec, 1 / LAM, INC, AZI, t(eps), torch.as_tensor(thick),
        eps_in=t(e_in), eps_out=t(e_out), eig_backend='torch',
        mu_grids=t(mu), eps_scalars=t(eps_s), mu_scalars=t(mu_s),
        mu_in=t(mu_in), mu_out=t(mu_out), **kw)
    if not ref:
        return S, intr, None, None
    S_ref, intr_ref = jax.jit(jax_solve)(
        jnp.asarray(eps), None if mu is None else jnp.asarray(mu))
    for got, want in zip(S, S_ref):
        _close(got, _np(want))
    return S, intr, [_np(s) for s in S_ref], intr_ref


def _gauge_free(E, H, C):
    """E Cf, E Cb, H Cf, H Cb over both halves of C = (Cf, Cb)."""
    n2 = E.shape[-1]
    return [M @ X[..., h:h + n2, :] for M in (E, H) for X in C
            for h in (0, n2)]


def _spec(n_layers, hom=(), has_output=True, order=ORDER):
    return jf.StackSpec(order=order, L=L, n_layers=n_layers, has_input=True,
                        has_output=has_output, homogeneous=hom)


def test_mixed_stack_and_mode_coupling_blocks_match_jax():
    # patterned, homogeneous (lossy), patterned, with both claddings; the
    # S-blocks with and without modes, the layers' eps and mu convolution
    # matrices, the homogeneous layer's modes, and each layer's C
    spec = _spec(3, (False, True, False))
    eps, thick = _rasters(2, 11), np.array([220., 130., 90.])
    kw = dict(e_out=1.2 + 0.01j, eps_s=[2.5 + 0.05j])
    S, intr, S_ref, ir = _solve_both(spec, eps, thick, with_modes=True, **kw)
    S_nm, _, _, _ = _solve_both(spec, eps, thick, ref=False, **kw)
    for a, b in zip(S, S_nm):
        _close(a, b.numpy())
    for key in ('conv', 'mu_conv'):
        _close(intr[key], _np(ir[key]), 1e-12)
    for key in ('kz', 'E', 'H', 'G', 'D'):       # the homogeneous layer
        _close(intr[key][1], _np(ir[key])[1], 1e-12)
    assert len(intr['C']) == 3 and intr['G'].shape == intr['E'].shape
    for i in range(3):
        ref_C = [_np(c) for c in ir['C'][i]]
        got = _gauge_free(intr['E'][i], intr['H'][i], intr['C'][i])
        ref = _gauge_free(_np(ir['E'])[i], _np(ir['H'])[i], ref_C)
        for a, b in zip(got, ref):
            _close(a, b)


def test_homogeneous_stack_without_tensors_follows_the_device_asked():
    # two homogeneous layers given as Python numbers and a numpy array of
    # eps (complex128: the solve's precision): with device 'cpu' the
    # S-blocks match the JAX package; with no device and no tensor the
    # solve goes to the CUDA card (so it raises without one)
    spec = _spec(2, (True, True))
    thick, eps_s = [120., 75.], np.array([2.25, 3.1 + 0.1j])
    S, _ = tp.solve_stack_pair(spec, 1 / LAM, INC, AZI, None, thick,
                               eps_in=EPS_SUB, eps_out=1.2, eps_scalars=eps_s,
                               device='cpu')
    e0 = jnp.zeros((0, GRID, GRID))
    S_ref, _ = jf.solve_stack_pair(
        spec, jnp.asarray(1 / LAM), jnp.asarray(INC), jnp.asarray(AZI),
        (e0, e0), jnp.asarray(thick), eps_in=_jpair(EPS_SUB),
        eps_out=_jpair(1.2), eps_scalars=_jpair(eps_s))
    for got, want in zip(S, S_ref):
        assert got.device.type == 'cpu'
        _close(got, _np(want))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tp.solve_stack_pair(spec, 1 / LAM, INC, AZI, None, thick,
                                eps_in=EPS_SUB, eps_out=1.2,
                                eps_scalars=eps_s)


def test_magnetic_stack_and_claddings_match_jax():
    # two patterned layers with permeability rasters, magnetic lossy
    # claddings; the S-blocks, mu_conv, and the xy and ps S-parameters
    # with mu_in / mu_out
    spec = _spec(2)
    eps, mu = _rasters(2, 21), _rasters(2, 22, lo=1.0)
    mu_in, mu_out = 1.1, 1.05 + 0.02j
    S, intr, S_ref, ir = _solve_both(
        spec, eps, np.array([150., 200.]), e_out=1.3, mu=mu,
        mu_in=mu_in, mu_out=mu_out)
    _close(intr['mu_conv'], _np(ir['mu_conv']), 1e-12)
    orders = [[0, 0], [1, 0], [0, -1], [1, 1]]
    clad = dict(eps_in=EPS_SUB, eps_out=1.3, mu_in=mu_in, mu_out=mu_out)
    jclad = {k: _jpair(v) for k, v in clad.items()}
    for fn, jfn, pols in ((tp.sparam_xy_pair, jf.sparam_xy_pair,
                           ('xx', 'xy', 'yx', 'yy')),
                          (tp.sparam_ps_pair, jf.sparam_ps_pair,
                           ('pp', 'ss'))):
        for pol in pols:
            for direction, port in (('forward', 'transmission'),
                                    ('backward', 'reflection')):
                got = fn(S, intr['kx'], intr['ky'], clad['eps_in'],
                         clad['eps_out'], ORDER, orders, [0, 0], pol,
                         direction, port, mu_in=clad['mu_in'],
                         mu_out=clad['mu_out'])
                ref = jfn([_jpair(s) for s in S_ref], ir['kx'], ir['ky'],
                          jclad['eps_in'], jclad['eps_out'], ORDER, orders,
                          [0, 0], pol, direction, port,
                          mu_in=jclad['mu_in'], mu_out=jclad['mu_out'])
                np.testing.assert_allclose(got.numpy(), _np(ref), rtol=0,
                                           atol=1e-9)


@pytest.mark.parametrize('threshold', [1e-30, 0.5])
def test_pinv_fallback_and_its_metrics_match_jax(threshold):
    # a threshold below round-off forces H = Q E Kz^-1 in every layer; 0.5
    # keeps H = P^-1 E Kz.  The metrics max|P P^-1 - I| are round-off of
    # two LAPACK inverses: held to 1e-12 absolute
    spec = _spec(2, has_output=False)
    eps = _rasters(2, 31)
    S, intr, _, ir = _solve_both(spec, eps, np.array([150., 250.]),
                                 avoid_pinv_instability=True,
                                 max_pinv_instability=threshold)
    p_ins, q_ins = intr['pinv_instability']
    for got, ref in zip((p_ins, q_ins), ir['pinv_instability']):
        assert got.shape == (2,) and not got.requires_grad
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-12)
    conv = intr['conv'][:, None]
    P, Q = tp.pq_pair(conv, intr['kx'][None], intr['ky'][None])
    E, kz, H = intr['E'], intr['kz'], intr['H']
    want = (Q[:, 0] @ (E / kz[:, None, :]) if threshold < 1e-12 else
            torch.linalg.solve(P[:, 0], E * kz[:, None, :]))
    _close(H, want.numpy(), 1e-10)


def test_scan_fold_matches_unrolled_and_jax_on_eight_layers():
    # eight layers (two homogeneous), modes carried: 'scan' (and 'auto' at
    # 8 layers) against 'unroll', the S-blocks and every layer's C; the JAX
    # package's scan for the S-blocks
    hom = (False, False, True, False, False, True, False, False)
    spec = _spec(8, hom, order=(1, 1))
    eps = _rasters(6, 41)
    thick = 60. + 40. * np.random.default_rng(42).random(8)
    kw = dict(e_out=1.1, eps_s=[2.0, 3.1 + 0.1j], with_modes=True)
    S_scan, i_scan, _, _ = _solve_both(spec, eps, thick, fold='scan', **kw)
    S_un, i_un, _, _ = _solve_both(spec, eps, thick, fold='unroll',
                                   ref=False, **kw)
    S_auto, _, _, _ = _solve_both(spec, eps, thick, fold='auto', ref=False,
                                  **kw)
    for a, b, c in zip(S_scan, S_un, S_auto):
        _close(a, b.numpy(), 1e-12)
        _close(c, b.numpy(), 1e-12)
    for (cf, cb), (uf, ub) in zip(i_scan['C'], i_un['C']):
        _close(cf, uf.numpy(), 1e-12)
        _close(cb, ub.numpy(), 1e-12)
    with pytest.raises(ValueError, match='fold'):
        tp.solve_stack_pair(spec, 1 / LAM, 0., 0., torch.as_tensor(eps),
                            thick, eps_in=EPS_SUB, fold='loop')


def test_sparam_ps_pair_with_evanescent_orders_matches_jax():
    # order (1, 0) is evanescent in the air above and propagates in the
    # substrate; (2, 0) is evanescent in both; the ps basis keeps |Re kz|
    # for evanescent output orders (the reference's quirk), and zeroes
    # everything where the reference order is evanescent
    spec = _spec(1)
    S, intr, S_ref, ir = _solve_both(spec, _rasters(1, 51),
                                     np.array([200.]), e_out=1.)
    orders = [[0, 0], [1, 0], [-1, 0], [2, 0], [0, 1], [1, -1]]
    Sj = [_jpair(s) for s in S_ref]
    for ref_order in ([0, 0], [2, 0]):
        for pol in ('pp', 'ps', 'sp', 'ss'):
            for direction in ('forward', 'backward'):
                for port in ('transmission', 'reflection'):
                    args = (ORDER, orders, ref_order, pol, direction, port)
                    got = tp.sparam_ps_pair(S, intr['kx'], intr['ky'],
                                            EPS_SUB, 1., *args)
                    ref = jf.sparam_ps_pair(Sj, ir['kx'], ir['ky'],
                                            _jpair(EPS_SUB), _jpair(1.),
                                            *args)
                    np.testing.assert_allclose(got.numpy(), _np(ref),
                                               rtol=0, atol=1e-9)
    # a batch of wavelengths: each row is its own scalar-freq solve
    eps_t = torch.as_tensor(_rasters(1, 51))
    freqs = torch.as_tensor([1 / LAM, 1 / 610.], dtype=torch.float64)
    Sb, ib = tp.solve_stack_pair(spec, freqs, INC, AZI, eps_t, [200.],
                                 eps_in=EPS_SUB, eps_out=1.,
                                 eig_backend='torch')
    got = tp.sparam_ps_pair(Sb, ib['kx'], ib['ky'], EPS_SUB, 1., ORDER,
                            orders, [0, 0])
    S1, i1 = tp.solve_stack_pair(spec, 1 / 610., INC, AZI, eps_t, [200.],
                                 eps_in=EPS_SUB, eps_out=1.,
                                 eig_backend='torch')
    _close(got[1], tp.sparam_ps_pair(S1, i1['kx'], i1['ky'], EPS_SUB, 1.,
                                     ORDER, orders, [0, 0]).numpy())


def test_sources_match_jax():
    spec = _spec(1)
    _, intr, _, ir = _solve_both(spec, _rasters(1, 61), np.array([100.]),
                                 e_out=1.2)
    amp = np.array([[1. + 0.5j, -0.3j], [0.2, 0.7 + 0.1j]])
    orders = [[0, 0], [1, -1]]
    clad = dict(eps_in=EPS_SUB, mu_in=1.1, eps_out=1.2, mu_out=None)
    jclad = {k: None if v is None else _jpair(v) for k, v in clad.items()}
    for notation in ('xy', 'ps'):
        for direction in ('forward', 'backward'):
            got = tp.source_fourier_pair(
                ORDER, amp, orders, direction, notation, kx=intr['kx'],
                ky=intr['ky'], rdtype=torch.float64, **clad)
            ref = jf.source_fourier_pair(
                ORDER, amp, orders, direction, notation, kx=ir['kx'],
                ky=ir['ky'], rdtype=jnp.float64, **jclad)
            np.testing.assert_allclose(got.numpy(), _np(ref), rtol=0,
                                       atol=1e-12)
    got = tp.source_planewave_pair(ORDER, [0.6, 0.8j], notation='ps',
                                   kx=intr['kx'], ky=intr['ky'],
                                   eps_in=EPS_SUB, rdtype=torch.float64)
    ref = jf.source_planewave_pair(ORDER, [0.6, 0.8j], notation='ps',
                                   kx=ir['kx'], ky=ir['ky'],
                                   eps_in=_jpair(EPS_SUB),
                                   rdtype=jnp.float64)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=0, atol=1e-12)
    xy = tp.source_planewave_pair(ORDER, rdtype=torch.float64, device='cpu')
    assert xy.dtype == torch.complex128 and xy[12] == 1 and xy.abs().sum() == 1


def test_layer_smatrix_pair_and_aliases_match_jax():
    # one patterned layer alone, with and without modes; the S-blocks are
    # gauge-free.  The aliases: angles of two orders in the substrate, a
    # layer's raster from its convolution matrix
    spec = _spec(1)
    eps = _rasters(1, 71)
    _, intr, _, ir = _solve_both(spec, eps, np.array([180.]), e_out=1.)
    conv = intr['conv'][0]
    Vf_inv = tp.core.bdp_inv(intr['Vf'])
    omega = 2 * tp._constants.PI_REF / LAM
    jconv = (ir['conv'][0][0], ir['conv'][1][0])
    jVf_inv = jf._bdp_inv(ir['Vf'])
    for modes in (True, False):
        got = tp.layer_smatrix_pair(conv, intr['kx'], intr['ky'], Vf_inv,
                                    omega, 180., 'auto', 'torch',
                                    need_modes=modes)
        ref = jax.jit(lambda c, v, m=modes: jf.layer_smatrix_pair(
            c, ir['kx'], ir['ky'], v, jnp.asarray(omega), jnp.asarray(180.),
            'auto', 'auto', need_modes=m))(jconv, jVf_inv)
        assert len(got) == len(ref) == (7 if modes else 5)
        _close(got[0], _np(ref[0]))
        _close(got[1], _np(ref[1]))
    inc, azi = tp.diffraction_angle_pair(intr['kx'], intr['ky'], EPS_SUB, 1.,
                                         [[0, 0], [1, 0]], ORDER, 'degree')
    jinc, jazi = jf.diffraction_angle_pair(ir['kx'], ir['ky'],
                                           _jpair(EPS_SUB), _jpair(1.),
                                           [[0, 0], [1, 0]], ORDER, 'degree')
    np.testing.assert_allclose(inc.numpy(), np.asarray(jinc), atol=1e-10)
    np.testing.assert_allclose(azi.numpy(), np.asarray(jazi), atol=1e-10)
    grid = tp.return_layer_pair(conv, ORDER, 20, 24)
    jgrid = jf.return_layer_pair(jconv, ORDER, 20, 24)
    _close(grid, _np(jgrid), 1e-12)


def test_field_adapter_matches_the_class_fields():
    # a patterned layer, a homogeneous spacer and a second patterned layer
    # between the substrate and air: the functional solve with modes
    # through fmm_field_adapter, and the class on the same stack, on an xz
    # plane through every region and on an xy plane inside layer 2
    eps = _rasters(2, 81)
    thick = [150., 100., 120.]
    spec = tp.StackSpec(order=ORDER, L=L, n_layers=3, has_input=True,
                        has_output=True, homogeneous=(False, True, False))
    e_t = torch.as_tensor(eps, dtype=torch.complex128)
    S, intr = tp.solve_stack_pair(spec, 1 / LAM, INC, AZI, e_t, thick,
                                  eps_in=EPS_SUB, eps_out=1.,
                                  eps_scalars=[2.4], with_modes=True,
                                  eig_backend='torch')
    E_i = tp.source_planewave_pair(ORDER, [1., 0.5j], device='cpu',
                                   rdtype=torch.float64)
    ad = tp.fmm_field_adapter(spec, S, intr, E_i, thick,
                              2 * tp._constants.PI_REF / LAM,
                              eps_in=EPS_SUB, eps_out=1.)
    sim = tp.rcwa(freq=1 / LAM, order=list(ORDER), L=L,
                  dtype=torch.complex128, device='cpu', eig_backend='torch')
    sim.add_input_layer(eps=EPS_SUB)
    sim.add_output_layer(eps=1.)
    sim.set_incident_angle(INC, AZI)
    sim.add_layer(thickness=thick[0], eps=e_t[0])
    sim.add_layer(thickness=thick[1], eps=2.4)
    sim.add_layer(thickness=thick[2], eps=e_t[1])
    sim.solve_global_smatrix()
    sim.source_planewave(amplitude=[1., 0.5j])
    x = np.linspace(0., L[0], 9)
    z = np.linspace(-80., 450., 12)
    for got, ref in ((tp.fields.field_plane(ad, 'xz', x, z, 37.),
                      sim.field_xz(x, z, 37.)),
                     (tp.fields.field_xy(ad, 2, x, x[:5], 40.),
                      sim.field_xy(2, x, x[:5], 40.))):
        for g3, r3 in zip(got, ref):
            for g, r in zip(g3, r3):
                scale = torch.stack(list(r3)).abs().max()
                assert (g - r).abs().max() <= 1e-8 * scale
    _, bare = tp.solve_stack_pair(spec, 1 / LAM, INC, AZI, e_t, thick,
                                  eps_in=EPS_SUB, eps_out=1.,
                                  eps_scalars=[2.4], eig_backend='torch')
    with pytest.raises(ValueError, match='with_modes'):
        tp.fmm_field_adapter(spec, S, bare, E_i, thick, 1.)
