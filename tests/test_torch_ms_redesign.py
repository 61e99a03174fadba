"""The chase and the slab products of ``schur_ms`` as the card runs them,
and three calls that the JAX package answers, on the CPU.

On the card the chase's step loop rotates H alone and records its
rotations; the window's unitary U is formed from them after the last
step.  Here the plain versions of both halves (``chase_plain`` with a
``rotations`` list, ``window_unitary_plain``) are held to the plain chase
that carries U step by step, bit for bit; the three slab products of an
applied transform, one launch on the card, to the three products one
after another; the card's chase check (``chip_smoke.chase_sweep_check``)
to a chase that leaves the active block wrongly.  Then ``fold='auto'``,
``max_pinv_instability``, ``sparam_xy_pair``'s ``mu_in`` / ``mu_out`` and
``device=None`` against the JAX package.  Inputs are made with numpy from
a seed.
"""

import inspect
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torcwa_tpu import fmm as jf  # noqa: E402
import torcwa_tpu_torch as tp  # noqa: E402
from torcwa_tpu_torch import convert  # noqa: E402
from torcwa_tpu_torch.ops import eig_kernels as ek  # noqa: E402
from torcwa_tpu_torch.ops import schur_ms as sm  # noqa: E402

torch.set_num_threads(2)

L = (300., 300.)


def _hessenberg(n, seed, dtype):
    rng = np.random.default_rng(seed)
    a = 0.3 * (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    H, _ = ek.hessenberg_plain(torch.as_tensor(a.astype(dtype))[None])
    return H[0]


# ---------------------------------------------------------------------------
# the window unitary formed after the chase
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [np.complex64, np.complex128])
@pytest.mark.parametrize('n', [96, 150])
def test_window_unitary_from_the_rotations_is_the_carried_one(n, dtype):
    # one sweep with AED's shifts, m = 8 bulges, windows of 128 rows: one
    # window at n = 96, two overlapping ones at n = 150.  Path A carries U
    # through chase_plain's step loop; path B is ms_chase on CPU tensors
    # (chase_plain recording the rotations, then window_unitary_plain).
    # Both apply the same operations in the same order: torch.equal
    m, kw, wb = 8, 24, 128
    H = _hessenberg(n, n, dtype)
    lo, hi = sm.band_scan_plain(H, n - 1, 4.0)
    _, _, _, shifts, _ = sm.aed_plain(H.clone(), lo, hi, m, kw, 4.0, False)
    Ha, Hb = H.clone(), H.clone()
    xs = torch.zeros(m, dtype=H.dtype)
    ys = torch.zeros_like(xs)
    xy = torch.zeros(2 * m, dtype=H.dtype)
    windows = list(sm.chase_windows(n, lo, hi, m, wb))
    assert len(windows) == (1 if n <= wb else 2)
    for a, wbe, tcur, t_end in windows:
        Ua = torch.eye(wbe, dtype=H.dtype)
        xs, ys = sm.chase_plain(Ha, shifts, xs, ys, a, wbe, tcur, t_end, lo,
                                hi, U=Ua)
        Ub = torch.full((wbe, wbe), float('nan'), dtype=H.dtype)
        sm.ms_chase(Hb, shifts, xy, a, wbe, tcur, t_end, lo, hi, Ub)
        assert torch.equal(Ha, Hb)
        assert torch.equal(Ua, Ub)
        assert torch.equal(xy, torch.cat([xs, ys]))
        eye = torch.eye(wbe, dtype=H.dtype)
        tol = 1e-5 if dtype == np.complex64 else 1e-13
        assert float((Ua.mH @ Ua - eye).abs().max()) <= tol
        for X in (Ha, Hb):
            X[a:a + wbe, a + wbe:] = Ua @ X[a:a + wbe, a + wbe:]
            X[:a, a:a + wbe] = X[:a, a:a + wbe] @ Ua.mH
    # the whole sweep was chased: H changed and is Hessenberg again
    assert not torch.equal(Ha, H)
    assert float(torch.tril(Ha, -2).abs().max()) == 0


def test_plain_chase_holds_float32_round_off_for_a_few_steps_only():
    # why the card's chase check holds the kernel to the plain float32
    # chase within a multiple of float32 round-off, measured as the plain
    # float32 chase's distance from float64, and not within 1e-5: the
    # same chase in float32 and in float64 (m = 24 bulges with AED's
    # shifts, the first 128-row window of a random n = 640 matrix) parts
    # by less than 1e-5 of max|H| after 8 steps and by more after the
    # window's 126, while the float32 U keeps the similarity to 1e-5
    n, m, wb = 640, 24, 128
    H = _hessenberg(n, 64, np.complex128)
    lo, hi = sm.band_scan_plain(H, n - 1, 4.0)
    shifts = sm.aed_plain(H.clone(), lo, hi, m, sm.AED_KW, 4.0, False)[3]
    a, wbe, tcur, t_end = next(sm.chase_windows(n, lo, hi, m, wb))
    e = a + wbe
    scale = float(H.abs().max())
    for last, apart in ((tcur + 7, False), (t_end, True)):
        out = []
        for dt in (torch.complex64, torch.complex128):
            Hx, U = H.to(dt, copy=True), torch.empty(wbe, wbe, dtype=dt)
            sm.ms_chase(Hx, shifts.to(dt), torch.zeros(2 * m, dtype=dt), a,
                        wbe, tcur, last, lo, hi, U)
            out.append((Hx.to(torch.complex128), U.to(torch.complex128)))
        (H32, U32), (H64, _) = out
        assert (float((H32 - H64).abs().max()) > 1e-5 * scale) == apart
        W = H.to(torch.complex64).to(torch.complex128)[a:e, a:e]
        assert float((U32 @ W @ U32.mH - H32[a:e, a:e]).abs().max()) \
            <= 1e-5 * scale


def _chase_sweep_check():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import chase_sweep_check
    return chase_sweep_check


def _exit_fault(fault):
    """ms_chase with a fault in the sweep's last window, where the bulges
    leave the active block: its last step left out, or the block's bottom
    taken a row too high."""
    chase = sm.ms_chase

    def faulty(H, shifts, xy, a, wbe, tcur, t_end, lo, hi, U):
        if a + wbe == H.shape[-1]:
            if fault == 'last step':
                t_end -= 1
            else:
                hi -= 1
        return chase(H, shifts, xy, a, wbe, tcur, t_end, lo, hi, U)
    return faulty


@pytest.mark.parametrize('fault', [None, 'last step', 'bottom'])
def test_chase_check_catches_a_wrong_exit(monkeypatch, fault):
    # the card's check of ms_chase (chip_smoke.chase_sweep_check) on the CPU,
    # where ms_chase is the plain chase: a sound chase passes with no
    # difference from the plain float32 chase; one that mishandles the
    # bulges' exit at the bottom of the active block fails
    check = _chase_sweep_check()
    H = _hessenberg(300, 5, np.complex64)
    if fault:
        monkeypatch.setattr(sm, 'ms_chase', _exit_fault(fault))
    rows, ok = check(torch, sm, H, 24, 128)
    assert ok == (fault is None)
    steps = [r for r in rows if ' steps ' in r[0] and ' - ' not in r[0]]
    if fault is None:
        assert all(err == 0 for _, err, _, _ in steps)
    else:
        # the sweep's last steps part from the plain chase by far more
        # than any round-off
        assert max(err for w, err, _, _ in rows if w.startswith('sweep steps')
                   ) > 1e3 * max(lim for _, _, _, lim in steps)


def test_chase_windows_cover_every_step_once():
    # the schedule the sweep loop and the card check share: windows at
    # multiples of ALIGN, consecutive steps, the last step of the chase
    # t_final = hi - 1 + 2 (m - 1) in the last window, which reaches row n
    for n, lo, hi, m, wb in ((640, 0, 639, 24, 128), (640, 130, 611, 32, 192),
                             (96, 5, 90, 8, 128)):
        ws = list(sm.chase_windows(n, lo, hi, m, wb))
        steps = [t for _, _, tcur, t_end in ws for t in range(tcur, t_end + 1)]
        assert steps == list(range(lo, hi - 1 + 2 * (m - 1) + 1))
        assert all(a % sm.ALIGN == 0 and a + wbe <= n for a, wbe, _, _ in ws)
        assert ws[-1][0] + ws[-1][1] == n
        # every step's bulges lie inside its window: rows t - 2 (m - 1) - 1
        # (the column left of the trailing bulge) to t + 2
        for a, wbe, tcur, t_end in ws:
            assert max(tcur - 2 * (m - 1) - 1, lo) >= a
            assert min(t_end + 2, hi) < a + wbe
        # the first window holds at most wb - 2 steps, the others
        # wb - overlap: the rotation list the kernel keeps in shared memory
        assert all(t_end - tcur + 1 <= wb - 2 for _, _, tcur, t_end in ws)


# ---------------------------------------------------------------------------
# the three slab products of an applied transform, one launch on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [np.complex64, np.complex128])
def test_apply_window_plain_is_the_three_slab_products(dtype):
    # a window inside H, an AED transform at the bottom (no slab right of
    # it) and one at the top (no slab above it): ms_apply_window_plain, and
    # ms_apply_window on CPU tensors, equal the product on H's rows of the
    # window right of it, then the products on H's columns above it and on
    # Z's columns, bit for bit
    rng = np.random.default_rng(7)
    n = 200

    def rand(r, c):
        return torch.as_tensor((rng.standard_normal((r, c)) + 1j *
                                rng.standard_normal((r, c))).astype(dtype))

    H, Z = rand(n, n), rand(n, n)
    for a, w in ((64, 96), (150, 50), (0, 128)):
        P = rand(w, w)
        ref_H, ref_Z, e = H.clone(), Z.clone(), a + w
        ref_H[a:e, e:] = P @ ref_H[a:e, e:]
        ref_H[:a, a:e] = ref_H[:a, a:e] @ P.mH
        ref_Z[:, a:e] = ref_Z[:, a:e] @ P.mH
        for fn in (sm.ms_apply_window_plain, sm.ms_apply_window):
            got_H, got_Z = fn(H.clone(), Z.clone(), a, w, P)
            assert torch.equal(got_H, ref_H) and torch.equal(got_Z, ref_Z)
    with pytest.raises(ValueError):
        sm.ms_apply_window(H, Z, 0, 5, P)       # P is not 5 x 5


# ---------------------------------------------------------------------------
# fold='auto', max_pinv_instability, mu_in / mu_out, device=None
# ---------------------------------------------------------------------------

def _stack(order, n_layers, seed):
    rng = np.random.default_rng(seed)
    eps = 1.5 + rng.random((n_layers, 16, 16))
    spec = jf.StackSpec(order=order, L=L, n_layers=n_layers, has_input=True,
                        has_output=True)
    thick = 100. + 50. * rng.random(n_layers)
    return spec, eps, thick


@pytest.mark.parametrize('order,n_layers', [((2, 2), 1), ((1, 1), 8)])
def test_fold_auto_matches_jax(order, n_layers):
    # float64, both sides at fold='auto': the JAX package unrolls one layer
    # and scans eight, the port unrolls both; the Redheffer products are
    # the same in the same order, so the S-matrices agree to 1e-9
    spec, eps, thick = _stack(order, n_layers, 3 + n_layers)
    e_in, e_out = (1.46 ** 2, 0.), (1.2, 0.01)
    S_ref, _ = jax.jit(lambda e: jf.solve_stack_pair(
        spec, jnp.asarray(1 / 530.), jnp.asarray(0.1), jnp.asarray(0.3),
        (e, jnp.zeros(eps.shape)), jnp.asarray(thick),
        eps_in=tuple(map(jnp.asarray, e_in)),
        eps_out=tuple(map(jnp.asarray, e_out)), fold='auto'))(
            jnp.asarray(eps))
    cv = convert.from_jax_pairs(eps_grids=(eps, np.zeros_like(eps)),
                                thicknesses=thick, eps_in=e_in,
                                eps_out=e_out, spec=spec, device='cpu')
    S, _ = tp.solve_stack_pair(cv['spec'], 1 / 530., 0.1, 0.3,
                               cv['eps_grids'], cv['thicknesses'],
                               eps_in=cv['eps_in'], eps_out=cv['eps_out'],
                               fold='auto')
    for blk, (r, i) in zip(S, S_ref):
        ref = np.asarray(r) + 1j * np.asarray(i)
        assert np.abs(blk.numpy() - ref).max() <= 1e-9 * np.abs(ref).max()


def test_keywords_take_the_reference_defaults():
    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty}

    for fn, jfn in ((tp.solve_stack_pair, jf.solve_stack_pair),
                    (tp.sparam_xy_pair, jf.sparam_xy_pair)):
        d, jd = defaults(fn), defaults(jfn)
        for k in ('fold', 'max_pinv_instability', 'mu_in', 'mu_out'):
            if k in jd:
                assert d[k] == jd[k], (fn.__name__, k)


def test_new_keywords_accepted_at_their_defaults_refused_otherwise():
    spec, eps, thick = _stack((1, 1), 1, 9)
    cv = convert.from_jax_pairs(eps_grids=(eps, np.zeros_like(eps)),
                                thicknesses=thick, eps_in=(2.1, 0.),
                                eps_out=(1., 0.), spec=spec, device='cpu')
    args = (cv['spec'], 1 / 530., 0.1, 0.3, cv['eps_grids'],
            cv['thicknesses'])
    kw = dict(eps_in=cv['eps_in'], eps_out=cv['eps_out'])
    S, intr = tp.solve_stack_pair(*args, **kw)
    # without avoid_pinv_instability the threshold is never read
    S2, _ = tp.solve_stack_pair(*args, max_pinv_instability=0.01, **kw)
    for a, b in zip(S, S2):
        assert torch.equal(a, b)
    sp = (S, intr['kx'], intr['ky'], cv['eps_in'], cv['eps_out'], (1, 1),
          [0, 0], [0, 0])
    t = tp.sparam_xy_pair(*sp)
    assert torch.equal(tp.sparam_xy_pair(*sp, mu_in=None, mu_out=None), t)
    # the calls the port once refused, now against the JAX package
    one = (jnp.asarray(1.), jnp.asarray(0.))
    jargs = (spec, jnp.asarray(1 / 530.), jnp.asarray(0.1), jnp.asarray(0.3),
             (jnp.asarray(eps), jnp.zeros(eps.shape)), jnp.asarray(thick))
    jkw = dict(eps_in=(jnp.asarray(2.1), jnp.asarray(0.)), eps_out=one)
    S_ref, ir = jf.solve_stack_pair(*jargs, avoid_pinv_instability=True,
                                    max_pinv_instability=0.01, **jkw)
    cplx = lambda p: np.asarray(p[0]) + 1j * np.asarray(p[1])
    for bad in (dict(mu_in=1.), dict(mu_out=1.)):
        ref = jf.sparam_xy_pair(S_ref, ir['kx'], ir['ky'], jkw['eps_in'],
                                one, (1, 1), [0, 0], [0, 0],
                                **{k: one for k in bad})
        got = tp.sparam_xy_pair(*sp, **bad).numpy()
        assert np.abs(got - cplx(ref)).max() <= 1e-9
    S_p, intr_p = tp.solve_stack_pair(*args, avoid_pinv_instability=True,
                                      max_pinv_instability=0.01, **kw)
    for blk, ref in zip(S_p, S_ref):
        ref = cplx(ref)
        assert np.abs(blk.numpy() - ref).max() <= 1e-9 * np.abs(ref).max()
    for got, ref in zip(intr_p['pinv_instability'],
                        ir['pinv_instability']):
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-12


def test_device_none_means_the_card(monkeypatch):
    # the JAX package's default device=None: the port reads it as 'cuda',
    # its own default; nothing is allocated here
    assert tp.geometry(device=None).device == torch.device('cuda')
    monkeypatch.setattr(tp.rcwa_geo, 'device', None)
    assert tp.rcwa_geo._geo().device == torch.device('cuda')
    monkeypatch.setattr(tp.rcwa_geo, 'device', 'cpu')
    for k in ('x', 'y', 'x_grid', 'y_grid'):     # removed again afterwards
        monkeypatch.setattr(tp.rcwa_geo, k, None, raising=False)
    tp.rcwa_geo.grid()
    assert tp.rcwa_geo.x_grid.device == torch.device('cpu')


# ---------------------------------------------------------------------------
# the empty stack and internals['mu_conv'] against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('inc_deg', [0., 30.])
@pytest.mark.parametrize('order', [(1, 1), (2, 2)])
@pytest.mark.parametrize('claddings', ['output', 'both'])
def test_empty_stack_is_the_claddings_alone(claddings, order, inc_deg):
    # no layer: the JAX package folds the claddings into the identity
    # S-matrix (Example 0 has an output cladding only).  float64; the same
    # interface products in the same order, so the S-blocks agree to 1e-12
    has_in = claddings == 'both'
    spec = jf.StackSpec(order=order, L=L, n_layers=0, has_input=has_in,
                        has_output=True)
    e_in, e_out = (1.46 ** 2, 0.), (1.2, 0.01)
    grids = np.zeros((0, 16, 16))
    kw = dict(eps_out=tuple(map(jnp.asarray, e_out)))
    if has_in:
        kw['eps_in'] = tuple(map(jnp.asarray, e_in))
    inc = np.radians(inc_deg)
    S_ref, intr_ref = jf.solve_stack_pair(
        spec, jnp.asarray(1 / 530.), jnp.asarray(inc), jnp.asarray(0.3),
        (jnp.asarray(grids), jnp.asarray(grids)), jnp.zeros(0),
        eps_scalars=(jnp.zeros(0), jnp.zeros(0)), **kw)
    cv = convert.from_jax_pairs(eps_grids=(grids, grids), thicknesses=[],
                                eps_in=e_in if has_in else None,
                                eps_out=e_out, spec=spec, device='cpu')
    S, intr = tp.solve_stack_pair(cv['spec'], 1 / 530., inc, 0.3,
                                  cv['eps_grids'], cv['thicknesses'],
                                  eps_in=cv.get('eps_in'),
                                  eps_out=cv['eps_out'])
    for blk, (r, i) in zip(S, S_ref):
        ref = np.asarray(r) + 1j * np.asarray(i)
        assert blk.dtype == torch.complex128
        assert blk.shape == ref.shape
        assert np.abs(blk.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    assert set(intr) == set(intr_ref)
    assert not {'kz', 'E', 'H', 'conv', 'mu_conv'} & set(intr)
    # with no grid the claddings give dtype and device
    S2, _ = tp.solve_stack_pair(cv['spec'], 1 / 530., inc, 0.3, None, [],
                                eps_in=cv.get('eps_in'),
                                eps_out=cv['eps_out'])
    for a, b in zip(S, S2):
        assert torch.equal(a, b)


def test_internals_carry_mu_conv_as_the_jax_package_does():
    # mu = 1 in every layer: the identity, (n_layers, N, N), complex
    spec, eps, thick = _stack((2, 2), 2, 5)
    e_in, e_out = (1.46 ** 2, 0.), (1.2, 0.01)
    _, intr_ref = jf.solve_stack_pair(
        spec, jnp.asarray(1 / 530.), jnp.asarray(0.1), jnp.asarray(0.3),
        (jnp.asarray(eps), jnp.zeros(eps.shape)), jnp.asarray(thick),
        eps_in=tuple(map(jnp.asarray, e_in)),
        eps_out=tuple(map(jnp.asarray, e_out)))
    cv = convert.from_jax_pairs(eps_grids=(eps, np.zeros_like(eps)),
                                thicknesses=thick, eps_in=e_in,
                                eps_out=e_out, spec=spec, device='cpu')
    _, intr = tp.solve_stack_pair(cv['spec'], 1 / 530., 0.1, 0.3,
                                  cv['eps_grids'], cv['thicknesses'],
                                  eps_in=cv['eps_in'], eps_out=cv['eps_out'])
    ref = (np.asarray(intr_ref['mu_conv'][0])
           + 1j * np.asarray(intr_ref['mu_conv'][1]))
    assert intr['mu_conv'].dtype == intr['conv'].dtype
    assert intr['mu_conv'].shape == ref.shape == intr['conv'].shape
    assert np.array_equal(intr['mu_conv'].numpy(), ref)
