"""The optimisation loop, checkpointing and export, and the two
optimisation examples of the port, against the JAX package on the CPU.

Inputs are made with numpy from a seed and go through ``torcwa_tpu.optim``
/ ``torcwa_tpu.utils`` (float64) and ``torcwa_tpu_torch.optim`` /
``torcwa_tpu_torch.utils``: one ADAM update, a 20-step trajectory on a
closed-form figure of merit with every hook, 3 steps on an RCWA figure of
merit at 10 degrees, the blur and the projection, a checkpoint written by
one package and resumed by the other, and both examples at order (2, 2) on
a small grid.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torcwa_tpu import optim as jo  # noqa: E402
from torcwa_tpu import fmm as jf  # noqa: E402
from torcwa_tpu import utils as ju  # noqa: E402
import torcwa_tpu_torch as tp  # noqa: E402
from torcwa_tpu_torch import optim as to  # noqa: E402
from torcwa_tpu_torch import utils as tu  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize('eps_in_sqrt', [False, True])
def test_adam_update_matches_jax(eps_in_sqrt):
    rng = np.random.default_rng(1)
    rho = {'a': rng.random(7), 'b': rng.random((3, 4))}
    grad = {k: rng.standard_normal(v.shape) for k, v in rho.items()}
    m = {k: 0.1 * rng.standard_normal(v.shape) for k, v in rho.items()}
    v = {k: 0.01 * rng.random(v.shape) for k, v in rho.items()}
    kw = dict(lr=0.3, beta1=0.8, beta2=0.99, eps=1e-6, lower=0.1, upper=0.9,
              eps_in_sqrt=eps_in_sqrt)
    ref = jo.adam_update(*(jax.tree.map(jnp.asarray, x)
                           for x in (rho, grad, m, v)), 4, **kw)
    got = to.adam_update(*(jax.tree.map(_t, x) for x in (rho, grad, m, v)),
                         4, **kw)
    assert got[3] == int(ref[3]) == 5
    for g, r in zip(got[:3], ref[:3]):
        for k in rho:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(r[k]),
                                       rtol=0, atol=1e-10)
    m0, v0, s0 = to.adam_init((_t(rho['a']), [_t(rho['b'])]))
    assert s0 == 0 and float(m0[0].abs().sum() + v0[1][0].abs().sum()) == 0


def _closed_form(asarray, sin):
    """FoM(p, beta) = -sum((p - c)^2) + beta sum(sin(3 p)) on a tuple of
    two parameter arrays, for either package."""
    c = asarray(np.linspace(0.2, 0.8, 5))

    def fom(p, beta):
        return (-((p[0] - c) ** 2).sum() - ((p[1] - 0.5) ** 2).sum()
                + beta * (sin(3 * p[0]).sum() + sin(3 * p[1]).sum()))
    return fom


def test_maximize_adam_trajectory_matches_jax_step_by_step():
    # 20 steps with a learning-rate schedule, a per-step FoM argument, a
    # post-update hook and the notebook's denominator; the FoM, the
    # gradient norm and the parameters at every step within 1e-10
    rng = np.random.default_rng(2)
    p0 = (rng.random(5), rng.random((2, 3)))
    kw = dict(lr_schedule=lambda s: 0.05 * (1 - s / 40),
              fom_args_schedule=lambda s: (0.1 + 0.01 * s,),
              lower=0.05, upper=0.95, eps_in_sqrt=True)
    seen_j, seen_t = [], []
    _, _, hist_j = jo.maximize_adam(
        _closed_form(jnp.asarray, jnp.sin), tuple(map(jnp.asarray, p0)), 20,
        post_update=lambda p, s: (p[0], p[1] * 0.999),
        callback=lambda r: seen_j.append(r), **kw)
    params, (m, v, step), hist_t = to.maximize_adam(
        _closed_form(_t, torch.sin), tuple(map(_t, p0)), 20,
        post_update=lambda p, s: (p[0], p[1] * 0.999),
        callback=lambda r: seen_t.append(r), **kw)
    assert step == 20 and len(hist_t) == 20
    np.testing.assert_allclose(np.array(hist_t), np.array(hist_j), rtol=0,
                               atol=1e-10)
    for rj, rt in zip(seen_j, seen_t):
        assert rj.step == rt.step
        for a, b in zip(rt.params, rj.params):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10)
    assert isinstance(params[0], torch.Tensor) and params[0].dtype == \
        torch.float64


def _rcwa_fom(package):
    """|t_xx(0, 0)|^2 + |t_yy(0, 0)|^2 of one raster layer (the params) on
    glass at order (2, 2), 530 nm, 10 degrees, float64."""
    order, L = (2, 2), (300., 300.)
    if package == 'jax':
        spec = jf.StackSpec(order=order, L=L, n_layers=1)
        sub = (jnp.asarray(2.1316), jnp.asarray(0.))
        one = (jnp.asarray(1.), jnp.asarray(0.))

        def fom(e):
            S, i = jf.solve_stack_pair(
                spec, jnp.asarray(1 / 530.), jnp.asarray(np.deg2rad(10.)),
                jnp.asarray(0.), (e[None], jnp.zeros_like(e)[None]),
                jnp.asarray([250.]), eps_in=sub)
            return sum((lambda t: t[0] ** 2 + t[1] ** 2)(jf.sparam_xy_pair(
                S, i['kx'], i['ky'], sub, one, order, [0, 0], [0, 0], pol))[0]
                for pol in ('xx', 'yy'))
        return jax.jit(fom)
    spec = tp.StackSpec(order=order, L=L, n_layers=1)

    def fom(e):
        S, i = tp.solve_stack_pair(spec, 1 / 530., np.deg2rad(10.), 0.,
                                   e[None], [250.], eps_in=2.1316,
                                   eig_backend='torch')
        return sum(tp.sparam_xy_pair(S, i['kx'], i['ky'], 2.1316, 1., order,
                                     [0, 0], [0, 0], pol)[0].abs() ** 2
                   for pol in ('xx', 'yy'))
    return fom


def test_maximize_adam_on_an_rcwa_fom_matches_jax():
    eps0 = 1.5 + 2 * np.random.default_rng(3).random((16, 16))
    kw = dict(lr=0.05, lower=1., upper=4.)
    pj, _, hj = jo.maximize_adam(_rcwa_fom('jax'), jnp.asarray(eps0), 3,
                                 **kw)
    pt, _, ht = to.maximize_adam(_rcwa_fom('torch'), _t(eps0), 3, **kw)
    np.testing.assert_allclose(np.array(ht), np.array(hj), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=1e-8)


def test_blur_and_projection_match_jax():
    rng = np.random.default_rng(4)
    rho = rng.random((24, 18))
    np.testing.assert_allclose(
        to.gaussian_blur(_t(rho), 2.5).numpy(),
        np.asarray(jo.gaussian_blur(jnp.asarray(rho), 2.5)), atol=1e-12)
    for beta in (3.0, _t(7.5)):
        jb = jnp.asarray(np.asarray(beta))
        np.testing.assert_allclose(
            to.tanh_projection(_t(rho), beta, 0.4).numpy(),
            np.asarray(jo.tanh_projection(jnp.asarray(rho), jb, 0.4)),
            atol=1e-12)


@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_checkpoint_written_by_one_package_resumes_in_both(writer, tmp_path):
    # a 4-step run checkpointed by one package; both load the file and
    # resume 2 steps, and agree with each other to 1e-10.  The schema's
    # markers keep the nested containers and the empty ones
    rng = np.random.default_rng(5)
    p0 = (rng.random(5), rng.random((2, 3)))
    fom_j = _closed_form(jnp.asarray, jnp.sin)
    fom_t = _closed_form(_t, torch.sin)
    beta = lambda s: (0.3,)
    path = str(tmp_path / 'state.npz')
    if writer == 'jax':
        p, (m, v, s), h = jo.maximize_adam(
            fom_j, tuple(map(jnp.asarray, p0)), 4, fom_args_schedule=beta)
        ju.save_state(path, {'p': p, 'm': m, 'v': v, 'step': s,
                             'history': jnp.asarray(h), 'empty': [],
                             'nested': {'t': (), 'l': [jnp.asarray(1.)]}})
    else:
        p, (m, v, s), h = to.maximize_adam(fom_t, tuple(map(_t, p0)), 4,
                                           fom_args_schedule=beta)
        tu.save_state(path, {'p': p, 'm': m, 'v': v, 'step': s,
                             'history': np.asarray(h), 'empty': [],
                             'nested': {'t': (), 'l': [torch.tensor(1.)]}})
    st_t = tu.load_state(path, device='cpu')
    st_j = ju.load_state(path)
    assert st_t['empty'] == [] and st_t['nested']['t'] == ()
    assert isinstance(st_t['p'], tuple) and int(st_t['step']) == 4
    assert st_t['p'][0].device == torch.device('cpu')
    res_t = to.maximize_adam(fom_t, None, 2, fom_args_schedule=beta,
                             state=(st_t['p'], st_t['m'], st_t['v'],
                                    int(st_t['step'])))
    res_j = jo.maximize_adam(fom_j, None, 2, fom_args_schedule=beta,
                             state=(st_j['p'], st_j['m'], st_j['v'],
                                    int(st_j['step'])))
    assert res_t[1][2] == 6
    np.testing.assert_allclose(np.array(res_t[2]), np.array(res_j[2]),
                               atol=1e-10)
    for a, b in zip(res_t[0], res_j[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10)
    with pytest.raises(ValueError, match='separator'):
        tu.save_state(path, {'a/b': 1.})


def test_save_mat_round_trip(tmp_path):
    pytest.importorskip('scipy')
    path = str(tmp_path / 'out.mat')
    data = {'rho': torch.arange(6., dtype=torch.float64).reshape(2, 3),
            'fom': np.array([0.1, 0.2]), 't': torch.tensor([1 + 2j])}
    tu.save_mat(path, data)
    back = tu.load_mat(path)
    np.testing.assert_array_equal(back['rho'], data['rho'].numpy())
    np.testing.assert_array_equal(back['fom'][0], data['fom'])
    np.testing.assert_array_equal(back['t'][0], data['t'].numpy())
    assert ju.load_mat(path)['rho'].shape == (2, 3)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f'torch_{name}', os.path.join(ROOT, 'examples', 'torch',
                                      f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('name,prefix,grid', [
    ('example5_shape_optimization', 'EX5', '120,120'),
    ('example6_topology_optimization', 'EX6', '70,30')])
def test_example_runs_two_steps_on_the_cpu_and_resumes(name, prefix, grid,
                                                       tmp_path, monkeypatch,
                                                       capsys):
    # order (2, 2) on a small grid through the eig kernels' plain versions:
    # two iterations, checkpointed at the last, then one more resumed
    ckpt = str(tmp_path / 'state.npz')
    for k, v in (('ITERS', '2'), ('ORDER', '2,2'), ('GRID', grid),
                 ('DEVICE', 'cpu'), ('CKPT', ckpt)):
        monkeypatch.setenv(f'{prefix}_{k}', v)
    mod = _example(name)
    hist = mod.main()
    assert len(hist) == 2 and os.path.exists(ckpt)
    fom = [h[0] if isinstance(h, tuple) else h for h in hist]
    assert np.all(np.isfinite(fom))
    monkeypatch.setenv(f'{prefix}_ITERS', '3')
    hist = mod.main()
    assert len(hist) == 3 and 'resumed' in capsys.readouterr().out
    st = tu.load_state(ckpt, device='cpu')
    assert int(st['step']) == 3


def _twin(name):
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}', os.path.join(ROOT, 'examples', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Captured(Exception):
    pass


def _twin_loop(twin, monkeypatch):
    """The JAX twin's maximize_adam arguments, taken from its main()."""
    seen = {}

    def capture(fom, params, n_iter, **kw):
        seen.update(kw, params=params)
        raise _Captured

    monkeypatch.setattr(jo, 'maximize_adam', capture)
    with pytest.raises(_Captured):
        twin.main()
    return seen


@pytest.mark.parametrize('name,prefix', [
    ('example5_shape_optimization', 'EX5'),
    ('example6_topology_optimization', 'EX6')])
def test_example_matches_its_jax_twin(name, prefix, tmp_path, monkeypatch):
    # each example's FoM against its JAX twin's on the same inputs at
    # order (2, 2), float64 (the twin's precision and grid set to match),
    # eig by torch.linalg.eig and host LAPACK: within 1e-9 relative; then
    # the loop's settings the twin's main() hands to maximize_adam
    order, grid = (2, 2), ((60, 60) if prefix == 'EX5' else (70, 30))
    monkeypatch.setenv(f'{prefix}_CKPT', str(tmp_path / 'none.npz'))
    twin, port = _twin(name), _example(name)
    for k, v in (('ORDER', order), ('NX', grid[0]), ('NY', grid[1]),
                 ('RDTYPE', jnp.float64),
                 ('SI_RE', jnp.asarray(twin._si.real, jnp.float64)),
                 ('SI_IM', jnp.asarray(twin._si.imag, jnp.float64)),
                 ('SPEC', jf.StackSpec(order=order, L=twin.L, n_layers=1,
                                       has_input=True))):
        monkeypatch.setattr(twin, k, v)
    fom = port.make_fom(order, grid, 'cpu', torch.float64, 'torch')
    rng = np.random.default_rng(7)
    if prefix == 'EX5':
        cases = [(np.array([100., 50.]),), (np.array([173.4, 211.9]),)]
    else:
        BX, BY = twin._blur_matrices()
        monkeypatch.setattr(twin, 'BX', BX)
        monkeypatch.setattr(twin, 'BY', BY)
        for a, b in zip(port.blur_matrices(grid, 'cpu', torch.float64),
                        (BX, BY)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-15)
        cases = [(rng.random(grid), 1.), (rng.random(grid), 37.5)]
    for args in cases:
        want = float(twin.fom(*(jnp.asarray(a) for a in args)))
        got = float(fom(*(_t(a) if isinstance(a, np.ndarray) else a
                          for a in args)))
        assert abs(got - want) <= 1e-9 * abs(want), (got, want)

    seen, kw = _twin_loop(twin, monkeypatch), port.loop_kwargs()
    for k in ('lower', 'upper', 'eps_in_sqrt'):
        assert kw.get(k) == seen[k], k
    steps = range(port.ITER_MAX)
    np.testing.assert_array_equal(
        [kw['lr_schedule'](s) for s in steps],
        [float(seen['lr_schedule'](s)) for s in steps])
    if prefix == 'EX5':
        np.testing.assert_array_equal(
            port.initial_params(grid, 'cpu').numpy(),
            np.asarray(seen['params']))
    else:
        np.testing.assert_array_equal(
            [kw['fom_args_schedule'](s)[0] for s in steps],
            [float(seen['fom_args_schedule'](s)[0]) for s in steps])
        rho = rng.random(grid)
        np.testing.assert_array_equal(
            kw['post_update'](_t(rho), 3).numpy(),
            np.asarray(seen['post_update'](jnp.asarray(rho), 3)))
