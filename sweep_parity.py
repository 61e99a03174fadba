"""The reference's full sweeps on one CUDA card through the port's examples
(examples/torch/), each through the eig kernels and through
``torch.linalg.eig`` (``eig_backend='torch'``, complex64):

    python3 sweep_parity.py [ex1] [ex11] [ex3]      (default: all three)

ex1   Example 1 at order (15, 15) (2N = 1922), 61 wavelengths 400-700 nm,
      grid 300, in batches of 2 wavelengths (the large route);
ex11  Example 1-1 at orders 0-22 (2N = 2 to 4050), three patterned layers a
      solve;
ex3   Example 3 at order (20, 20) (2N = 3362), the 11 x 11 (Wx, Wy) grid,
      grid 300, in batches of 4 points (the large route).

Each run prints its s/solve (host clock around the sweep, the results
read back), the stage split of the eig (``utils.StageTimer`` over each
stage of the eig routes: hess, qr, vec, refine; and the whole eig
forward), the peak device memory above what was held before it, and the
card's name and power limit; the two backends' results are compared (|t|^2, and
Example 1-1's TRR + TLR + TRL + TLL <= 1 + 1e-4).  The first batch of each
run is solved once before the clock starts (the kernels' first launches).
Needs no JAX and no network; allow ~40 minutes for all three.
"""

import sys
import time

import numpy as np

import chip_smoke as cs

BACKENDS = ('kernels', 'torch')


def timed(torch, label, backend, fn, n_solves, reports=True):
    """Run fn() under the eig stage timers: (result, s/solve, stages,
    whole, peak GB); with ``reports`` the timers' reports are printed."""
    from torcwa_tpu_torch.utils import StageTimer
    stages, whole = StageTimer(), StageTimer()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with cs.timed_eig_stages(torch, stages, whole):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    print(f'  {label}, {backend}: {n_solves} solves in {dt:.3f} s, '
          f'{dt / n_solves:.6f} s/solve; peak memory {peak:.3f} GB above '
          f'what was held [{cs.smi_line()}]')
    if reports:
        for name, t in (('the whole eig forward', whole),
                        ('its stages', stages if backend == 'kernels'
                         else None)):
            if t is not None:
                print(f'    {name}:\n      ' +
                      t.report().replace('\n', '\n      '))
    return out, dt / n_solves, stages, whole, peak


def versus_library(T, res):
    """|t|^2 and s/solve through the kernels beside the library's."""
    dT = np.abs(T['kernels'] - T['torch']).max()
    print(f'  max |dT| kernels - torch.linalg.eig {dT:.2e}; library '
          f'{res["torch"][1]:.6f} s/solve, the kernels '
          f'{res["kernels"][1] / res["torch"][1]:.2f}x of it')


def ex1(torch, dev):
    ex = cs.load_example('example1_wavelength_sweep')
    order, lams = (15, 15), np.linspace(400., 700., 61)
    n = 2 * (2 * order[0] + 1) ** 2
    geom = ex.build_geom(300, dev)
    freqs = torch.as_tensor(1. / lams, dtype=torch.float32, device=dev)
    print(f'  Example 1: order {order} (n = {n}), {len(lams)} wavelengths, '
          f'grid 300, batches of {ex.CHUNK}')
    res = {}
    for backend in BACKENDS:
        ex.sweep(freqs[:ex.CHUNK] * 1.0003, geom, order, backend)
        res[backend] = timed(
            torch, 'Example 1', backend,
            lambda: ex.sweep(freqs, geom, order, backend, ex.CHUNK),
            len(lams))
    T = {k: v[0] for k, v in res.items()}
    print(f'  |t_xx|^2 kernels {np.round(T["kernels"], 5).tolist()}')
    versus_library(T, res)


def ex11(torch, dev):
    ex = cs.load_example('example1_1_multilayer')
    sums = {}
    for backend in BACKENDS:
        rows, per = [], []
        ex.t_elements(3, dev, eig_backend=backend)        # first launches
        for order_n in range(23):
            n = 2 * (2 * order_n + 1) ** 2
            t, s, stages, _, pk = timed(
                torch, f'Example 1-1 order {order_n} (n = {n})', backend,
                lambda: ex.t_elements(order_n, dev, eig_backend=backend), 1,
                reports=order_n in (0, 12, 22))
            rows.append((order_n,) + ex.circular(*t))
            per.append((n, s, pk))
        sums[backend] = rows
        print(f'  Example 1-1, {backend}: s/solve by n ' + ', '.join(
            f'{n}: {s:.4f}' for n, s, _ in per) + '; peak GB by n ' +
            ', '.join(f'{n}: {p:.3f}' for n, _, p in per))
    print(f'{"order":>6} {"TRR":>9} {"TLR":>9} {"TRL":>9} {"TLL":>9}'
          f' {"sum":>9}  (kernels; max |d| from torch.linalg.eig)')
    for a, b in zip(sums['kernels'], sums['torch']):
        d = max(abs(x - y) for x, y in zip(a[1:], b[1:]))
        print(f'{a[0]:6d} ' + ' '.join(f'{x:9.5f}' for x in a[1:])
              + f' {sum(a[1:]):9.5f}  {d:.1e}')
    worst = max(sum(r[1:]) for r in sums['kernels'])
    print(f'  largest TRR + TLR + TRL + TLL through the kernels {worst:.6f} '
          f'({"<=" if worst <= 1 + 1e-4 else ">"} 1 + 1e-4)')


def ex3(torch, dev):
    ex = cs.load_example('example3_parameter_sweep')
    order, nw = (20, 20), 11
    n = 2 * (2 * order[0] + 1) ** 2
    w, pts = ex.grid_points(nw)
    kw = dict(order=order, grid=300, device=dev)
    print(f'  Example 3: order {order} (n = {n}), {nw} x {nw} points, grid '
          f'300, batches of {ex.CHUNK}')
    res = {}
    for backend in BACKENDS:
        ex.sweep(pts[:ex.CHUNK] + 0.01, eig_backend=backend, **kw)
        res[backend] = timed(
            torch, 'Example 3', backend,
            lambda: ex.sweep(pts, ex.CHUNK, eig_backend=backend, **kw),
            len(pts))
    T = {k: np.abs(v[0]) ** 2 for k, v in res.items()}
    print('  |t00|^2 over the grid (kernels):')
    print(np.round(T['kernels'].reshape(nw, nw), 4))
    versus_library(T, res)


def main():
    import torch
    if not torch.cuda.is_available():
        print('sweep_parity: CUDA is not available', file=sys.stderr)
        return 2
    from torcwa_tpu_torch.ops import _build
    dev = torch.device('cuda', 0)
    runs = {'ex1': ex1, 'ex11': ex11, 'ex3': ex3}
    which = sys.argv[1:] or list(runs)
    print(f'card: {cs.smi_line()}; torch {torch.__version__}')
    _build.load()
    for k in which:
        cs.phase(k)
        runs[k](torch, dev)
    return 0


if __name__ == '__main__':
    sys.exit(main())
