"""Sweeps split over the devices of a 1-D mesh.

Counterpart of ``torcwa_tpu/parallel/sweep.py``.  The JAX package vmaps a
per-point function and shards the vmapped axis over a device mesh; the
port's solve already takes a batch (``solve_stack_pair``'s frequencies and
rasters), so here ``fn`` and ``loss_fn`` take a *batch* of points, not one:
the hand-written kernels' ``autograd.Function``s have no vmap rule, so
``torch.func.vmap`` cannot stand in for ``jax.vmap``.  The leading axis is
padded to a multiple of the device count by repeating the last point, cut
into equal contiguous chunks, one for each device, and each chunk is run
on its device in turn; the results are gathered on the first device and
the padding stripped.  A mesh may name a device more than once
(``['cuda:0'] * 2``), which runs the same split on one card.
"""

from typing import NamedTuple

import torch
import torch.utils._pytree as pytree

__all__ = ['sweep_mesh', 'shard_sweep', 'sweep_and_grad']


class SweepMesh(NamedTuple):
    """The devices a sweep is split over, in order; one axis, 'sweep'."""
    devices: tuple
    axis_names: tuple = ('sweep',)


def sweep_mesh(devices=None):
    """1-D mesh over every CUDA device (``torch.cuda.device_count()`` of
    them) or over the given devices; with no CUDA device and none given it
    raises, so that no sweep falls back to the CPU unasked."""
    if devices is None:
        count = torch.cuda.device_count()
        if not count:
            raise RuntimeError('sweep_mesh: no CUDA device; pass devices= '
                               "(e.g. ['cpu']) to sweep elsewhere")
        devices = [torch.device('cuda', i) for i in range(count)]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError('sweep_mesh: no devices given')
    return SweepMesh(devices)


def _pad(xs, n_dev):
    """Pad the leading axis to a multiple of n_dev by repeating the last
    point; returns (padded, n_real)."""
    n = xs.shape[0]
    pad = (-n) % n_dev
    if pad:
        xs = torch.cat([xs, xs[-1:].expand((pad,) + xs.shape[1:])])
    return xs, n


def _split(xs, mesh):
    """The padded points in equal contiguous chunks, each on its device:
    [(chunk, index of its first point, device)], and the number of real
    points."""
    xs, n = _pad(torch.as_tensor(xs), len(mesh.devices))
    size = xs.shape[0] // len(mesh.devices)
    return [(xs[i * size:(i + 1) * size].to(d), i * size, d)
            for i, d in enumerate(mesh.devices)], n


def shard_sweep(fn, mesh=None):
    """Run ``fn`` over the leading axis of its argument, split over the
    mesh's devices.

    fn(xs) -> a tensor, or a dict, tuple or list of tensors, each with the
    batch of points xs as its leading axis.  Returns run(xs) -> the
    results of every point on the mesh's first device (padding stripped).
    Arguments that are not swept are closed over."""
    mesh = sweep_mesh() if mesh is None else mesh

    def run(xs):
        chunks, n = _split(xs, mesh)
        outs = [pytree.tree_flatten(fn(c)) for c, _, _ in chunks]
        first = mesh.devices[0]
        leaves = [torch.cat([o[0][i].to(first) for o in outs])[:n]
                  for i in range(len(outs[0][0]))]
        return pytree.tree_unflatten(leaves, outs[0][1])

    return run


def sweep_and_grad(loss_fn, mesh=None):
    """Value and gradient of a mean over the sweep, split over the mesh.

    loss_fn(xs, theta) -> a (k,) tensor, the loss of each point of the
    batch xs given the shared parameters theta (a tensor, or a tuple, list
    or dict of them, as ``optim``'s parameters).  Returns run(xs, theta) ->
    (mean loss, gradient w.r.t. theta in theta's structure), both on the
    mesh's first device.  Padding points get weight zero, so the mean is
    exact for any len(xs); each chunk's gradient is taken on its device and
    the chunks' gradients are summed on the first."""
    mesh = sweep_mesh() if mesh is None else mesh

    def run(xs, theta):
        chunks, n = _split(xs, mesh)
        flat, spec = pytree.tree_flatten(theta)
        first = mesh.devices[0]
        total, grads = 0., [0.] * len(flat)
        for c, start, dev in chunks:
            th = [torch.as_tensor(t).detach().to(dev).requires_grad_(True)
                  for t in flat]
            vals = loss_fn(c, pytree.tree_unflatten(th, spec))
            w = (torch.arange(start, start + c.shape[0], device=dev) < n)
            part = (vals * w.to(vals.dtype)).sum() / n
            got = torch.autograd.grad(part, th, allow_unused=True)
            total = total + part.detach().to(first)
            grads = [a + (torch.zeros_like(t) if g is None else g).to(first)
                     for a, g, t in zip(grads, got, th)]
        return total, pytree.tree_unflatten(grads, spec)

    return run
