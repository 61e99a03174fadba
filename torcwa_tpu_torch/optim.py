"""Optimisation helpers for shape and topology design loops.

Counterpart of ``torcwa_tpu/optim.py``: the reference notebooks' hand-rolled
ADAM update (README.md:469-511, Examples 5 and 6) and the Gaussian blur and
tanh projection of their fabrication constraints (Example 6, cell 2), as
library functions on tensors.

Parameters are a tensor, or a tuple, list or dict of tensors.  The figure
of merit's value and gradient come from ``torch.autograd.grad``; the update
runs under ``torch.no_grad()``.  Every tensor the optimiser makes lives on
the device of the parameters.
"""

import math
import time
from typing import NamedTuple

import torch
import torch.utils._pytree as pytree

from ._constants import f32_pinned
from .utils import timing

__all__ = ['adam_init', 'adam_update', 'gaussian_blur', 'tanh_projection',
           'IterationRecord', 'maximize_adam']


def adam_init(rho):
    """(m, v, step) moments for a tensor or a tuple, list or dict of
    tensors."""
    return (pytree.tree_map(torch.zeros_like, rho),
            pytree.tree_map(torch.zeros_like, rho), 0)


@torch.no_grad()
def adam_update(rho, grad, m, v, step, lr=0.02, beta1=0.9, beta2=0.999,
                eps=1e-8, lower=0., upper=1., eps_in_sqrt=False):
    """One ADAM step with bias correction and clamping to [lower, upper]
    (the notebooks' ``rho[rho>1]=1`` idiom, functionalised).  Returns
    (rho, m, v, step + 1).

    ``eps_in_sqrt=True`` reproduces the reference notebooks' denominator
    ``sqrt(v_hat + eps)`` (Examples 5 and 6, cell 2) instead of the
    textbook ``sqrt(v_hat) + eps``."""
    step = int(step) + 1
    m = pytree.tree_map(lambda m_, g: beta1 * m_ + (1 - beta1) * g, m, grad)
    v = pytree.tree_map(lambda v_, g: beta2 * v_ + (1 - beta2) * g * g, v,
                        grad)
    bc1 = 1 - beta1 ** step
    bc2 = 1 - beta2 ** step
    if eps_in_sqrt:
        den = lambda v_: torch.sqrt(v_ / bc2 + eps)
    else:
        den = lambda v_: torch.sqrt(v_ / bc2) + eps
    rho = pytree.tree_map(
        lambda r, m_, v_: torch.clamp(r - lr * (m_ / bc1) / den(v_), lower,
                                      upper), rho, m, v)
    return rho, m, v, step


class IterationRecord(NamedTuple):
    """Per-iteration metrics of an optimisation loop, for a callback to
    log, plot or checkpoint (in place of the notebooks' prints)."""
    step: int
    fom: float
    grad_norm: float
    elapsed_s: float
    params: object           # the parameters after the update
    opt_state: object = None  # (m, v, step), for checkpoint and resume


@timing.spanned('adam.value_and_grad')
def _value_and_grad(fom_fn, params, extra):
    leaves, spec = pytree.tree_flatten(params)
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        f = fom_fn(pytree.tree_unflatten(leaves, spec), *extra)
        with timing.span('adam.backward'):
            grads = torch.autograd.grad(f, leaves)
    return f.detach(), pytree.tree_unflatten(list(grads), spec)


def maximize_adam(fom_fn, params0, n_iters, *, lr=0.02, beta1=0.9,
                  beta2=0.999, eps=1e-8, lower=0., upper=1.,
                  lr_schedule=None, callback=None, post_update=None,
                  state=None, eps_in_sqrt=False, fom_args_schedule=None):
    """Gradient-ascent ADAM loop with per-iteration metrics.

    The reference notebooks' loops (Example 5 cell 2, Example 6 cell 2):
    the value and gradient of ``fom_fn(params, *extra)``, bias-corrected
    ADAM ascent, clamping to [lower, upper].  ``lr_schedule(step) -> lr``
    gives a per-iteration learning rate (Example 5's linear decay, Example
    6's cosine); ``fom_args_schedule(step) -> tuple`` the extra arguments
    of ``fom_fn`` (Example 6's binarisation beta), which get no gradient;
    ``post_update(params, step) -> params`` runs after each update
    (Example 6's mirror symmetrisation); ``callback(IterationRecord)``
    after each iteration.  ``state = (params, m, v, step)`` resumes a
    run.  Each iteration runs inside ``_constants.f32_pinned`` and reads
    the host once, for the figure of merit and the gradient norm together.

    Returns (params, (m, v, step), history), history the list of
    (fom, grad_norm) per iteration.
    """
    if state is not None:
        params, m, v, step = state
    else:
        params = params0
        m, v, step = adam_init(params0)
    step = int(step)
    history = []
    t0 = time.time()
    for _ in range(n_iters):
        extra = fom_args_schedule(step) if fom_args_schedule else ()
        lr_t = lr_schedule(step) if lr_schedule is not None else lr
        with timing.span('adam.step'):
            with f32_pinned():
                f, g = _value_and_grad(fom_fn, params, extra)
                with timing.span('adam.update'):
                    params, m, v, step = adam_update(
                        params, pytree.tree_map(torch.neg, g), m, v, step,
                        lr=lr_t, beta1=beta1, beta2=beta2, eps=eps,
                        lower=lower, upper=upper, eps_in_sqrt=eps_in_sqrt)
                    gn = torch.sqrt(sum((x * x).sum()
                                        for x in pytree.tree_leaves(g)))
                    scalars = torch.stack([f.to(gn.dtype), gn])
            if post_update is not None:
                params = post_update(params, step)
            with timing.span('adam.read'):
                fom, gn = scalars.tolist()
        history.append((fom, gn))
        if callback is not None:
            callback(IterationRecord(step=step, fom=fom, grad_norm=gn,
                                     elapsed_s=time.time() - t0,
                                     params=params, opt_state=(m, v, step)))
    return params, (m, v, step), history


def gaussian_blur(rho, sigma_cells):
    """Periodic Gaussian blur of an [nx, ny] density by real FFTs (the
    fabrication-radius filter of Example 6, cell 2)."""
    nx, ny = rho.shape[-2:]
    fx = torch.fft.fftfreq(nx, dtype=rho.dtype, device=rho.device)
    fy = torch.fft.rfftfreq(ny, dtype=rho.dtype, device=rho.device)
    g = torch.exp(-2 * (math.pi ** 2) * (sigma_cells ** 2)
                  * (fx[:, None] ** 2 + fy[None, :] ** 2))
    return torch.fft.irfft2(torch.fft.rfft2(rho) * g, s=(nx, ny))


def tanh_projection(rho, beta, eta=0.5):
    """Smoothed binarisation (Example 6's projection step)."""
    tanh = torch.tanh if isinstance(beta, torch.Tensor) else math.tanh
    num = tanh(beta * eta) + torch.tanh(beta * (rho - eta))
    den = tanh(beta * eta) + tanh(beta * (1 - eta))
    return num / den
