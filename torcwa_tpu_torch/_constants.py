"""Physical constants, dtype policy and the scoped f32 precision pin.

Counterpart of ``torcwa_tpu/_constants.py``.  Units follow the upstream
torcwa: Lorentz-Heaviside, c = eps0 = mu0 = 1, time-harmonic exp(-j w t).

``PI_REF`` keeps the upstream torcwa's dropped digit (3.141592652589793
instead of 3.14159265358979...) on purpose, so that float64 runs agree
with the reference and with the JAX package bit for bit in omega.
"""

import contextlib
import functools
import threading
import warnings

import torch
import torch.utils._pytree as pytree

PI_REF = 3.141592652589793
PI = 3.14159265358979323846
RAD2DEG = 180.0 / PI_REF


def validate_sim_dtype(dtype):
    """complex64 or complex128; anything else warns and falls back to
    complex64 (upstream torcwa semantics)."""
    if dtype is None:
        return torch.complex64
    if dtype not in (torch.complex64, torch.complex128):
        warnings.warn('Invalid simulation data type. Set as complex64.',
                      UserWarning)
        return torch.complex64
    return dtype


def real_dtype_of(cdtype):
    return torch.float32 if cdtype == torch.complex64 else torch.float64


def complex_dtype_of(rdtype):
    return torch.complex64 if rdtype == torch.float32 else torch.complex128


def _switches():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


@contextlib.contextmanager
def f32_pinned():
    """Full IEEE f32 in every matmul and convolution inside the scope.

    TF32 keeps ~10 mantissa bits: reduced-precision products stall QR
    deflation and corrupt eigenvectors, and the repeated inverses of the
    S-matrix algebra amplify the error.  The three switches (TF32 for
    cuBLAS matmuls and for cuDNN, the float32 matmul precision) are
    process-wide: the scope saves the caller's values and restores them on
    exit, so two threads that enter it at once see each other's setting."""
    saved = _switches()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    try:
        yield
    finally:
        # the precision first: setting it also sets the matmul TF32 switch
        torch.set_float32_matmul_precision(saved[2])
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]


def f32_precision_pinned():
    """True where the three switches read IEEE f32 (inside a scope of
    :func:`f32_pinned`, or where the caller set them so)."""
    return _switches() == (False, False, 'highest')


# set while a pinned function builds its inner graph: a pinned function
# called there runs plainly, since the outer one's backward is pinned too
_INSIDE = threading.local()


class _Pinned(torch.autograd.Function):
    """Runs fn on detached copies of its tensor inputs, building an inner
    graph inside the pin; the backward takes the gradient of that graph
    inside the pin too, so torch's own backward ops (the transposed
    solves, inverses and matmuls) run in IEEE f32 as well."""

    @staticmethod
    def forward(ctx, fn, flat, spec, idx, box, *tensors):
        ctx.set_materialize_grads(False)
        need = ctx.needs_input_grad[5:]
        ins = [t.detach().requires_grad_() if g else t
               for t, g in zip(tensors, need)]
        flat = list(flat)
        for i, t in zip(idx, ins):
            flat[i] = t
        args, kwargs = pytree.tree_unflatten(flat, spec)
        _INSIDE.depth = getattr(_INSIDE, 'depth', 0) + 1
        try:
            with torch.enable_grad(), f32_pinned():
                out = fn(*args, **kwargs)
        finally:
            _INSIDE.depth -= 1
        leaves, box['spec'] = pytree.tree_flatten(out)
        box['leaves'] = leaves
        box['idx'] = [i for i, x in enumerate(leaves)
                      if isinstance(x, torch.Tensor)]
        outs = [leaves[i] for i in box['idx']]
        ctx.ins = [t for t, g in zip(ins, need) if g]
        ctx.need = need
        ctx.outs = outs
        res = tuple(o.detach() for o in outs)
        ctx.mark_non_differentiable(
            *[r for r, o in zip(res, outs) if not o.requires_grad])
        return res

    @staticmethod
    def backward(ctx, *grads):
        pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                 if g is not None and o.requires_grad]
        got = iter([None] * len(ctx.ins))
        if pairs and ctx.ins:
            with f32_pinned():
                got = iter(torch.autograd.grad(
                    [o for o, _ in pairs], ctx.ins, [g for _, g in pairs],
                    allow_unused=True))
        return (None,) * 5 + tuple(next(got) if g else None
                                   for g in ctx.need)


def pinned(fn):
    """Decorator: fn runs inside :func:`f32_pinned`, and so does the
    backward of everything it computes.  Its arguments and result may be
    nested lists, tuples, named tuples and dicts; every tensor among them
    is an input or an output of the pinned graph."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        flat, spec = pytree.tree_flatten((args, kwargs))
        idx = [i for i, x in enumerate(flat) if isinstance(x, torch.Tensor)]
        tensors = [flat[i] for i in idx]
        if getattr(_INSIDE, 'depth', 0) or not (
                torch.is_grad_enabled()
                and any(t.requires_grad for t in tensors)):
            with f32_pinned():
                return fn(*args, **kwargs)
        box = {}
        outs = _Pinned.apply(fn, flat, spec, idx, box, *tensors)
        leaves = list(box['leaves'])
        for i, o in zip(box['idx'], outs):
            leaves[i] = o
        return pytree.tree_unflatten(leaves, box['spec'])
    return wrapped
