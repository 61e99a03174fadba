"""Blocked (compact-WY) Hessenberg reduction of one large matrix.

Counterpart of ``torcwa_tpu/ops/hess_blocked.py`` (LAPACK zgehrd's panel
algorithm, dlahr2 structure), which is plain XLA in the JAX package and
holds no Pallas kernel.  Callers pin IEEE float32
(``_constants.f32_pinned``).

Per panel starting at column k0, width p, trailing size t = n - k0:
  Q_p = P_k0 ... P_k0+p-1 = I - V T V^H                    (compact WY)
  column j of the current matrix, needed to build reflector j:
      u = a0_j - Y (T (V^H e_j)),   Y = A0[k0:, k0:] V     (one GEMV/col)
      c = u - V (T^H (V^H u))
  panel end (all updates touch only rows and columns >= k0):
      A[k0:, k0:] <- M1 - V (T^H (V^H M1)),  M1 = A[k0:, k0:] - Y (T V^H)
      A[:k0, k0:] <- A[:k0, k0:] - (A[:k0, k0:] V) (T V^H)
      Q[:, k0:]   <- Q[:, k0:]   - (Q[:, k0:] V)   (T V^H)
The reflector convention (v = x + phase(x_0) ||x|| e_1, beta = 2/||v||^2)
is that of ``eig_kernels.hessenberg_plain``.

A panel's column loop (V, Y and T) is one launch of the hand-written
kernel ``csrc/hess_panel.cu`` on the card (:func:`hess_panel`): the same
loop in plain torch issued some thirty small launches a column, and the
host's launch rate set the time of the whole stage.  The kernel runs a
persistent grid over the trailing block's rows, two grid barriers a
column; :func:`hess_panel_plain` is the plain model of its schedule, and
:func:`hess_panel_plan` mirrors the grid its C entry point picks.  The
panel-end update stays three ``torch.matmul`` GEMMs (cuBLAS).  A CPU
tensor takes the plain column loop (:func:`_columns`).  A panel's column
loop and its end-of-panel update are the spans ``eig.hess.columns`` and
``eig.hess.update`` (``utils.timing``), so a trace tells the two apart;
``eig.hess`` counts the panels whose column loop ran in the kernel
(``panels``) or in the plain loop (``plain_panels``).
"""

import ctypes
import functools

import torch

from ..utils import timing
from . import _build
from .eig_kernels import LAUNCHES, _raise_on, _stream

__all__ = ['hessenberg_blocked', 'hess_panel', 'hess_panel_plain',
           'hess_panel_plan', 'hess_panel_info', 'MAX_PANEL']

# csrc/hess_panel.cu: threads of a block (warps), the widest panel, the
# fewest rows a block takes, the shared memory a block may use, and an
# H100's SMs (the plan's default)
THREADS = 512
WARPS = THREADS // 32
MAX_PANEL = 128
MIN_ROWS = 16
SMEM_PER_BLOCK = 232448
SMS = 132


def hess_panel_smem_bytes(t, p, rows, vy_smem, stage):
    """Shared memory of one block of the kernel (its ``plan_smem``)."""
    f2 = (p * ((p | 1) + 1) + 6 * p + 1 + THREADS + 3 * rows
          + max(rows, WARPS))
    if vy_smem:
        f2 += 2 * rows * p
    if stage:
        f2 += t
    return 8 * f2


def hess_panel_plan(t, p, sms=SMS):
    """The grid the kernel takes at trailing size t and panel width p on a
    card of ``sms`` SMs, as its C entry point picks it: MIN_ROWS rows a
    block, or as many more as keep to one block a SM (the last block takes
    what is left); the block's rows of V and Y in shared memory where they
    fit beside T and the staged v, else in device memory; v staged where it
    fits, else read from L2.  dict(blocks, rows, smem_bytes, vy_smem,
    stage)."""
    rows = max(MIN_ROWS, -(-t // sms))
    blocks = -(-t // rows)
    vy_smem = hess_panel_smem_bytes(t, p, rows, True, True) \
        <= SMEM_PER_BLOCK
    stage = vy_smem or hess_panel_smem_bytes(t, p, rows, False, True) \
        <= SMEM_PER_BLOCK
    return dict(blocks=blocks, rows=rows, vy_smem=vy_smem, stage=stage,
                smem_bytes=hess_panel_smem_bytes(t, p, rows, vy_smem, stage))


@functools.lru_cache(maxsize=None)
def hess_panel_info(t, p):
    """The grid the kernel launches at trailing size t and panel width p
    on this card, as its C entry point reports it (the keys of
    :func:`hess_panel_plan`; cached, not to be changed)."""
    out = (ctypes.c_int * 5)()
    _raise_on('hess_panel_info',
              _build.load().torcwa_hess_panel_info(t, p, out))
    return dict(blocks=out[0], rows=out[1], smem_bytes=out[2],
                vy_smem=bool(out[3]), stage=bool(out[4]))


def _columns(At, p, cols):
    """The plain column loop: (V, Y, T) of columns [0, cols) of the panel
    of width p whose trailing block is At (t, t)."""
    t = At.shape[-1]
    V = At.new_zeros(t, p)
    Y = At.new_zeros(t, p)
    T = At.new_zeros(p, p)
    one = torch.ones((), dtype=At.real.dtype, device=At.device)
    for jj in range(cols):
        Vj, Yj, Tj = V[:, :jj], Y[:, :jj], T[:jj, :jj]
        u = At[:, jj] - Yj @ (Tj @ V[jj, :jj].conj())
        c = u - Vj @ (Tj.mH @ (Vj.mH @ u))
        # Householder from the local rows > jj of c: v = x + phase(x_0)
        # ||x|| e_1, so ||v||^2 = 2 ||x|| (||x|| + |x_0|); a division by
        # zero lands in the branch that torch.where discards
        x = c[jj + 1:]
        alpha = x[0]
        xnorm = torch.linalg.vector_norm(x)
        aabs = alpha.abs()
        ph = torch.where(aabs > 0, alpha / aabs, one)
        v = x.clone()
        v[0] += ph * xnorm
        vnorm2 = 2. * xnorm * (xnorm + aabs)
        beta = torch.where(vnorm2 > 0, 2. / vnorm2, 0.)
        T[:jj, jj] = -beta * (Tj @ (V[jj + 1:, :jj].mH @ v))
        T[jj, jj] = beta
        # v is zero above its head: the GEMV reads columns > jj only
        Y[:, jj] = At[:, jj + 1:] @ v
        V[jj + 1:, jj] = v
    return V, Y, T


def hess_panel_plain(At, p, cols, rows=None, blocks=None):
    """Plain model of the kernel's schedule: (V, Y, T) as :func:`_columns`
    gives them, with every sum over the rows taken as the kernel takes it.
    The rows are cut into blocks of ``rows`` rows (the kernel's grid,
    :func:`hess_panel_plan`, by default), ``blocks`` of them (as many as
    the rows need by default; blocks past the last row hold none); per
    column, each block's partial sums of
    V^H u, then of V[jj+1:, :]^H x and ||x||^2 in one vector, are added
    over the blocks; T's new column is formed from V^H v = V^H x +
    conj(V[jj+1, :]) phase(x_0) ||x||, and Y's from c and v's head apart."""
    t = At.shape[-1]
    if rows is None:
        rows = hess_panel_plan(t, p)['rows']
    if blocks is None:
        blocks = -(-t // rows)
    pad = blocks * rows - t
    V = At.new_zeros(t, p)
    Y = At.new_zeros(t, p)
    T = At.new_zeros(p, p)
    zero = At.new_zeros(())
    one = torch.ones((), dtype=At.real.dtype, device=At.device)
    below = torch.arange(t, device=At.device)

    def block_sums(M, x):
        """Over the blocks: sum of conj(M[i, :]) x_i over each block's rows,
        (blocks, k)."""
        Mb = torch.cat([M, M.new_zeros(pad, M.shape[1])]).view(blocks, rows,
                                                               -1)
        xb = torch.cat([x, x.new_zeros(pad)]).view(blocks, rows)
        return torch.einsum('bri,br->bi', Mb.conj(), xb)

    for jj in range(cols):
        Vj, Tj = V[:, :jj], T[:jj, :jj]
        u = At[:, jj] - Y[:, :jj] @ (Tj @ V[jj, :jj].conj())
        s = block_sums(Vj, u).sum(0)
        c = u - Vj @ (Tj.mH @ s)
        x = torch.where(below > jj, c, zero)
        r = block_sums(torch.cat([Vj, x[:, None]], 1), x).sum(0)
        xnorm = torch.sqrt(r[jj].real)
        alpha = c[jj + 1]
        aabs = alpha.abs()
        hs = torch.where(aabs > 0, alpha / aabs, one) * xnorm
        vnorm2 = 2. * xnorm * (xnorm + aabs)
        beta = torch.where(vnorm2 > 0, 2. / vnorm2, 0.)
        T[:jj, jj] = -beta * (Tj @ (r[:jj] + V[jj + 1, :jj].conj() * hs))
        T[jj, jj] = beta
        V[:, jj] = x
        V[jj + 1, jj] += hs
        Y[:, jj] = At[:, jj + 1:] @ c[jj + 1:] + At[:, jj + 1] * hs
    return V, Y, T


def hess_panel(At, p, cols):
    """(V, Y, T) of columns [0, cols) of the panel of width p whose
    trailing block is At (t, t), a view with unit column stride: one launch
    of the kernel for a CUDA tensor, the plain loop for a CPU tensor."""
    t = At.shape[-1]
    if At.dim() != 2 or At.shape[0] != t or not 1 <= cols <= min(p, t - 2):
        raise ValueError(f'hess_panel: bad panel, At {tuple(At.shape)}, '
                         f'p = {p}, cols = {cols}')
    dev = At.device.type
    if dev == 'cpu':
        return _columns(At, p, cols)
    if dev != 'cuda':
        raise RuntimeError(f'hess_panel: no kernel for device {dev!r}')
    if At.dtype != torch.complex64:
        raise TypeError('hess_panel: the CUDA kernel takes complex64 only '
                        f'(got {At.dtype})')
    if At.stride(1) != 1 or At.stride(0) < t:
        raise ValueError('hess_panel: At must have unit column stride')
    if p > MAX_PANEL:
        raise ValueError(f'hess_panel: panel width {p} > {MAX_PANEL}')
    blocks = hess_panel_info(t, p)['blocks']
    # V, Y, T, then the kernel's scratch: c, two partial vectors a block,
    # the barrier's counter
    buf = torch.empty(2 * t * p + p * p + t + 2 * blocks * (p + 1) + 1,
                      dtype=At.dtype, device=At.device)
    V = buf[:t * p].view(t, p)
    Y = buf[t * p:2 * t * p].view(t, p)
    T = buf[2 * t * p:2 * t * p + p * p].view(p, p)
    err = _build.load().torcwa_hess_panel_c64(
        At.data_ptr(), At.stride(0), t, p, cols, V.data_ptr(), Y.data_ptr(),
        T.data_ptr(), buf[2 * t * p + p * p:].data_ptr(), _stream())
    _raise_on('hess_panel', err)
    LAUNCHES['hess_panel'] += 1
    return V, Y, T


def _panel(A, Q, k0, p):
    """Reduce columns [k0, k0+p) of A in place and fold the panel's
    reflectors into Q."""
    n = A.shape[-1]
    cols = min(p, n - 2 - k0)            # the tail panel may be short
    At = A[k0:, k0:]                     # panel-start block, read only here
    with timing.span('eig.hess.columns'):
        V, Y, T = hess_panel(At, p, cols)
    with timing.span('eig.hess.update'):
        TVh = T @ V.mH                                      # (p, t)
        M1 = At - Y @ TVh
        A[k0:, k0:] = M1 - V @ (T.mH @ (V.mH @ M1))
        if k0:
            Atop = A[:k0, k0:]
            A[:k0, k0:] = Atop - (Atop @ V) @ TVh
        Qc = Q[:, k0:]
        Q[:, k0:] = Qc - (Qc @ V) @ TVh


def hessenberg_blocked(A, panel=128):
    """(n, n) complex -> (H, Q) with A = Q H Q^H, H upper Hessenberg and
    Q unitary."""
    with timing.span('eig.hess') as sp:
        if A.dim() != 2 or A.shape[0] != A.shape[1] or not A.is_complex():
            raise ValueError('hessenberg_blocked: expected one complex (n, n) '
                             f'matrix, got {tuple(A.shape)} {A.dtype}')
        n = A.shape[-1]
        H = A.clone()
        Q = torch.eye(n, dtype=A.dtype, device=A.device)
        if n > 2:
            p = min(panel, n - 2)
            starts = range(0, n - 2, p)
            for k0 in starts:
                _panel(H, Q, k0, p)
            if sp is not None:
                sp.count('plain_panels' if A.device.type == 'cpu'
                         else 'panels', len(starts))
        idx = torch.arange(n, device=A.device)
        return H.masked_fill(idx[:, None] > idx[None, :] + 1, 0), Q
