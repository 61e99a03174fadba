"""Dispersive materials: tabulated (n, k) that is differentiable in the
wavelength.

Counterpart of ``torcwa_tpu/materials.py``.  Natural cubic-spline
coefficients are computed once on the host with numpy; the spline is
evaluated with torch ops, so the index and the permittivity carry the
spline's own derivative in the wavelength through autograd.  Wavelengths
outside the table clamp to its edges (the reference's behaviour).  The
coefficients live on ``device``: the CUDA card unless the caller passes
``device='cpu'``; ``device=None`` means the card too.
"""

import os

import numpy as np
import torch

__all__ = ['TabulatedMaterial', 'aSiH']


def _natural_cubic_coeffs(x, y):
    """Natural cubic spline coefficients (a, b, c, d) per interval:
    s(t) = a + b dt + c dt^2 + d dt^3, dt = t - x[i]."""
    n = len(x) - 1
    h = np.diff(x)
    A = np.zeros((n + 1, n + 1))
    rhs = np.zeros(n + 1)
    A[0, 0] = 1.
    A[n, n] = 1.
    for i in range(1, n):
        A[i, i - 1] = h[i - 1]
        A[i, i] = 2 * (h[i - 1] + h[i])
        A[i, i + 1] = h[i]
        rhs[i] = 3 * ((y[i + 1] - y[i]) / h[i] - (y[i] - y[i - 1]) / h[i - 1])
    c = np.linalg.solve(A, rhs)
    a = y[:-1]
    b = (y[1:] - y[:-1]) / h - h * (2 * c[:-1] + c[1:]) / 3
    d = (c[1:] - c[:-1]) / (3 * h)
    return a, b, c[:-1], d


class TabulatedMaterial:
    """Complex refractive index n(lambda) + i k(lambda) from a table.

    Args:
      wavelength: [M] sample points, any length unit (use the same one
        when evaluating); sorted here.
      n, k: [M] refractive index and extinction samples (k None: 0).
      device: where the coefficients live and the results are made.
    """

    def __init__(self, wavelength, n, k=None, device='cuda'):
        self.device = torch.device('cuda' if device is None else device)
        wl = np.asarray(wavelength, np.float64)
        order = np.argsort(wl)
        wl = wl[order]
        n = np.asarray(n, np.float64)[order]
        k = (np.zeros_like(wl) if k is None
             else np.asarray(k, np.float64)[order])
        self.wl_min = float(wl[0])
        self.wl_max = float(wl[-1])
        t = lambda v: torch.as_tensor(v, device=self.device)
        self._knots = t(wl)
        self._coeff_n = tuple(t(c) for c in _natural_cubic_coeffs(wl, n))
        self._coeff_k = tuple(t(c) for c in _natural_cubic_coeffs(wl, k))

    @classmethod
    def from_file(cls, path, skiprows=0, device='cuda'):
        """Load a whitespace table of columns (wavelength, n[, k])."""
        data = np.loadtxt(path, skiprows=skiprows)
        k = data[:, 2] if data.shape[1] > 2 else None
        return cls(data[:, 0], data[:, 1], k, device=device)

    def _lam(self, wavelength):
        """The wavelength as a real tensor on the material's device: a
        tensor keeps its floating dtype (and its graph), anything else is
        float64."""
        if isinstance(wavelength, torch.Tensor) and \
                wavelength.is_floating_point():
            return wavelength.to(self.device)
        return torch.as_tensor(wavelength, dtype=torch.float64,
                               device=self.device)

    def _eval(self, coeffs, lam):
        a, b, c, d = coeffs
        lam = self._lam(lam)
        # jnp.clip's form: at a table edge the derivative is the mean of the
        # two one-sided ones, as in the JAX package
        lam = torch.minimum(torch.maximum(lam, lam.new_tensor(self.wl_min)),
                            lam.new_tensor(self.wl_max))
        i = torch.clamp(torch.searchsorted(self._knots, lam.detach().double(),
                                           right=True) - 1, 0, len(a) - 1)
        dt = lam - self._knots[i]
        return a[i] + dt * (b[i] + dt * (c[i] + dt * d[i]))

    def n(self, wavelength):
        """Real refractive index at the given wavelength(s)."""
        return self._eval(self._coeff_n, wavelength)

    def k(self, wavelength):
        return self._eval(self._coeff_k, wavelength)

    def nk(self, wavelength):
        """Complex refractive index n + i k."""
        return torch.complex(self.n(wavelength), self.k(wavelength))

    def eps(self, wavelength):
        """Complex permittivity (n + i k)^2."""
        return self.nk(wavelength) ** 2

    # the reference's aSiH.apply(lamb0) returned the complex index
    def apply(self, wavelength):
        return self.nk(wavelength)

    def __call__(self, wavelength):
        return self.nk(wavelength)


# the table the JAX package ships (Tauc-Lorentz a-Si:H), copied beside this
# module so that the port reads nothing of the JAX package
_ASIH_VENDORED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              'data', 'aSiH_nk.txt')


def aSiH(path=None, device='cuda'):
    """Hydrogenated amorphous silicon (n, k): the vendored table
    (``torcwa_tpu_torch/data/aSiH_nk.txt``) unless ``path`` names another
    table of the same format."""
    p = path or _ASIH_VENDORED
    if not os.path.exists(p):
        raise FileNotFoundError(
            f'aSiH data table not found at {p}; pass path= explicitly')
    return TabulatedMaterial.from_file(p, device=device)
