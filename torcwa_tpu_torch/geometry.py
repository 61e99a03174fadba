"""Differentiable level-set shape rasterization.

Counterpart of ``torcwa_tpu/geometry.py``: each primitive builds a signed
level-set function on a cell-centred grid and squashes it through
``sigmoid(edge_sharpness * level)``; boolean ops act pointwise on the
occupancy rasters (union = max, intersection = min, difference =
min(A, 1 - B)).  Rasters are made on ``device``.
"""

import torch

__all__ = ['geometry', 'rcwa_geo']


def _as(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _grid(Lx, Ly, nx, ny, dtype, device):
    """Cell-centred sampling grid x_i = (Lx/nx)(i + 0.5), indexing='ij'."""
    x = (Lx / nx) * (torch.arange(nx, dtype=dtype, device=device) + 0.5)
    y = (Ly / ny) * (torch.arange(ny, dtype=dtype, device=device) + 0.5)
    x_grid, y_grid = torch.meshgrid(x, y, indexing='ij')
    return x, y, x_grid, y_grid


def _rot_coords(x_grid, y_grid, Cx, Cy, theta):
    theta = _as(theta, x_grid)
    ct, st = torch.cos(theta), torch.sin(theta)
    u = (x_grid - Cx) * ct + (y_grid - Cy) * st
    v = -(x_grid - Cx) * st + (y_grid - Cy) * ct
    return u, v


def _sigmoid(x):
    # torch.sigmoid is overflow-safe in value and gradient (the naive
    # 1/(1+exp(-x)) gives inf/inf = NaN gradients for strongly negative x
    # at the edge sharpness values used here)
    return torch.sigmoid(x)


class geometry:
    """Instance-configured rasterizer."""

    def __init__(self, Lx=1., Ly=1., nx=100, ny=100, edge_sharpness=1000.,
                 *, dtype=torch.float32, device='cpu'):
        self.Lx = Lx
        self.Ly = Ly
        self.nx = nx
        self.ny = ny
        self.edge_sharpness = edge_sharpness
        self.dtype = dtype
        self.device = torch.device(device)

    def grid(self):
        self.x, self.y, self.x_grid, self.y_grid = _grid(
            self.Lx, self.Ly, self.nx, self.ny, self.dtype, self.device)

    def circle(self, R, Cx, Cy):
        self.grid()
        level = 1. - torch.sqrt(((self.x_grid - Cx) / R) ** 2
                                + ((self.y_grid - Cy) / R) ** 2)
        return _sigmoid(self.edge_sharpness * level)

    def ellipse(self, Rx, Ry, Cx, Cy, theta=0.):
        self.grid()
        u, v = _rot_coords(self.x_grid, self.y_grid, Cx, Cy, theta)
        level = 1. - torch.sqrt((u / Rx) ** 2 + (v / Ry) ** 2)
        return _sigmoid(self.edge_sharpness * level)

    def square(self, W, Cx, Cy, theta=0.):
        return self.rectangle(W, W, Cx, Cy, theta)

    def rectangle(self, Wx, Wy, Cx, Cy, theta=0.):
        self.grid()
        u, v = _rot_coords(self.x_grid, self.y_grid, Cx, Cy, theta)
        level = 1. - torch.maximum(torch.abs(u / (Wx / 2.)),
                                   torch.abs(v / (Wy / 2.)))
        return _sigmoid(self.edge_sharpness * level)

    def rhombus(self, Wx, Wy, Cx, Cy, theta=0.):
        """Rotated rhombus; Wx and Wy are the diagonals."""
        self.grid()
        u, v = _rot_coords(self.x_grid, self.y_grid, Cx, Cy, theta)
        level = 1. - (torch.abs(u / (Wx / 2.)) + torch.abs(v / (Wy / 2.)))
        return _sigmoid(self.edge_sharpness * level)

    def super_ellipse(self, Wx, Wy, Cx, Cy, theta=0., power=2.):
        self.grid()
        u, v = _rot_coords(self.x_grid, self.y_grid, Cx, Cy, theta)
        level = 1. - (torch.abs(u / (Wx / 2.)) ** power
                      + torch.abs(v / (Wy / 2.)) ** power) ** (1. / power)
        return _sigmoid(self.edge_sharpness * level)

    @staticmethod
    def union(A, B):
        return torch.maximum(A, B)

    @staticmethod
    def intersection(A, B):
        return torch.minimum(A, B)

    @staticmethod
    def difference(A, B):
        return torch.minimum(A, 1. - B)


class rcwa_geo:
    """Class-attribute-configured twin of :class:`geometry` (the upstream
    torcwa's legacy interface)."""

    edge_sharpness = 100.
    Lx = 1.
    Ly = 1.
    nx = 100
    ny = 100
    dtype = torch.float32
    device = 'cpu'

    @classmethod
    def _geo(cls):
        return geometry(cls.Lx, cls.Ly, cls.nx, cls.ny, cls.edge_sharpness,
                        dtype=cls.dtype, device=cls.device)

    @classmethod
    def grid(cls):
        cls.x, cls.y, cls.x_grid, cls.y_grid = _grid(
            cls.Lx, cls.Ly, cls.nx, cls.ny, cls.dtype,
            torch.device(cls.device))

    @classmethod
    def circle(cls, R, Cx, Cy):
        cls.grid()
        return cls._geo().circle(R, Cx, Cy)

    @classmethod
    def ellipse(cls, Rx, Ry, Cx, Cy, theta=0.):
        cls.grid()
        return cls._geo().ellipse(Rx, Ry, Cx, Cy, theta)

    @classmethod
    def square(cls, W, Cx, Cy, theta=0.):
        cls.grid()
        return cls._geo().square(W, Cx, Cy, theta)

    @classmethod
    def rectangle(cls, Wx, Wy, Cx, Cy, theta=0.):
        cls.grid()
        return cls._geo().rectangle(Wx, Wy, Cx, Cy, theta)

    @classmethod
    def rhombus(cls, Wx, Wy, Cx, Cy, theta=0.):
        cls.grid()
        return cls._geo().rhombus(Wx, Wy, Cx, Cy, theta)

    @classmethod
    def super_ellipse(cls, Wx, Wy, Cx, Cy, theta=0., power=2.):
        cls.grid()
        return cls._geo().super_ellipse(Wx, Wy, Cx, Cy, theta, power)

    @classmethod
    def union(cls, A, B):
        return torch.maximum(A, B)

    @classmethod
    def intersection(cls, A, B):
        return torch.minimum(A, B)

    @classmethod
    def difference(cls, A, B):
        return torch.minimum(A, 1. - B)
