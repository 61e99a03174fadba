"""Eig kernels, Fourier factorization and complex helpers of the port."""
