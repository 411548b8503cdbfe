"""Synthetic test-matrix generator with controlled singular spectrum.

The port's copy of ``raleigh_tpu/examples/generate_matrix.py`` (NumPy
and SciPy only): the same seed gives the same matrix.

Produces a random matrix with sigma_k ~ k**(-alpha) decay from random
orthonormal factors; with ``pca=True`` the leading left singular vector is
the constant vector, making the remaining singular values invariant under
the shift-to-zero-mean used by PCA.  Semantics parity with reference
raleigh/examples/pca/generate_matrix.py:50-77 (the fixture behind the pca()
doctests, reference interfaces/pca.py:95-117).
"""

import numpy as np
import scipy.linalg as sla


def random_singular_values(k, f_sigma, dt):
    s = np.sort(np.random.rand(k).astype(dt))
    s = f_sigma(s)
    return s / s[0]


def random_singular_vectors(m, n, k, dt, pca):
    u = np.random.randn(m, k).astype(dt)
    if pca:
        u[:, 0] = 1.0
    v = np.random.randn(n, k).astype(dt)
    u, _ = sla.qr(u, mode='economic')
    v, _ = sla.qr(v, mode='economic')
    return u, v


def random_matrix_for_svd(m, n, k, f_sigma, dt, pca=False):
    s = random_singular_values(min(m, n), f_sigma, dt)[:k]
    u, v = random_singular_vectors(m, n, k, dt, pca)
    a = np.dot(u * s, v.T)
    return s, u, v, a


def generate(m, n, rank, dtype=np.float32, scale=1.0, alpha=0.75, pca=False):
    """Return (A, sigma, u, v) with A = u diag(sigma) v^T of the given rank
    and sigma_k ~ scale * k**(-alpha)."""
    def f_sigma(t):
        return dtype(scale) * t ** (-alpha)
    sigma, u, v, a = random_matrix_for_svd(m, n, rank, f_sigma, dtype, pca)
    return a, sigma, u, v
