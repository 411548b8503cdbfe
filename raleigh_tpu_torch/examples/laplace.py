"""Finite-difference Laplacians in 1/2/3 dimensions (Kronecker products);
the standard sparse test matrices (reference raleigh/examples/laplace.py)."""

import numpy as np
import scipy.sparse as scs


def lap1d(n, a):
    h = a / (n + 1)
    d = np.ones((n,)) / (h * h)
    return scs.spdiags([-d, 2 * d, -d], [-1, 0, 1], n, n, format='csr')


def lap2d(nx, ny, ax, ay):
    lx = lap1d(nx, ax)
    ly = lap1d(ny, ay)
    return scs.csr_matrix(scs.kron(scs.eye(ny), lx)
                          + scs.kron(ly, scs.eye(nx)))


def lap3d(nx, ny, nz, ax, ay, az):
    lxy = lap2d(nx, ny, ax, ay)
    lz = lap1d(nz, az)
    return scs.csr_matrix(scs.kron(scs.eye(nz), lxy)
                          + scs.kron(lz, scs.eye(nx * ny)))


def lap3d_eigenvalues(nx, ny, nz, ax, ay, az):
    """Exact eigenvalues of the 3D FD Laplacian (for test pins)."""
    def eigs1(n, a):
        h = a / (n + 1)
        k = np.arange(1, n + 1)
        return 4.0 * np.sin(k * np.pi / (2 * (n + 1))) ** 2 / (h * h)
    ex = eigs1(nx, ax)
    ey = eigs1(ny, ay)
    ez = eigs1(nz, az)
    return (ex[:, None, None] + ey[None, :, None]
            + ez[None, None, :]).ravel()
