"""The 7-point finite-difference Laplacian on a box with Dirichlet
boundaries, and its eigenvalues in closed form: a frozen copy of
``raleigh_tpu_torch/examples/laplace.py`` (upstream
raleigh/examples/laplace.py), kept here so that a later change to the
program cannot move the benchmark's inputs.  Only ``make`` is new."""

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
    """Exact eigenvalues of the 3D FD Laplacian."""
    def eigs1(n, a):
        h = a / (n + 1)
        k = np.arange(1, n + 1)
        return 4.0 * np.sin(k * np.pi / (2 * (n + 1))) ** 2 / (h * h)
    ex = eigs1(nx, ax)
    ey = eigs1(ny, ay)
    ez = eigs1(nz, az)
    return (ex[:, None, None] + ey[None, :, None]
            + ez[None, None, :]).ravel()


def make(params, seed):
    """{'A': the Laplacian as f64 CSR, 'grid', 'sides'} for run seed
    ``seed``: the domain's sides are ``params['sides']`` (upstream's
    1.0, 1.01, 1.02; distinct sides keep the low eigenvalues simple) times
    one scale that the seed draws from ``params['scale']``.  A common
    scale divides every eigenvalue by its square and leaves the spectrum's
    shape as it is, so every seed asks the solver for the same work;
    sides drawn one by one move the low eigenvalues together or apart,
    and the solver's work with them."""
    grid = tuple(int(g) for g in params['grid'])
    scale = np.random.default_rng(seed).uniform(*params['scale'])
    sides = tuple(float(scale * s) for s in params['sides'])
    return {'A': lap3d(*grid, *sides), 'B': None, 'grid': grid,
            'sides': sides}
