"""Entry points of a whole-system check: one block-iteration step on one
device, and a dry run of the mesh path.

The port of ``__graft_entry__.py``.  ``entry()`` returns the forward step
of the PCA/SVD engine's block iteration, the normal-operator application
y = (x Aᵀ) A followed by the block Gram matrix: the GEMMs and the reduction
that dominate every iteration of the dense solvers.

``dryrun_multichip(n)`` builds a mesh of n shards (``parallel/mesh.py``: a
list of devices walked by one process, by default n shards of the card) and
runs on it, at tiny shapes, one block-iteration step over split layouts,
the block Jacobi-CG ``Solver`` on sharded ``dense_torch`` blocks, the
sharded device LOBPCG and the explicit halo-exchange DIA SpMM, on a 1-D
mesh and on a 2-D (hosts x chips) one.
"""

import numpy as np
import torch

from .algebra import dense_torch
from .core.device_solver import lobpcg, shard_operator
from .core.solver import (DefaultConvergenceCriteria, Options, Problem,
                          Solver)
from .examples.laplace import lap1d
from .ops.spmm import device_sparse, storage_device
from .parallel.mesh import (AXIS, HOST_AXIS, ShardedRows, blockvec_sharding,
                            make_mesh, make_mesh2d, matrix_sharding)


def entry(device=None):
    """(forward, (x, a)): ``forward(x, a)`` is one block-iteration step on
    seeded f32 operands on ``device`` (default: the card)."""
    device = storage_device(device)
    m, n, k = 512, 1024, 32
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))

    def forward(x, a):
        # normal-operator apply + block Gram
        ax = torch.matmul(x, a.T)
        y = torch.matmul(ax, a)
        gram = torch.matmul(y, x.T)
        return y, gram

    return forward, (x.to(device), a.to(device))


def _block_step(x, a, k):
    """One block iteration over split layouts: x (k, n) and a (rows, n) are
    ``ShardedRows``; contractions over the split dimension are per-shard
    GEMMs summed over the mesh, the small results live on the first shard's
    device."""
    # 1) operator apply: y = (x Aᵀ) A
    ax = x.gram(a)
    y = a.mixed(ax)
    # 2) Rayleigh-Ritz Gram matrices
    xax = y.gram(x)
    xbx = x.gram(x)
    # 3) residuals w = y - theta x (theta = Ritz values)
    theta = torch.diagonal(xax) / torch.diagonal(xbx)
    w = y - x * theta[:, None]
    res = w.row_norms()
    # 4) orthonormalization from the Cholesky factor of the Gram matrix
    c = torch.linalg.cholesky(
        xbx + 1e-6 * torch.eye(k, dtype=xbx.dtype, device=xbx.device))
    xn = x.mixed(torch.linalg.inv(c))
    return xn, w, theta, res


def _solver_step(mesh, n):
    """The block Jacobi-CG ``Solver`` over blocks split along the vector
    dimension (its Grams per-shard GEMMs and a reduce): an f32 diagonal
    ``Matrix`` split the same way, the 2 smallest eigenvalues to 1e-3 in
    at most 12 iterations.  Returns (status, 0 or 1; the Solver)."""
    sh = blockvec_sharding(mesh)
    diag = np.arange(1, n + 1, dtype=np.float32)
    A = dense_torch.Matrix(np.diag(diag), sharding=sh)
    v = dense_torch.Vectors(n, data_type=np.float32, sharding=sh)
    opt = Options()
    opt.convergence_criteria = DefaultConvergenceCriteria()
    opt.convergence_criteria.set_error_tolerance('eigenvector error', 1e-3)
    opt.verbosity = -1
    opt.max_iter = 12
    solver = Solver(Problem(v, A))
    status = solver.solve(v, opt, which=(2, 0))
    assert status in (0, 1), status
    return status, solver


def dryrun_multichip(n_devices, device=None):
    """Runs the mesh path end to end on ``n_devices`` shards of ``device``
    (default: the card; CUDA with no card raises) and raises on any wrong
    result."""
    device = storage_device(device)
    meshes = [make_mesh(n_devices, [device] * n_devices)]
    if n_devices >= 4 and n_devices % 2 == 0:
        meshes.append(make_mesh2d(2, n_devices // 2, [device] * n_devices))
    n = 16 * n_devices   # tiny vector dimension, divisible by the mesh
    rows, k = 24, 8
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((rows, n)).astype(np.float32)
    x_np = rng.standard_normal((k, n)).astype(np.float32)
    for mesh in meshes:
        axes = (HOST_AXIS, AXIS) if len(mesh.axis_names) == 2 else AXIS
        a = ShardedRows.split(a_np, matrix_sharding(mesh))
        x = ShardedRows.split(x_np, blockvec_sharding(mesh))
        xn, w, theta, res = _block_step(x, a, k)
        assert xn.shape == (k, n) and res.shape == (k,)
        y_np = (x_np @ a_np.T) @ a_np
        ref = np.diag(y_np @ x_np.T) / np.diag(x_np @ x_np.T)
        assert np.allclose(theta.cpu().numpy(), ref, rtol=1e-4), (theta, ref)
        gram = xn.gram(xn).cpu().numpy()
        assert np.abs(gram - np.eye(k)).max() < 1e-3, gram

        # the production Solver over the same mesh
        _solver_step(mesh, n)

        # the device LOBPCG over the same mesh: halo-exchange DIA SpMM,
        # Gram partial sums and the Ritz eigh on the first shard's device
        a_sp = lap1d(n, 1.0)
        dm = shard_operator(device_sparse(a_sp, dtype=np.float32,
                                          device=device), mesh, axis=axes)
        lam, xx, rr, it, st = lobpcg(
            dm, 2, tol=1e-2, maxit=30, chunk=10, dtype=torch.float32,
            sharding=blockvec_sharding(mesh))
        assert st in (0, 2) and lam.shape == (2,), (st, lam.shape)
        assert np.all(np.isfinite(lam)) and xx.shape == (n, 2)

        # explicit halo-exchange SpMM: each shard's own lanes and its
        # neighbours' edge lanes, read where they lie
        n_sp = 128 * n_devices
        a_big = lap1d(n_sp, 1.0)
        dm2 = shard_operator(device_sparse(a_big, dtype=np.float32,
                                           device=device), mesh, axis=axes)
        fn = dm2.sharded_rows_fn(4, n_sp)
        assert fn is not None, 'the halo path must take a sharded DIA matrix'
        xb_np = rng.standard_normal((4, n_sp)).astype(np.float32)
        yb = fn(ShardedRows.split(xb_np, blockvec_sharding(mesh)))
        ref = (a_big @ xb_np.T).T
        err = float(np.abs(yb.gather().cpu().numpy() - ref).max())
        assert err <= 1e-3 * float(np.abs(ref).max()) + 1e-6, err
