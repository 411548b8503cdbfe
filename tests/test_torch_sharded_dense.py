"""Sharded ``dense_torch`` blocks, the core ``Solver`` on them, the dry
run's Solver parts and feature-split ``subspace_pca``, on the CPU, against
the JAX package.

The port runs on meshes of 8 shards of the CPU (``make_mesh(8, ['cpu'] *
8)`` and ``make_mesh2d(2, 4, ...)``), where every wrapper takes its
kernel's plain version; the JAX package on the 8 virtual CPU devices of
``tests/conftest.py``, where XLA partitions the same operations.  Inputs
are seeded NumPy arrays at small sizes.

Tolerances.  Contract operations on sharded blocks against the unsharded
port and against dense_jax: f64 1e-12 and c128 1e-12 of the largest |entry|
(per-shard partial sums add in another order), f32 1e-5 (the JAX test's
own ``atol``); fills, copies, selections and the split itself: exact.  The
Solver on sharded f64 blocks against the JAX package's sharded run and the
unsharded port: eigenvalues within 1e-10 relative, iteration counts equal.
The compensated Gram: 1e-10 relative against an f64 oracle (the JAX test's
limit).  ``subspace_pca`` on split features against the unsharded port and,
given jax.random's starting block, the JAX package's sharded run: the JAX
test's limits, mean within 1e-4 and ``trans @ comps`` within 1e-3 of its
largest |entry|.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from raleigh_tpu.algebra import dense_jax
from raleigh_tpu.algebra import sparse as jsparse
from raleigh_tpu.core import solver as jsolver
from raleigh_tpu.interfaces import randomized as jr
from raleigh_tpu.parallel import mesh as jmesh
from raleigh_tpu_torch import graft_entry
from raleigh_tpu_torch.algebra import dense_torch
from raleigh_tpu_torch.algebra import sparse as tsparse
from raleigh_tpu_torch.core import solver as tsolver
from raleigh_tpu_torch.core.device_solver import shard_operator
from raleigh_tpu_torch.examples.laplace import lap3d, lap3d_eigenvalues
from raleigh_tpu_torch.interfaces import randomized as tr
from raleigh_tpu_torch.ops import spmm_window as sw
from raleigh_tpu_torch.parallel.mesh import (ShardedRows, blockvec_sharding,
                                             make_mesh, make_mesh2d,
                                             matrix_sharding)

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One OpenBLAS thread for NumPy and SciPy inside these tests, for the
    same reason, restored after each test."""
    with threadpool_limits(1):
        yield


def _mesh(two_d):
    return (make_mesh2d(2, 4, ['cpu'] * 8) if two_d
            else make_mesh(8, ['cpu'] * 8))


def _jax_mesh(two_d):
    return jmesh.make_mesh2d(2, 4) if two_d else jmesh.make_mesh(8)


def _tol(dt):
    return 1e-5 if np.dtype(dt) in (np.float32, np.complex64) else 1e-12


def _rand(m, n, dt, seed):
    rng = np.random.RandomState(seed)
    a = rng.standard_normal((m, n))
    if np.dtype(dt).kind == 'c':
        a = a + 1j * rng.standard_normal((m, n))
    return a.astype(dt)


def _close(got, want, dt):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= _tol(dt) * max(np.abs(want).max(),
                                                      1e-300)


@pytest.mark.parametrize('two_d', [False, True])
@pytest.mark.parametrize('dt', [np.float32, np.float64, np.complex128])
def test_sharded_vectors_match_single(dt, two_d):
    """tests/test_algebra.py:179 with the port: dot, multiply and add on a
    block split over the mesh agree with the unsharded block and with
    dense_jax's sharded one."""
    n = 256
    sh = blockvec_sharding(_mesh(two_d))
    jsh = NamedSharding(_jax_mesh(two_d), P(None, jmesh.AXIS) if not two_d
                        else P(None, (jmesh.HOST_AXIS, jmesh.AXIS)))
    a, b = _rand(6, n, dt, 1), _rand(6, n, dt, 2)
    q = _rand(6, 6, dt, 3)
    out = {}
    for name, mod, kw in (('whole', dense_torch, {'device': 'cpu'}),
                          ('split', dense_torch, {'device': 'cpu',
                                                  'sharding': sh}),
                          ('jax', dense_jax, {'sharding': jsh})):
        u = mod.Vectors(n, 6, dt, **kw)
        u.fill(a)
        v = mod.Vectors(n, 6, dt, **kw)
        v.fill(b)
        w = mod.Vectors(n, 6, dt, **kw)
        g = u.dot(v)
        u.multiply(q, w)
        u.add(v, -2.0)
        out[name] = (g, w.data(), u.data(), u.dots(v), v.dots(v, transp=True))
    if two_d is False:
        parts = dense_torch.Vectors(a, sharding=sh).device_data().parts
        assert [p.shape[1] for p in parts] == [32] * 8
    for name in ('split', 'jax'):
        for got, want in zip(out[name], out['whole']):
            _close(got, want, dt)


@pytest.mark.parametrize('op', ['fill_random', 'copy_index', 'scale',
                                'append_rows', 'append_lanes',
                                'orthogonalize', 'svd', 'select_grow',
                                'matrix_apply', 'matrix_adjoint'])
def test_sharded_contract_ops_equal_unsharded(op):
    """Every contract operation on a block split over 8 shards of the CPU
    against the same on the unsharded block (f64)."""
    n, dt = 200, np.float64
    sh = blockvec_sharding(_mesh(False))
    a, b = _rand(5, n, dt, 4), _rand(3, n, dt, 5)
    res = []
    for sharding in (None, sh):
        np.random.seed(7)
        u = dense_torch.Vectors(a, sharding=sharding, device='cpu')
        v = dense_torch.Vectors(b, sharding=sharding, device='cpu')
        if op == 'fill_random':
            u.select(3, 1)
            u.fill_random()
            u.select_all()
            r = u.data()
        elif op == 'copy_index':
            w = u.new_vectors(3)
            u.copy(w, [4, 0, 2])
            r = w.data()
        elif op == 'scale':
            u.scale(np.arange(1.0, 6.0))
            v.scale(np.arange(2.0, 5.0), multiply=True)
            r = np.concatenate((u.data(), v.data()))
        elif op == 'append_rows':
            u.append(v)
            r = u.data()
        elif op == 'append_lanes':
            u.append(dense_torch.Vectors(_rand(5, 30, dt, 6),
                                         device='cpu'), axis=1)
            r = u.data()
        elif op == 'orthogonalize':
            v.select(2)
            v.scale(np.sqrt(v.dots(v)))
            q = u.orthogonalize(v)
            r = np.concatenate((u.data(), q.data().T), axis=1)
        elif op == 'svd':
            # the singular values and the block they rebuild (the signs of
            # the singular vectors are rounding's to choose)
            sigma, uu = u.svd()
            r = np.concatenate(((uu.conj() * sigma[None, :]) @ u.data(),
                                sigma[:, None]), axis=1)
        elif op == 'select_grow':
            u.select(4, 3)
            u.fill(v.data()[0])
            u.select_all()
            r = u.data()
        else:
            mat = _rand(40, n, dt, 8)
            am = dense_torch.Matrix(mat, sharding=sharding, device='cpu')
            if op == 'matrix_apply':
                y = am.new_vectors(40, 5)
                am.apply(u, y)
                r = (y.data(), u.data() @ mat.T)
            else:
                x = dense_torch.Vectors(_rand(2, 40, dt, 9), device='cpu')
                y = am.new_vectors(n, 2)
                am.apply(x, y, transp=True)
                r = (y.data(), x.data() @ mat)
            _close(r[0], r[1], dt)
            r = r[0]
        res.append(r)
        if sharding is not None:
            assert isinstance(u.device_data(), ShardedRows)
    _close(res[1], res[0], dt)


def _diag_solver(mod, sol, n, sh, dt, tol, max_iter=-1, which=(4, 0),
                 **kw):
    """The reference's diag(1..n) problem on ``mod``'s blocks: the Solver,
    its eigenvalue block and its status."""
    a = np.arange(1, n + 1).astype(dt)
    A = mod.Matrix(np.diag(a), sharding=sh, **kw)
    np.random.seed(1)
    v = mod.Vectors(n, data_type=dt, sharding=sh, **kw)
    opt = sol.Options()
    opt.convergence_criteria = sol.DefaultConvergenceCriteria()
    opt.convergence_criteria.set_error_tolerance('eigenvector error', tol)
    opt.verbosity = -1
    opt.max_iter = max_iter
    solver = sol.Solver(sol.Problem(v, A))
    status = solver.solve(v, opt, which=which)
    return solver, v, status


@pytest.mark.parametrize('two_d', [False, True])
def test_solver_on_sharded_vectors(two_d):
    """tests/test_sharded.py:22 (1-D mesh) and :139 (2-D mesh): the whole
    block Jacobi-CG iteration over f64 blocks split along the vector
    dimension matches the JAX package's sharded run and the port's
    unsharded one; the eigenvector block stays split."""
    n = 96
    runs = [
        _diag_solver(dense_torch, tsolver, n,
                     blockvec_sharding(_mesh(two_d)), np.float64, 1e-8,
                     device='cpu'),
        _diag_solver(dense_torch, tsolver, n, None, np.float64, 1e-8,
                     device='cpu'),
        _diag_solver(dense_jax, jsolver, n,
                     jmesh.blockvec_sharding(_jax_mesh(two_d)), np.float64,
                     1e-8)]
    (split, v, status), (whole, _, s1), (jax_run, _, s2) = runs
    assert status == s1 == s2 == 0
    assert split.iteration == whole.iteration == jax_run.iteration
    lmd = np.sort(split.eigenvalues)[:4]
    assert np.allclose(lmd, [1, 2, 3, 4], atol=1e-6)
    for other in (whole, jax_run):
        want = np.sort(other.eigenvalues)
        assert np.abs(np.sort(split.eigenvalues) - want).max() <= \
            1e-10 * np.abs(want).max()
    assert v.nvec() >= 4 and isinstance(v.device_data(), ShardedRows)


@pytest.mark.parametrize('two_d', [False, True])
def test_dryrun_solver_part_matches_jax(two_d):
    """The dry run's Solver part (``__graft_entry__.py:87-106`` and
    :142-160: an f32 diagonal Matrix, which=(2, 0), 12 iterations, status
    0 or 1) against the same run of the JAX package on its mesh."""
    n = 16 * 8
    status, solver = graft_entry._solver_step(_mesh(two_d), n)
    jax_run, _, jstatus = _diag_solver(
        dense_jax, jsolver, n, jmesh.blockvec_sharding(_jax_mesh(two_d)),
        np.float32, 1e-3, max_iter=12, which=(2, 0))
    assert status == jstatus and status in (0, 1)
    assert solver.iteration == jax_run.iteration
    assert len(solver.eigenvalues) == len(jax_run.eigenvalues)
    assert np.allclose(np.sort(solver.eigenvalues),
                       np.sort(jax_run.eigenvalues), rtol=1e-5)


def test_graft_dryrun_multichip_with_solver_parts():
    """tests/test_sharded.py:17: the dry run, its Solver parts included,
    on 8 shards of the CPU."""
    graft_entry.dryrun_multichip(8, device='cpu')


def _lap_problem(mod, sol, sparse, sh, kind):
    """lap3d 12^3, 4 smallest, f64 blocks, with a degree-10 Chebyshev on
    [lo, hi]: the port with its operator and preconditioner split over the
    mesh by ``shard_operator`` (kind 'split') or left whole ('whole'), the
    JAX package with its blocks sharded ('jax')."""
    a = lap3d(12, 12, 12, 1.0, 1.0, 1.0)
    lo, hi = jsparse.spectral_bounds(a)
    if kind == 'jax':
        op = sparse.SparseSymmetricMatrix(a, arch='tpu')
        T = sparse.Chebyshev(a, lo, hi, degree=10, arch='tpu')
        v = mod.Vectors(a.shape[0], data_type=np.float64, sharding=sh)
    else:
        op = sparse.SparseSymmetricMatrix(a, device='cpu', exact=True)
        T = sparse.Chebyshev(a, lo, hi, degree=10, device='cpu')
        if kind == 'split':
            mesh = sh.mesh
            shard_operator(op.device_matrix(), mesh)
            shard_operator(T.device_matrix(), mesh)
        v = mod.Vectors(a.shape[0], data_type=np.float64, sharding=sh,
                        device='cpu')
    np.random.seed(2)
    solver = sol.Solver(sol.Problem(v, op))
    solver.set_preconditioner(T)
    opt = sol.Options()
    opt.convergence_criteria = sol.DefaultConvergenceCriteria()
    opt.convergence_criteria.set_error_tolerance('k eigenvector error',
                                                 1e-6)
    opt.verbosity = -1
    status = solver.solve(v, opt, which=(4, 0))
    return solver, v, status


def test_sharded_solver_on_dia_with_chebyshev():
    """The core Solver on f64 blocks split over 8 shards of the CPU, with
    lap3d 12^3's DIA operator and its Chebyshev split by
    ``shard_operator`` (the mesh apply's plain version over its piece
    table, f64 and f32 values): the unsharded port's iterations and
    eigenvalues, the JAX package's, and the analytic ones."""
    sh = blockvec_sharding(_mesh(False))
    before = dict(sw.LAUNCHES)
    split, v, st = _lap_problem(dense_torch, tsolver, tsparse, sh, 'split')
    assert dict(sw.LAUNCHES) == before           # no kernel on the CPU
    whole, _, st1 = _lap_problem(dense_torch, tsolver, tsparse, None,
                                 'whole')
    jax_run, _, st2 = _lap_problem(
        dense_jax, jsolver, jsparse,
        jmesh.blockvec_sharding(jmesh.make_mesh(8)), 'jax')
    assert st == st1 == st2 == 0
    assert split.iteration == whole.iteration == jax_run.iteration
    lmd = np.sort(split.eigenvalues)[:4]
    for other in (whole, jax_run):
        want = np.sort(other.eigenvalues)[:4]
        assert np.abs(lmd - want).max() <= 1e-10 * want.max()
    exact = np.sort(lap3d_eigenvalues(12, 12, 12, 1.0, 1.0, 1.0))[:4]
    assert np.allclose(lmd, exact, rtol=1e-6)
    assert isinstance(v.device_data(), ShardedRows)


def test_compensated_dot_sharded():
    """tests/test_sharded.py:311: f32 shards with the compensated Gram
    return f64 at 1e-10 of an f64 oracle (per-shard f64 partial Grams)."""
    rng = np.random.RandomState(5)
    m, n = 6, 4096
    a32 = rng.standard_normal((m, n)).astype(np.float32)
    b32 = rng.standard_normal((m, n)).astype(np.float32)
    oracle = b32.astype(np.float64) @ a32.astype(np.float64).T
    sh = blockvec_sharding(_mesh(False))
    g = dense_torch.Vectors(a32, sharding=sh, compensated=True,
                            device='cpu').dot(
        dense_torch.Vectors(b32, sharding=sh, device='cpu'))
    jg = dense_jax.Vectors(a32, sharding=jmesh.blockvec_sharding(
        jmesh.make_mesh(8)), compensated=True).dot(dense_jax.Vectors(b32))
    for got in (g, jg):
        assert got.dtype == np.float64
        assert np.abs(got - oracle).max() / np.abs(oracle).max() < 1e-10


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's subspace engine draws jax.random's starting block."""
    def normal(shape, like, seed):
        dt = jnp.float64 if like.dtype == torch.float64 else jnp.float32
        q = np.array(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                       dtype=dt))
        return torch.from_numpy(q).to(like.device)
    monkeypatch.setattr(tr, '_normal', normal)


@pytest.mark.parametrize('two_d', [False, True])
def test_subspace_pca_sharded_matches_single(jax_draws, two_d):
    """tests/test_sharded.py:288: the data matrix split along its features
    (``matrix_sharding``): per-shard Grams and a reduce; mean and comps
    stay split until fetched; the factors match the unsharded port and the
    JAX package's feature-sharded run."""
    rng = np.random.RandomState(0)
    m, n, npc = 96, 512, 8
    a = (rng.standard_normal((m, 32)) @ rng.standard_normal((32, n))
         + 0.01 * rng.standard_normal((m, n))).astype(np.float32)
    mesh = _mesh(two_d)
    a_sh = ShardedRows.split(torch.from_numpy(a), matrix_sharding(mesh))
    kept = tr.subspace_pca(a_sh, npc, fetch=False)
    assert isinstance(kept[0], ShardedRows) and kept[0].shape == (1, n)
    assert isinstance(kept[2], ShardedRows) and kept[2].shape == (npc, n)
    assert isinstance(kept[1], torch.Tensor) and kept[1].shape == (m, npc)
    jm = _jax_mesh(two_d)
    spec = (P(None, jmesh.AXIS) if not two_d
            else P(None, (jmesh.HOST_AXIS, jmesh.AXIS)))
    runs = [tr.subspace_pca(a_sh, npc), tr.subspace_pca(a, npc, device='cpu'),
            jr.subspace_pca(jax.device_put(a, NamedSharding(jm, spec)), npc)]
    mean, trans, comps = runs[0]
    assert np.array_equal(mean, kept[0].gather().numpy())
    r = trans @ comps
    for m2, t2, c2 in runs[1:]:
        assert np.abs(mean - m2).max() < 1e-4
        r2 = np.asarray(t2) @ np.asarray(c2)
        assert np.abs(r - r2).max() / np.abs(r2).max() < 1e-3
