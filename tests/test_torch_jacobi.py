"""The port's chunked per-vector Jacobi engine (``raleigh_tpu_torch.core.
device_jacobi.DeviceJacobi``) on the CPU against the JAX package's, on the
problems of ``tests/test_device_solver.py`` (the generalized pencil, its
forced restart, the one-fetch-per-chunk count) and its standard twin, with
the same NumPy seed: the same status and iteration count, eigenvalues
within 1e-10 relative in f64.  Also ``svd_normal_matmat`` against the JAX
operator, and ``partial_hevp(engine='jacobi', device='cpu')`` on small
Laplacians (standard and generalized, the Chebyshev recurrence and A in
f64) against the JAX package's ``engine='jacobi'``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as scs
import torch
from threadpoolctl import threadpool_limits

import raleigh_tpu.core.device_jacobi as jdj
from raleigh_tpu.algebra import dense_jax
from raleigh_tpu.algebra.sparse import Chebyshev as JaxChebyshev
from raleigh_tpu.core import solver as jsolver
from raleigh_tpu.examples.laplace import lap2d, lap3d, lap3d_eigenvalues
from raleigh_tpu.interfaces.partial_hevp import partial_hevp as jax_hevp
import raleigh_tpu_torch.core.device_jacobi as tdj
from raleigh_tpu_torch import Chebyshev, Options, partial_hevp
from raleigh_tpu_torch import spectral_bounds
from raleigh_tpu_torch.algebra import dense_torch
from raleigh_tpu_torch.core import solver as tsolver

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One OpenBLAS thread for NumPy and SciPy inside these tests, for the
    same reason (their small products gain nothing from more), restored
    after each test."""
    with threadpool_limits(1):
        yield


@pytest.fixture
def f64_default():
    """f64 device values for the Chebyshev recurrence, as the JAX package
    keeps them under x64."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _pencil(n=400, seed=3):
    """A x = lmd B x of test_device_solver.py::
    test_device_jacobi_generalized: a noisy diagonal A, a tridiagonal SPD
    B."""
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((n, n)) * 0.05
    A = np.diag(np.linspace(1.0, 60.0, n)) + (q + q.T)
    c = 0.2 * rng.standard_normal(n - 1)
    B = np.diag(np.linspace(1.0, 2.0, n))
    B[np.arange(n - 1), np.arange(1, n)] = c
    B[np.arange(1, n), np.arange(n - 1)] = c
    return A, B


def _engine(pkg, A, B=None, dt=np.float64):
    """Each package's engine on the dense operator(s) and an empty block
    of the package's device Vectors."""
    n = A.shape[0]
    if pkg == 'jax':
        def mm(ops, x):
            return jnp.matmul(x, ops[0].T)
        eng = jdj.DeviceJacobi(
            mm, n, dtype=dt, operands=(jnp.asarray(A.astype(dt)),),
            matmat_b=mm if B is not None else None,
            operands_b=(jnp.asarray(B.astype(dt)),) if B is not None
            else None)
        return eng, dense_jax.Vectors(n, data_type=dt), jsolver

    def mm(ops, x):
        return torch.matmul(x, ops[0].T)
    eng = tdj.DeviceJacobi(
        mm, n, dtype=dt, operands=(torch.from_numpy(A.astype(dt)),),
        matmat_b=mm if B is not None else None,
        operands_b=(torch.from_numpy(B.astype(dt)),) if B is not None
        else None)
    return eng, dense_torch.Vectors(n, data_type=dt, device='cpu'), tsolver


def _options(mod, tol, max_iter=300):
    opt = mod.Options()
    opt.convergence_criteria = mod.DefaultConvergenceCriteria()
    opt.convergence_criteria.set_error_tolerance('k eigenvector error', tol)
    opt.max_iter = max_iter
    opt.verbosity = -1
    return opt


def _both(A, B, nwanted, tol, dt=np.float64, chunk=8):
    out = []
    for pkg in ('jax', 'torch'):
        np.random.seed(1)
        eng, v, mod = _engine(pkg, A, B, dt)
        st = eng.solve(v, options=_options(mod, tol), nwanted=nwanted,
                       chunk=chunk)
        out.append((st, eng.iteration, eng.eigenvalues, v.data(), eng))
    (sj, ij, lj, xj, _), (st, it, lt, xt, eng) = out
    assert st == sj and it == ij, (st, sj, it, ij)
    assert lt.shape == lj.shape
    rel = 1e-10 if dt == np.float64 else 1e-5
    assert np.abs(lt - lj).max() <= rel * np.abs(lj).max(), (lt, lj)
    return st, lt, xt, eng


@pytest.mark.parametrize('gen', [False, True])
def test_device_jacobi_matches_jax(gen):
    A, B = _pencil()
    st, lmd, X, eng = _both(A, B if gen else None, 5, 1e-8)
    assert st == 0
    exact = sla.eigh(A, B if gen else None, eigvals_only=True)
    assert np.abs(np.sort(lmd)[-5:] - exact[-5:]).max() / exact[-1] < 1e-6
    g = X @ (B if gen else np.eye(A.shape[0])) @ X.T
    assert np.abs(g - np.eye(X.shape[0])).max() < 1e-6
    # Solver-compatible observability
    assert eng.residual_norms.shape[0] == eng.rcon == 5
    assert eng.eigenvalue_errors.kinematic.shape[0] == eng.rcon
    assert isinstance(eng.eigenvectors, dense_torch.Vectors)
    assert eng.eigenvectors.nvec() == 5


def test_device_jacobi_f32_matches_jax():
    """The f32 engine on a diagonal operator: the JAX package's
    test_device_jacobi_one_sync_per_chunk problem."""
    A = np.diag(np.linspace(1.0, 40.0, 400))
    st, lmd, _, _ = _both(A, None, 5, 1e-6, dt=np.float32)
    assert st == 0
    assert np.allclose(np.sort(lmd), np.linspace(1.0, 40.0, 400)[-5:],
                       rtol=1e-4)


def test_device_jacobi_gen_restart_matches_jax(monkeypatch):
    """A failed orthonormality check forced on the first chunk in both
    packages: the restart (re-whitening, fresh images, no conjugate
    directions) runs, and both converge alike after it."""
    n = 200
    rng = np.random.RandomState(7)
    q = rng.standard_normal((n, n)) * 0.05
    A = np.diag(np.linspace(1.0, 40.0, n)) + (q + q.T)
    B = np.diag(np.linspace(1.0, 2.0, n))
    forced = {'jax': 0, 'torch': 0}
    jget = jax.device_get

    def fake_jget(x):
        vals = jget(x)
        if isinstance(vals, tuple) and len(vals) == 5 and not forced['jax']:
            forced['jax'] += 1
            return vals[:4] + (np.float64(1.0),)
        return vals
    tfetch = tdj.fetch

    def fake_tfetch(*x):
        vals = tfetch(*x)
        if not forced['torch']:
            forced['torch'] += 1
            return vals[:4] + (np.float64(1.0),)
        return vals
    monkeypatch.setattr(jax, 'device_get', fake_jget)
    monkeypatch.setattr(tdj, 'fetch', fake_tfetch)
    st, lmd, _, _ = _both(A, B, 4, 1e-8)
    assert forced == {'jax': 1, 'torch': 1} and st == 0
    exact = sla.eigh(A, B, eigvals_only=True)
    assert np.abs(np.sort(lmd)[-4:] - exact[-4:]).max() / exact[-1] < 1e-6


def test_device_jacobi_one_fetch_per_chunk(monkeypatch):
    """The chunk's statistics come back in one transfer, and nothing else
    in the solve transfers to the host: a solve of C chunks makes exactly
    C fetches and C host transfers."""
    n = 400
    d = torch.from_numpy(np.linspace(1.0, 40.0, n).astype(np.float32))

    def matmat(ops, x):
        return x * ops[0][None, :]
    eng = tdj.DeviceJacobi(matmat, n, dtype=np.float32, operands=(d,))
    v = dense_torch.Vectors(n, data_type=np.float32, device='cpu')
    calls = [0]
    real = tdj.fetch

    def counting(*x):
        calls[0] += 1
        return real(*x)
    monkeypatch.setattr(tdj, 'fetch', counting)
    dense_torch.reset_counts()
    status = eng.solve(v, options=_options(tsolver, 1e-6), nwanted=5,
                       chunk=8)
    assert status == 0
    chunks = -(-eng.iteration // 8)
    assert calls[0] == chunks == dense_torch.COUNTS['to_host'], (
        calls[0], chunks, dense_torch.COUNTS)
    assert calls[0] <= eng.iteration / 4


def test_device_jacobi_iteration_limit():
    """max_iter reached: status 2 with the pairs locked so far (the JAX
    engine stops the same way while its slots' iteration counts reach the
    limit first)."""
    A, _ = _pencil(200)
    np.random.seed(1)
    eng, v, mod = _engine('torch', A)
    st = eng.solve(v, options=_options(mod, 1e-14, max_iter=16),
                   nwanted=5)
    assert st == 2 and eng.iteration == 16
    assert v.nvec() == eng.rcon < 5


@pytest.mark.parametrize('shift', [False, True])
@pytest.mark.parametrize('transp', [False, True])
def test_svd_normal_matmat_matches_jax(transp, shift):
    rng = np.random.RandomState(0)
    a = rng.standard_normal((30, 20))
    aves = a.mean(axis=0)
    x = rng.standard_normal((4, 30 if transp else 20))
    jf, jops = jdj.svd_normal_matmat(jnp.asarray(a), transp, shift,
                                     jnp.asarray(aves))
    tf, tops = tdj.svd_normal_matmat(torch.from_numpy(a), transp, shift,
                                     torch.from_numpy(aves))
    want = np.asarray(jf(jops, jnp.asarray(x)))
    got = tf(tops, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def _iterations(text):
    return [int(v) for v in re.findall(r'iterations: (\d+)', text)]


@pytest.mark.parametrize('gen', [False, True])
def test_partial_hevp_jacobi_matches_jax(capsys, f64_default, gen):
    """engine='jacobi' with a Chebyshev: f64 iteration on A's f64 device
    values (the plain version of the f64 DIA kernel here), against the JAX
    package's engine='jacobi' under x64."""
    if gen:
        a = lap2d(16, 16, 1.0, 1.0)
        b = scs.diags(1.0 + np.random.RandomState(4).rand(a.shape[0]),
                      format='csr')
        lo, hi = spectral_bounds(a)
        lo = hi * 1e-4
    else:
        a, b = lap3d(10, 10, 10, 1.0, 1.0, 1.0), None
        lo, hi = spectral_bounds(a)
    out = []
    for fn, T, kw in ((jax_hevp, JaxChebyshev(a, lo, hi, degree=8,
                                              arch='tpu'), {'arch': 'tpu'}),
                      (partial_hevp, Chebyshev(a, lo, hi, degree=8,
                                               device='cpu'),
                       {'device': 'cpu'})):
        capsys.readouterr()
        np.random.seed(3)
        res = fn(a, B=b, T=T, which=5, tol=1e-6, verb=0, engine='jacobi',
                 **kw)
        out.append((res, _iterations(capsys.readouterr().out)))
    ((jl, jx, js), jit), ((tl, tx, ts), tit) = out
    assert ts == js == 0 and tit == jit, (ts, js, tit, jit)
    assert np.abs(tl - jl).max() <= 1e-10 * np.abs(jl).max(), (tl, jl)
    assert tx.shape == jx.shape == (a.shape[0], len(tl))
    if not gen:
        exact = np.sort(lap3d_eigenvalues(10, 10, 10, 1.0, 1.0, 1.0))[:5]
        assert np.allclose(tl[:5], exact, rtol=1e-6)


def test_partial_hevp_jacobi_options_restored():
    """The caller's Options leave engine='jacobi' as they came in, and the
    engine needs a device and a Chebyshev preconditioner."""
    a = lap3d(6, 6, 6, 1.0, 1.0, 1.0)
    T = Chebyshev(a, *spectral_bounds(a), degree=6, device='cpu')
    opt = Options()
    lmd, x, st = partial_hevp(a, T=T, which=3, tol=1e-5, verb=-1, opt=opt,
                              engine='jacobi', device='cpu')
    assert st == 0 and lmd.shape == (3,) and x.shape == (216, 3)
    assert (opt.block_size, opt.max_iter) == (-1, -1)
    assert opt.convergence_criteria is None
    with pytest.raises(ValueError):
        partial_hevp(a, T=T, which=3, engine='jacobi', arch='cpu', verb=-1)
    with pytest.raises(ValueError):
        partial_hevp(a, T=np.eye(216), which=3, engine='jacobi',
                     device='cpu', verb=-1)
