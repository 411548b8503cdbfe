"""The port's chunked per-vector Jacobi engine (``raleigh_tpu_torch.core.
device_jacobi.DeviceJacobi``) on the CPU, on the problems of
``tests/test_device_solver.py`` (the generalized pencil, its forced restart,
the one-fetch-per-chunk count), its standard twin and a complex Hermitian
pencil, held against ``scipy.linalg.eigh``: eigenvalues within 1e-10
relative in f64, eigenvectors within ten times the tolerance asked.  The
JAX package's engine is not the reference there: it locks these pairs as
stagnated once their eigenvalue decrements fall below sqrt(eps) |lambda|,
with eigenvectors 7e-5 to 2e-4 from the exact ones at a tolerance of 1e-8
(1.6e-2 in f32 at 1e-6), and it drops complex blocks (ROADMAP fault 3.6).
Also ``svd_normal_matmat`` against the JAX operator,
``partial_hevp(engine='jacobi', device='cpu')`` on small Laplacians
(standard against the JAX package's ``engine='jacobi'``, generalized
against the exact pencil; the Chebyshev recurrence and A in f64), and
``truncated_svd`` at nsv = 150 on the device engine in f32 (every value
within 1e-3 of the host SVD) and f64 (no restart, every chunk's block
orthonormal to sqrt(eps)) in three row orders.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as scs
import torch
from threadpoolctl import threadpool_limits

import raleigh_tpu.core.device_jacobi as jdj
from raleigh_tpu.algebra.sparse import Chebyshev as JaxChebyshev
from raleigh_tpu.examples.laplace import lap2d, lap3d, lap3d_eigenvalues
from raleigh_tpu.interfaces.partial_hevp import partial_hevp as jax_hevp
import raleigh_tpu_torch.core.device_jacobi as tdj
from raleigh_tpu_torch import Chebyshev, Options, partial_hevp, truncated_svd
from raleigh_tpu_torch import spectral_bounds
from raleigh_tpu_torch.algebra import dense_torch
from raleigh_tpu_torch.core import solver as tsolver
from raleigh_tpu_torch.examples.generate_matrix import generate

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


def _engine(A, B=None, dt=np.float64):
    """The port's engine on the dense operator(s) and an empty block of
    device Vectors."""
    n = A.shape[0]

    def mm(ops, x):
        return torch.matmul(x, ops[0].T)
    eng = tdj.DeviceJacobi(
        mm, n, dtype=dt, operands=(torch.from_numpy(A.astype(dt)),),
        matmat_b=mm if B is not None else None,
        operands_b=(torch.from_numpy(B.astype(dt)),) if B is not None
        else None)
    return eng, dense_torch.Vectors(n, data_type=dt, device='cpu')


def _options(tol, max_iter=300):
    opt = tsolver.Options()
    opt.convergence_criteria = tsolver.DefaultConvergenceCriteria()
    opt.convergence_criteria.set_error_tolerance('k eigenvector error', tol)
    opt.max_iter = max_iter
    opt.verbosity = -1
    return opt


def _vector_errors(X, V, B=None):
    """The sine of the angle between each row of X and the span of the
    exact eigenvectors V (columns, B-orthonormal), in the B-inner
    product."""
    Bm = np.eye(V.shape[0]) if B is None else B
    X = X / np.sqrt(np.einsum('ij,jk,ik->i', X.conj(), Bm, X).real)[:, None]
    c = X.conj() @ Bm @ V
    return np.sqrt(np.clip(1.0 - (np.abs(c) ** 2).sum(axis=1), 0.0, None))


def _exact(A, B, nwanted, tol, dt=np.float64):
    """The port's engine alone, held against ``scipy.linalg.eigh``: status
    0, the nwanted largest eigenvalues within 1e-10 relative (1e-5 in f32)
    and every eigenvector within 10 tol (1e-3 in f32, whose rounding the
    tolerance may lie under) of the exact span."""
    np.random.seed(1)
    eng, v = _engine(A, B, dt)
    st = eng.solve(v, options=_options(tol), nwanted=nwanted)
    lmd, X = eng.eigenvalues, v.data()
    exact, V = sla.eigh(A, B)
    exact, V = exact[-nwanted:], V[:, -nwanted:]
    single = np.finfo(dt).eps > 1e-10
    assert st == 0 and lmd.shape == (nwanted,), (st, lmd)
    err = np.abs(np.sort(lmd) - exact).max() / np.abs(exact).max()
    assert err <= (1e-5 if single else 1e-10), (err, lmd, exact)
    verr = _vector_errors(X.astype(np.complex128), V, B).max()
    assert verr <= (1e-3 if single else 10 * tol), verr
    return st, lmd, X, eng


@pytest.mark.parametrize('gen', [False, True])
def test_device_jacobi_matches_jax(gen):
    A, B = _pencil()
    st, lmd, X, eng = _exact(A, B if gen else None, 5, 1e-8)
    g = X @ (B if gen else np.eye(A.shape[0])) @ X.T
    assert np.abs(g - np.eye(X.shape[0])).max() < 1e-6
    # Solver-compatible observability
    assert eng.residual_norms.shape[0] == eng.rcon == 5
    assert eng.eigenvalue_errors.kinematic.shape[0] == eng.rcon
    assert isinstance(eng.eigenvectors, dense_torch.Vectors)
    assert eng.eigenvectors.nvec() == 5


def test_device_jacobi_f32_matches_jax():
    """The f32 engine on a diagonal operator: the JAX package's
    test_device_jacobi_one_sync_per_chunk problem, held against the exact
    eigenpairs."""
    A = np.diag(np.linspace(1.0, 40.0, 400))
    st, lmd, _, _ = _exact(A, None, 5, 1e-6, dt=np.float32)
    assert np.allclose(np.sort(lmd), np.linspace(1.0, 40.0, 400)[-5:],
                       rtol=1e-4)


def test_device_jacobi_gen_restart_matches_jax(monkeypatch):
    """A failed orthonormality check forced on the first chunk: the
    restart (re-whitening, fresh images, no conjugate directions) runs,
    and the engine converges after it to the exact eigenpairs."""
    n = 200
    rng = np.random.RandomState(7)
    q = rng.standard_normal((n, n)) * 0.05
    A = np.diag(np.linspace(1.0, 40.0, n)) + (q + q.T)
    B = np.diag(np.linspace(1.0, 2.0, n))
    forced = [0]
    tfetch = tdj.fetch

    def fake_tfetch(*x):
        vals = tfetch(*x)
        if not forced[0]:
            forced[0] += 1
            return vals[:4] + (np.float64(1.0),)
        return vals
    monkeypatch.setattr(tdj, 'fetch', fake_tfetch)
    st, lmd, _, eng = _exact(A, B, 4, 1e-8)
    assert forced == [1] and st == 0 and eng.restarts == 1


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
    status = eng.solve(v, options=_options(1e-6), nwanted=5,
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
    eng, v = _engine(A)
    st = eng.solve(v, options=_options(1e-14, max_iter=16),
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
    values (the plain version of the f64 DIA kernel here).  The standard
    problem against the JAX package's engine='jacobi' under x64 (the same
    iterations); the generalized one against the exact pencil, eigenvalues
    within 1e-10 relative and eigenvectors within 10 tol: there the JAX
    package's engine locks its pairs as stagnated with eigenvectors 2.9e-5
    from the exact ones at tol 1e-6 (ROADMAP fault 3.6)."""
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
    runs = ((partial_hevp, Chebyshev(a, lo, hi, degree=8, device='cpu'),
             {'device': 'cpu'}),)
    if not gen:
        runs = ((jax_hevp, JaxChebyshev(a, lo, hi, degree=8, arch='tpu'),
                 {'arch': 'tpu'}),) + runs
    for fn, T, kw in runs:
        capsys.readouterr()
        np.random.seed(3)
        res = fn(a, B=b, T=T, which=5, tol=1e-6, verb=0, engine='jacobi',
                 **kw)
        out.append((res, _iterations(capsys.readouterr().out)))
    (tl, tx, ts), tit = out[-1]
    assert ts == 0 and tx.shape == (a.shape[0], len(tl))
    if gen:
        exact, V = sla.eigh(a.toarray(), b.toarray())
        err = np.abs(tl[:5] - exact[:5]).max() / np.abs(exact[:5]).max()
        assert err <= 1e-10, (tl, exact[:5])
        verr = _vector_errors(tx[:, :5].T, V[:, :5], b.toarray()).max()
        assert verr <= 1e-5, verr
        return
    (jl, jx, js), jit = out[0]
    assert js == 0 and tit == jit, (js, tit, jit)
    assert np.abs(tl - jl).max() <= 1e-10 * np.abs(jl).max(), (tl, jl)
    assert tx.shape == jx.shape
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


def _hermitian_pencil(n=300, seed=3):
    """A complex Hermitian twin of _pencil: a noisy diagonal A, a
    tridiagonal Hermitian positive definite B."""
    rng = np.random.RandomState(seed)
    q = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))) \
        * 0.05
    A = np.diag(np.linspace(1.0, 60.0, n)) + (q + q.conj().T)
    c = 0.2 * (rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1))
    B = np.diag(np.linspace(1.0, 2.0, n)).astype(np.complex128)
    B[np.arange(n - 1), np.arange(1, n)] = c
    B[np.arange(1, n), np.arange(n - 1)] = c.conj()
    return A, B


@pytest.mark.parametrize('gen', [False, True])
def test_device_jacobi_c128_matches_eigh(gen):
    """Complex Hermitian blocks, standard and generalized: the engine's
    projections take the coefficients <basis, row> (not their conjugates)
    and its whitening mixes rows by (V Lambda^-1/2)^T, so it converges to
    the exact eigenpairs."""
    A, B = _hermitian_pencil()
    _exact(A, B if gen else None, 5, 1e-8, dt=np.complex128)


def _svd_case(perm, dt):
    """generate(1000, 800, 400) after np.random.seed(1), its rows as
    generated (perm 0) or permuted by np.random.RandomState(perm)."""
    np.random.seed(1)
    a = generate(1000, 800, 400, dtype=dt)[0]
    if perm:
        a = a[np.random.RandomState(perm).permutation(a.shape[0])]
    return a


@pytest.mark.parametrize('perm', [0, 3, 5])
def test_truncated_svd_f32_every_value(perm):
    """f32 truncated_svd(nsv=150) on the device engine, at the default
    iteration limit, returns all 150 values, each within 1e-3 relative of
    the host SVD, in every row order."""
    a = _svd_case(perm, np.float32)
    s0 = np.linalg.svd(a.astype(np.float64), compute_uv=False)[:150]
    _, sigma, _ = truncated_svd(a, nsv=150, device='cpu')
    assert sigma.shape == (150,), sigma.shape
    err = np.abs(sigma - s0) / s0
    assert err.max() <= 1e-3, err.max()


@pytest.mark.parametrize('perm', [0, 3, 5])
def test_truncated_svd_f64_no_restart(monkeypatch, perm):
    """f64 truncated_svd(nsv=150) on the device engine: every chunk's
    block leaves orthonormal to sqrt(eps), so no chunk restarts, and the
    engine converges within its default iteration limit, every value
    within 1e-10 relative of the host SVD."""
    a = _svd_case(perm, np.float64)
    s0 = np.linalg.svd(a, compute_uv=False)[:150]
    gram_errs, runs = [], []
    fetch, solve = tdj.fetch, tdj.DeviceJacobi.solve

    def recording_fetch(*x):
        vals = fetch(*x)
        gram_errs.append(float(vals[4]))
        return vals

    def recording_solve(self, *args, **kw):
        status = solve(self, *args, **kw)
        runs.append((status, self.iteration))
        return status
    monkeypatch.setattr(tdj, 'fetch', recording_fetch)
    monkeypatch.setattr(tdj.DeviceJacobi, 'solve', recording_solve)
    _, sigma, _ = truncated_svd(a, nsv=150, device='cpu')
    assert max(gram_errs) <= np.sqrt(np.finfo(np.float64).eps), gram_errs
    assert len(runs) == 1 and runs[0][0] == 0 and runs[0][1] < 100, runs
    assert sigma.shape == (150,)
    assert (np.abs(sigma - s0) / s0).max() <= 1e-10


def test_bench_jacobi_on_the_cpu():
    """benches/bench_jacobi.py at a small size on the CPU: every run
    returns its values within 1e-5 of the host SVD, the device engine
    counts its iterations and no restart; and ``--parts`` times its twelve
    small dense operations."""
    from raleigh_tpu_torch.benches import bench_jacobi
    rows = bench_jacobi.main(['--device', 'cpu', '--m', '300', '--n', '200',
                              '--rank', '100', '--nsv', '20', '--perm', '3'])
    assert [(r['dtype'], r['engine']) for r in rows] == [
        ('float64', 'auto'), ('float32', 'host'), ('float32', 'auto')]
    for r in rows:
        assert r['values'] >= 20 and r['agree'] <= 1e-5, r
        assert r['restarts'] == 0, r
        assert (r['iterations'] is None) == (r['engine'] == 'host'), r
    times = bench_jacobi.main(['--device', 'cpu', '--parts'])
    assert len(times) == 12 and min(times.values()) > 0, times
