"""The PyTorch port's device LOBPCG against the JAX package's, on the CPU,
from the same start block ``x0`` (made with NumPy: the packages' random
generators differ).

In f64 both run the same algorithm up to summation order, so eigenvalues
agree to 1e-10 relative and the iteration counts (whole chunks of 16) are
equal.
"""

import numpy as np
import pytest
import scipy.sparse as scs
import torch

from raleigh_tpu.algebra.sparse import Chebyshev as JaxChebyshev
from raleigh_tpu.algebra.sparse import spectral_bounds
from raleigh_tpu.core.device_solver import lobpcg as jax_lobpcg
from raleigh_tpu.examples.laplace import lap2d, lap3d, lap3d_eigenvalues
from raleigh_tpu.ops.spmm import device_sparse as jax_device_sparse
from raleigh_tpu_torch.algebra.sparse import Chebyshev
from raleigh_tpu_torch.core.device_solver import default_block, lobpcg
from raleigh_tpu_torch.ops.spmm import device_sparse

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores (the small
# operand blocks here gain nothing from more threads).
torch.set_num_threads(1)


@pytest.fixture
def f64_default():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture(scope='module')
def lap():
    a = lap3d(10, 10, 10, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(10, 10, 10, 1.0, 1.0, 1.0))
    x0 = np.random.RandomState(0).standard_normal((a.shape[0], 8))
    return a, exact, x0


@pytest.fixture(scope='module')
def pencil():
    a = lap2d(20, 20, 1.0, 1.0)
    n = a.shape[0]
    b = scs.diags(1.0 + np.random.RandomState(2).rand(n), format='csr')
    x0 = np.random.RandomState(3).standard_normal((n, 8))
    return a, b, x0


def _rel(got, want):
    return np.abs(np.sort(got) - np.sort(want)).max() / np.abs(want).max()


@pytest.mark.parametrize('case', ['plain', 'chebyshev', 'largest'])
def test_lobpcg_matches_jax(lap, f64_default, case):
    a, exact, x0 = lap
    n = a.shape[0]
    lo, hi = spectral_bounds(a)
    k, kw = 6, dict(tol=1e-8, maxit=300, x0=x0, dtype=np.float64)
    pre = jpre = None
    if case == 'chebyshev':
        pre = Chebyshev(a, lo, hi, degree=10, device='cpu') \
            .device_rows_operands(8, n, dtype=torch.float64)
        jpre = JaxChebyshev(a, lo, hi, degree=10, arch='tpu') \
            .device_rows_operands(8, n, dtype=np.float64)
    if case == 'largest':
        k, kw = 3, dict(kw, largest=True, tol=1e-6)
    dm = device_sparse(a, dtype=np.float64, device='cpu')
    lam, x, r, it, st = lobpcg(dm, k, precond=pre, **kw)
    jlam, _, _, jit, jst = jax_lobpcg(
        jax_device_sparse(a, dtype=np.float64), k, precond=jpre, **kw)
    assert st == jst == 0
    assert it == jit
    assert _rel(lam, jlam) < 1e-10
    want = exact[-k:] if case == 'largest' else exact[:k]
    assert _rel(lam, want) < 1e-10
    assert np.abs(x.T @ x - np.eye(k)).max() < 1e-8


def test_bf16_stream_iteration_parity(lap):
    """The accuracy guard of bf16 Chebyshev streaming, f32 outer
    iteration: a preconditioner is percent-level by design, so bf16
    iterates must not change the iteration count, counted in host-check
    chunks of 16 (tests/test_device_solver.py:681-712 holds the JAX
    package so).

    At 1e-4 the counts are equal.  At 1e-5 the port's bf16 run may take
    one more chunk than its f32 run: eager PyTorch rounds the result of
    every bf16 operation (XLA may keep f32 between the operations it
    fuses), and at equal iterations its residual is about 1.5 times the
    f32 run's, which here falls across a chunk boundary.  It takes
    exactly as many chunks as the JAX package's bf16 run from the same
    start block."""
    a, exact, x0 = lap
    n = a.shape[0]
    lo, hi = spectral_bounds(a)
    ch = Chebyshev(a, hi * 1e-4, hi, degree=10, device='cpu')
    jch = JaxChebyshev(a, hi * 1e-4, hi, degree=10, arch='tpu')
    dm = device_sparse(a, device='cpu')
    jdm = jax_device_sparse(a)
    for tol, slack in ((1e-4, 0), (1e-5, 16)):
        lam, its = {}, {}
        for flag in (False, True):
            pre = ch.device_rows_operands(8, n, stream_bf16=flag)
            lam[flag], _, _, its[flag], st = lobpcg(
                dm, 6, precond=pre, block_size=8, tol=tol, maxit=300,
                x0=x0)
            assert st == 0
        assert abs(its[True] - its[False]) <= slack, (tol, its)
        assert np.abs(lam[True] - lam[False]).max() < 1e-3 * hi
        jpre = jch.device_rows_operands(8, n, stream_bf16=True)
        _, _, _, jits, jst = jax_lobpcg(jdm, 6, precond=jpre, block_size=8,
                                        tol=tol, maxit=300, x0=x0)
        assert jst == 0 and its[True] == jits, (tol, its, jits)


@pytest.mark.parametrize('case', ['generalized', 'constraints'])
def test_lobpcg_pencil_matches_jax(pencil, f64_default, case):
    """Generalized A x = λ B x (B-inner-product iteration), and deflation
    against the first 6 B-orthonormal eigenvectors given as
    ``constraints`` (the next 4 pairs come out)."""
    a, b, x0 = pencil
    kw = dict(tol=1e-8, maxit=300, x0=x0, dtype=np.float64)
    jA = jax_device_sparse(a, dtype=np.float64)
    jB = jax_device_sparse(b, dtype=np.float64)
    tA = device_sparse(a, dtype=np.float64, device='cpu')
    tB = device_sparse(b, dtype=np.float64, device='cpu')
    k = 6
    if case == 'constraints':
        _, xc, _, _, st = jax_lobpcg(jA, 6, opB=jB, **kw)
        assert st == 0
        kw['constraints'] = xc
        k = 4
    lam, x, _, it, st = lobpcg(tA, k, opB=tB, **kw)
    jlam, _, _, jit, jst = jax_lobpcg(jA, k, opB=jB, **kw)
    assert st == jst == 0 and it == jit
    assert _rel(lam, jlam) < 1e-10
    assert np.abs(x.T @ (b @ x) - np.eye(k)).max() < 1e-8
    if case == 'constraints':
        assert np.abs(kw['constraints'].T @ (b @ x)).max() < 1e-8


def test_default_block_and_errors(lap):
    a, _, _ = lap
    assert default_block(4, 10 ** 6) == 16
    assert default_block(10, 125000) == 24
    dm = device_sparse(a, device='cpu')
    with pytest.raises(ValueError):
        lobpcg(dm, 6, block_size=4)
    with pytest.raises(NotImplementedError, match='item 13'):
        lobpcg(dm, 6, sharding=object())


def test_lobpcg_takes_a_bare_callable(lap, f64_default):
    """A column-layout callable on tensors, with ``n`` given, is the same
    operator as the DIA matrix it wraps."""
    a, exact, x0 = lap
    dm = device_sparse(a, dtype=np.float64, device='cpu')
    kw = dict(tol=1e-8, maxit=300, x0=x0, dtype=np.float64)
    lam, _, _, it, st = lobpcg(dm, 6, **kw)
    lam2, _, _, it2, st2 = lobpcg(dm.matmat_t, 6, n=a.shape[0],
                                  device='cpu', **kw)
    assert st == st2 == 0 and it == it2
    assert _rel(lam2, lam) < 1e-12
