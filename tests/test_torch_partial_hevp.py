"""The port's slice end to end: ``partial_hevp`` with a Chebyshev
preconditioner on the device LOBPCG engine, run on the CPU
(``arch='gpu', device='cpu'``) against the JAX package's
``partial_hevp(..., arch='tpu')`` on the same matrices, in f64."""

import numpy as np
import pytest
import scipy.sparse as scs
import scipy.sparse.linalg as spl
import torch

from raleigh_tpu.algebra.sparse import Chebyshev as JaxChebyshev
from raleigh_tpu.examples.laplace import lap2d, lap3d, lap3d_eigenvalues
from raleigh_tpu.interfaces.partial_hevp import partial_hevp as jax_hevp
from raleigh_tpu_torch import (Chebyshev, SparseSymmetricMatrix,
                               partial_hevp, spectral_bounds)

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


def _problem(kind):
    if kind == 'standard':
        a = lap3d(10, 10, 10, 1.0, 1.0, 1.0)
        exact = np.sort(lap3d_eigenvalues(10, 10, 10, 1.0, 1.0, 1.0))
        return a, None, exact
    a = lap2d(20, 20, 1.0, 1.0)
    b = scs.diags(1.0 + np.random.RandomState(2).rand(a.shape[0]),
                  format='csr')
    exact = np.sort(spl.eigsh(a, M=b, k=6, sigma=0, which='LM',
                              return_eigenvectors=False))
    return a, b, exact


@pytest.mark.parametrize('kind', ['standard', 'generalized'])
def test_partial_hevp_matches_jax(f64_default, kind):
    """Both packages start from their own random blocks, so they agree to
    the accuracy tol=1e-8 buys: eigenvalue errors go as the residual
    squared, far below the 1e-8 relative asked here, in f64."""
    a, b, exact = _problem(kind)
    lo, hi = spectral_bounds(a)
    T = Chebyshev(a, lo, hi, degree=10, arch='gpu', device='cpu')
    lmd, x, status = partial_hevp(a, B=b, T=T, which=6, tol=1e-8, verb=-1,
                                  arch='gpu', device='cpu')
    jT = JaxChebyshev(a, lo, hi, degree=10, arch='tpu')
    jlmd, _, jstatus = jax_hevp(a, B=b, T=jT, which=6, tol=1e-8, verb=-1,
                                arch='tpu')
    assert status == jstatus == 0
    assert lmd.shape == (6,) and x.shape == (a.shape[0], 6)
    assert x.dtype == np.float64
    assert np.abs(lmd - np.sort(jlmd)).max() / np.abs(jlmd).max() < 1e-8
    assert np.abs(lmd - exact[:6]).max() / exact[5] < 1e-8
    bx = x if b is None else b @ x
    assert np.abs(x.T @ bx - np.eye(6)).max() < 1e-8


def test_iteration_dtype_follows_default(capsys):
    """float64 only while it is torch's default dtype (the JAX package's
    jax_enable_x64 rule); otherwise the f32 outer iteration."""
    a = lap3d(6, 6, 6, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(6, 6, 6, 1.0, 1.0, 1.0))
    lo, hi = spectral_bounds(a)
    T = Chebyshev(a, lo, hi, degree=8, device='cpu')
    lmd, x, status = partial_hevp(a, T=T, which=4, tol=1e-4, verb=0,
                                  arch='gpu', device='cpu')
    assert status == 0 and x.dtype == np.float32
    assert np.abs(lmd - exact[:4]).max() / exact[3] < 1e-4
    assert 'iterations:' in capsys.readouterr().out


def test_unported_paths_raise(monkeypatch):
    """No mode is left unported: engine='jacobi' (ported last),
    shift-invert (T=None) and engine='core' run and converge; the device
    engines refuse arch='cpu'; arch='gpu' with no card raises, it never
    runs on the CPU instead."""
    a = lap3d(4, 4, 4, 1.0, 1.0, 1.0)
    T = Chebyshev(a, 0.1, 1e3, device='cpu')
    kw = dict(arch='gpu', device='cpu', verb=-1)
    exact = np.sort(lap3d_eigenvalues(4, 4, 4, 1.0, 1.0, 1.0))[:4]
    lmd, _, status = partial_hevp(a, T=T, which=4, tol=1e-6,
                                  engine='jacobi', **kw)
    assert status == 0 and np.allclose(lmd[:4], exact, rtol=1e-6)
    lmd, _, status = partial_hevp(a, which=4, tol=1e-6, **kw)
    assert status == 0 and np.allclose(lmd[:4], exact, rtol=1e-6)
    lmd, _, status = partial_hevp(a, T=T, which=4, tol=1e-6,
                                  engine='core', **kw)
    assert status == 0 and np.allclose(lmd[:4], exact, rtol=1e-6)
    lmd, _, status = partial_hevp(a, T=T, which=4, tol=1e-6, arch='cpu',
                                  verb=-1)
    assert status == 0 and np.allclose(lmd[:4], exact, rtol=1e-6)
    for engine in ('device', 'jacobi'):
        with pytest.raises(ValueError):
            partial_hevp(a, T=T, which=4, arch='cpu', engine=engine)
    # arch='gpu' with no card raises; it never runs on the CPU instead
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA'):
        partial_hevp(a, T=T, which=4, arch='gpu')
    with pytest.raises(RuntimeError, match='no CUDA'):
        partial_hevp(a, which=4, arch='gpu')
    with pytest.raises(RuntimeError, match='no CUDA'):
        Chebyshev(a, 0.1, 1e3, arch='gpu')


def test_preconditioner_matrix_is_shared(monkeypatch):
    """A sits on the device once: partial_hevp takes the device matrix of
    a preconditioner built from the same matrix object, and builds its
    own for any other matrix, with the same result."""
    from raleigh_tpu_torch.interfaces import partial_hevp as ph
    a = lap3d(6, 6, 6, 1.0, 1.0, 1.0)
    lo, hi = spectral_bounds(a)
    T = Chebyshev(a, lo, hi, degree=8, device='cpu')
    built = []

    def counted(*args, **kw):
        built.append(1)
        return SparseSymmetricMatrix(*args, **kw)
    monkeypatch.setattr(ph, 'SparseSymmetricMatrix', counted)
    kw = dict(T=T, which=4, tol=1e-4, verb=-1, arch='gpu', device='cpu')
    lmd, _, status = partial_hevp(a, **kw)
    assert status == 0 and built == []
    lmd2, _, status2 = partial_hevp(a.copy(), **kw)
    assert status2 == 0 and built == [1]
    assert np.array_equal(lmd, lmd2)


@pytest.mark.parametrize('path', ['device', 'core', 'shift-invert'])
def test_b_device_matrix_is_shared(monkeypatch, path):
    """B sits on the device once: a second call with the same B object
    builds no matrix, on the device LOBPCG path, on the core Solver and in
    shift-invert (where the probe's host operators are kept as well); a
    new B object is built anew."""
    from raleigh_tpu_torch.interfaces import partial_hevp as ph
    a = lap2d(12, 12, 1.0, 1.0)
    b = scs.diags(1.0 + np.random.RandomState(2).rand(a.shape[0]),
                  format='csr')
    lo, hi = spectral_bounds(a)
    T = Chebyshev(a, lo, hi, degree=8, device='cpu')
    built = []

    def counted(*args, **kw):
        built.append(1)
        return SparseSymmetricMatrix(*args, **kw)
    monkeypatch.setattr(ph, 'SparseSymmetricMatrix', counted)
    kw = dict(B=b, which=4, tol=1e-5, verb=-1, device='cpu')
    if path == 'shift-invert':
        kw.update(sigma=0)
    else:
        kw.update(T=T, engine=path)
    lmd, _, status = partial_hevp(a, **kw)
    first = len(built)
    assert status == 0 and first >= 1
    lmd2, _, status2 = partial_hevp(a, **kw)
    assert status2 == 0 and len(built) == first
    assert np.allclose(lmd, lmd2, rtol=1e-8)
    kw['B'] = b.copy()
    partial_hevp(a, **kw)
    assert len(built) > first
