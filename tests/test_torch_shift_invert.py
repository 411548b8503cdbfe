"""``partial_hevp`` on the core Solver: shift-invert, interior shift,
generalized (the product problem), buckling, a complex Hermitian chain,
the factorization probe's ``(None, None, -1)``, and ``engine='core'``
with a Chebyshev, an ILU and an ndarray-level preconditioner, each run on
the CPU (``device='cpu'``: dense_torch blocks, the kernels' plain
versions) against the JAX package's ``partial_hevp`` (``arch='tpu'``,
dense_jax blocks) with the same ``opt.orchestration`` and the same seed:
f64 eigenvalues within 1e-10 relative and equal iteration counts.  Also
the f64 instantiations' wrappers (K1, K5) on the CPU against the JAX
package's fused XLA versions under x64, and the port's copies of the
native C++ sources and of the LDL^T binding.
"""

import os
import re

import numpy as np
import pytest
import scipy.sparse as scs
import scipy.sparse.linalg as spl
import torch

from raleigh_tpu.algebra.sparse import Chebyshev as JaxChebyshev
from raleigh_tpu.algebra.sparse import IncompleteLU as JaxILU
from raleigh_tpu.core.solver import Options as JaxOptions
from raleigh_tpu.examples.laplace import lap2d, lap3d, lap3d_eigenvalues
from raleigh_tpu.interfaces.partial_hevp import partial_hevp as jax_hevp
from raleigh_tpu_torch import (Chebyshev, IncompleteLU, Options,
                               partial_hevp, spectral_bounds)

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores (the small
# operand blocks here gain nothing from more threads).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def f64_default():
    """f64 device values, as the JAX package keeps them under x64."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _iterations(text):
    return [int(v) for v in re.findall(r'iterations: (\d+)', text)]


def _both(capsys, args, orchestration=None, jax_kw=None, port_kw=None,
          **kw):
    """The same call on both packages from the same seed: (jax result,
    port result, jax iterations, port iterations)."""
    out = []
    for fn, opt_cls, extra in ((jax_hevp, JaxOptions,
                                dict(arch='tpu', **(jax_kw or {}))),
                               (partial_hevp, Options,
                                dict(device='cpu', **(port_kw or {})))):
        opt = opt_cls()
        if orchestration is not None:
            opt.orchestration = orchestration
        capsys.readouterr()
        np.random.seed(3)
        res = fn(*args, opt=opt, verb=0, **{**kw, **extra})
        out.append((res, _iterations(capsys.readouterr().out)))
    (jres, jit), (tres, tit) = out
    return jres, tres, jit, tit


def _agree(jres, tres, jit, tit, k, rel=1e-10):
    jl, jx, js = jres
    tl, tx, ts = tres
    assert ts == js and tit == jit, (ts, js, tit, jit)
    assert tl.shape == jl.shape and tx.shape == jx.shape
    assert np.abs(tl - jl).max() <= rel * np.abs(jl).max(), (tl, jl)
    return tl[:k], tx[:, :k]


@pytest.mark.parametrize('orchestration', ['device', 'host'])
def test_shift_invert_matches_jax(capsys, orchestration):
    a = lap3d(12, 12, 12, 1.0, 1.01, 1.02)
    jres, tres, jit, tit = _both(capsys, (a,), orchestration, sigma=0,
                                 which=6, tol=1e-6)
    lmd, x = _agree(jres, tres, jit, tit, 6)
    exact = np.sort(lap3d_eigenvalues(12, 12, 12, 1.0, 1.01, 1.02))[:6]
    assert np.allclose(lmd, exact, rtol=1e-6)
    r = a @ x - x * lmd[None, :]
    assert np.linalg.norm(r) < 1e-4 * exact[-1]


def test_interior_shift_matches_jax(capsys):
    a = lap3d(8, 8, 8, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(8, 8, 8, 1.0, 1.0, 1.0))
    sigma = float(0.5 * (exact[9] + exact[10]))
    jres, tres, jit, tit = _both(capsys, (a,), sigma=sigma, which=6,
                                 tol=1e-6)
    lmd, _ = _agree(jres, tres, jit, tit, len(tres[0]))
    got = np.sort(np.abs(lmd - sigma))
    assert np.allclose(got, np.sort(np.abs(exact - sigma))[:len(got)],
                       rtol=1e-6)


def test_generalized_shift_invert_matches_jax(capsys):
    """The product problem (A - sigma B)^-1 B x = mu x: B's apply runs on
    B's device matrix (DIA, f64 values), the solve on the host."""
    a = lap2d(16, 16, 1.0, 1.0)
    n = a.shape[0]
    b = scs.diags(1.0 + np.random.RandomState(2).rand(n), format='csr')
    jres, tres, jit, tit = _both(capsys, (a,), B=b, sigma=0, which=4,
                                 tol=1e-6)
    lmd, _ = _agree(jres, tres, jit, tit, 4)
    w = spl.eigsh(a, M=b, k=4, sigma=0, which='LM',
                  return_eigenvectors=False)
    assert np.allclose(lmd, np.sort(w), rtol=1e-6)


def test_buckling_matches_jax(capsys):
    """K x = lmd Ks x: descending load factors nearest zero first."""
    k = lap2d(12, 12, 1.0, 1.0)
    n = k.shape[0]
    ks = scs.diags(np.linspace(-1.0, -2.0, n), format='csr')
    s_inv = scs.diags(1.0 / np.sqrt(-ks.diagonal()))
    w = np.sort(-np.linalg.eigvalsh((s_inv @ k @ s_inv).toarray()))[::-1]
    jres, tres, jit, tit = _both(capsys, (k,), B=ks, buckling=True,
                                 sigma=-15.0, which=3, tol=1e-6)
    lmd, _ = _agree(jres, tres, jit, tit, 3)
    assert np.allclose(lmd, w[:3], rtol=1e-4)


def test_complex_hermitian_matches_jax(capsys):
    """A complex Hermitian chain through the native LDL^H on c128 blocks
    (B=None: no device SpMM)."""
    n = 128
    d = 1j * np.ones(n - 1)
    a = scs.csr_matrix(np.diag(d, 1) - np.diag(d, -1)
                       + np.diag(np.linspace(0, 1, n)))
    w = np.linalg.eigvalsh(a.toarray())
    sigma = 0.3
    jres, tres, jit, tit = _both(capsys, (a,), sigma=sigma, which=4,
                                 tol=1e-6)
    lmd, x = _agree(jres, tres, jit, tit, 4)
    assert x.dtype == np.complex128
    got = np.sort(np.abs(tres[0] - sigma))
    assert np.allclose(got, np.sort(np.abs(w - sigma))[:len(got)],
                       atol=1e-6)
    assert np.linalg.norm(a @ x - x * lmd[None, :]) < 1e-4


@pytest.mark.parametrize('arch', [None, 'cpu'])
def test_probe_aborts_when_sigma_is_an_eigenvalue(capsys, arch):
    """sigma on an eigenvalue: the factorization-accuracy probe returns
    (None, None, -1), on dense_torch blocks and on the host."""
    a = scs.diags(np.arange(200, dtype=np.float64), format='csr')
    kw = {'arch': 'cpu'} if arch == 'cpu' else {'device': 'cpu'}
    lmd, x, status = partial_hevp(a, sigma=5.0, which=2, tol=1e-6, verb=0,
                                  **kw)
    assert (lmd, x, status) == (None, None, -1)
    assert 'too inaccurate' in capsys.readouterr().out
    assert jax_hevp(a, sigma=5.0, which=2, tol=1e-6, verb=-1)[2] == -1


def test_core_engine_chebyshev_matches_jax(capsys, f64_default):
    """engine='core' with a Chebyshev: the Solver on dense_torch blocks,
    the recurrence on the preconditioner's device matrix in the blocks'
    f64 (the plain version of the f64 DIA kernel here)."""
    a = lap3d(10, 10, 10, 1.0, 1.0, 1.0)
    lo, hi = spectral_bounds(a)
    T = Chebyshev(a, lo, hi, degree=8, device='cpu')
    jT = JaxChebyshev(a, lo, hi, degree=8, arch='tpu')
    jres, tres, jit, tit = _both(capsys, (a,), which=5, tol=1e-6,
                                 engine='core', jax_kw={'T': jT},
                                 port_kw={'T': T})
    lmd, _ = _agree(jres, tres, jit, tit, 5)
    exact = np.sort(lap3d_eigenvalues(10, 10, 10, 1.0, 1.0, 1.0))[:5]
    assert np.allclose(lmd, exact, rtol=1e-6)


def test_core_engine_generalized_solves_the_pencil():
    """engine='core' with B: the Solver's generalized problem A x = lmd B x,
    preconditioned, within 1e-6 of eigsh.  (The JAX package's partial_hevp
    passes 'gen' as ``Problem``'s ``prod`` argument, which makes it the
    product problem A B x = lmd x with the preconditioner never applied;
    the port passes none, so there is no JAX result to hold it against.)"""
    a = lap2d(16, 16, 1.0, 1.0)
    b = scs.diags(1.0 + np.random.RandomState(2).rand(a.shape[0]),
                  format='csr')
    lo, hi = spectral_bounds(a)
    T = Chebyshev(a, lo, hi, degree=8, device='cpu')
    w = np.sort(spl.eigsh(a, M=b, k=4, sigma=0, which='LM',
                          return_eigenvectors=False))
    for kw in ({'device': 'cpu'}, {'arch': 'cpu'}):
        lmd, x, status = partial_hevp(a, B=b, T=T, which=4, tol=1e-6,
                                      engine='core', verb=-1, **kw)
        assert status == 0 and np.allclose(lmd[:4], w, rtol=1e-6), lmd
        assert np.abs(x.T @ (b @ x) - np.eye(x.shape[1])).max() < 1e-8


def test_core_engine_ilu_and_ndarray_preconditioner_match_jax(capsys):
    """engine 'auto' with a preconditioner the device engine cannot take
    runs the core Solver: the port's IncompleteLU, and an object of no
    package with an ndarray-level apply (wrapped in ``Operator``)."""
    a = lap3d(8, 8, 8, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(8, 8, 8, 1.0, 1.0, 1.0))[:4]
    T = IncompleteLU(a)
    T.factorize(tol=1e-4, max_fill=4)
    jT = JaxILU(a)
    jT.factorize(tol=1e-4, max_fill=4)
    jres, tres, jit, tit = _both(capsys, (a,), which=4, tol=1e-6,
                                 jax_kw={'T': jT}, port_kw={'T': T})
    lmd, _ = _agree(jres, tres, jit, tit, 4)
    assert np.allclose(lmd, exact, rtol=1e-6)

    jacobi = _Jacobi(a)
    jres, tres, jit, tit = _both(capsys, (a,), T=jacobi, which=4, tol=1e-6)
    lmd, _ = _agree(jres, tres, jit, tit, 4)
    assert np.allclose(lmd, exact, rtol=1e-6)


class _Jacobi:
    """A diagonal preconditioner with an ndarray-level apply."""

    def __init__(self, a):
        self.inv = 1.0 / a.diagonal()

    def apply(self, x, y):
        y[...] = x * self.inv[None, :]


def test_f64_wrappers_on_cpu_match_jax():
    """The f64 instantiations' wrappers (K1: f64 operand with f32 or f64
    values; K5: f64 operand with f32 or f64 tiles) take their plain
    versions on the CPU, counting no launch, and agree with the JAX
    package's fused XLA SpMMs under x64 within 1e-13 of the largest
    entry."""
    import jax.numpy as jnp
    from raleigh_tpu.ops.spmm import _bsr_matmat, _dia_matmat_rows
    from raleigh_tpu_torch.examples.fe_model import fe_pencil
    from raleigh_tpu_torch.ops import spmm_pallas as sp
    from raleigh_tpu_torch.ops import spmm_window as sw
    from raleigh_tpu_torch.ops.spmm import BsrMatrix, DiaMatrix

    rng = np.random.RandomState(4)
    a = lap3d(6, 7, 5, 1.0, 1.3, 0.7)
    n = a.shape[0]
    x = rng.standard_normal((5, n))
    before = dict(sw.LAUNCHES), dict(sp.LAUNCHES)
    for values in (np.float32, np.float64):
        dm = DiaMatrix(a, dtype=values, device='cpu', exact=True)
        got = sw.dia_matmat_rows(dm.val, torch.from_numpy(x), dm.offsets_t)
        want = np.asarray(_dia_matmat_rows(
            jnp.asarray(dm.val.numpy().astype(np.float64)), jnp.asarray(x),
            dm.offsets))
        assert got.dtype == torch.float64
        assert np.abs(got.numpy() - want).max() < 1e-13 * np.abs(want).max()

    k = fe_pencil(9, 3, 0.1, seed=2, which='k')
    n = k.shape[0]
    x = rng.standard_normal((7, n))
    for tiles in (np.float32, np.float64):
        bm = BsrMatrix(k, dtype=tiles, bs=16, device='cpu', exact=True)
        got = sp.bsr_matmat_rows(bm.blocks, bm.block_indptr_t, bm.block_cols,
                                 torch.from_numpy(x), n)
        bs, nb = bm.bs, bm.nb
        xt = np.zeros((nb * bs, x.shape[0]))
        xt[:n] = x.T
        y = _bsr_matmat(jnp.asarray(bm.blocks.numpy().astype(np.float64)),
                        jnp.asarray(bm.block_cols.numpy()),
                        jnp.asarray(bm.block_rows.numpy()),
                        jnp.asarray(xt.reshape(nb, bs, -1)), nb)
        want = np.asarray(y).reshape(nb * bs, -1)[:n].T
        assert got.dtype == torch.float64
        assert np.abs(got.numpy() - want).max() < 1e-13 * np.abs(want).max()
    assert (dict(sw.LAUNCHES), dict(sp.LAUNCHES)) == before


def test_native_sources_and_binding_are_copies():
    """The C++ sources are the JAX package's byte for byte; the port's
    binding builds its own library (under raleigh_tpu_torch/_build/) and
    factorizes, solves and counts inertia as the original does."""
    for name in ('ldlt.cpp', 'mf.cpp', 'nd.cpp', 'amd.cpp', 'ilut.cpp'):
        with open(os.path.join(ROOT, 'raleigh_tpu_torch', 'native',
                               name), 'rb') as f:
            mine = f.read()
        with open(os.path.join(ROOT, 'raleigh_tpu', 'native', name),
                  'rb') as f:
            assert mine == f.read(), name
    from raleigh_tpu.native.ldlt import SparseLDLT as JaxLDLT
    from raleigh_tpu_torch.native import ldlt
    a = lap3d(6, 6, 6, 1.0, 1.0, 1.0) - 30.0 * scs.eye(216, format='csr')
    mine, ref = ldlt.SparseLDLT(a), JaxLDLT(a)
    for s in (mine, ref):
        s.analyse()
        s.factorize()
    b = np.random.RandomState(1).standard_normal((3, 216))
    assert mine.inertia() == ref.inertia()
    assert np.abs(mine.solve(b) - ref.solve(b)).max() < 1e-12
    assert os.path.dirname(ldlt._LIB).endswith(
        os.path.join('raleigh_tpu_torch', '_build'))
