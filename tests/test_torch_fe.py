"""The finite-element operator path of the PyTorch port against the JAX
package, on the CPU: the port's own copies of the jax-free host code, the
ELL layout, the layout rule, the Chebyshev recurrence over ELL, and the
slice as a whole (``partial_hevp`` on the pencil K x = lambda M x).

Inputs are small box-girder pencils, fe_pencil(9, 3, 0.1, seed=2)
(n = 2,796) and fe_pencil(10, 3, 0.15, seed=5), and seeded NumPy blocks.
Tolerances, relative to the largest |entry| of the reference: f32 1e-6
(f32 accumulation in another order), f64 1e-12; whole solves in f64 agree
to 1e-10 with equal iteration counts from one start block.
"""

import inspect

import numpy as np
import pytest
import scipy.sparse as scs
import scipy.sparse.linalg as spl
import torch

import jax.numpy as jnp

from raleigh_tpu.algebra.sparse import Chebyshev as JaxChebyshev
from raleigh_tpu.algebra.sparse import spectral_bounds as jax_spectral_bounds
from raleigh_tpu.core import solver as jax_solver
from raleigh_tpu.core.device_solver import lobpcg as jax_lobpcg
from raleigh_tpu.examples import fe_model as jax_fe
from raleigh_tpu.examples import laplace as jax_laplace
from raleigh_tpu.interfaces.partial_hevp import partial_hevp as jax_hevp
from raleigh_tpu.ops import spmm as jax_spmm
import raleigh_tpu_torch as rt
from raleigh_tpu_torch.algebra.sparse import (Chebyshev,
                                              SparseSymmetricMatrix,
                                              spectral_bounds)
from raleigh_tpu_torch.core import solver as solver
from raleigh_tpu_torch.core.device_solver import lobpcg
from raleigh_tpu_torch.examples import fe_model as fe
from raleigh_tpu_torch.examples import laplace
from raleigh_tpu_torch.ops.spmm import (BsrMatrix, DiaMatrix, EllMatrix,
                                        device_sparse, rows_matmat_operands)

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores (the small
# operand blocks here gain nothing from more threads).
torch.set_num_threads(1)

TOL = {np.float32: 1e-6, np.float64: 1e-12}


@pytest.fixture
def f64_default():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture(scope='module')
def pencil():
    return fe.fe_pencil(9, 3, 0.1, seed=2)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _same_sparse(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and (a != b).nnz == 0


# ---- the port's own copies of the jax-free host code ---------------------

@pytest.mark.parametrize('kwargs', [
    dict(nc=9, spacing=3, hole_frac=0.1, seed=2, which='km'),
    dict(nc=10, spacing=3, hole_frac=0.15, seed=5, which='kg',
         relabel=False),
    dict(nc=8, spacing=4, hole_frac=0.0, seed=1, which='k', bsr=True,
         jitter=0.0)], ids=['km', 'kg-natural', 'k-bsr'])
def test_fe_pencil_copy_equals_original(kwargs):
    got, want = fe.fe_pencil(**kwargs), jax_fe.fe_pencil(**kwargs)
    if kwargs['which'] == 'k':
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.format == b.format and _same_sparse(a, b)


def test_fe_model_pieces_copy_equals_original():
    for a, b in zip(fe.hex8_matrices((0.5, 0.25, 1.0), E=2.0, nu=0.25),
                    jax_fe.hex8_matrices((0.5, 0.25, 1.0), E=2.0, nu=0.25)):
        assert np.array_equal(a, b)
    for relabel in (True, False):
        conn, nn = fe.girder_mesh(7, 3, 0.2, seed=3, relabel=relabel)
        jconn, jnn = jax_fe.girder_mesh(7, 3, 0.2, seed=3, relabel=relabel)
        assert nn == jnn and np.array_equal(conn, jconn)
    # the two flagship entry points are the same calls in both packages
    for name in ('shipsec_like', 'buckling_64k'):
        assert inspect.getsource(getattr(fe, name)) == \
            inspect.getsource(getattr(jax_fe, name))


def test_laplace_copy_equals_original():
    assert _same_sparse(laplace.lap1d(9, 2.0), jax_laplace.lap1d(9, 2.0))
    assert _same_sparse(laplace.lap2d(5, 7, 1.0, 2.0),
                        jax_laplace.lap2d(5, 7, 1.0, 2.0))
    assert _same_sparse(laplace.lap3d(4, 5, 6, 1.0, 2.0, 3.0),
                        jax_laplace.lap3d(4, 5, 6, 1.0, 2.0, 3.0))
    assert np.array_equal(
        laplace.lap3d_eigenvalues(4, 5, 6, 1.0, 2.0, 3.0),
        jax_laplace.lap3d_eigenvalues(4, 5, 6, 1.0, 2.0, 3.0))


@pytest.mark.parametrize('matrix', ['girder', 'lap3d', 'diagonally dominant'])
def test_spectral_bounds_copy_equals_original(pencil, matrix):
    """Gershgorin alone (a diagonally dominant matrix) and the Lanczos
    branch (the other two) give the original's numbers exactly."""
    a = {'girder': pencil[0], 'lap3d': laplace.lap3d(6, 7, 8, 1.0, 1.0, 1.0),
         'diagonally dominant': laplace.lap1d(50, 1.0)
         + 1e5 * scs.identity(50)}[matrix]
    assert spectral_bounds(a) == jax_spectral_bounds(a)
    assert spectral_bounds(a, iters=12, seed=3) == \
        jax_spectral_bounds(a, iters=12, seed=3)
    assert rt.spectral_bounds is spectral_bounds


def test_options_copy_equals_original():
    assert vars(solver.Options()) == vars(jax_solver.Options())
    assert rt.Options is solver.Options
    cc, jcc = (solver.DefaultConvergenceCriteria(),
               jax_solver.DefaultConvergenceCriteria())
    assert vars(cc) == vars(jcc)
    cc.set_error_tolerance('residual eigenvector error', 1e-5)
    jcc.set_error_tolerance('residual eigenvector error', 1e-5)
    assert vars(cc) == vars(jcc)

    class Fake:
        def convergence_data(self, what, i):
            return {0: 1e-6, 1: 1e-4, 2: -1.0}[i]
    assert [cc.satisfied(Fake(), i) for i in range(3)] == \
        [jcc.satisfied(Fake(), i) for i in range(3)] == [True, False, False]


def test_package_exports():
    assert rt.EllMatrix is EllMatrix and rt.BsrMatrix is BsrMatrix
    assert rt.DiaMatrix is DiaMatrix and rt.device_sparse is device_sparse
    assert rt.fe_model is fe
    assert set(rt.__all__) <= set(dir(rt))


# ---- ELL -------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('which', ['9-3-0.1-2', '10-3-0.15-5'])
def test_ell_matches_jax_and_scipy(f64_default, which, dtype):
    """Same storage as the JAX EllMatrix and the same product as it and as
    SciPy, through matmat_t, matmat_rows and the operand form."""
    nc, sp, hole, seed = which.split('-')
    k = fe.fe_pencil(int(nc), int(sp), float(hole), seed=int(seed), which='k')
    n = k.shape[0]
    em = EllMatrix(k, dtype=dtype, device='cpu')
    je = jax_spmm.EllMatrix(k, dtype=dtype)
    assert (em.shape, em.nnz, em.row_degree) == \
        (je.shape, je.nnz, je.row_degree)
    assert em.row_degree % 8 == 0
    assert em.idx.dtype == torch.int32
    assert np.array_equal(em.idx.numpy(), np.asarray(je.idx))
    assert np.array_equal(em.val.numpy(), np.asarray(je.val))
    xt = np.random.RandomState(0).randn(n, 12).astype(dtype)
    yt = em.matmat_t(torch.from_numpy(xt))
    assert yt.shape == xt.shape and yt.numpy().dtype == dtype
    assert _rel(yt.numpy(), k @ xt.astype(np.float64)) < TOL[dtype]
    assert _rel(yt.numpy(), np.asarray(je.matmat_t(jnp.asarray(xt)))) \
        < TOL[dtype]
    y = em.matmat_rows(torch.from_numpy(xt.T.copy()))
    assert y.is_contiguous() and torch.equal(y, yt.T)
    fn, ops = rows_matmat_operands(em)
    assert torch.equal(fn(ops, torch.from_numpy(xt.T.copy())), y)


def test_ell_from_arrays_pad_and_bf16_operand(pencil):
    """State carried across from a JAX EllMatrix; ``pad_to`` as in the
    reference; a bf16 operand is summed in f32 and comes back bf16."""
    k, _ = pencil
    n = k.shape[0]
    je = jax_spmm.EllMatrix(k, pad_to=16)
    em = EllMatrix.from_arrays(np.asarray(je.idx), np.asarray(je.val),
                               nnz=je.nnz, device='cpu')
    assert em.row_degree == je.row_degree == \
        EllMatrix(k, pad_to=16, device='cpu').row_degree
    assert em.row_degree % 16 == 0 and em.nnz == k.nnz
    x = np.random.RandomState(1).randn(8, n).astype(np.float32)
    want = np.asarray(je.matmat_t(jnp.asarray(x.T))).T
    assert _rel(em.matmat_rows(torch.from_numpy(x)).numpy(), want) < 1e-6
    xb = torch.from_numpy(x).to(torch.bfloat16)
    yb = em.matmat_rows(xb)
    assert yb.dtype == torch.bfloat16
    exact = (k @ xb.float().numpy().astype(np.float64).T).T
    assert _rel(yb.float().numpy(), exact) < 2e-2


# ---- the layout rule ------------------------------------------------------

def _hub_rows():
    n = 2000
    a = scs.random(n, n, density=0.002, random_state=1, format='lil')
    a[0, :] = 1.0                      # hub row coupled to everything
    a = scs.csr_matrix(a)
    return a + a.T + scs.eye(n), {}


def _blocky(hint):
    rng = np.random.default_rng(4)
    adj = scs.csr_matrix(laplace.lap3d(12, 12, 12, 1.0, 1.0, 1.0))
    adj.data[:] = 1.0
    nn = adj.shape[0]
    r = rng.integers(0, nn, size=(300, 2))
    extra = scs.coo_matrix((np.ones(300), (r[:, 0], r[:, 1])),
                           shape=adj.shape).tocsr()
    adj = ((adj + extra + extra.T) != 0).astype(np.float64)
    blk = scs.kron(adj, np.ones((3, 3)), format='csr')
    blk.data = rng.standard_normal(blk.data.size) * 0.01
    return (blk + blk.T) * 0.5, dict(block_width_hint=hint)


LAYOUT_CASES = {
    'hub rows': (_hub_rows, 'BsrMatrix'),
    'blocky, wide operand': (lambda: _blocky(1 << 16), 'BsrMatrix'),
    'blocky, narrow operand': (lambda: _blocky(8), 'EllMatrix'),
    'girder relabelled': (
        lambda: (fe.fe_pencil(9, 3, 0.1, seed=2, which='k'), {}),
        'EllMatrix'),
    'girder natural': (
        lambda: (fe.fe_pencil(9, 3, 0.1, seed=2, which='k', relabel=False),
                 {}), 'EllMatrix'),
    'girder natural, bs 64, wide': (
        lambda: (fe.fe_pencil(9, 3, 0.1, seed=2, which='k', relabel=False),
                 dict(bs=64, block_width_hint=128)), None),
    'stencil': (lambda: (laplace.lap3d(6, 6, 6, 1.0, 1.0, 1.0), {}),
                'DiaMatrix'),
    'dense, below one tile': (
        lambda: (scs.csr_matrix(np.ones((40, 40)) + 40 * np.eye(40)), {}),
        'DiaMatrix'),
}


@pytest.mark.parametrize('case', sorted(LAYOUT_CASES))
def test_device_sparse_gives_the_reference_layout(case):
    """The same matrix gets the same layout class in both packages (the
    rule and its constants are the JAX package's), on the cases of
    tests/test_device_solver.py and on both orderings of a girder."""
    make, expected = LAYOUT_CASES[case]
    a, kw = make()
    dm = device_sparse(a, **kw, device='cpu')
    jdm = jax_spmm.device_sparse(a, **kw)
    assert type(dm).__name__ == type(jdm).__name__
    if expected is not None:
        assert type(dm).__name__ == expected
    if isinstance(dm, BsrMatrix):
        assert dm.bs == jdm.bs == kw.get('bs', 128)
    x = np.random.RandomState(2).randn(4, a.shape[0]).astype(np.float32)
    want = (a @ x.T.astype(np.float64)).T
    assert _rel(dm.matmat_rows(torch.from_numpy(x)).numpy(), want) < 1e-6


@pytest.mark.parametrize('entry', ['DiaMatrix', 'EllMatrix', 'BsrMatrix',
                                   'device_sparse', 'lobpcg',
                                   'SparseSymmetricMatrix', 'Chebyshev',
                                   'partial_hevp'])
def test_entry_points_default_to_the_card(entry):
    """With no ``device`` a layout is built on the card, a bare operator
    is iterated there and ``partial_hevp`` solves there; with no card that
    raises, and nothing runs on the CPU unasked."""
    a = laplace.lap3d(5, 5, 5, 1.0, 1.0, 1.0)

    def build(**kw):
        if entry == 'lobpcg':
            return lobpcg(lambda xt: xt, 2, n=a.shape[0], **kw)[1]
        if entry == 'SparseSymmetricMatrix':
            return SparseSymmetricMatrix(a, **kw).device_matrix()
        if entry == 'Chebyshev':
            return Chebyshev(a, 0.1, 13.0, **kw).device_matrix()
        if entry == 'partial_hevp':
            T = Chebyshev(a, 0.1, 13.0, device=kw.get('device', 'cpu'))
            return rt.partial_hevp(a, T=T, which=2, verb=-1, **kw)[1]
        return getattr(rt, entry)(a, **kw)

    if torch.cuda.is_available():
        build()
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build()
    on_cpu = build(device='cpu')
    if entry in ('lobpcg', 'partial_hevp'):
        assert np.all(np.isfinite(on_cpu))
    else:
        assert on_cpu.device.type == 'cpu'
    if entry in ('SparseSymmetricMatrix', 'Chebyshev'):
        # arch='cpu' keeps its meaning: the host CSR and no device matrix
        assert build(arch='cpu') is None


def test_sparse_symmetric_matrix_any_layout(pencil):
    """``apply`` works on every layout, ``bs`` is passed on, and an upper
    triangle is symmetrized as the reference does."""
    k, _ = pencil
    n = k.shape[0]
    x = np.random.RandomState(3).randn(6, n).astype(np.float32)
    want = (k @ x.T.astype(np.float64)).T
    sm = SparseSymmetricMatrix(scs.triu(k), device='cpu')
    assert isinstance(sm.device_matrix(), EllMatrix)
    y = torch.empty(x.shape)
    sm.apply(torch.from_numpy(x), y)
    # values are f64 on the host and canonical f32 on the device
    assert sm.device_matrix().val.dtype == torch.float32
    assert _rel(y.numpy(), want) < 1e-6
    hub, _ = _hub_rows()
    sb = SparseSymmetricMatrix(hub, bs=64, device='cpu')
    assert isinstance(sb.device_matrix(), BsrMatrix)
    assert sb.device_matrix().bs == 64
    xh = np.random.RandomState(4).randn(3, hub.shape[0]).astype(np.float32)
    yh = torch.empty(xh.shape)
    sb.apply(torch.from_numpy(xh), yh)
    assert _rel(yh.numpy(), (hub @ xh.T.astype(np.float64)).T) < 1e-6


# ---- Chebyshev over ELL, and the slice as a whole -------------------------

def test_chebyshev_over_ell_matches_jax(pencil, f64_default):
    """device_rows_operands over the ELL matrix the rule picks, against
    the JAX package's, f64, 1e-10; the bf16 auto rule stays DIA-only."""
    k, _ = pencil
    n = k.shape[0]
    lo, hi = spectral_bounds(k)
    x = np.random.RandomState(5).randn(8, n)
    ch = Chebyshev(k, hi * 1e-4, hi, degree=12, device='cpu')
    assert isinstance(ch.device_matrix(), EllMatrix)
    fn, ops = ch.device_rows_operands(8, n, dtype=torch.float64)
    got = fn(ops, torch.from_numpy(x)).numpy()
    jch = JaxChebyshev(k, hi * 1e-4, hi, degree=12, arch='tpu')
    jfn, jops = jch.device_rows_operands(8, n, dtype=np.float64)
    assert _rel(got, np.asarray(jfn(jops, jnp.asarray(x)))) < 1e-10
    out = torch.empty(x.shape, dtype=torch.float64)
    ch.apply(torch.from_numpy(x), out)
    assert _rel(out.numpy(), got) < 1e-12
    # a working set far past WINDOW_HBM_BYTES still iterates in f32
    big = ch.device_rows_operands(10 ** 6, n, dtype=torch.float32)
    x32 = torch.from_numpy(x.astype(np.float32))
    f32 = ch.device_rows_operands(8, n, dtype=torch.float32,
                                  stream_bf16=False)
    assert torch.equal(big[0](big[1], x32), f32[0](f32[1], x32))


@pytest.mark.parametrize('layout', ['ell', 'mixed'])
def test_lobpcg_on_ell_matches_jax(pencil, f64_default, layout):
    """lobpcg on the pencil (K, M) with the layouts device_sparse picks
    (ELL for both), and with K in ELL against M in BSR, from one start
    block: eigenvalues to 1e-10 relative and equal iteration counts."""
    k, mass = pencil
    n = k.shape[0]
    lo, hi = spectral_bounds(k)
    x0 = np.random.RandomState(6).standard_normal((n, 16))
    kw = dict(tol=1e-8, maxit=400, x0=x0, dtype=np.float64, block_size=16)
    tk = device_sparse(k, dtype=np.float64, device='cpu')
    jk = jax_spmm.device_sparse(k, dtype=np.float64)
    if layout == 'ell':
        tm = device_sparse(mass, dtype=np.float64, device='cpu')
        jm = jax_spmm.device_sparse(mass, dtype=np.float64)
        assert isinstance(tm, EllMatrix)
    else:
        tm = BsrMatrix(mass, dtype=np.float64, bs=128, device='cpu')
        jm = jax_spmm.BsrMatrix(mass, dtype=np.float64, bs=128)
    pre = Chebyshev(k, hi * 1e-4, hi, degree=32, device_matrix=tk) \
        .device_rows_operands(16, n, dtype=torch.float64)
    jpre = JaxChebyshev(k, hi * 1e-4, hi, degree=32, device_matrix=jk) \
        .device_rows_operands(16, n, dtype=np.float64)
    lam, x, _, it, status = lobpcg(tk, 6, opB=tm, precond=pre, **kw)
    jlam, _, _, jit, jstatus = jax_lobpcg(jk, 6, opB=jm, precond=jpre, **kw)
    assert status == jstatus == 0 and it == jit
    assert np.abs(lam - jlam).max() / np.abs(jlam).max() < 1e-10
    assert np.abs(x.T @ (mass @ x) - np.eye(6)).max() < 1e-8


def test_partial_hevp_fe_pencil_matches_jax(pencil, f64_default):
    """The FE-ELL field at a small size, as a user calls it.  The packages
    start from their own random blocks, so they agree to what tol=1e-8
    buys in f64: eigenvalue errors go as the residual squared, far below
    the 1e-8 relative asked here; SciPy's shift-invert eigsh agrees to the
    same."""
    k, mass = pencil
    lo, hi = spectral_bounds(k)
    T = Chebyshev(k, hi * 1e-4, hi, degree=32, arch='gpu', device='cpu')
    lmd, x, status = rt.partial_hevp(k, B=mass, T=T, which=6, tol=1e-8,
                                     verb=-1, arch='gpu', device='cpu')
    jT = JaxChebyshev(k, hi * 1e-4, hi, degree=32, arch='tpu')
    jlmd, _, jstatus = jax_hevp(k, B=mass, T=jT, which=6, tol=1e-8, verb=-1,
                                arch='tpu')
    assert status == jstatus == 0
    assert lmd.shape == (6,) and x.shape == (k.shape[0], 6)
    assert x.dtype == np.float64
    assert np.abs(lmd - np.sort(jlmd)).max() / np.abs(jlmd).max() < 1e-8
    exact = np.sort(spl.eigsh(k, M=mass, k=6, sigma=0, which='LM',
                              return_eigenvectors=False))
    assert np.abs(lmd - exact).max() / exact[-1] < 1e-8
    assert np.abs(x.T @ (mass @ x) - np.eye(6)).max() < 1e-8


def test_orderings_share_a_spectrum(f64_default):
    """chip_smoke.py's cross-check at a small size: the relabelled and the
    natural ordering are one mesh (K_nat = P K P^T), so FE-ELL on one and
    FE-BSR on the other return the same six eigenvalues (1e-8 relative at
    tol=1e-8, f64)."""
    lams = []
    for relabel in (True, False):
        k, mass = fe.fe_pencil(9, 3, 0.1, seed=2, relabel=relabel)
        n = k.shape[0]
        lo, hi = spectral_bounds(k)
        if relabel:
            tk, tm = device_sparse(k, dtype=np.float64, device='cpu'), \
                device_sparse(mass, dtype=np.float64, device='cpu')
        else:
            tk, tm = BsrMatrix(k, dtype=np.float64, bs=128, device='cpu'), \
                BsrMatrix(mass, dtype=np.float64, bs=128, device='cpu')
        pre = Chebyshev(k, hi * 1e-4, hi, degree=32, device_matrix=tk) \
            .device_rows_operands(16, n, dtype=torch.float64)
        lam, _, _, _, status = lobpcg(tk, 6, opB=tm, precond=pre, tol=1e-8,
                                      maxit=400, dtype=torch.float64,
                                      block_size=16)
        assert status == 0
        lams.append(lam)
    assert np.abs(lams[0] / lams[1] - 1).max() < 1e-8
