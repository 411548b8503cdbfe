"""The port's ELL apply (``raleigh_tpu_torch/ops/spmm.py::_ell_matmat``,
kernel ``csrc/ell_spmm.cu``) against the JAX package's ``_ell_matmat`` on
the CPU, where the wrapper takes the kernel's plain PyTorch version; the
checks of the wrapper; and, marked ``gpu`` (they skip without a card), the
kernel against its plain version on the card.

Tolerance, entrywise (``chip_smoke.ell_excess``): twice the summation error
bound of a row's K terms, 2 K u sum_k |val[i, k] x[idx[i, k], r]| with
u = 2^-24 for f32 sums and 2^-53 for f64 sums (two applies that each sum
the same K terms in their sum type, in any order, each within K u of the
exact sum), 2K + 1 terms for a complex sum, plus one bf16 rounding on either
side (2^-7 |want|) for a bf16 result.
"""

import importlib.util
import os

import numpy as np
import pytest
import scipy.sparse as scs
import torch

import jax.numpy as jnp

from raleigh_tpu.ops import spmm as jax_spmm
from raleigh_tpu_torch.examples import fe_model as fe
from raleigh_tpu_torch.ops import _build
from raleigh_tpu_torch.ops import spmm
from raleigh_tpu_torch.ops.spmm import EllMatrix, rows_matmat_operands

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores (the small
# operand blocks here gain nothing from more threads).
torch.set_num_threads(1)


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'chip_smoke.py')
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


PAIRS = [('f32', 'f32'), ('f32', 'bf16'), ('f32', 'f64'), ('f64', 'f64')]
DTYPES = {'f32': torch.float32, 'bf16': torch.bfloat16, 'f64': torch.float64}


def _excess(idx, val, xt, got, want):
    return CS.ell_excess(torch, spmm, idx, val, xt, got, want)


@pytest.fixture(scope='module')
def girder():
    """A small box-girder stiffness matrix (n = 2,796, K = 88)."""
    return fe.fe_pencil(9, 3, 0.1, seed=2, which='k')


def _ragged(n, k, seed, n_x=None, hub=True):
    """ELL arrays (idx, val) of n rows padded to K with random degrees in
    [0, K], every fifth row empty and, with ``hub``, row 1 of degree K;
    columns in [0, n_x)."""
    rng = np.random.default_rng(seed)
    n_x = n if n_x is None else n_x
    deg = rng.integers(0, k + 1, size=n)
    deg[::5] = 0
    if hub:
        deg[1] = k
    idx = np.zeros((n, k), dtype=np.int32)
    val = np.zeros((n, k), dtype=np.float64)
    for i, d in enumerate(deg):
        idx[i, :d] = rng.integers(0, n_x, size=d)
        val[i, :d] = rng.standard_normal(d)
    return idx, val


# ---- the plain version on the CPU, against the JAX package -----------------

@pytest.mark.parametrize('m', [1, 8, 12, 16])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_plain_matches_jax_ell_matmat(girder, dtype, m):
    """On CPU tensors ``_ell_matmat`` is the plain version, and it agrees
    with the JAX package's ``EllMatrix.matmat_t`` on the same arrays within
    the summation bound of the sum type (f32 or f64)."""
    je = jax_spmm.EllMatrix(girder, dtype=dtype)
    # f64 values stay f64 only with exact (from_arrays narrows them)
    em = (EllMatrix(girder, dtype=dtype, device='cpu', exact=True)
          if dtype == np.float64 else
          EllMatrix.from_arrays(np.asarray(je.idx), np.asarray(je.val),
                                nnz=je.nnz, device='cpu'))
    assert np.array_equal(em.idx.numpy(), np.asarray(je.idx))
    assert np.array_equal(em.val.numpy(), np.asarray(je.val))
    xt = np.random.default_rng(m).standard_normal(
        (girder.shape[0], m)).astype(dtype)
    x = torch.from_numpy(xt)
    before = dict(spmm.ELL_LAUNCHES)
    got = spmm._ell_matmat(em.idx, em.val, x)
    assert spmm.ELL_LAUNCHES == before
    assert torch.equal(got, spmm._ell_matmat_plain(em.idx, em.val, x))
    want = torch.from_numpy(np.array(je.matmat_t(jnp.asarray(xt))))
    assert got.dtype == want.dtype and got.shape == want.shape
    worst, _ = _excess(em.idx, em.val, x, got, want)
    assert worst <= 1


def test_plain_bf16_operand_within_the_bound(girder):
    """A bf16 operand is summed in f32 and rounded once to bf16: within the
    f32 summation bound plus one bf16 rounding of the exact product (the
    JAX package's scan keeps its carry in the operand's type, so it takes
    no bf16 operand to compare with)."""
    em = EllMatrix(girder, device='cpu')
    xt = np.random.default_rng(3).standard_normal((girder.shape[0], 16))
    xb = torch.from_numpy(xt).to(torch.bfloat16)
    got = spmm._ell_matmat(em.idx, em.val, xb)
    assert got.dtype == torch.bfloat16
    exact = torch.from_numpy(girder.astype(np.float32).astype(np.float64)
                             @ xb.double().numpy())
    worst, _ = _excess(em.idx, em.val, xb, got, exact)
    assert worst <= 1


@pytest.mark.parametrize('values', ['real', 'complex'])
def test_plain_complex_matches_jax(girder, values):
    """A c128 operand with real or complex (Hermitian) values through the
    plain version, against the JAX package's apply (f64 complex sums)."""
    a, dtype = girder, np.float64
    if values == 'complex':
        dtype = np.complex128
        up = scs.triu(girder, k=1).tocoo()
        phase = np.exp(1j * np.random.default_rng(4).uniform(
            0, np.pi, up.nnz))
        h = scs.coo_matrix((up.data * phase, (up.row, up.col)),
                           shape=girder.shape)
        a = scs.csr_matrix(h + h.conj().T + scs.diags(girder.diagonal()))
    je = jax_spmm.EllMatrix(a, dtype=dtype)
    em = EllMatrix(a, dtype=dtype, device='cpu', exact=True)
    assert em.val.is_complex() == (values == 'complex')
    rng = np.random.default_rng(5)
    n = girder.shape[0]
    xt = rng.standard_normal((n, 8)) + 1j * rng.standard_normal((n, 8))
    x = torch.from_numpy(xt)
    got = spmm._ell_matmat(em.idx, em.val, x)
    assert got.dtype == torch.complex128
    want = torch.from_numpy(np.array(je.matmat_t(jnp.asarray(xt))))
    worst, _ = _excess(em.idx, em.val, x, got, want)
    assert worst <= 1
    assert np.abs(got.numpy() - a @ xt).max() < 1e-12 * np.abs(a @ xt).max()


@pytest.mark.parametrize('m', [1, 16, 33])
def test_row_and_column_layouts_agree(girder, m):
    """The (n, m) and the (m, n) layouts give the same result, through
    ``_ell_matmat`` and ``_ell_matmat_rows``, the matrix's methods and its
    operand form; the row result is contiguous."""
    em = EllMatrix(girder, device='cpu')
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (m, girder.shape[0])).astype(np.float32))
    cols = spmm._ell_matmat(em.idx, em.val, x.T.contiguous())
    rows = spmm._ell_matmat_rows(em.idx, em.val, x)
    assert rows.is_contiguous() and torch.equal(rows, cols.T)
    assert torch.equal(em.matmat_rows(x), rows)
    assert torch.equal(em.matmat_t(x.T), cols)
    fn, ops = rows_matmat_operands(em)
    assert torch.equal(fn(ops, x), rows)


def test_sharded_ell_apply_equals_the_whole(girder):
    """An ELL matrix split by rows over a CPU mesh (one apply a shard over
    the gathered (n, m) operand, written in the row layout) equals the
    unsplit apply."""
    from raleigh_tpu_torch.core.device_solver import shard_operator
    from raleigh_tpu_torch.parallel.mesh import ShardedRows, make_mesh
    whole = EllMatrix(girder, device='cpu')
    split = shard_operator(EllMatrix(girder, device='cpu'),
                           make_mesh(4, ['cpu'] * 4))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (16, girder.shape[0])).astype(np.float32))
    want = whole.matmat_rows(x)
    assert torch.equal(split.matmat_rows(x), want)
    xs = ShardedRows.split(x, split.val.sharding)
    assert torch.equal(split.matmat_rows(xs).gather(), want)


def test_ragged_rows_and_a_wider_operand():
    """Rows of degree 0 give 0; a hub row of degree K; columns index an
    operand with more rows than the matrix (a sharded extended operand)."""
    idx, val = _ragged(101, 16, 7, n_x=140)
    idx_t = torch.from_numpy(idx)
    val_t = torch.from_numpy(val.astype(np.float32))
    xt = np.random.default_rng(8).standard_normal((140, 5)).astype(
        np.float32)
    got = spmm._ell_matmat(idx_t, val_t, torch.from_numpy(xt))
    want = np.einsum('ik,ikr->ir', val.astype(np.float32).astype(np.float64),
                     xt.astype(np.float64)[idx])
    assert got.shape == (101, 5)
    assert torch.all(got[::5] == 0)
    worst, _ = _excess(idx_t, val_t, torch.from_numpy(xt), got,
                       torch.from_numpy(want))
    assert worst <= 1


@pytest.mark.parametrize('bad', [-1, 2796])
def test_matrices_check_their_columns_when_built(girder, bad):
    """The kernel gathers by idx unchecked, so a matrix built from arrays
    with a column outside the operand raises: ``EllMatrix`` against n,
    ``ShardedEllMatrix`` in halo mode against its extended operand."""
    from raleigh_tpu_torch.parallel.mesh import make_mesh
    from raleigh_tpu_torch.parallel.spmm_sharded import ShardedEllMatrix
    je = jax_spmm.EllMatrix(girder)
    idx = np.array(je.idx)
    idx[5, 0] = bad
    with pytest.raises(ValueError, match='column indices'):
        EllMatrix.from_arrays(idx, np.asarray(je.val), device='cpu')
    sm = ShardedEllMatrix(girder, make_mesh(4, ['cpu'] * 4))
    sidx = np.concatenate([p.numpy() for p in sm.idx.parts])
    sval = np.concatenate([p.numpy() for p in sm.val.parts])
    assert sm.mode == 'halo'
    sidx[5, 0] = -1 if bad < 0 else sm.chunk + sum(sm.halo)
    with pytest.raises(ValueError, match='column indices'):
        ShardedEllMatrix.from_arrays(sidx, sval, sm.perm, sm.halo, sm.chunk,
                                     sm.mode, sm.mesh)


# ---- the wrapper's checks ---------------------------------------------------

def _meta(idx, val, x):
    return idx.to('meta'), val.to('meta'), x.to('meta')


BAD = {
    'devices differ': (lambda i, v, x: (i, v.to('meta'), x.to('meta')),
                       ValueError, 'share a device'),
    'f16 operand': (lambda i, v, x: _meta(i, v, x.half()), TypeError,
                    'ELL kernel takes'),
    'f64 values, f32 operand': (lambda i, v, x: _meta(i, v.double(), x),
                                TypeError, 'ELL kernel takes'),
    'bf16 values': (lambda i, v, x: _meta(i, v.bfloat16(), x.bfloat16()),
                    TypeError, 'ELL kernel takes'),
    'int64 idx': (lambda i, v, x: _meta(i.long(), v, x), TypeError,
                  'int32 idx'),
    'val shape': (lambda i, v, x: _meta(i, v[:, :-1], x), ValueError,
                  'shape mismatch'),
    '1-D operand': (lambda i, v, x: _meta(i, v, x[:, 0]), ValueError,
                    'shape mismatch'),
    'operand with no rows': (lambda i, v, x: _meta(i, v, x[:0]),
                             ValueError, 'shape mismatch'),
    'strided val': (lambda i, v, x: _meta(i, v.T.contiguous().T, x),
                    ValueError, 'contiguous'),
    'strided operand': (lambda i, v, x: _meta(i, v, x.T.contiguous().T),
                        ValueError, 'contiguous'),
    'no kernel for meta': (_meta, ValueError, 'no ELL apply for device'),
}


@pytest.mark.parametrize('case', list(BAD))
def test_wrapper_refuses_before_any_launch(girder, monkeypatch, case):
    """Every input the kernel does not take raises on the CPU, before the
    library is asked for and with no launch counted; a tensor on a device
    that is neither the CPU nor a card is refused, never computed
    elsewhere."""
    def no_library():
        raise AssertionError('the library was asked for')
    monkeypatch.setattr(_build, 'library', no_library)
    em = EllMatrix(girder, device='cpu')
    x = torch.ones((girder.shape[0], 8), dtype=torch.float32)
    make, err, match = BAD[case]
    idx, val, xt = make(em.idx, em.val, x)
    before = dict(spmm.ELL_LAUNCHES)
    with pytest.raises(err, match=match):
        spmm._ell_matmat(idx, val, xt)
    assert spmm.ELL_LAUNCHES == before


def test_wrapper_uses_plain_version_only_on_cpu(girder, monkeypatch):
    """A CPU tensor takes the plain version, counts no launch and never
    loads the library; the counters reset to 0."""
    def no_library():
        raise AssertionError('the library was asked for')
    monkeypatch.setattr(_build, 'library', no_library)
    em = EllMatrix(girder, device='cpu')
    x = torch.ones((8, girder.shape[0]), dtype=torch.float32)
    before = dict(spmm.ELL_LAUNCHES)
    y = em.matmat_rows(x)
    assert torch.equal(y, spmm._ell_matmat_plain(em.idx, em.val, x.T).T)
    assert spmm.ELL_LAUNCHES == before
    assert set(spmm.ELL_LAUNCHES) == {
        ('f32', 'f32'), ('f32', 'bf16'), ('f32', 'f64'), ('f64', 'f64'),
        ('f32', 'f32', 'complex'), ('f32', 'f64', 'complex'),
        ('f64', 'f64', 'complex')}
    spmm.ELL_LAUNCHES[('f32', 'f32')] += 1
    spmm.reset_launches()
    assert not any(spmm.ELL_LAUNCHES.values())


@pytest.mark.parametrize('control', ['bf16 running sum', 'bf16 products'])
def test_chip_smoke_ell_bound_rejects_bf16_sums(girder, control):
    """The entrywise bound chip_smoke holds the kernel to: the plain
    version passes it against an f64 apply, and the two controls, a bf16
    running sum and bf16 products, fail it."""
    em = EllMatrix(girder, device='cpu')
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (girder.shape[0], 16)).astype(np.float32))
    plain = spmm._ell_matmat_plain(em.idx, em.val, x)
    exact = spmm._ell_matmat_plain(em.idx, em.val.double(), x.double())
    assert _excess(em.idx, em.val, x, plain, exact)[0] <= 1
    yc = CS.ell_controls(torch, em.idx, em.val, x)[control]
    assert _excess(em.idx, em.val, x, yc, plain)[0] > 1


# ---- the kernel on the card -------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; torch finds none')
    return torch.device('cuda')


def _kernel_case(cuda, pair, n, k, m, seed, n_x=None):
    idx, val = _ragged(n, k, seed, n_x=n_x)
    idx = torch.from_numpy(idx).to(cuda)
    val = torch.from_numpy(val).to(cuda, DTYPES[pair[0]])
    gen = torch.Generator('cuda').manual_seed(seed)
    xt = torch.randn((n if n_x is None else n_x, m), generator=gen,
                     device=cuda, dtype=torch.float64).to(DTYPES[pair[1]])
    return idx, val, xt


@pytest.mark.gpu
@pytest.mark.parametrize('m', [1, 8, 12, 16, 32, 33, 64])
@pytest.mark.parametrize('pair', PAIRS, ids=['_'.join(p) for p in PAIRS])
def test_kernel_matches_plain(cuda, pair, m):
    """Every instantiation at every m, n = 1,001 (a multiple of no block's
    rows), rows of degree 0 and a hub row of degree K: within the bound of
    the plain version; one launch counted, under the pair's key; the row
    layout equal to the column layout's transpose bit for bit."""
    idx, val, xt = _kernel_case(cuda, pair, 1001, 40, m, seed=m)
    before = spmm.ELL_LAUNCHES[pair]
    got = spmm._ell_matmat(idx, val, xt)
    torch.cuda.synchronize()
    assert spmm.ELL_LAUNCHES[pair] == before + 1
    want = spmm._ell_matmat_plain(idx, val, xt)
    assert got.dtype == xt.dtype and got.shape == (1001, m)
    assert torch.isfinite(got.double()).all()
    worst, share = _excess(idx, val, xt, got, want)
    assert worst <= 1, share
    assert torch.all(got[::5] == 0)
    rows = spmm._ell_matmat_rows(idx, val, xt.T.contiguous())
    assert rows.is_contiguous() and torch.equal(rows, got.T)


@pytest.mark.gpu
@pytest.mark.parametrize('k', [13, 8])
@pytest.mark.parametrize('pair', PAIRS, ids=['_'.join(p) for p in PAIRS])
def test_kernel_scalar_paths(cuda, pair, k):
    """K not a multiple of 8 (the scalar entry loop), an operand view with
    an unaligned base (one value a lane at m = 16), and an operand with
    more rows than the matrix."""
    idx, val, xt = _kernel_case(cuda, pair, 777, k, 16, seed=k, n_x=900)
    view = torch.empty((900 * 16 + 1,), dtype=xt.dtype, device=cuda)
    view = view[1:].view(900, 16)
    view.copy_(xt)
    for x in (xt, view):
        got = spmm._ell_matmat(idx, val, x)
        want = spmm._ell_matmat_plain(idx, val, x)
        assert _excess(idx, val, x, got, want)[0] <= 1


@pytest.mark.gpu
@pytest.mark.parametrize('values', ['real', 'complex'])
@pytest.mark.parametrize('operand', [torch.complex64, torch.complex128])
def test_complex_route_matches_plain(cuda, values, operand):
    """Complex operands and complex values through the real kernel
    (``ops/complex_rows.py``): one launch over the stacked rows for real
    values, two for complex values, counted under the complex key."""
    idx, val, _ = _kernel_case(cuda, ('f32', 'f32'), 513, 24, 8, seed=11)
    if values == 'complex':
        val = torch.complex(val, val.flip(1))
    if operand == torch.complex128:
        val = val.to(torch.complex128 if val.is_complex() else torch.float64)
    gen = torch.Generator('cuda').manual_seed(12)
    real = torch.float64 if operand == torch.complex128 else torch.float32
    xt = torch.complex(
        torch.randn((513, 8), generator=gen, device=cuda, dtype=real),
        torch.randn((513, 8), generator=gen, device=cuda, dtype=real))
    wide = 'f64' if real == torch.float64 else 'f32'
    key = (wide, wide, 'complex')
    before = spmm.ELL_LAUNCHES[key]
    got = spmm._ell_matmat(idx, val, xt)
    torch.cuda.synchronize()
    assert spmm.ELL_LAUNCHES[key] - before == (2 if values == 'complex'
                                               else 1)
    want = spmm._ell_matmat_plain(idx, val, xt)
    assert got.dtype == want.dtype == operand
    assert _excess(idx, val, xt, got, want)[0] <= 1
    rows = spmm._ell_matmat_rows(idx, val, xt.T.contiguous())
    assert _excess(idx, val, xt, rows.T, want)[0] <= 1


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take(cuda):
    """On the card the wrapper raises instead of computing elsewhere."""
    idx, val, xt = _kernel_case(cuda, ('f32', 'f32'), 64, 8, 4, seed=13)
    with pytest.raises(TypeError):
        spmm._ell_matmat(idx, val, xt.half())
    with pytest.raises(ValueError, match='contiguous'):
        spmm._ell_matmat(idx, val, xt.T.contiguous().T)
    with pytest.raises(ValueError, match='share a device'):
        spmm._ell_matmat(idx.cpu(), val, xt)


@pytest.mark.gpu
def test_solve_on_the_card_launches_the_kernel_and_no_plain(cuda,
                                                            monkeypatch):
    """``partial_hevp`` on a small girder pencil, no device argument, K and
    M in EllMatrix: the kernel launches, the plain version never runs, and
    the eigenvalues match the same call on the host (``arch='cpu'``)."""
    from raleigh_tpu_torch import Chebyshev, partial_hevp, spectral_bounds

    def refuse(*a):
        raise AssertionError('the plain ELL version ran on the card')
    k, mass = fe.fe_pencil(9, 3, 0.1, seed=2)
    lo, hi = spectral_bounds(k)
    ch = Chebyshev(k, hi * 1e-4, hi, degree=16)
    assert type(ch.device_matrix()).__name__ == 'EllMatrix'
    spmm.reset_launches()
    monkeypatch.setattr(spmm, '_ell_matmat_plain', refuse)
    lmd, x, status = partial_hevp(k, B=mass, T=ch, which=4, tol=1e-4,
                                  verb=-1)
    monkeypatch.undo()
    assert status == 0 and spmm.ELL_LAUNCHES[('f32', 'f32')] > 0
    import scipy.linalg
    want = scipy.linalg.eigh(k.toarray(), mass.toarray(), eigvals_only=True,
                             subset_by_index=[0, 3])
    assert np.allclose(np.sort(lmd)[:4], want, rtol=1e-3)
