"""The PyTorch port's BSR SpMM (raleigh_tpu_torch/ops/spmm.py,
ops/spmm_pallas.py) and stream probe (ops/stream.py) against the JAX
package and SciPy, on the CPU, where each wrapper takes its kernel's plain
PyTorch version.  The CUDA kernels themselves are held against those plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py).

Inputs are small finite-element pencils (fe_pencil(9, 3, 0.1, seed=2),
n = 2,796, and fe_pencil(10, 3, 0.15, seed=5)): n is a multiple of neither
block size.  Tolerances, relative to the largest |entry| of the reference:
f32 1e-6 (f32 accumulation in another order), f64 1e-12, bf16 tiles 2e-2
(one bf16 rounding of every tile entry, as
tests/test_device_solver.py::test_bsr_bf16_blocks_f32_accumulate has it).
"""

import importlib.util
import os
import re

import numpy as np
import pytest
import scipy.sparse as scs
import torch

import jax.numpy as jnp

from raleigh_tpu.algebra.sparse import Chebyshev as JaxChebyshev
from raleigh_tpu.core.device_solver import lobpcg as jax_lobpcg
from raleigh_tpu.examples.fe_model import fe_pencil
from raleigh_tpu.ops.spmm import BsrMatrix as JaxBsr
from raleigh_tpu.ops.spmm_pallas import PallasBsrMatrix
from raleigh_tpu_torch.algebra.sparse import Chebyshev, spectral_bounds
from raleigh_tpu_torch.core.device_solver import lobpcg
from raleigh_tpu_torch.ops import _build
from raleigh_tpu_torch.ops import spmm_pallas as sp
from raleigh_tpu_torch.ops import stream as st
from raleigh_tpu_torch.ops.spmm import BsrMatrix, rows_matmat_operands

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores (the small
# operand blocks here gain nothing from more threads).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {np.float32: 1e-6, np.float64: 1e-12}


@pytest.fixture
def f64_default():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture(scope='module')
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def pencil():
    return fe_pencil(9, 3, 0.1, seed=2)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _block(n, m, seed, dtype):
    return np.random.RandomState(seed).randn(m, n).astype(dtype)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('bs', [64, 128])
def test_bsr_matches_jax_and_scipy(pencil, f64_default, bs, dtype):
    """Same fields as the JAX BsrMatrix, and the same product as it and as
    SciPy, through matmat_rows, matmat_t and the operand form."""
    k, _ = pencil
    n = k.shape[0]
    assert n % bs
    bm = BsrMatrix(k, dtype=dtype, bs=bs, device='cpu')
    jb = JaxBsr(k, dtype=dtype, bs=bs)
    assert (bm.shape, bm.nb, bm.n_padded, bm.nnz, bm.bs) == \
        (jb.shape, jb.nb, jb.n_padded, jb.nnz, jb.bs)
    assert np.array_equal(bm.block_indptr, jb.block_indptr)
    assert np.array_equal(bm.block_cols.numpy(), np.asarray(jb.block_cols))
    assert np.array_equal(bm.block_rows.numpy(), np.asarray(jb.block_rows))
    assert np.array_equal(bm.blocks.numpy(), np.asarray(jb.blocks))
    assert bm.block_indptr_t.dtype == torch.int32
    x = _block(n, 12, 0, dtype)
    y = bm.matmat_rows(torch.from_numpy(x))
    assert y.shape == x.shape and y.numpy().dtype == dtype
    assert y.is_contiguous()
    assert _rel(y.numpy(), (k @ x.T.astype(np.float64)).T) < TOL[dtype]
    want = np.asarray(jb.matmat_t(jnp.asarray(x.T)))
    assert _rel(y.numpy().T, want) < TOL[dtype]
    yt = bm.matmat_t(torch.from_numpy(x.T.copy()))
    assert torch.equal(yt, y.T)
    fn, ops = rows_matmat_operands(bm)
    assert torch.equal(fn(ops, torch.from_numpy(x)), y)


@pytest.mark.parametrize('seed_pencil', ['9-3-0.1-2', '10-3-0.15-5'])
def test_bsr_matches_pallas_kernel_interpreted(seed_pencil):
    """The port's BSR apply against the Pallas kernel it replaces, run in
    interpret mode on the CPU, f32, to 1e-6 of the largest entry."""
    nc, sp_, hole, seed = seed_pencil.split('-')
    k = fe_pencil(int(nc), int(sp_), float(hole), seed=int(seed), which='k')
    n = k.shape[0]
    x = _block(n, 8, 1, np.float32)
    pm = PallasBsrMatrix(k, bs=64, interpret=True)
    want = np.asarray(pm.matmat_t(jnp.asarray(x.T)))
    y = BsrMatrix(k, bs=64, device='cpu').matmat_rows(torch.from_numpy(x))
    assert _rel(y.numpy().T, want) < 1e-6


def test_from_arrays_reproduces_jax_matrix(pencil):
    """State carried across: a JAX BsrMatrix's arrays build the port's
    matrix, whose product is the JAX matrix's."""
    k, _ = pencil
    jb = JaxBsr(k, bs=64)
    bm = BsrMatrix.from_arrays(np.asarray(jb.blocks),
                               np.asarray(jb.block_cols), jb.block_indptr,
                               jb.shape[0], nnz=jb.nnz, device='cpu')
    assert (bm.shape, bm.nb, bm.n_padded, bm.nnz, bm.bs) == \
        (jb.shape, jb.nb, jb.n_padded, jb.nnz, jb.bs)
    assert bm.blocks.dtype == torch.float32
    x = _block(k.shape[0], 8, 2, np.float32)
    want = np.asarray(jb.matmat_t(jnp.asarray(x.T)))
    assert _rel(bm.matmat_rows(torch.from_numpy(x)).numpy().T, want) < 1e-6


def test_bsr_bf16_blocks_f32_accumulate(pencil):
    """Opt-in bf16 tiles: the product matches SciPy at bf16 storage
    precision (2e-2), for an f32 and for a bf16 operand, and the JAX
    package's bf16-tile product to the same."""
    k, _ = pencil
    n = k.shape[0]
    x = _block(n, 8, 3, np.float32)
    bm = BsrMatrix(k, dtype=torch.bfloat16, bs=64, device='cpu')
    assert bm.blocks.dtype == torch.bfloat16 and bm.dtype == torch.bfloat16
    want = (k @ x.T.astype(np.float64)).T
    y = bm.matmat_rows(torch.from_numpy(x))
    assert y.dtype == torch.float32
    assert _rel(y.numpy(), want) < 2e-2
    yb = bm.matmat_rows(torch.from_numpy(x).to(torch.bfloat16))
    assert yb.dtype == torch.bfloat16
    assert _rel(yb.float().numpy(), want) < 2e-2
    jb = JaxBsr(k, dtype=jnp.bfloat16, bs=64)
    jwant = np.asarray(jb.matmat_t(jnp.asarray(x.T)).astype(jnp.float32))
    assert _rel(y.numpy().T, jwant) < 2e-2


@pytest.mark.parametrize('operand', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('control', ['bf16 running sum', 'bf16 products'])
def test_chip_smoke_bsr_bound_rejects_bf16_accumulation(chip_smoke, pencil,
                                                        control, operand):
    """chip_smoke.py holds the BSR kernel to the plain version entrywise.
    The exact product rounded once to the operand type and an f32 product
    summed in another order (tile by tile, with the tiles reversed) meet
    the bound; a bf16 running sum and bf16 products do not."""
    k, _ = pencil
    n = k.shape[0]
    bm = BsrMatrix(k, bs=64, device='cpu')
    x = torch.from_numpy(_block(n, 12, 4, np.float32)).to(operand)
    want = sp.bsr_matmat_rows_plain(bm.blocks, bm.block_indptr_t,
                                    bm.block_cols, x, n)

    def excess(got):
        return chip_smoke.bsr_excess(torch, sp, bm, x, got, want)[0]
    exact = (k @ x.float().numpy().astype(np.float64).T).T
    assert excess(torch.from_numpy(exact).to(operand)) <= 1
    # another order of summation: one tile at a time, last tile first
    y = torch.zeros((bm.nb, 64, 12))
    xp = torch.nn.functional.pad(x.float(), (0, bm.n_padded - n))
    for t in reversed(range(bm.blocks.shape[0])):
        c = int(bm.block_cols[t])
        y[int(bm.block_rows[t])] += bm.blocks[t] @ xp[:, c * 64:(c + 1) * 64].T
    reordered = y.reshape(-1, 12)[:n].T.to(operand)
    assert excess(reordered) <= 1
    bad = chip_smoke.bsr_controls(torch, bm, x)[control]
    assert bad.dtype == operand
    assert excess(bad) > 2


def test_empty_block_row_and_tail(pencil):
    """A block row with no tile yields zeros, and the tail block (n not a
    multiple of bs) is masked: against SciPy, f32, 1e-6."""
    k, _ = pencil
    n, bs = k.shape[0], 64
    keep = np.ones(n)
    keep[3 * bs:4 * bs] = 0.0
    a = scs.csr_matrix(scs.diags(keep) @ k @ scs.diags(keep))
    a.eliminate_zeros()
    bm = BsrMatrix(a, bs=bs, device='cpu')
    assert np.diff(bm.block_indptr).min() == 0
    x = _block(n, 24, 5, np.float32)
    y = bm.matmat_rows(torch.from_numpy(x)).numpy()
    assert _rel(y, (a @ x.T.astype(np.float64)).T) < 1e-6
    assert np.all(y[:, 3 * bs:4 * bs] == 0)


def test_wrapper_uses_plain_version_only_on_cpu(pencil):
    """A CPU tensor takes the plain version and counts no launch; a tensor
    on another device is refused, never computed elsewhere; what the kernel
    cannot take is refused by name."""
    k, _ = pencil
    n = k.shape[0]
    bm = BsrMatrix(k, bs=64, device='cpu')
    x = torch.from_numpy(_block(n, 8, 6, np.float32))
    args = (bm.blocks, bm.block_indptr_t, bm.block_cols)
    before = dict(sp.LAUNCHES)
    assert torch.equal(sp.bsr_matmat_rows(*args, x, n),
                       sp.bsr_matmat_rows_plain(*args, x, n))
    assert sp.LAUNCHES == before
    assert sorted(sp.LAUNCHES) == [('bf16', 'bf16'), ('bf16', 'f32'),
                                   ('f32', 'bf16'), ('f32', 'f32')]
    with pytest.raises(ValueError, match='device'):
        sp.bsr_matmat_rows(*args, x.to('meta'), n)
    # the checks the wrapper makes before a launch
    sp._check(*args, x, n)
    with pytest.raises(TypeError, match='float64'):
        sp._check(*args, x.double(), n)
    with pytest.raises(TypeError, match='int32'):
        sp._check(bm.blocks, bm.block_indptr_t.long(), bm.block_cols, x, n)
    with pytest.raises(ValueError, match='shape'):
        sp._check(*args, x[:, :-1].contiguous(), n)
    with pytest.raises(ValueError, match='contiguous'):
        sp._check(*args, torch.from_numpy(_block(8, n, 6, np.float32)).T, n)
    with pytest.raises(ValueError, match='device'):
        sp._check(bm.blocks.to('meta'), bm.block_indptr_t, bm.block_cols,
                  x, n)


def test_chebyshev_over_bsr_matches_jax(pencil, f64_default):
    """Chebyshev.device_rows_operands over a hand-built BsrMatrix
    (``device_matrix=``) against the JAX package's, f64, 1e-10."""
    k, _ = pencil
    n = k.shape[0]
    lo, hi = spectral_bounds(k)
    x = _block(n, 8, 7, np.float64)
    bm = BsrMatrix(k, dtype=np.float64, bs=64, device='cpu')
    ch = Chebyshev(k, hi * 1e-4, hi, degree=12, device_matrix=bm)
    assert ch.device_matrix() is bm
    fn, ops = ch.device_rows_operands(8, n, dtype=torch.float64)
    got = fn(ops, torch.from_numpy(x)).numpy()
    jch = JaxChebyshev(k, hi * 1e-4, hi, degree=12,
                       device_matrix=JaxBsr(k, dtype=np.float64, bs=64))
    jfn, jops = jch.device_rows_operands(8, n, dtype=np.float64)
    assert _rel(got, np.asarray(jfn(jops, jnp.asarray(x)))) < 1e-10
    # bf16 iterates stay possible with BSR, on request only
    f32 = BsrMatrix(k, bs=64, device='cpu')
    ch32 = Chebyshev(k, hi * 1e-4, hi, degree=12, device_matrix=f32)
    x32 = torch.from_numpy(x.astype(np.float32))
    auto = ch32.device_rows_operands(8, n)
    assert torch.equal(auto[0](auto[1], x32),
                       ch32.device_rows_operands(8, n, stream_bf16=False)[0](
                           auto[1], x32))
    bfn, bops = ch32.device_rows_operands(8, n, stream_bf16=True)
    yb = bfn(bops, x32)
    assert yb.dtype == torch.float32
    assert _rel(yb.numpy(), got) < 5e-2


def test_lobpcg_on_bsr_matches_jax(pencil, f64_default):
    """The FE-BSR field at a small size: lobpcg on hand-built BsrMatrix
    operators for the pencil (K, M) with a Chebyshev preconditioner over
    the same BSR matrix, against the JAX package from the same start
    block: eigenvalues to 1e-10 relative, equal iteration counts, f64."""
    k, mass = pencil
    n = k.shape[0]
    lo, hi = spectral_bounds(k)
    x0 = np.random.RandomState(8).standard_normal((n, 16))
    kw = dict(tol=1e-8, maxit=400, x0=x0, dtype=np.float64, block_size=16)
    tk = BsrMatrix(k, dtype=np.float64, bs=64, device='cpu')
    tm = BsrMatrix(mass, dtype=np.float64, bs=64, device='cpu')
    pre = Chebyshev(k, hi * 1e-4, hi, degree=32, device_matrix=tk) \
        .device_rows_operands(16, n, dtype=torch.float64)
    lam, x, _, it, status = lobpcg(tk, 6, opB=tm, precond=pre, **kw)
    jk = JaxBsr(k, dtype=np.float64, bs=64)
    jm = JaxBsr(mass, dtype=np.float64, bs=64)
    jpre = JaxChebyshev(k, hi * 1e-4, hi, degree=32, device_matrix=jk) \
        .device_rows_operands(16, n, dtype=np.float64)
    jlam, _, _, jit, jstatus = jax_lobpcg(jk, 6, opB=jm, precond=jpre, **kw)
    assert status == jstatus == 0 and it == jit
    assert np.abs(lam - jlam).max() / np.abs(jlam).max() < 1e-10
    assert np.abs(x.T @ (mass @ x) - np.eye(6)).max() < 1e-8
    # the solver stops at |K x - lambda M x| <= tol * (largest Ritz value
    # seen), which this pencil's random start block makes a large number:
    # measured 9e-8 here
    res = np.linalg.norm(k @ x - (mass @ x) * lam[None, :], axis=0)
    assert res.max() / (abs(k).sum(axis=1).max()
                        * np.linalg.norm(x, axis=0).min()) < 1e-6


def test_stream_scale_on_cpu_is_torch_mul():
    """The stream probe's wrapper: plain ``torch.mul`` on the CPU with no
    launch counted; other devices and the rate itself need a card."""
    x = torch.from_numpy(_block(1001, 3, 9, np.float32))
    before = dict(st.LAUNCHES)
    assert torch.equal(st.stream_scale(x, st.REFERENCE_SCALE),
                       torch.mul(x, st.REFERENCE_SCALE))
    assert st.LAUNCHES == before
    assert st.REFERENCE_SHAPE == (32, 1277952)
    with pytest.raises(ValueError, match='device'):
        st.stream_scale(x.to('meta'), 2.0)
    with pytest.raises(ValueError, match='CUDA'):
        st.stream_rate(device='cpu')


def test_every_c_entry_point_has_a_signature():
    """The loader binds exactly the C entry points the sources define,
    source by source (a missing signature would pass pointers as 32-bit
    ints)."""
    for src in sorted(_build.CSRC.glob('*.cu')):
        text = src.read_text()
        names = set(re.findall(r'extern "C" int (\w+)\(', text))
        names |= set(re.findall(r'^BSR_ENTRY\((\w+),', text, flags=re.M))
        names.discard('name')        # the macro's own parameter
        assert names == set(_build._SIGNATURES[src.stem]), src.name
    assert {s.stem for s in _build.CSRC.glob('*.cu')} == \
        set(_build._SIGNATURES)
