"""The CUDA kernels (DIA SpMM, BSR SpMM, stream scale) against their plain
PyTorch versions on the card.

Marked ``gpu``: without a CUDA device every test here skips (the fixture
decides, so every pytest-xdist worker collects the same tests).  Run on a
machine with a card:  python -m pytest tests/test_torch_gpu.py
(add --noconftest where jax is not installed: tests/conftest.py imports
it).

Tolerances: f32, 1e-6 of the largest |entry| of the plain result (both
accumulate in f32); bf16, the entrywise bound of ``chip_smoke.bf16_excess``
(one bf16 rounding on either side plus the f32 summation error bound),
which a bf16 running sum or bf16 products fail.  BSR: the entrywise bound
of ``chip_smoke.bsr_excess`` (twice the f32 summation error bound of an
entry's terms, plus one rounding on either side for a bf16 result).  Stream:
exact equality with ``torch.mul``.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from raleigh_tpu_torch.examples.fe_model import fe_pencil
from raleigh_tpu_torch.examples.laplace import lap3d
from raleigh_tpu_torch.ops import spmm_pallas as sp
from raleigh_tpu_torch.ops import spmm_window as sw
from raleigh_tpu_torch.ops import stream as st
from raleigh_tpu_torch.ops.spmm import BsrMatrix, DiaMatrix

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores (the small
# operand blocks here gain nothing from more threads).
torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

F32_TOL = 1e-6


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'chip_smoke.py')
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; torch finds none')
    return torch.device('cuda')


def _banded(n, offsets, seed):
    """A DIA matrix with the given offsets and random values."""
    rng = np.random.RandomState(seed)
    val = rng.standard_normal((len(offsets), n)).astype(np.float32)
    return offsets, val


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(8, 8, 16, 8), (7, 9, 11, 12),
                                   (30, 30, 31, 3)])
def test_kernel_matches_plain(cuda, shape, dtype):
    """lap3d stencils: aligned n, unaligned n with m = 12, and m below
    the kernel's 8-row group."""
    nx, ny, nz, m = shape
    dm = DiaMatrix(lap3d(nx, ny, nz, 1.0, 1.0, 1.0), device=cuda)
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn((m, dm.shape[0]), generator=g, device=cuda).to(dtype)
    before = sw.LAUNCHES[str(dtype).replace('torch.', '')]
    y = sw.dia_matmat_rows(dm.val, x, dm.offsets_t)
    want = sw.dia_matmat_rows_plain(dm.val, x, dm.offsets_t)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape
    if dtype == torch.float32:
        err = (y - want).abs().max() / want.abs().max()
        assert err.item() <= F32_TOL
    else:
        worst, _ = _chip_smoke().bf16_excess(torch, sw, dm.val, x,
                                             dm.offsets_t, y, want)
        assert worst <= 1
    assert sw.LAUNCHES[str(dtype).replace('torch.', '')] == before + 1


def test_kernel_many_offsets(cuda):
    """96 diagonals (device_sparse's DIA limit), offsets past either end
    of a short vector."""
    n = 1000
    offsets = sorted(set(range(-60, 61, 2)) | {-1500, -999, 999, 1500})
    offs, val = _banded(n, offsets[:96], 1)
    dm = DiaMatrix.from_arrays(offs, val, device=cuda)
    x = torch.randn((16, n), device=cuda)
    y = dm.matmat_rows(x)
    want = sw.dia_matmat_rows_plain(dm.val, x, dm.offsets_t)
    torch.cuda.synchronize()
    err = (y - want).abs().max() / want.abs().max()
    assert err.item() <= F32_TOL


def test_kernel_refuses_what_it_cannot_take(cuda):
    dm = DiaMatrix(lap3d(6, 6, 6, 1.0, 1.0, 1.0), device=cuda)
    x = torch.randn((8, dm.shape[0]), device=cuda)
    with pytest.raises(TypeError):
        sw.dia_matmat_rows(dm.val, x.double(), dm.offsets_t)
    with pytest.raises(ValueError, match='contiguous'):
        sw.dia_matmat_rows(dm.val, torch.randn((dm.shape[0], 8),
                                               device=cuda).T, dm.offsets_t)
    with pytest.raises(ValueError, match='shape'):
        sw.dia_matmat_rows(dm.val, x[:, :-1].contiguous(), dm.offsets_t)
    with pytest.raises(ValueError, match='device'):
        sw.dia_matmat_rows(dm.val.cpu(), x, dm.offsets_t)


@pytest.mark.parametrize('operand', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('tiles', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('bs,m', [(64, 24), (128, 16), (48, 5), (160, 3)])
def test_bsr_kernel_matches_plain(cuda, bs, m, tiles, operand):
    """A small girder (n = 2,796, a multiple of no block size here) with
    one block row emptied: block sizes below, at and above the kernel's
    128-row slab and off its 32-column chunk, m below, at and above its
    16-row group."""
    import scipy.sparse as scs
    k = fe_pencil(9, 3, 0.1, seed=2, which='k')
    n = k.shape[0]
    keep = np.ones(n)
    keep[2 * bs:3 * bs] = 0.0
    k = scs.csr_matrix(scs.diags(keep) @ k @ scs.diags(keep))
    k.eliminate_zeros()
    bm = BsrMatrix(k, bs=bs, dtype=tiles, device=cuda)
    assert n % bs and np.diff(bm.block_indptr).min() == 0
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn((m, n), generator=g, device=cuda).to(operand)
    key = (sp._NAMES[tiles], sp._NAMES[operand])
    before = sp.LAUNCHES[key]
    y = bm.matmat_rows(x)
    want = sp.bsr_matmat_rows_plain(bm.blocks, bm.block_indptr_t,
                                    bm.block_cols, x, n)
    torch.cuda.synchronize()
    assert y.dtype == operand and y.shape == x.shape
    assert sp.LAUNCHES[key] == before + 1
    worst, _ = _chip_smoke().bsr_excess(torch, sp, bm, x, y, want)
    assert worst <= 1
    assert torch.all(y[:, 2 * bs:3 * bs] == 0)
    if tiles == operand == torch.float32:
        exact = (k @ x.double().cpu().numpy().T).T
        err = np.abs(y.cpu().numpy() - exact).max() / np.abs(exact).max()
        assert err < 1e-6


def test_bsr_kernel_refuses_what_it_cannot_take(cuda):
    k = fe_pencil(9, 3, 0.1, seed=2, which='k')
    n = k.shape[0]
    bm = BsrMatrix(k, bs=64, device=cuda)
    x = torch.randn((8, n), device=cuda)
    args = (bm.blocks, bm.block_indptr_t, bm.block_cols)
    with pytest.raises(TypeError, match='float64'):
        sp.bsr_matmat_rows(*args, x.double(), n)
    with pytest.raises(ValueError, match='contiguous'):
        sp.bsr_matmat_rows(*args, torch.randn((n, 8), device=cuda).T, n)
    with pytest.raises(ValueError, match='shape'):
        sp.bsr_matmat_rows(*args, x[:, :-1].contiguous(), n)
    with pytest.raises(ValueError, match='device'):
        sp.bsr_matmat_rows(bm.blocks.cpu(), bm.block_indptr_t,
                           bm.block_cols, x, n)


def test_bsr_solve_with_no_device_argument_launches_the_kernel(cuda):
    """``BsrMatrix(K, bs=128)`` and ``lobpcg`` with no device named run on
    the card: the solve goes through the BSR kernel."""
    from raleigh_tpu_torch import Chebyshev, lobpcg, spectral_bounds
    k, mass = fe_pencil(9, 3, 0.1, seed=2, relabel=False)
    n = k.shape[0]
    bk, bmass = BsrMatrix(k, bs=128), BsrMatrix(mass, bs=128)
    assert bk.device.type == bk.blocks.device.type == 'cuda'
    _, hi = spectral_bounds(k)
    pre = Chebyshev(k, hi * 1e-4, hi, degree=32, device_matrix=bk) \
        .device_rows_operands(16, n)
    before = sp.LAUNCHES[('f32', 'f32')]
    lam, _, _, _, status = lobpcg(bk, 6, opB=bmass, precond=pre, tol=1e-4)
    assert status == 0 and np.all(np.isfinite(lam))
    assert sp.LAUNCHES[('f32', 'f32')] > before


@pytest.mark.parametrize('count,offset', [(1 << 20, 0), (1000003, 0),
                                          (1000003, 1), (3, 0)])
def test_stream_kernel_equals_torch_mul(cuda, count, offset):
    """16-byte aligned and not, with and without a tail."""
    g = torch.Generator(cuda).manual_seed(1)
    x = torch.randn(count + offset, generator=g, device=cuda)[offset:]
    before = st.LAUNCHES['float32']
    y = st.stream_scale(x, st.REFERENCE_SCALE)
    torch.cuda.synchronize()
    assert torch.equal(y, torch.mul(x, st.REFERENCE_SCALE))
    assert st.LAUNCHES['float32'] == before + 1
    with pytest.raises(TypeError, match='f32'):
        st.stream_scale(x.double(), 2.0)
