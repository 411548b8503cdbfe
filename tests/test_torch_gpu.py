"""The CUDA kernels (DIA SpMM in its three structures and over an extended
operand, BSR SpMM, stream scale in its three structures, the strided
copy) against their plain PyTorch versions on the card, and the mesh path
on a mesh of several shards of the one card.

Marked ``gpu``: without a CUDA device every test here skips (the fixture
decides, so every pytest-xdist worker collects the same tests).  Run on a
machine with a card:  python -m pytest tests/test_torch_gpu.py
(add --noconftest where jax is not installed: tests/conftest.py imports
it).

Tolerances: the DIA kernel keeps the plain version's products and order
of sums: exact equality.  Older DIA cases:
f32, 1e-6 of the largest |entry| of the plain result (both
accumulate in f32); bf16, the entrywise bound of ``chip_smoke.bf16_excess``
(one bf16 rounding on either side plus the f32 summation error bound),
which a bf16 running sum or bf16 products fail.  BSR: the entrywise bound
of ``chip_smoke.bsr_excess`` (twice the f32 summation error bound of an
entry's terms, plus one rounding on either side for a bf16 result), for
the kernel on its 16-byte and its general path.  Stream kernels: exact
equality with ``torch.mul``.  The f64 instantiation of the DIA kernel:
exact equality with its plain version; of the BSR kernel: 1e-13 of the
largest |entry| (f64 sums in another order) against the plain version.
The staged-window DIA kernels keep the plain version's order of
summation: exact equality, on the bulk-copy path and on the per-thread
copy branch.  The copy kernel, one copy or a batch: exact equality with ``Tensor.copy_``.  The mesh
DIA kernel, through its one-piece entry and its mesh entry: the entrywise
bounds of ``chip_smoke.window_excess`` and ``bf16_excess`` against its
plain version, and exact equality with the unsharded kernel (it adds a
zero where that one skips a term).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from raleigh_tpu_torch.examples.fe_model import fe_pencil
from raleigh_tpu_torch.examples.laplace import lap3d
from raleigh_tpu_torch.ops import _build
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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n,offsets', [
    # aligned n: interior tiles, shifts 0 to 3 mod 4 both ways
    (4096, [-1024, -101, -6, -3, -1, 0, 1, 2, 7, 100, 1024]),
    # n not a multiple of the 4 lanes a thread: the checked path only
    (4099, [-1024, -101, -6, -3, -1, 0, 1, 2, 7, 100, 1024]),
    # |offset| >= n, one diagonal, one batch of eight exactly
    (1000, [-1500, -1000, -999, 0, 999, 1000, 1500]),
    (1000, [0]),
    (2048, [-9, -5, -2, -1, 0, 1, 2, 3]),
    # lap3d's stencil at an aligned size
    (8 * 8 * 16, [-64, -8, -1, 0, 1, 8, 64]),
])
def test_kernel_equals_plain(cuda, n, offsets, dtype):
    """Random diagonals: the kernel equals its plain version bit for bit
    (it keeps the plain version's products and order of sums), for m = 1,
    5, 16, 24 and 40; one launch each."""
    offs, val = _banded(n, offsets, 3)
    dm = DiaMatrix.from_arrays(offs, val, device=cuda)
    key = str(dtype).replace('torch.', '')
    g = torch.Generator(cuda).manual_seed(n)
    for m in (1, 5, 16, 24, 40):
        x = torch.randn((m, n), generator=g, device=cuda).to(dtype)
        before = sw.LAUNCHES[key]
        y = sw.dia_matmat_rows(dm.val, x, dm.offsets_t)
        want = sw.dia_matmat_rows_plain(dm.val, x, dm.offsets_t)
        torch.cuda.synchronize()
        assert sw.LAUNCHES[key] == before + 1
        assert y.dtype == dtype and y.shape == x.shape
        assert torch.equal(y, want), m


def test_kernel_on_unaligned_views_equals_plain(cuda):
    """Operands one element into their storage (no 16-byte base): the
    checked path, still equal to the plain version bit for bit."""
    n = 4096
    offs, val = _banded(n, [-64, -1, 0, 1, 64], 4)
    dm = DiaMatrix.from_arrays(offs, val, device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.randn(16 * n + 1, device=cuda).to(dtype)
        x = buf[1:].view(16, n)
        assert x.data_ptr() % 16
        y = sw.dia_matmat_rows(dm.val, x, dm.offsets_t)
        assert torch.equal(y, sw.dia_matmat_rows_plain(dm.val, x,
                                                       dm.offsets_t))


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
    # an f64 operand has an instantiation (f32 or f64 values); an f16
    # operand, bf16 values under an f64 operand and f64 values under an
    # f32 operand have none
    with pytest.raises(TypeError):
        sw.dia_matmat_rows(dm.val, x.half(), dm.offsets_t)
    with pytest.raises(TypeError):
        sw.dia_matmat_rows(dm.val.bfloat16(), x.double(), dm.offsets_t)
    with pytest.raises(TypeError):
        sw.dia_matmat_rows(dm.val.double(), x, dm.offsets_t)
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


@pytest.mark.parametrize('operand', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('tiles', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('bs', [3, 5, 48, 64, 128, 160])
def test_bsr_kernel_on_both_paths(cuda, bs, tiles, operand):
    """The girder cut to n = 2,794, a multiple of no block size here, with
    one block row emptied: bs = 3 and 5 take the general path (a row of
    tiles is no multiple of 16 bytes), 48 to 160 the 16-byte path; m = 1,
    5, 16, 24 and 40 (a half row group, one, one and a half, two and a
    half).  The kernel within the entrywise bound of the plain version,
    the empty block row zero, one launch each."""
    import scipy.sparse as scs
    k = fe_pencil(9, 3, 0.1, seed=2, which='k')[:2794, :2794]
    n = k.shape[0]
    keep = np.ones(n)
    keep[2 * bs:3 * bs] = 0.0
    k = scs.csr_matrix(scs.diags(keep) @ k @ scs.diags(keep))
    k.eliminate_zeros()
    bm = BsrMatrix(k, bs=bs, dtype=tiles, device=cuda)
    assert n % bs and np.diff(bm.block_indptr).min() == 0
    assert ((bs * bm.blocks.element_size()) % 16 == 0) == (bs >= 48)
    cs = _chip_smoke()
    key = (sp._NAMES[tiles], sp._NAMES[operand])
    g = torch.Generator(cuda).manual_seed(bs)
    args = (bm.blocks, bm.block_indptr_t, bm.block_cols)
    for m in (1, 5, 16, 24, 40):
        x = torch.randn((m, n), generator=g, device=cuda).to(operand)
        want = sp.bsr_matmat_rows_plain(*args, x, n)
        before = sp.LAUNCHES[key]
        y = sp.bsr_matmat_rows(*args, x, n)
        torch.cuda.synchronize()
        assert sp.LAUNCHES[key] == before + 1
        assert y.dtype == operand and y.shape == x.shape
        assert torch.isfinite(y.float()).all()
        worst, _ = cs.bsr_excess(torch, sp, bm, x, y, want)
        assert worst <= 1, m
        assert torch.all(y[:, 2 * bs:3 * bs] == 0)


@pytest.mark.parametrize('n, offsets', [(1000, (-31, -1, 0, 1, 31)),
                                        (999, (-7, -2, 0, 3, 5)),
                                        (64, (-70, -1, 0, 2, 70))])
@pytest.mark.parametrize('m', [1, 5, 16])
@pytest.mark.parametrize('values', [torch.float32, torch.float64])
def test_f64_kernel_equals_plain(cuda, n, offsets, m, values):
    """The f64 instantiation of the DIA kernel (f64 operand, f32 or f64
    values widened on load, f64 sums in diagonal order) equals the plain
    version bit for bit: aligned and odd shifts, odd n, offsets past the
    matrix, a view at an unaligned base."""
    offs, val = _banded(n, list(offsets), 3)
    dm = DiaMatrix.from_arrays(offs, val.astype(np.float64), device=cuda,
                               exact=True)
    v = dm.val.to(values)
    g = torch.Generator(cuda).manual_seed(m)
    x = torch.randn((m, n), generator=g, device=cuda, dtype=torch.float64)
    key = 'float64_val32' if values == torch.float32 else 'float64_val64'
    before = sw.LAUNCHES[key]
    y = sw.dia_matmat_rows(v, x, dm.offsets_t)
    want = sw.dia_matmat_rows_plain(v, x, dm.offsets_t)
    torch.cuda.synchronize()
    assert sw.LAUNCHES[key] == before + 1
    assert y.dtype == torch.float64 and torch.equal(y, want)
    xu = torch.randn((m * n + 1,), generator=g, device=cuda,
                     dtype=torch.float64)[1:].reshape(m, n)
    assert torch.equal(sw.dia_matmat_rows(v, xu, dm.offsets_t),
                       sw.dia_matmat_rows_plain(v, xu, dm.offsets_t))


@pytest.mark.parametrize('bs, aligned', [(128, True), (64, True),
                                         (16, True), (160, True), (5, True),
                                         (160, False)])
@pytest.mark.parametrize('tiles', [torch.float32, torch.float64])
def test_bsr_f64_kernel_matches_plain(cuda, bs, aligned, tiles):
    """The f64 instantiation of the BSR kernel (f64 operand, f32 or f64
    tiles, f64 sums on the tensor cores) against the plain version, within
    1e-13 of the largest |entry| (f64 sums in another order): the girder (n = 2,796, a multiple
    of no block size here) with one block row emptied; bs = 128, 64, 16
    and 160 (two slabs) on the 16-byte path, bs = 5 and 160 at a tile base
    4 or 8 bytes off (the general path); m = 1, 3, 8, 9, 16 and 24 (one n8
    tile, two, a group of 16 and one of 8, rows no group divides); x
    contiguous and as a view 8 bytes into its storage; one launch each."""
    import scipy.sparse as scs
    k = fe_pencil(9, 3, 0.1, seed=2, which='k')
    n = k.shape[0]
    keep = np.ones(n)
    keep[2 * bs:3 * bs] = 0.0
    k = scs.csr_matrix(scs.diags(keep) @ k @ scs.diags(keep))
    k.eliminate_zeros()
    bm = BsrMatrix(k, dtype=np.float64, bs=bs, device=cuda, exact=True)
    assert n % bs and np.diff(bm.block_indptr).min() == 0
    blocks = bm.blocks.to(tiles)
    if not aligned:
        blocks = torch.empty(blocks.numel() + 1, dtype=tiles, device=cuda)[
            1:].view_as(blocks).copy_(blocks)
    rows16 = bs * blocks.element_size() % 16 == 0
    assert (rows16 and blocks.data_ptr() % 16 == 0) == (aligned and bs != 5)
    args = (blocks, bm.block_indptr_t, bm.block_cols)
    key = (sp._NAMES[tiles], 'f64')
    g = torch.Generator(cuda).manual_seed(bs)
    for m in (1, 3, 8, 9, 16, 24):
        xs = (torch.randn((m, n), generator=g, device=cuda,
                          dtype=torch.float64),
              torch.randn((m * n + 1,), generator=g, device=cuda,
                          dtype=torch.float64)[1:].reshape(m, n))
        for x in xs:
            want = sp.bsr_matmat_rows_plain(*args, x, n)
            before = sp.LAUNCHES[key]
            y = sp.bsr_matmat_rows(*args, x, n)
            torch.cuda.synchronize()
            assert sp.LAUNCHES[key] == before + 1
            assert y.dtype == torch.float64 and y.shape == x.shape
            rel = ((y - want).abs().max() / want.abs().max()).item()
            assert rel < 1e-13, m
            assert torch.all(y[:, 2 * bs:3 * bs] == 0)


def test_bsr_kernel_refuses_what_it_cannot_take(cuda):
    k = fe_pencil(9, 3, 0.1, seed=2, which='k')
    n = k.shape[0]
    bm = BsrMatrix(k, bs=64, device=cuda)
    x = torch.randn((8, n), device=cuda)
    args = (bm.blocks, bm.block_indptr_t, bm.block_cols)
    # an f64 operand takes f32 or f64 tiles (the f64 instantiation), not
    # bf16 tiles
    with pytest.raises(TypeError, match='float64'):
        sp.bsr_matmat_rows(bm.blocks.bfloat16(), *args[1:], x.double(), n)
    before = sp.LAUNCHES[('f32', 'f64')]
    sp.bsr_matmat_rows(*args, x.double(), n)
    assert sp.LAUNCHES[('f32', 'f64')] == before + 1
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


def _launched(before):
    """{launch key: launches since ``before``} of the keys that moved."""
    return {k: v - before[k] for k, v in sw.LAUNCHES.items()
            if v != before[k]}


@pytest.mark.parametrize('variant', ['slide', 'tiles'])
@pytest.mark.parametrize('shape,m,tile', [
    ((8, 8, 16), 8, 256),       # aligned n, two rows of tiles
    ((7, 9, 11), 5, 100),       # n = 693, not a multiple of 4; ragged tile
    ((7, 9, 11), 5, 64),        # tiles: max|offset| = 63 just fits
    ((30, 30, 31), 3, 1000),    # n = 27,900: many segments, m below a group
    ((30, 30, 31), 16, 4096),   # two row groups
    ((6, 6, 6), 1, 5000),       # one tile wider than the vector
])
def test_staged_window_kernels_equal_plain(cuda, variant, shape, m, tile):
    """The sliding-window and tile-ring kernels against the plain version
    at odd shapes: they sum the diagonals in its order, so they are equal
    bit for bit; one launch, under the kernel's own key."""
    fn, key = sw.VARIANTS[variant], variant
    dm = DiaMatrix(lap3d(*shape, 1.0, 1.0, 1.0), device=cuda)
    g = torch.Generator(cuda).manual_seed(3)
    x = torch.randn((m, dm.shape[0]), generator=g, device=cuda)
    before = dict(sw.LAUNCHES)
    y = fn(dm.val, x, dm.offsets, tile)
    want = sw.dia_matmat_rows_plain(dm.val, x, dm.offsets_t)
    torch.cuda.synchronize()
    assert _launched(before) == {key: 1}
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert torch.equal(y, want)


@pytest.mark.parametrize('variant,tile', [('slide', 16384), ('tiles', 8192)])
@pytest.mark.parametrize('m', [1, 5, 33])
def test_staged_window_kernels_fill_ragged_clusters(cuda, variant, tile, m):
    """Tiles wide enough that a block holds one row, so a cluster holds
    one row group a block: m = 1 (a cluster of one block), 5 and 33 (rows
    that fill no whole cluster; the blocks past m read every val chunk and
    compute nothing), on the bulk-copy path with a stage of val: equal to
    the plain version bit for bit."""
    dm = DiaMatrix(lap3d(30, 30, 31, 1.0, 1.0, 1.0), device=cuda)
    g = torch.Generator(cuda).manual_seed(m)
    x = torch.randn((m, dm.shape[0]), generator=g, device=cuda)
    y = sw.VARIANTS[variant](dm.val, x, dm.offsets, tile)
    plan = sw.window_launch_plan(variant, dm.val, x, dm.offsets, tile)
    want = sw.dia_matmat_rows_plain(dm.val, x, dm.offsets_t)
    torch.cuda.synchronize()
    assert plan['rows'] == 1 and plan['bulk'], plan
    assert plan['chunk'] >= sw.MIN_CHUNK_LANES, plan
    assert plan['cluster'] == (1 if m == 1 else 2), plan
    assert plan['cluster'] * plan['clusters_per_segment'] >= m, plan
    assert plan['blocks'] == (plan['segments'] * plan['clusters_per_segment']
                              * plan['cluster']), plan
    assert torch.equal(y, want)


def _largest_tile(variant, offsets, m, bulk, staged=None):
    """The widest tile whose windows (and, on the bulk-copy branch, the val
    stages the kernel keeps) fit a block's shared memory, of those where
    the kernel keeps a stage of val (``staged``), keeps none, or either
    (None)."""
    def fits(tile):
        if variant == 'tiles':
            lanes = 4 * tile
        else:
            lanes = sw._reach(offsets) + 2 * tile
        try:
            chunk = sw._window_plan(m, lanes, len(offsets), bulk, variant)[1]
        except ValueError:
            return False
        return staged is None or (chunk > 0) == staged

    lo, hi = 1, 1 << 16
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


@pytest.mark.parametrize('variant', ['slide', 'tiles'])
@pytest.mark.parametrize('case,shape,m,tile', [
    ('n % 4', (7, 9, 11), 5, None),       # n = 693
    ('n % 4', (9, 9, 9), 3, 100),         # n = 729, many tiles
    ('view', (30, 30, 31), 16, None),     # x 4 bytes into its storage
    ('view', (30, 30, 31), 16, 1000),
])
def test_staged_window_kernels_per_thread_copy_branch(cuda, variant, case,
                                                      shape, m, tile):
    """Shapes a bulk copy cannot take, n not a multiple of 4 and an operand
    one element into its storage, go through the kernels' per-thread copy
    branch (a cluster of one block, no stage of val), at a tile of many and
    at the widest tile whose windows fit: equal to the plain version bit
    for bit.  One lane wider is refused before any launch."""
    fn, key = sw.VARIANTS[variant], variant
    dm = DiaMatrix(lap3d(*shape, 1.0, 1.0, 1.0), device=cuda)
    n = dm.shape[0]
    g = torch.Generator(cuda).manual_seed(5)
    if case == 'view':
        x = torch.randn(m * n + 1, generator=g, device=cuda)[1:].view(m, n)
        assert x.data_ptr() % 16 == 4
    else:
        x = torch.randn((m, n), generator=g, device=cuda)
        assert n % 4
    widest = tile is None
    if widest:
        tile = _largest_tile(variant, dm.offsets, m, bulk=False)
    before = dict(sw.LAUNCHES)
    y = fn(dm.val, x, dm.offsets, tile)
    want = sw.dia_matmat_rows_plain(dm.val, x, dm.offsets_t)
    torch.cuda.synchronize()
    assert _launched(before) == {key: 1}
    plan = sw.window_launch_plan(variant, dm.val, x, dm.offsets, tile)
    assert not plan['bulk'] and plan['chunk'] == 0, plan
    assert plan['cluster'] == 1, plan
    assert torch.equal(y, want)
    if widest:
        with pytest.raises(ValueError, match='shared memory'):
            fn(dm.val, x, dm.offsets, tile + 1)
        assert _launched(before) == {key: 1}


@pytest.mark.parametrize('variant', ['slide', 'tiles'])
def test_staged_window_kernels_at_the_widest_bulk_tile(cuda, variant):
    """The bulk-copy branch at the widest tile that keeps a stage of val
    (the narrowest chunk), at the widest tile that fits at all (val from
    device memory, no stage) and at the sweep's widest tile: equal to the
    plain version bit for bit; one lane a tile wider is refused."""
    dm = DiaMatrix(lap3d(30, 30, 32, 1.0, 1.0, 1.0), device=cuda)
    g = torch.Generator(cuda).manual_seed(7)
    x = torch.randn((16, dm.shape[0]), generator=g, device=cuda)
    want = sw.dia_matmat_rows_plain(dm.val, x, dm.offsets_t)
    staged = _largest_tile(variant, dm.offsets, 16, True, True)
    widest = _largest_tile(variant, dm.offsets, 16, True)
    assert staged < widest
    for tile, stage in ((staged - staged % 4, True),
                        (widest - widest % 4, False),
                        ({'slide': 16384, 'tiles': 14336}[variant], None)):
        y = sw.VARIANTS[variant](dm.val, x, dm.offsets, tile)
        plan = sw.window_launch_plan(variant, dm.val, x, dm.offsets, tile)
        torch.cuda.synchronize()
        assert plan['bulk'], plan
        if stage is not None:
            assert (plan['chunk'] >= sw.MIN_CHUNK_LANES) == stage, plan
            assert plan['cluster'] == (2 if stage else 1), plan
        assert torch.equal(y, want), tile
    with pytest.raises(ValueError, match='shared memory'):
        sw.VARIANTS[variant](dm.val, x, dm.offsets, widest + 1)


@pytest.mark.parametrize('variant', ['slide', 'tiles'])
def test_staged_window_kernels_many_diagonals_no_stage(cuda, variant):
    """128 diagonals, the most the kernels take: no stage of val of
    ``MIN_CHUNK_LANES`` fits beside eight rows' windows, so the bulk-copy
    branch reads val from device memory with eight rows a block: equal to
    the plain version bit for bit."""
    n = 4000
    offs, val = _banded(n, list(range(-64, 64)), 11)
    dm = DiaMatrix.from_arrays(offs, val, device=cuda)
    x = torch.randn((16, n), generator=torch.Generator(cuda).manual_seed(11),
                    device=cuda)
    y = sw.VARIANTS[variant](dm.val, x, dm.offsets, 512)
    plan = sw.window_launch_plan(variant, dm.val, x, dm.offsets, 512)
    want = sw.dia_matmat_rows_plain(dm.val, x, dm.offsets_t)
    torch.cuda.synchronize()
    assert plan['bulk'] and plan['chunk'] == 0 and plan['rows'] == 8, plan
    assert plan['cluster'] == 1, plan
    assert torch.equal(y, want)


@pytest.mark.parametrize('variant', ['slide', 'tiles'])
def test_staged_window_kernels_unsymmetric_offsets(cuda, variant):
    """Random values on an unsymmetric offset set, offsets past either end
    of the vector included."""
    n = 1003
    offs, val = _banded(n, [-700, -31, -2, 0, 1, 5, 64, 1100], 2)
    tile = 1100 if variant == 'tiles' else 128
    dm = DiaMatrix.from_arrays(offs, val, device=cuda)
    x = torch.randn((5, n), device=cuda)
    y = sw.VARIANTS[variant](dm.val, x, dm.offsets, tile)
    want = sw.dia_matmat_rows_plain(dm.val, x, dm.offsets_t)
    torch.cuda.synchronize()
    assert torch.equal(y, want)


def test_staged_window_kernels_refuse_what_they_cannot_take(cuda):
    dm = DiaMatrix(lap3d(6, 6, 6, 1.0, 1.0, 1.0), device=cuda)
    x = torch.randn((5, dm.shape[0]), device=cuda)
    with pytest.raises(ValueError, match='max.offset. <= tile'):
        sw.dia_matmat_rows_tiles(dm.val, x, dm.offsets, 35)
    with pytest.raises(ValueError, match='shared memory'):
        sw.dia_matmat_rows_tiles(dm.val, x, dm.offsets, 20000)
    with pytest.raises(ValueError, match='shared memory'):
        sw.dia_matmat_rows_slide(dm.val, x, dm.offsets, 40000)
    with pytest.raises(ValueError, match='at least 1'):
        sw.dia_matmat_rows_slide(dm.val, x, dm.offsets, 0)
    with pytest.raises(TypeError, match='f32'):
        sw.dia_matmat_rows_slide(dm.val, x.bfloat16(), dm.offsets, 64)
    with pytest.raises(ValueError, match='device'):
        sw.dia_matmat_rows_tiles(dm.val.cpu(), x, dm.offsets, 64)


@pytest.mark.parametrize('per_step', [1, 4])
@pytest.mark.parametrize('m,n,tile', [(5, 4096, 1024), (5, 1000, 8),
                                      (3, 40 * 52, 52), (1, 16, 4)])
def test_tiled_stream_kernel_equals_torch_mul(cuda, m, n, tile, per_step):
    g = torch.Generator(cuda).manual_seed(1)
    n -= n % (tile * per_step)
    x = torch.randn((m, n), generator=g, device=cuda)
    before = st.LAUNCHES['tiled']
    y = st.stream_scale_tiled(x, st.REFERENCE_SCALE, tile, per_step)
    torch.cuda.synchronize()
    assert torch.equal(y, torch.mul(x, st.REFERENCE_SCALE))
    assert st.LAUNCHES['tiled'] == before + 1


@pytest.mark.parametrize('depth', [2, 4])
@pytest.mark.parametrize('m,n,tile', [(5, 4096, 1024), (5, 1000, 8),
                                      (3, 40 * 52, 52), (1, 16, 4),
                                      (32, 1 << 16, 8192)])
def test_pipelined_stream_kernel_equals_torch_mul(cuda, m, n, tile, depth):
    """Fewer chunks than blocks, more chunks than blocks with an uneven
    share, and a single chunk."""
    g = torch.Generator(cuda).manual_seed(1)
    x = torch.randn((m, n), generator=g, device=cuda)
    key = 'pipelined_depth%d' % depth
    before = st.LAUNCHES[key]
    y = st.stream_scale_pipelined(x, st.REFERENCE_SCALE, tile, depth)
    torch.cuda.synchronize()
    assert torch.equal(y, torch.mul(x, st.REFERENCE_SCALE))
    assert st.LAUNCHES[key] == before + 1


# the largest tile whose stages and barriers fit a block, per depth
_EDGE_TILE = {2: 29052, 4: 14524}


@pytest.mark.parametrize('depth', [2, 4])
@pytest.mark.parametrize('m,n,tile', [
    (5, 4000, 4),               # 5,000 chunks of 16 bytes, the bulk minimum
    (7, 1024 * 1000, 1024),     # 7,000 chunks: many a block, shared unevenly
    (3, 40 * 52, 52),           # fewer chunks than blocks
    (2, None, None),            # depth * tile at the shared-memory edge
])
def test_pipelined_stream_designs_at_their_edges(cuda, m, n, tile, depth):
    """The pipelined kernel equals ``torch.mul`` on
    the bulk copy's smallest chunk, on many chunks per block with an
    uneven share, and at the largest tile whose ``depth`` stages and their
    barriers fit a block's shared memory (four tiles a row); one tile more
    is refused before any launch."""
    if tile is None:
        tile = _EDGE_TILE[depth]
        n = 4 * tile
        assert (st.pipeline_smem_bytes(tile, depth) <= _build.SMEM_PER_BLOCK
                < st.pipeline_smem_bytes(tile + 4, depth))
    fn, key = st.stream_scale_pipelined, 'pipelined_depth%d' % depth
    g = torch.Generator(cuda).manual_seed(depth)
    x = torch.randn((m, n), generator=g, device=cuda)
    before = st.LAUNCHES[key]
    y = fn(x, st.REFERENCE_SCALE, tile, depth)
    torch.cuda.synchronize()
    assert torch.equal(y, torch.mul(x, st.REFERENCE_SCALE))
    assert st.LAUNCHES[key] == before + 1
    if tile == _EDGE_TILE[depth]:
        wider = torch.zeros((1, 2 * (tile + 4)), device=cuda)
        with pytest.raises(ValueError, match='shared memory'):
            fn(wider, 2.0, tile + 4, depth)


def test_stream_probes_refuse_what_they_cannot_take(cuda):
    x = torch.randn((5, 1000), device=cuda)
    with pytest.raises(ValueError, match='multiple of tile'):
        st.stream_scale_tiled(x, 2.0, 16)
    with pytest.raises(ValueError, match='multiple of 4'):
        st.stream_scale_tiled(x, 2.0, 10)
    with pytest.raises(ValueError, match='depth'):
        st.stream_scale_pipelined(x, 2.0, 8, 3)
    with pytest.raises(ValueError, match='shared memory'):
        st.stream_scale_pipelined(torch.zeros((1, 1 << 17), device=cuda),
                                  2.0, 1 << 16, 4)
    with pytest.raises(ValueError, match='aligned'):
        st.stream_scale_pipelined(x.reshape(-1)[1:801].reshape(1, 800), 2.0,
                                  8, 2)
    with pytest.raises(TypeError, match='f32'):
        st.stream_scale_tiled(x.double(), 2.0, 8)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('rows,width,src_off,dst_off', [
    (16, 10000, 150000, 0),     # a halo: both ends 16-byte aligned
    (16, 10000, 150001, 0),     # source shifted by one element
    (16, 10000, 150000, 3),     # destination shifted
    (5, 1001, 7, 11),           # odd width, both shifted
    (1, 4099, 0, 0),            # one row
    (3, 1, 2, 2),               # one lane
])
def test_copy_lanes_equals_copy(cuda, rows, width, src_off, dst_off, dtype):
    """Column slices of one row-major block into a slot of another, on the
    16-byte path and on the element path: exact equality with ``copy_``."""
    g = torch.Generator(cuda).manual_seed(4)
    src = torch.randn((rows, 160016), generator=g, device=cuda).to(dtype)
    want = torch.zeros((rows, 20000 + width), dtype=dtype, device=cuda)
    got = torch.zeros_like(want)
    view = src[:, src_off:src_off + width]
    before = st.LAUNCHES['copy_lanes']
    out = st.copy_lanes(got[:, dst_off:dst_off + width], view)
    st.copy_lanes_plain(want[:, dst_off:dst_off + width], view)
    torch.cuda.synchronize()
    assert st.LAUNCHES['copy_lanes'] == before + 1
    assert out.data_ptr() == got[:, dst_off:].data_ptr()
    assert torch.equal(got, want)        # and nothing outside the slot


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64,
                                   torch.bfloat16, torch.uint8])
@pytest.mark.parametrize('m,n,tile', [(32, 8192, 1024), (5, 1000, 8),
                                      (3, 2080, 52), (1, 16, 16),
                                      (7, 999, 999), (4, 6000, 3)])
def test_hbm2hbm_equals_copy(cuda, m, n, tile, dtype):
    g = torch.Generator(cuda).manual_seed(5)
    x = (torch.randn((m, n), generator=g, device=cuda) * 50).to(dtype)
    before = st.LAUNCHES['copy_lanes']
    y = st.hbm2hbm(x, tile)
    torch.cuda.synchronize()
    assert st.LAUNCHES['copy_lanes'] == before + 1
    assert y.dtype == dtype and y.data_ptr() != x.data_ptr()
    assert torch.equal(y, x)
    # a contiguous copy between two whole tensors runs as one long row
    z = torch.empty_like(x)
    st.copy_lanes(z, x)
    assert torch.equal(z, x)


def test_copy_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.randn((4, 100), device=cuda)
    with pytest.raises(ValueError, match='device'):
        st.copy_lanes(torch.empty((4, 100)), x)
    with pytest.raises(TypeError, match='converts nothing'):
        st.copy_lanes(torch.empty_like(x, dtype=torch.bfloat16), x)
    with pytest.raises(ValueError, match='one shape'):
        st.copy_lanes(torch.empty((4, 99), device=cuda), x)
    with pytest.raises(ValueError, match='unit stride'):
        st.copy_lanes(torch.empty((100, 4), device=cuda).T, x)
    with pytest.raises(ValueError, match='multiple of tile'):
        st.hbm2hbm(x, 33)


def _ext_case(cuda, shape, m, dtype, pad=(0, 0), seed=6):
    """A DIA matrix, an operand and its extension by ring-wrapped halos of
    the stencil's reach plus ``pad`` lanes on either side."""
    dm = DiaMatrix(lap3d(*shape, 1.0, 1.0, 1.0), device=cuda)
    n = dm.shape[0]
    g = torch.Generator(cuda).manual_seed(seed)
    x = torch.randn((m, n), generator=g, device=cuda).to(dtype)
    lo = max(0, -min(dm.offsets)) + pad[0]
    hi = max(0, max(dm.offsets)) + pad[1]
    x_ext = torch.cat((x[:, n - lo:], x, x[:, :hi]), dim=1)
    return dm, x, x_ext, lo


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,m,pad', [
    ((8, 8, 16), 8, (0, 0)),        # aligned n
    ((5, 7, 9), 12, (0, 0)),        # n = 315, odd halos of 35
    ((5, 7, 9), 3, (1, 2)),         # more halo than the reach asks for
    ((30, 30, 31), 16, (0, 0)),     # two row groups
])
def test_ext_kernel_matches_plain_and_the_unsharded_kernel(cuda, shape, m,
                                                           pad, dtype):
    """The extended-operand kernel on a whole matrix with ring-wrapped
    halos: within the entrywise bound of its plain version, and equal bit
    for bit to the unsharded kernel (the wrapped lanes meet zero values)."""
    dm, x, x_ext, lo = _ext_case(cuda, shape, m, dtype, pad)
    n = dm.shape[0]
    key = 'ext_' + str(dtype).replace('torch.', '')
    before = sw.LAUNCHES[key]
    y = sw.dia_matmat_rows_ext(dm.val, x_ext, dm.offsets_t, lo, n)
    want = sw.dia_matmat_rows_ext_plain(dm.val, x_ext, dm.offsets_t, lo, n)
    torch.cuda.synchronize()
    assert sw.LAUNCHES[key] == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    cs = _chip_smoke()
    excess = cs.window_excess if dtype == torch.float32 else cs.bf16_excess
    worst, _ = excess(torch, sw, dm.val, x, dm.offsets_t, y, want)
    assert worst <= 1
    assert torch.equal(y, sw.dia_matmat_rows(dm.val, x, dm.offsets_t))
    # a strided operand: the kernel takes x_ext's own row stride
    wide = torch.zeros((m, x_ext.shape[1] + 5), dtype=dtype, device=cuda)
    wide[:, 2:2 + x_ext.shape[1]] = x_ext
    y2 = sw.dia_matmat_rows_ext(dm.val, wide[:, 2:2 + x_ext.shape[1]],
                                dm.offsets_t, lo, n)
    assert torch.equal(y2, y)


def test_ext_kernel_refuses_what_it_cannot_take(cuda):
    dm, x, x_ext, lo = _ext_case(cuda, (6, 6, 6), 8, torch.float32)
    n = dm.shape[0]
    with pytest.raises(ValueError, match='reach'):
        sw.dia_matmat_rows_ext(dm.val, x_ext, dm.offsets_t, lo - 1, n)
    with pytest.raises(ValueError, match='reach'):
        sw.dia_matmat_rows_ext(dm.val, x_ext[:, :-1], dm.offsets_t, lo, n)
    with pytest.raises(TypeError, match='f32 or bf16'):
        sw.dia_matmat_rows_ext(dm.val, x_ext.half(), dm.offsets_t, lo, n)
    with pytest.raises(ValueError, match='shape'):
        sw.dia_matmat_rows_ext(dm.val, x_ext, dm.offsets_t, lo, n - 1)
    with pytest.raises(ValueError, match='device'):
        sw.dia_matmat_rows_ext(dm.val.cpu(), x_ext, dm.offsets_t, lo, n)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,shards', [((8, 8, 16), 8), ((5, 7, 9), 8),
                                          ((5, 7, 9), 3), ((30, 30, 31), 2),
                                          ((6, 6, 6), 8), ((8, 8, 16), 1),
                                          ((8, 8, 16), 20)])
def test_sharded_apply_on_one_card_equals_the_unsharded(cuda, shape, shards,
                                                        dtype):
    """A mesh of several shards of one card: even and uneven shards, odd
    halos, a reach wider than a shard (6^3 on 8), one shard, and more shards
    than one parameter block takes (20: two launches).  One mesh-kernel
    launch per table, no copy and no per-shard launch; within the
    entrywise bound of the plain version over the same piece table, and
    equal bit for bit to the unsharded kernel."""
    from raleigh_tpu_torch import make_mesh, shard_operator
    from raleigh_tpu_torch.parallel.mesh import ShardedRows, blockvec_sharding
    a = lap3d(*shape, 1.0, 1.0, 1.0)
    mesh = make_mesh(shards)
    assert all(d.type == 'cuda' for d in mesh.devices.ravel())
    dm = DiaMatrix(a)
    sharded = shard_operator(DiaMatrix(a), mesh)
    g = torch.Generator(cuda).manual_seed(7)
    x = torch.randn((12, dm.shape[0]), generator=g, device=cuda).to(dtype)
    xs = ShardedRows.split(x, blockvec_sharding(mesh))
    plan = sharded._mesh_plan(sharded.val.sharding)
    assert len(plan.launches) == (1 if shards <= sw.MESH_MAX_SHARDS else 2)
    key = 'mesh_' + str(dtype).replace('torch.', '')
    before = dict(sw.LAUNCHES), dict(st.LAUNCHES)
    y = sharded.matmat_rows(xs)
    torch.cuda.synchronize()
    moved = {k: v - before[0][k] for k, v in sw.LAUNCHES.items()
             if v != before[0][k]}
    assert moved == {key: len(plan.launches)}
    assert dict(st.LAUNCHES) == before[1]
    assert torch.equal(y.gather(), dm.matmat_rows(x))
    want = sw.dia_matmat_rows_mesh_plain(sharded.val.parts, xs.parts, plan)
    cs = _chip_smoke()
    excess = cs.window_excess if dtype == torch.float32 else cs.bf16_excess
    whole = torch.cat(want, dim=1)
    worst, _ = excess(torch, sw, dm.val, x, dm.offsets_t, y.gather(), whole)
    assert worst <= 1


def test_mesh_kernel_refuses_what_it_cannot_take(cuda):
    from raleigh_tpu_torch import make_mesh, shard_operator
    from raleigh_tpu_torch.parallel.mesh import ShardedRows, blockvec_sharding
    sharded = shard_operator(DiaMatrix(lap3d(6, 6, 8, 1.0, 1.0, 1.0)),
                             make_mesh(4))
    plan = sharded._mesh_plan(sharded.val.sharding)
    x = torch.randn((5, 288), device=cuda)
    xs = ShardedRows.split(x, sharded.val.sharding).parts
    with pytest.raises(TypeError, match='f32 or bf16'):
        sw.dia_matmat_rows_mesh(sharded.val.parts, [p.half() for p in xs],
                                plan)
    with pytest.raises(ValueError, match='operand parts'):
        sw.dia_matmat_rows_mesh(sharded.val.parts,
                                [p[:, 1:] for p in xs], plan)
    with pytest.raises(ValueError, match='operand part on'):
        sw.dia_matmat_rows_mesh(sharded.val.parts, [p.cpu() for p in xs],
                                plan)
    with pytest.raises(ValueError, match='unit stride'):
        sw.dia_matmat_rows_mesh(sharded.val.parts,
                                [p.T.contiguous().T for p in xs], plan)


def test_copy_lanes_many_is_one_launch(cuda):
    """Copies of mixed dtypes and alignments (16-byte and element paths)
    in one call: one launch for up to ``COPY_MAX`` copies, exact equality
    with ``copy_`` and nothing written outside the slots."""
    g = torch.Generator(cuda).manual_seed(8)
    for count in (24, st.COPY_MAX + 3):
        pairs, plain, gots, wants = [], [], [], []
        for i in range(count):
            dtype = (torch.float32, torch.bfloat16, torch.uint8,
                     torch.float64)[i % 4]
            rows, width, s0, d0 = 1 + i % 5, 1000 + 37 * i, i % 3, i % 7
            src = (torch.randn((rows, width + 8), generator=g, device=cuda)
                   * 50).to(dtype)
            got = torch.zeros((rows, width + 16), dtype=dtype, device=cuda)
            want = torch.zeros_like(got)
            pairs.append((got[:, d0:d0 + width], src[:, s0:s0 + width]))
            plain.append((want[:, d0:d0 + width], src[:, s0:s0 + width]))
            gots.append(got)
            wants.append(want)
        before = st.LAUNCHES['copy_lanes']
        st.copy_lanes_many(pairs)
        st.copy_lanes_many_plain(plain)
        torch.cuda.synchronize()
        assert st.LAUNCHES['copy_lanes'] == before + -(-count // st.COPY_MAX)
        for got, want in zip(gots, wants):
            assert torch.equal(got, want)


def test_sharded_ell_halo_is_one_copy_launch(cuda):
    """``ShardedEllMatrix`` in halo mode on eight shards of the card: every
    product assembles all shards' extended operands in one copy launch,
    within 1e-5 of SciPy."""
    from raleigh_tpu_torch import ShardedEllMatrix, make_mesh
    a = lap3d(12, 12, 12, 1.0, 1.0, 1.0)
    sm = ShardedEllMatrix(a, make_mesh(8))
    assert sm.mode == 'halo'
    x = np.random.default_rng(5).standard_normal((a.shape[0], 8)) \
        .astype(np.float32)
    before = st.LAUNCHES['copy_lanes']
    y = sm.matmat_t(x)
    torch.cuda.synchronize()
    assert st.LAUNCHES['copy_lanes'] == before + 1
    ref = a @ x
    assert np.abs(y.cpu().numpy() - ref).max() / np.abs(ref).max() < 1e-5


def test_sharded_solve_with_no_device_argument_runs_on_the_card(cuda):
    from raleigh_tpu_torch import (Chebyshev, blockvec_sharding, lobpcg,
                                   make_mesh, shard_operator,
                                   spectral_bounds)
    from raleigh_tpu_torch.examples.laplace import lap3d_eigenvalues
    a = lap3d(12, 12, 12, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(12, 12, 12, 1.0, 1.0, 1.0))[:5]
    _, hi = spectral_bounds(a)
    mesh = make_mesh(8)
    dm = shard_operator(DiaMatrix(a), mesh)
    pre = Chebyshev(a, hi * 1e-4, hi, degree=10, device_matrix=dm) \
        .device_rows_operands(16)
    before = (sw.LAUNCHES['mesh_float32'], sw.LAUNCHES['float32'],
              st.LAUNCHES['copy_lanes'])
    lam, x, _, _, status = lobpcg(dm, 5, precond=pre, tol=1e-5,
                                  sharding=blockvec_sharding(mesh))
    assert status == 0 and x.shape == (a.shape[0], 5)
    assert np.abs(lam - exact).max() / exact[-1] < 1e-4
    assert sw.LAUNCHES['mesh_float32'] > before[0]
    assert sw.LAUNCHES['float32'] == before[1]
    assert st.LAUNCHES['copy_lanes'] == before[2]


def test_core_solver_on_the_card(cuda):
    """partial_hevp on the core Solver with no device argument: shift-invert
    and the product problem (dense_torch blocks on the card, the LDL^T on
    the host) and engine='core' with a Chebyshev, whose recurrence and A's
    apply run the f64 DIA kernel (f32 and f64 values)."""
    import scipy.sparse as scs
    from raleigh_tpu_torch import Chebyshev, partial_hevp, spectral_bounds
    from raleigh_tpu_torch.algebra import dense_torch
    from raleigh_tpu_torch.examples.laplace import lap3d_eigenvalues
    a = lap3d(10, 10, 12, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(10, 10, 12, 1.0, 1.0, 1.0))[:4]
    dense_torch.reset_counts()
    lmd, x, status = partial_hevp(a, sigma=0, which=4, tol=1e-6, verb=-1)
    assert status == 0 and np.allclose(lmd[:4], exact, rtol=1e-6)
    assert dense_torch.COUNTS['to_device'] > 0
    b = scs.diags(np.linspace(1.0, 2.0, a.shape[0]), format='csr')
    lmd, x, status = partial_hevp(a, B=b, sigma=0, which=4, tol=1e-6,
                                  verb=-1)
    assert status == 0 and x.dtype == np.float64
    before = dict(sw.LAUNCHES)
    T = Chebyshev(a, *spectral_bounds(a), degree=8)
    lmd, x, status = partial_hevp(a, T=T, which=4, tol=1e-6, verb=-1,
                                  engine='core')
    assert status == 0 and np.allclose(lmd[:4], exact, rtol=1e-6)
    for key in ('float64_val32', 'float64_val64'):
        assert sw.LAUNCHES[key] > before[key], key


# ---- the dense SVD/PCA engines on the card against the port on the CPU --

def _svd_data(m=600, n=400, rank=200, pca=True, dtype=np.float64):
    from raleigh_tpu_torch.examples.generate_matrix import generate
    np.random.seed(1)
    return generate(m, n, rank, dtype=dtype, pca=pca)[0]


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_subspace_engines_on_the_card_match_cpu(cuda, dtype):
    """subspace_pca, subspace_pca_tol and randomized_svd from one starting
    block on the card and on the CPU: the same factors (1e-10 relative in
    f64, 1e-3 in f32, where cuBLAS's and the CPU's f32 summation orders
    move the trailing components), the same rank."""
    from raleigh_tpu_torch.interfaces import randomized as rz
    a = _svd_data(pca=False, dtype=dtype)
    tol = 1e-10 if dtype == np.float64 else 1e-3
    at = torch.from_numpy(a)
    q = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (a.shape[0], 40)).astype(dtype))
    out = [rz._subspace_pca_gram(at.to(dev), q.to(dev), 20, 6)
           for dev in ('cpu', cuda)]
    (cm, ct, cc, cs), (gm, gt, gc, gs) = [[t.cpu().numpy() for t in o]
                                          for o in out]
    assert np.abs(gs - cs).max() <= tol * cs[0]
    assert np.abs(gt @ gc - ct @ cc).max() <= tol * np.abs(ct @ cc).max()
    # the public engines on the card: quality against the host SVD
    mean, trans, comps = rz.subspace_pca(a, 20)
    assert isinstance(comps, np.ndarray) and comps.shape == (20, 400)
    s = np.linalg.svd(a - a.mean(axis=0), compute_uv=False)
    ef = np.linalg.norm((a - mean) - trans @ comps) / np.linalg.norm(
        a - mean)
    assert ef <= 1.02 * np.sqrt(np.sum(s[20:] ** 2) / np.sum(s ** 2))
    k_card = rz.subspace_pca_tol(a, 0.1)[2].shape[0]
    k_cpu = rz.subspace_pca_tol(a, 0.1, device='cpu')[2].shape[0]
    assert abs(k_card - k_cpu) <= 2, (k_card, k_cpu)
    u, sig, vt = rz.randomized_svd(a, 10)
    sv = np.linalg.svd(a, compute_uv=False)
    assert np.abs(sig - sv[:10]).max() <= 1e-3 * sv[0]


@pytest.mark.parametrize('method', ['jacobi', 'subspace'])
def test_pca_on_the_card_matches_cpu(cuda, method):
    """pca with no device argument runs on the card and agrees with the
    same call on the CPU in f64: the device Jacobi engine to 1e-10 in
    sigma (the column norms of L) from one NumPy seed, the subspace
    engine by its truncation error."""
    from raleigh_tpu_torch import pca, pca_error
    a = _svd_data(300, 200, 100)
    out = []
    for kw in ({}, {'device': 'cpu'}):
        np.random.seed(2)
        out.append(pca(a, npc=15, method=method, **kw))
    (gm, gl, gr), (cm, cl, cr) = out
    assert gr.shape == cr.shape == (15, 200)
    if method == 'jacobi':
        sg, sc = np.linalg.norm(gl, axis=0), np.linalg.norm(cl, axis=0)
        assert np.abs(sg - sc).max() <= 1e-10 * sc.max()
    eg, ec = pca_error(a, gm, gl, gr), pca_error(a, cm, cl, cr)
    assert eg[1] <= 1.01 * ec[1], (eg, ec)


def test_truncated_svd_and_jacobi_hevp_on_the_card(cuda):
    """truncated_svd on the card against the host SVD, and
    partial_hevp(engine='jacobi') on lap3d launching the DIA kernel and
    no plain version."""
    from raleigh_tpu_torch import Chebyshev, partial_hevp, spectral_bounds
    from raleigh_tpu_torch import truncated_svd
    from raleigh_tpu_torch.examples.laplace import lap3d_eigenvalues
    a = _svd_data(600, 400, 200, pca=False)
    u, sig, vt = truncated_svd(a, nsv=20)
    sv = np.linalg.svd(a, compute_uv=False)
    assert np.abs(sig[:20] - sv[:20]).max() <= 1e-6 * sv[0]
    lap = lap3d(12, 12, 12, 1.0, 1.0, 1.0)
    ch = Chebyshev(lap, *spectral_bounds(lap), degree=8)
    sw.reset_launches()
    plain = sw.dia_matmat_rows_plain
    sw.dia_matmat_rows_plain = None      # any plain call would fail
    try:
        lmd, x, st_ = partial_hevp(lap, T=ch, which=4, tol=1e-6,
                                   engine='jacobi', verb=-1)
    finally:
        sw.dia_matmat_rows_plain = plain
    exact = np.sort(lap3d_eigenvalues(12, 12, 12, 1.0, 1.0, 1.0))[:4]
    assert st_ == 0 and np.allclose(lmd[:4], exact, rtol=1e-6)
    assert sum(sw.LAUNCHES.values()) > 0


# ---- K4 in f64, the complex routes, the sharded core Solver -------------

@pytest.mark.parametrize('values', [torch.float32, torch.float64])
@pytest.mark.parametrize('shape,shards', [((8, 8, 16), 8), ((5, 7, 9), 3),
                                          ((30, 30, 31), 2), ((6, 6, 6), 8),
                                          ((8, 8, 16), 20)])
def test_mesh_f64_kernel_equals_plain_and_the_unsharded(cuda, shape, shards,
                                                        values):
    """The mesh kernel's f64 instantiations (an f64 operand, f32 or f64
    values): one launch per table, equal bit for bit to the plain version
    over the piece table (products and sums in its order) and to the
    unsharded f64 kernel."""
    from raleigh_tpu_torch import make_mesh, shard_operator
    from raleigh_tpu_torch.parallel.mesh import ShardedRows, blockvec_sharding
    a = lap3d(*shape, 1.0, 1.0, 1.0)
    vdt = np.float64 if values == torch.float64 else np.float32
    dm = DiaMatrix(a, dtype=vdt, exact=True)
    sharded = shard_operator(DiaMatrix(a, dtype=vdt, exact=True),
                             make_mesh(shards))
    g = torch.Generator(cuda).manual_seed(8)
    x = torch.randn((9, dm.shape[0]), generator=g, device=cuda,
                    dtype=torch.float64)
    xs = ShardedRows.split(x, sharded.val.sharding)
    plan = sharded._mesh_plan(sharded.val.sharding)
    key = 'mesh_float64_val%d' % (64 if values == torch.float64 else 32)
    before = dict(sw.LAUNCHES)
    y = sharded.matmat_rows(xs)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in sw.LAUNCHES.items()
             if v != before[k]}
    assert moved == {key: len(plan.launches)}
    assert y.dtype == torch.float64
    want = sw.dia_matmat_rows_mesh_plain(sharded.val.parts, xs.parts, plan)
    assert torch.equal(y.gather(), torch.cat(want, dim=1))
    assert torch.equal(y.gather(), dm.matmat_rows(x))


@pytest.mark.parametrize('values', [torch.float32, torch.float64])
def test_ext_f64_kernel_matches_plain(cuda, values):
    """The one-piece entry's f64 instantiations over a ring-extended
    operand: equal to its plain version and to the unsharded f64 kernel."""
    dm, x, x_ext, lo = _ext_case(cuda, (5, 7, 9), 12, torch.float64)
    val = dm.val.to(values)
    n = dm.shape[0]
    key = 'ext_float64_val%d' % (64 if values == torch.float64 else 32)
    before = sw.LAUNCHES[key]
    y = sw.dia_matmat_rows_ext(val, x_ext, dm.offsets_t, lo, n)
    want = sw.dia_matmat_rows_ext_plain(val, x_ext, dm.offsets_t, lo, n)
    torch.cuda.synchronize()
    assert sw.LAUNCHES[key] == before + 1
    assert torch.equal(y, want)
    assert torch.equal(y, sw.dia_matmat_rows(val, x, dm.offsets_t))


def _complex_block(cuda, m, n, dtype, seed):
    g = torch.Generator(cuda).manual_seed(seed)
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    return torch.complex(
        torch.randn((m, n), generator=g, device=cuda, dtype=real),
        torch.randn((m, n), generator=g, device=cuda, dtype=real))


def _hermitian(a, dtype):
    """a's pattern with an imaginary antisymmetric part added."""
    import scipy.sparse as scs
    a = scs.csr_matrix(a, dtype=np.float64)
    up = scs.triu(a, k=1).tocoo()
    im = scs.csr_matrix((np.random.RandomState(3).standard_normal(up.nnz),
                         (up.row, up.col)), shape=a.shape)
    return (a + 1j * (im - im.T)).astype(dtype)


@pytest.mark.parametrize('xdt,vdt,key,launches', [
    (torch.complex128, np.float64, 'complex128_val64', 1),
    (torch.complex128, np.float32, 'complex128_val32', 1),
    (torch.complex128, np.complex128, 'complex128_val128', 1),
    (torch.float64, np.complex128, 'complex_float64_val64', 2),
    (torch.complex64, np.float32, 'complex_float32', 1),
    (torch.complex64, np.complex64, 'complex_float32', 2)])
def test_complex_dia_route_matches_plain(cuda, xdt, vdt, key, launches):
    """A c128 operand through the kernel's complex instantiation (one
    launch, under its value type's key); other complex blocks through the
    stacked route, a complex operand as one real block of its real and
    imaginary rows (one launch), complex values as two launches, counted
    under the complex keys: within 1e-14 (c128) or 1e-6 (c64) of the
    largest |entry| of the plain version on the complex tensors."""
    a = lap3d(8, 9, 10, 1.0, 1.0, 1.0)
    if np.dtype(vdt).kind == 'c':
        a = _hermitian(a, vdt)
    dm = DiaMatrix(a, dtype=vdt, device=cuda, exact=True)
    n = dm.shape[0]
    x = (_complex_block(cuda, 7, n, xdt, 4) if xdt.is_complex
         else torch.randn((7, n), device=cuda, dtype=xdt))
    before = dict(sw.LAUNCHES)
    y = sw.dia_matmat_rows(dm.val, x, dm.offsets_t)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in sw.LAUNCHES.items()
             if v != before[k]}
    assert moved == {key: launches}
    want = sw.dia_matmat_rows_plain(dm.val, x, dm.offsets_t)
    assert y.dtype == want.dtype and y.is_complex()
    tol = 1e-14 if y.dtype == torch.complex128 else 1e-6
    assert (y - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize('values', [np.float64, np.complex128])
def test_complex_mesh_route_matches_plain(cuda, values):
    """A c128 block on a DIA matrix split over 8 shards of the card: the
    mesh kernel's f64 instantiation over the stacked rows, one launch per
    device (two for complex values), counted under the mesh_complex keys."""
    from raleigh_tpu_torch import make_mesh, shard_operator
    from raleigh_tpu_torch.parallel.mesh import ShardedRows
    a = lap3d(8, 8, 16, 1.0, 1.0, 1.0)
    if np.dtype(values).kind == 'c':
        a = _hermitian(a, values)
    whole = DiaMatrix(a, dtype=values, device=cuda, exact=True)
    sharded = shard_operator(DiaMatrix(a, dtype=values, exact=True),
                             make_mesh(8))
    x = _complex_block(cuda, 5, whole.shape[0], torch.complex128, 9)
    before = dict(sw.LAUNCHES)
    y = sharded.matmat_rows(ShardedRows.split(x, sharded.val.sharding))
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in sw.LAUNCHES.items()
             if v != before[k]}
    assert moved == {'mesh_complex_float64_val64':
                     2 if np.dtype(values).kind == 'c' else 1}
    want = sw.dia_matmat_rows_plain(whole.val, x, whole.offsets_t)
    assert (y.gather() - want).abs().max() <= 1e-14 * want.abs().max()


@pytest.mark.parametrize('tiles,xdt,launches', [
    (np.float32, torch.complex128, 1), (np.float64, torch.complex128, 1),
    (np.complex128, torch.complex128, 2), (np.float32, torch.complex64, 1)])
def test_complex_bsr_route_matches_plain(cuda, tiles, xdt, launches):
    """K5 on a complex operand (stacked rows, one launch) or complex tiles
    (two launches), counted under (tiles, operand, 'complex'): within
    1e-13 (c128) or 1e-5 (c64) of the largest |entry| of the plain
    version."""
    k = fe_pencil(9, 3, 0.1, seed=2, which='k')
    if np.dtype(tiles).kind == 'c':
        k = _hermitian(k, tiles)
    n = k.shape[0]
    bm = BsrMatrix(k, dtype=tiles, bs=64, device=cuda, exact=True)
    x = _complex_block(cuda, 6, n, xdt, 5)
    args = (bm.blocks, bm.block_indptr_t, bm.block_cols)
    real = 'f64' if xdt == torch.complex128 else 'f32'
    part = 'f32' if tiles == np.float32 else 'f64'
    key = (part, real, 'complex') if real == 'f64' else ('f32', 'f32',
                                                         'complex')
    before = dict(sp.LAUNCHES)
    y = sp.bsr_matmat_rows(*args, x, n)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in sp.LAUNCHES.items()
             if v != before[k]}
    assert moved == {key: launches}
    want = sp.bsr_matmat_rows_plain(*args, x, n)
    tol = 1e-13 if xdt == torch.complex128 else 1e-5
    assert (y - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize('two_d', [False, True])
def test_sharded_core_solver_on_the_card(cuda, two_d):
    """The core Solver on f64 dense_torch blocks split over 8 shards of the
    card, lap3d 12^3 with its DIA operator and Chebyshev split by
    shard_operator: the f64 mesh kernel for both value types and no other
    DIA kernel; the unsharded run's eigenvalues within 1e-10 and the
    analytic ones within 1e-6."""
    from raleigh_tpu_torch import Chebyshev, spectral_bounds
    from raleigh_tpu_torch.algebra import dense_torch
    from raleigh_tpu_torch.algebra.sparse import SparseSymmetricMatrix
    from raleigh_tpu_torch.core.device_solver import shard_operator
    from raleigh_tpu_torch.core.solver import (DefaultConvergenceCriteria,
                                               Options, Problem, Solver)
    from raleigh_tpu_torch.examples.laplace import lap3d_eigenvalues
    from raleigh_tpu_torch.parallel.mesh import (blockvec_sharding,
                                                 make_mesh, make_mesh2d)
    a = lap3d(12, 12, 12, 1.0, 1.0, 1.0)
    lo, hi = spectral_bounds(a)
    mesh = make_mesh2d(2, 4) if two_d else make_mesh(8)
    runs = []
    for sh in (blockvec_sharding(mesh), None):
        op = SparseSymmetricMatrix(a, exact=True)
        ch = Chebyshev(a, lo, hi, degree=10)
        if sh is not None:
            shard_operator(op.device_matrix(), mesh, axis=mesh.axis_names)
            shard_operator(ch.device_matrix(), mesh, axis=mesh.axis_names)
        np.random.seed(2)
        v = dense_torch.Vectors(a.shape[0], 0, np.float64, sharding=sh)
        solver = Solver(Problem(v, op))
        solver.set_preconditioner(ch)
        opt = Options()
        opt.convergence_criteria = DefaultConvergenceCriteria()
        opt.convergence_criteria.set_error_tolerance('k eigenvector error',
                                                     1e-6)
        before = dict(sw.LAUNCHES)
        assert solver.solve(v, opt, which=(4, 0)) == 0
        moved = {k for k, c in sw.LAUNCHES.items() if c != before[k]}
        runs.append((np.sort(solver.eigenvalues)[:4], solver.iteration,
                     moved))
    (lmd, its, moved), (lmd1, its1, moved1) = runs
    assert moved == {'mesh_float64_val32', 'mesh_float64_val64'}
    assert moved1 == {'float64_val32', 'float64_val64'}
    assert its == its1 and np.abs(lmd - lmd1).max() <= 1e-10 * lmd1.max()
    exact = np.sort(lap3d_eigenvalues(12, 12, 12, 1.0, 1.0, 1.0))[:4]
    assert np.allclose(lmd, exact, rtol=1e-6)


def test_complex_generalized_shift_invert_on_the_card(cuda):
    """The complex chain with B = I + 0.25 H on the card (B's c128 DIA
    values through the DIA kernel's complex instantiation, and none
    through the stacked route) against the host algebra: within 1e-8."""
    import scipy.sparse as scs
    from raleigh_tpu_torch import Options, partial_hevp
    n = 2000
    d = 1j * np.ones(n - 1)
    hop = scs.csr_matrix(scs.diags(d, 1) - scs.diags(d, -1))
    a = scs.csr_matrix(hop + scs.diags(np.linspace(0, 1, n)))
    b = scs.csr_matrix(scs.eye(n) + 0.25 * hop)
    opt = Options()
    opt.orchestration = 'device'
    before = dict(sw.LAUNCHES)
    lmd, x, status = partial_hevp(a, B=b, sigma=0.3, which=4, tol=1e-6,
                                  verb=-1, opt=opt)
    assert sw.LAUNCHES['complex128_val128'] > before['complex128_val128']
    assert sw.LAUNCHES['complex_float64_val64'] == \
        before['complex_float64_val64']
    hl, hx, hs = partial_hevp(a, B=b, sigma=0.3, which=4, tol=1e-6,
                              verb=-1, arch='cpu')
    assert status == hs == 0 and x.dtype == np.complex128
    near = np.sort(lmd[np.argsort(np.abs(lmd - 0.3))[:4]])
    hnear = np.sort(hl[np.argsort(np.abs(hl - 0.3))[:4]])
    assert np.abs(near - hnear).max() <= 1e-8 * np.abs(hnear).max()
