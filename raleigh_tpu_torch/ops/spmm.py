"""Device SpMM: symmetric sparse matrix times a block of row-vectors.

PyTorch port of ``raleigh_tpu/ops/spmm.py``, three layouts:

  * ``DiaMatrix``  values per populated diagonal, a sum of shifted
    multiply-adds with no gathers — stencil and banded matrices;
  * ``EllMatrix``  rows padded to the largest degree (ELLPACK), one gather
    and one multiply-add per padded column — scattered patterns;
  * ``BsrMatrix``  the nonempty (bs x bs) tiles, dense — patterns with
    block locality (finite-element matrices in the mesher's order).

``device_sparse`` picks one by the JAX package's rule.  Every layout is
built on the card unless ``device`` names another, and raises when there
is no card.  Operands are (m, n) blocks with vectors as rows.  On CUDA every DIA and BSR row apply
goes through its hand-written kernel (``ops/spmm_window.py``,
``ops/spmm_pallas.py``) at every size, and on the CPU through the
kernel's plain PyTorch version.  The ELL apply is plain PyTorch on either
device, as it is plain XLA code in the JAX package.

Left out, because they exist only for the TPU: the per-shape kernel
caches and their shard fingerprints, the window/fused-XLA routing and its
Mosaic alignment limits, ``window_padded_fn`` (the kernel takes unaligned
n), and the mesh-sharded apply (``_multi_device``, ``sharded_rows_fn``),
which returns with ``torch.distributed`` (ROADMAP queue 1, item 13).
"""

import numpy as np
import torch

from .spmm_pallas import bsr_matmat_rows
from .spmm_window import dia_matmat_rows


def torch_dtype(dtype):
    """torch dtype of a torch, numpy or Python dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def canonical_dtype(dtype):
    """Storage dtype of device values: float64 only while it is torch's
    default dtype, else float32 — as ``jnp.asarray`` keeps f64 only when
    ``jax_enable_x64`` is on."""
    dt = torch_dtype(dtype)
    if dt == torch.float64 and torch.get_default_dtype() != torch.float64:
        return torch.float32
    return dt


def storage_device(device=None):
    """The torch.device a device matrix lives on: the card unless
    ``device`` names another (``'cpu'``, as the CPU tests do).  CUDA with
    no card raises: nothing falls back to the CPU."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('%s was asked for, but torch finds no CUDA '
                           "device (pass device=None to stay on the host)"
                           % device)
    return device


def _to_full_csr(a):
    """scipy sparse (any symmetric storage) -> full-row canonical CSR."""
    import scipy.sparse as scs
    a = scs.csr_matrix(a)
    # symmetrize from whichever triangle(s) are present
    au = scs.triu(a, k=1)
    al = scs.tril(a, k=-1)
    if au.nnz == 0 and al.nnz > 0:
        a = a + al.T
    elif al.nnz == 0 and au.nnz > 0:
        a = a + au.T
    a = scs.csr_matrix(a)
    a.sum_duplicates()
    a.sort_indices()
    return a


# DIA is chosen for at most this many populated diagonals, storing at most
# this many values (noff * n) per nonzero
DIA_MAX_OFFSETS = 96
DIA_MAX_WASTE = 3.0


def _diagonals(csr):
    """(rows, offsets, k) of a full CSR matrix: each stored entry's row,
    the sorted offsets of the populated diagonals, and each entry's
    diagonal as an index into ``offsets``."""
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    offsets, k = np.unique(csr.indices - rows, return_inverse=True)
    return rows, offsets, k.reshape(-1)


def _dia_values(csr, rows, offsets, k, dtype):
    """DIA values in the row convention val[k, i] = A[i, i + offsets[k]]."""
    val = np.zeros((len(offsets), csr.shape[0]), dtype=dtype)
    val[k, rows] = csr.data
    return val


class DiaMatrix:
    """Diagonal (DIA) device storage.  ``val[k, i]`` holds
    A[i, i + offsets[k]] (row-major diagonal convention); ``offsets`` is a
    tuple of ints, ``offsets_t`` the same offsets as an int32 tensor on
    ``device`` for the kernel; ``dtype`` is the values' storage dtype, as
    on the other layouts."""

    # Working set above which the Chebyshev recurrence streams its
    # iterates in bf16 (algebra/sparse.py, auto rule).  The value is the
    # TPU v5e's VMEM switch, kept as it was; it waits to be measured
    # again on the H100 (ROADMAP queue 1, item 4).  It no longer routes
    # the SpMM itself: the CUDA kernel serves every size.
    WINDOW_HBM_BYTES = 112 * 2 ** 20

    def __init__(self, a, dtype=np.float32, device=None):
        csr = _to_full_csr(a)
        rows, offsets, k = _diagonals(csr)
        self._init(offsets, _dia_values(csr, rows, offsets, k, dtype),
                   device)

    @classmethod
    def from_arrays(cls, offsets, val, device=None):
        """The port's matrix from another DIA matrix's arrays, e.g. the
        ``offsets`` and ``np.asarray(val)`` of a ``raleigh_tpu``
        ``DiaMatrix``."""
        self = cls.__new__(cls)
        # torch takes no read-only array (jax hands those out): copy one
        self._init(offsets, np.require(val, requirements='W'), device)
        return self

    def _init(self, offsets, val, device):
        n = val.shape[1]
        self.shape = (n, n)
        self.offsets = tuple(int(o) for o in offsets)
        self.device = storage_device(device)
        self.val = torch.as_tensor(val, dtype=canonical_dtype(val.dtype),
                                   device=self.device).contiguous()
        self.dtype = self.val.dtype
        self.offsets_t = torch.tensor(self.offsets, dtype=torch.int32,
                                      device=self.device)

    def matmat_rows(self, x):
        """(m, n) = ((m, n) @ A) for a row-vector block, in x's dtype (A
        symmetric, so x A = (A xᵀ)ᵀ)."""
        return dia_matmat_rows(self.val, x, self.offsets_t)

    def matmat_t(self, xt):
        """(n, m) = A @ (n, m)."""
        return self.matmat_rows(xt.T.contiguous()).T

    def rows_operand_form(self):
        """(fn, operands) form of ``matmat_rows``: ``fn(operands, x)``
        applies A to a row block of any shape and dtype.  The JAX package
        picks a kernel by block shape and dtype here; one kernel serves
        them all."""
        def fn(ops, x):
            return dia_matmat_rows(ops[0], x, ops[1])
        return fn, (self.val, self.offsets_t)


def _values(values, dtype, device):
    """Values (an array or a tensor) as a contiguous device tensor of
    ``dtype`` (default: the canonical dtype of the values).  torch takes
    no read-only array (jax hands those out): copy one."""
    if not isinstance(values, torch.Tensor):
        values = np.require(values, requirements='W')
    dt = canonical_dtype(values.dtype if dtype is None else dtype)
    return torch.as_tensor(values, device=device).to(dt).contiguous()


def _int32(index, device):
    return torch.as_tensor(np.array(index, dtype=np.int32), device=device)


class EllMatrix:
    """Padded-row (ELLPACK) device storage of a symmetric sparse matrix:
    ``idx[i, k]`` and ``val[i, k]`` hold the column and value of row i's
    k-th entry, rows padded with (column 0, value 0) to ``row_degree``, the
    largest degree rounded up to a multiple of ``pad_to``."""

    def __init__(self, a, dtype=np.float32, pad_to=8, device=None):
        a = _to_full_csr(a)
        n = a.shape[0]
        deg = np.diff(a.indptr)
        k = int(deg.max()) if n else 0
        k = max(1, ((k + pad_to - 1) // pad_to) * pad_to)
        idx = np.zeros((n, k), dtype=np.int32)
        val = np.zeros((n, k), dtype=dtype)
        # vectorized fill of the padded structure
        rows = np.repeat(np.arange(n), deg)
        offs = np.arange(a.nnz) - np.repeat(a.indptr[:-1], deg)
        idx[rows, offs] = a.indices
        val[rows, offs] = a.data.astype(dtype)
        self._init(idx, val, int(a.nnz), device)

    @classmethod
    def from_arrays(cls, idx, val, nnz=None, device=None):
        """The port's matrix from another ELL matrix's arrays, e.g. the
        ``np.asarray`` of a ``raleigh_tpu`` ``EllMatrix``'s ``idx`` and
        ``val``."""
        self = cls.__new__(cls)
        self._init(idx, val, nnz, device)
        return self

    def _init(self, idx, val, nnz, device):
        n, k = val.shape
        self.shape = (n, n)
        self.row_degree = k
        self.device = storage_device(device)
        self.idx = _int32(idx, self.device).contiguous()
        self.val = _values(val, None, self.device)
        self.nnz = int(torch.count_nonzero(self.val)) if nnz is None else nnz
        self.dtype = self.val.dtype

    def matmat_t(self, xt):
        """(n, m) = A @ (n, m): operand and result transposed blocks."""
        return _ell_matmat(self.idx, self.val, xt)

    def matmat_rows(self, x):
        """(m, n) = ((m, n) @ A) for a row-vector block, in x's dtype."""
        return _ell_matmat(self.idx, self.val, x.T).T.contiguous()


def _ell_matmat(idx, val, xt):
    """y[i, :] = sum_k val[i, k] * xt[idx[i, k], :] by a loop over the
    padded-column axis: one gather and one multiply-add per step keep peak
    memory at one (n, m) temporary instead of an (n, K, m) cube.
    Accumulates in the promoted type of val and xt, returns xt's dtype."""
    n, k = idx.shape
    acc = torch.zeros((n, xt.shape[1]), device=xt.device,
                      dtype=torch.promote_types(val.dtype, xt.dtype))
    xt = xt.contiguous()
    for j in range(k):
        acc.addcmul_(val[:, j, None], xt.index_select(0, idx[:, j]))
    return acc.to(xt.dtype)


class BsrMatrix:
    """Block-sparse (dense tile) device storage: the nonempty (bs x bs)
    tiles ``blocks`` in block-CSR order, tile t in block row
    ``block_rows[t]`` and block column ``block_cols[t]``, block row i
    holding tiles ``block_indptr[i]:block_indptr[i + 1]``.  ``dtype`` may
    be ``torch.bfloat16``: half the tile bytes, sums still in f32.

    ``block_indptr`` is a host array as in the JAX package;
    ``block_indptr_t`` is the same as an int32 tensor on ``device`` for the
    kernel."""

    def __init__(self, a, dtype=np.float32, bs=128, device=None):
        import scipy.sparse as scs
        a = _to_full_csr(a)
        n = a.shape[0]
        nb = -(-n // bs)
        store = torch_dtype(dtype)
        # tiles are cut from a matrix already in the host type nearest the
        # storage type, so no (nblocks, bs, bs) f64 copy is ever made
        a = a.astype(np.float64 if store == torch.float64 else np.float32)
        # pad to whole tiles: empty rows below, empty columns to the right
        indptr = np.concatenate(
            [a.indptr, np.full(nb * bs - n, a.indptr[-1], a.indptr.dtype)])
        ab = scs.csr_matrix((a.data, a.indices, indptr),
                            shape=(nb * bs, nb * bs)).tobsr((bs, bs))
        ab.sort_indices()
        self._init(ab.data, ab.indices, ab.indptr, n, int(a.nnz), store,
                   device)

    @classmethod
    def from_arrays(cls, blocks, block_cols, block_indptr, n, nnz=None,
                    device=None):
        """The port's matrix from another BSR matrix's arrays, e.g. the
        ``np.asarray`` of a ``raleigh_tpu`` ``BsrMatrix``'s ``blocks`` and
        ``block_cols`` with its ``block_indptr`` and ``shape[0]``."""
        self = cls.__new__(cls)
        self._init(blocks, block_cols, block_indptr, n, nnz, None, device)
        return self

    def _init(self, blocks, block_cols, block_indptr, n, nnz, dtype, device):
        bs = blocks.shape[1]
        nb = len(block_indptr) - 1
        self.shape = (n, n)
        self.n_padded = nb * bs
        self.bs = bs
        self.nb = nb
        self.device = storage_device(device)
        self.block_indptr = np.asarray(block_indptr)
        self.block_indptr_t = _int32(block_indptr, self.device)
        self.block_cols = _int32(block_cols, self.device)
        self.block_rows = _int32(np.repeat(np.arange(nb),
                                           np.diff(self.block_indptr)),
                                 self.device)
        self.blocks = _values(blocks, dtype, self.device)
        self.nnz = (int(torch.count_nonzero(self.blocks)) if nnz is None
                    else nnz)
        self.dtype = self.blocks.dtype

    def matmat_rows(self, x):
        """(m, n) = ((m, n) @ A) for a row-vector block, in x's dtype: the
        CUDA kernel on a CUDA tensor, its plain version on the CPU."""
        return bsr_matmat_rows(self.blocks, self.block_indptr_t,
                               self.block_cols, x.contiguous(),
                               self.shape[0])

    def matmat_t(self, xt):
        """(n, m) = A @ (n, m)."""
        return self.matmat_rows(xt.T).T


def rows_matmat_operands(dm):
    """(fn, operands) for a device sparse matrix: ``fn(operands, x)``
    applies A to an (m, n) row block."""
    if isinstance(dm, DiaMatrix):
        return dm.rows_operand_form()
    if isinstance(dm, EllMatrix):
        def fn(ops, x):
            return _ell_matmat(ops[0], ops[1], x.T).T.contiguous()
        return fn, (dm.idx, dm.val)
    if isinstance(dm, BsrMatrix):
        n = dm.shape[0]

        def fn(ops, x):
            return bsr_matmat_rows(ops[0], ops[1], ops[2], x.contiguous(), n)
        return fn, (dm.blocks, dm.block_indptr_t, dm.block_cols)
    raise TypeError('unsupported device matrix %r' % type(dm).__name__)


# The constants of the ELL/BSR choice below are the JAX package's, kept as
# they are so that both packages give a matrix the same layout; they are
# not measured on this card yet (ROADMAP queue 1, item 11).
BSR_MIN_FILL_WIDTH = 8.0        # fill * min(block width, 128) from which BSR
BSR_RESIDENT_BYTES = 64 * 2 ** 20   # operand block size of the second test
BSR_TILE_STREAM_RATE = 350e9    # bytes/s of tiles, BSR apply estimate
ELL_GATHER_RATE = 0.03e9        # nonzeros/s, ELL apply estimate
ELL_MAX_PADDING = 16            # padded ELL entries per nonzero


def device_sparse(a, dtype=np.float32, block_width_hint=32, bs=128,
                  device=None):
    """Choose a device layout for the symmetric sparse matrix ``a``: DIA
    when the pattern collapses onto few populated diagonals (stencils,
    banded matrices — no gathers at all), BSR when tile fill times block
    width is high enough, or when the operand block is large and the
    estimated tile-stream time beats the estimated gather time, or when a
    few hub rows would inflate ELL's padding; ELL otherwise."""
    return _device_layout(_to_full_csr(a), dtype, device, block_width_hint,
                          bs)


def _device_layout(csr, dtype, device, block_width_hint=32, bs=128):
    """``device_sparse`` of a matrix already in full canonical CSR."""
    n = csr.shape[0]
    if n > 1:
        rows, offsets, k = _diagonals(csr)
        noff = len(offsets)
        if noff <= DIA_MAX_OFFSETS and noff * n <= DIA_MAX_WASTE * csr.nnz:
            val = _dia_values(csr, rows, offsets, k, dtype)
            return DiaMatrix.from_arrays(offsets, val, device)
    if n >= bs:
        # number of nonempty tiles = distinct (row tile, column tile) pairs
        nb = -(-n // bs)
        row_t = np.repeat(np.arange(n) // bs, np.diff(csr.indptr))
        keys = row_t.astype(np.int64) * nb + (csr.indices // bs)
        ntiles = np.unique(keys).size
        fill = csr.nnz / (ntiles * bs * bs)
        if fill * min(block_width_hint, 128) >= BSR_MIN_FILL_WIDTH:
            return BsrMatrix(csr, dtype=dtype, bs=bs, device=device)
        # large operand blocks: compare estimated apply times instead of
        # demanding high fill
        if n * block_width_hint * 4 > BSR_RESIDENT_BYTES:
            bsr_t = ntiles * bs * bs * 4 / BSR_TILE_STREAM_RATE
            ell_t = csr.nnz / ELL_GATHER_RATE
            if bsr_t < ell_t:
                return BsrMatrix(csr, dtype=dtype, bs=bs, device=device)
    # ELL pads every row to the largest degree: a few hub rows (a
    # boundary-condition row coupled to everything, say) would inflate the
    # padded storage K*n arbitrarily — such patterns go to BSR, whose
    # storage is bounded by the nonempty tiles
    deg_max = int(np.diff(csr.indptr).max()) if n else 0
    if (n and deg_max * n > ELL_MAX_PADDING * max(csr.nnz, 1) and n >= bs):
        return BsrMatrix(csr, dtype=dtype, bs=bs, device=device)
    return EllMatrix(csr, dtype=dtype, device=device)
