"""Device SpMM: symmetric sparse matrix times a block of row-vectors.

PyTorch port of ``raleigh_tpu/ops/spmm.py``, DIA layout only: values are
stored per populated diagonal, and the product is a sum of shifted
multiply-adds with no gathers — the layout of stencil and banded matrices.
Operands are (m, n) blocks with vectors as rows.  On CUDA every row apply
goes through the hand-written kernel (``ops/spmm_window.py``) at every
size; on the CPU through its plain PyTorch version.

Left out, because they exist only for the TPU: the per-shape kernel
caches and their shard fingerprints, the window/fused-XLA routing and its
Mosaic alignment limits, ``window_padded_fn`` (the kernel takes unaligned
n), and the mesh-sharded apply (``_multi_device``, ``sharded_rows_fn``),
which returns with ``torch.distributed`` (ROADMAP queue 1, item 13).  The
ELL and BSR layouts follow with ROADMAP queue 1, item 11.
"""

import numpy as np
import torch

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
    ``device`` for the kernel."""

    # Working set above which the Chebyshev recurrence streams its
    # iterates in bf16 (algebra/sparse.py, auto rule).  The value is the
    # TPU v5e's VMEM switch, kept as it was; it waits to be measured
    # again on the H100 (ROADMAP queue 1, item 4).  It no longer routes
    # the SpMM itself: the CUDA kernel serves every size.
    WINDOW_HBM_BYTES = 112 * 2 ** 20

    def __init__(self, a, dtype=np.float32, device='cpu'):
        csr = _to_full_csr(a)
        rows, offsets, k = _diagonals(csr)
        self._init(offsets, _dia_values(csr, rows, offsets, k, dtype),
                   device)

    @classmethod
    def from_arrays(cls, offsets, val, device='cpu'):
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
        self.device = torch.device(device)
        self.val = torch.as_tensor(val, dtype=canonical_dtype(val.dtype),
                                   device=self.device).contiguous()
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


def rows_matmat_operands(dm):
    """(fn, operands) for a device sparse matrix: ``fn(operands, x)``
    applies A to an (m, n) row block."""
    if isinstance(dm, DiaMatrix):
        return dm.rows_operand_form()
    raise TypeError('unsupported device matrix %r' % type(dm).__name__)


def device_sparse(a, dtype=np.float32, device='cpu'):
    """Device layout for the symmetric sparse matrix ``a``: DIA when the
    pattern collapses onto few populated diagonals (stencils, banded
    matrices).  Other patterns need ELL or BSR, which are not ported yet
    (ROADMAP queue 1, item 11)."""
    return _device_layout(_to_full_csr(a), dtype, device)


def _device_layout(csr, dtype, device):
    """``device_sparse`` of a matrix already in full canonical CSR."""
    n = csr.shape[0]
    if n > 1:
        rows, offsets, k = _diagonals(csr)
        noff = len(offsets)
        if noff <= DIA_MAX_OFFSETS and noff * n <= DIA_MAX_WASTE * csr.nnz:
            val = _dia_values(csr, rows, offsets, k, dtype)
            return DiaMatrix.from_arrays(offsets, val, device)
    raise NotImplementedError(
        'this sparsity pattern needs the ELL or BSR layout, which the '
        'PyTorch port does not have yet (ROADMAP queue 1, item 11)')
