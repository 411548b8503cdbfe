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
is no card.  Operands are (m, n) blocks with vectors as rows.  On CUDA
every apply goes through a hand-written kernel at every size: DIA and BSR
through ``ops/spmm_window.py`` and ``ops/spmm_pallas.py``, ELL through
``csrc/ell_spmm.cu`` (``_ell_matmat`` below; in the JAX package the ELL
apply is a jitted ``lax.scan``, not a Pallas kernel).  On the CPU each
goes through the kernel's plain PyTorch version.

A DIA or ELL matrix whose values ``core.device_solver.shard_operator``
has split over a mesh (``parallel/mesh.py``: a list of devices, one per
shard, walked by one process) applies to ``ShardedRows`` blocks: DIA
through the mesh kernel, one launch per device that reads each shard's
halo lanes where they lie (``DiaMatrix.sharded_rows_fn``), ELL row block
by row block against the gathered operand, one ELL launch a shard.

Every layout takes complex values and complex operands, as the JAX
package's XLA applies do: on the card a complex block goes through the DIA,
mesh DIA, ELL or BSR kernel as one real block of its real and imaginary
rows, and complex values as two launches (``ops/complex_rows.py``); the
plain versions take complex tensors as they are.

Left out, because they exist only for the TPU: the per-shape kernel
caches and their shard fingerprints, the window/fused-XLA routing and its
Mosaic alignment limits, and ``window_padded_fn`` (the kernels take
unaligned n).
"""

import ctypes

import numpy as np
import torch

from ..parallel.mesh import ShardedRows
from ..utils.profiling import spanned
from . import _build
from .complex_rows import complex_rows, result_dtype
from .spmm_pallas import bsr_matmat_rows
from .spmm_window import DiaMeshPlan, dia_matmat_rows, dia_matmat_rows_mesh


def torch_dtype(dtype):
    """torch dtype of a torch, numpy or Python dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def canonical_dtype(dtype, exact=False):
    """Storage dtype of device values: float64 (complex128) only while
    float64 is torch's default dtype, else float32 (complex64) — as
    ``jnp.asarray`` keeps 64-bit types only when ``jax_enable_x64`` is on.
    ``exact``: the dtype as it is (the core Solver's f64 problems keep f64
    operators)."""
    dt = torch_dtype(dtype)
    narrow = {torch.float64: torch.float32,
              torch.complex128: torch.complex64}
    if (dt in narrow and not exact
            and torch.get_default_dtype() != torch.float64):
        return narrow[dt]
    return dt


def storage_device(device=None):
    """The torch.device a device matrix lives on: the card unless
    ``device`` names another (``'cpu'``, as the CPU tests do).  CUDA with
    no card raises: nothing falls back to the CPU."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('%s was asked for, but torch finds no CUDA '
                           "device (pass device='cpu' to run on the CPU)"
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
    on the other layouts.  After ``core.device_solver.shard_operator``,
    ``val`` is a ``ShardedRows`` of (noff, n_p) tensors, one per shard."""

    # Working set above which the Chebyshev recurrence streams its
    # iterates in bf16 (algebra/sparse.py, auto rule).  The value is the
    # TPU v5e's VMEM switch, kept as it was; it waits to be measured
    # again on the H100 (ROADMAP queue 1, item 4).  It no longer routes
    # the SpMM itself: the CUDA kernel serves every size.
    WINDOW_HBM_BYTES = 112 * 2 ** 20

    def __init__(self, a, dtype=np.float32, device=None, exact=False):
        csr = _to_full_csr(a)
        rows, offsets, k = _diagonals(csr)
        self._init(offsets, _dia_values(csr, rows, offsets, k, dtype),
                   device, exact)

    @classmethod
    def from_arrays(cls, offsets, val, device=None, exact=False):
        """The port's matrix from another DIA matrix's arrays, e.g. the
        ``offsets`` and ``np.asarray(val)`` of a ``raleigh_tpu``
        ``DiaMatrix``; ``exact`` keeps f64 values f64."""
        self = cls.__new__(cls)
        # torch takes no read-only array (jax hands those out): copy one
        self._init(offsets, np.require(val, requirements='W'), device,
                   exact)
        return self

    def _init(self, offsets, val, device, exact=False):
        n = val.shape[1]
        self.shape = (n, n)
        self.offsets = tuple(int(o) for o in offsets)
        self.device = storage_device(device)
        self.val = torch.as_tensor(val,
                                   dtype=canonical_dtype(val.dtype, exact),
                                   device=self.device).contiguous()
        self.dtype = self.val.dtype
        self.offsets_t = torch.tensor(self.offsets, dtype=torch.int32,
                                      device=self.device)
        self._plans = {}

    def _multi_device(self):
        """True when the diagonal values are split over a mesh
        (``core.device_solver.shard_operator``): ``val`` is then a
        ``ShardedRows`` of (noff, n_p) tensors."""
        return isinstance(self.val, ShardedRows)

    def _mesh_plan(self, sharding):
        """The piece table of the mesh apply for values split by
        ``sharding``, built at its first apply and kept."""
        plan = self._plans.get(sharding)
        if plan is None:
            widths = [e - s for s, e in sharding.bounds(self.shape[0])]
            plan = self._plans[sharding] = DiaMeshPlan(
                widths, sharding.devices, self.offsets)
        return plan

    def matmat_rows(self, x):
        """(m, n) = ((m, n) @ A) for a row-vector block, in x's dtype (A
        symmetric, so x A = (A xᵀ)ᵀ).  With values split over a mesh, x is
        a ``ShardedRows`` and so is the result; a plain tensor is split,
        applied and gathered again."""
        if self._multi_device():
            return _dia_sharded_apply(
                self.val, self._mesh_plan(self.val.sharding), x)
        return dia_matmat_rows(self.val, x, self.offsets_t)

    def matmat_t(self, xt):
        """(n, m) = A @ (n, m)."""
        return self.matmat_rows(xt.T.contiguous()).T

    def rows_operand_form(self):
        """(fn, operands) form of ``matmat_rows``: ``fn(operands, x)``
        applies A to a row block of any shape and dtype.  The JAX package
        picks a kernel by block shape and dtype here; one kernel serves
        them all, and a second one the values split over a mesh."""
        if self._multi_device():
            def fn(ops, x):
                return _dia_sharded_apply(
                    ops[0], self._mesh_plan(ops[0].sharding), x)
            return fn, (self.val,)

        def fn(ops, x):
            return dia_matmat_rows(ops[0], x, ops[1])
        return fn, (self.val, self.offsets_t)

    def sharded_rows_fn(self, m, n, dtype=torch.float32):
        """Mesh-partitioned row-layout apply, or None when the values are
        not split over a mesh: ``fn(x)`` takes a ``ShardedRows`` block (m, n)
        of ``dtype`` and returns one.  Each shard computes its lane range
        from its own diagonals and its own lanes extended by its
        neighbours' edge lanes, which the mesh kernel
        (``dia_matmat_rows_mesh``) reads where they lie: one launch per
        device for all of its shards, at every size and in f32 and bf16,
        through a piece table built once per partition
        (``DiaMeshPlan``).  Nothing is copied on one device; lanes on
        another device move by ``Tensor.copy_``.

        The ring of shards wraps at the global boundary; the wrapped lanes
        meet zero out-of-range diagonal values, so no edge cases exist and
        the result equals the unsharded apply.  Shards may be uneven, and a
        reach wider than a shard takes lanes from as many neighbours as it
        spans.  ``fn.operand_fn(val, x)`` is the same apply with the split
        values as an argument.

        The JAX package's ``tile=``, ``interpret=`` and ``force_window=``
        selected between its Pallas kernel and fused XLA code; here one
        kernel serves every shard, so they have nothing left to select and
        are dropped."""
        if not self._multi_device():
            return None
        if n != self.shape[0]:
            raise ValueError('operand has %d lanes, the matrix %d'
                             % (n, self.shape[0]))
        self._mesh_plan(self.val.sharding)

        def operand_fn(val, x):
            return _dia_sharded_apply(val, self._mesh_plan(val.sharding), x)

        def apply(x):
            return operand_fn(self.val, x)
        apply.operand_fn = operand_fn
        return apply


def _dia_sharded_apply(val, plan, x):
    """The DIA apply with values ``val`` split along the lanes, through the
    mesh kernel on the partition's piece table ``plan``.  A plain tensor
    ``x`` is split, applied and gathered again."""
    if isinstance(x, ShardedRows):
        back = x.sharding
        x = x.resplit(val.sharding)
    else:
        back = None
        x = ShardedRows.split(x, val.sharding)
    y = ShardedRows(dia_matmat_rows_mesh(val.parts, x.parts, plan),
                    val.sharding)
    return y.gather() if back is None else y.resplit(back)


def _values(values, dtype, device, exact=False):
    """Values (an array or a tensor) as a contiguous device tensor of
    ``dtype`` (default: the canonical dtype of the values; ``exact`` keeps
    f64 f64).  torch takes no read-only array (jax hands those out): copy
    one."""
    if not isinstance(values, torch.Tensor):
        values = np.require(values, requirements='W')
    dt = canonical_dtype(values.dtype if dtype is None else dtype, exact)
    return torch.as_tensor(values, device=device).to(dt).contiguous()


def _int32(index, device):
    return torch.as_tensor(np.array(index, dtype=np.int32), device=device)


def _checked_columns(idx, width):
    """``idx`` as a host int32 array, every entry in [0, width): the ELL
    kernel gathers operand rows by it unchecked, so a matrix checks its
    columns once, when it is built."""
    idx = np.array(idx, dtype=np.int32)
    if idx.size and (idx.min() < 0 or idx.max() >= width):
        raise ValueError('ELL column indices must lie in [0, %d), not '
                         '[%d, %d]' % (width, idx.min(), idx.max()))
    return idx


class EllMatrix:
    """Padded-row (ELLPACK) device storage of a symmetric sparse matrix:
    ``idx[i, k]`` and ``val[i, k]`` hold the column and value of row i's
    k-th entry, rows padded with (column 0, value 0) to ``row_degree``, the
    largest degree rounded up to a multiple of ``pad_to``."""

    def __init__(self, a, dtype=np.float32, pad_to=8, device=None,
                 exact=False):
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
        self._init(idx, val, int(a.nnz), device, exact)

    @classmethod
    def from_arrays(cls, idx, val, nnz=None, device=None):
        """The port's matrix from another ELL matrix's arrays, e.g. the
        ``np.asarray`` of a ``raleigh_tpu`` ``EllMatrix``'s ``idx`` and
        ``val``."""
        self = cls.__new__(cls)
        self._init(idx, val, nnz, device)
        return self

    def _init(self, idx, val, nnz, device, exact=False):
        n, k = val.shape
        self.shape = (n, n)
        self.row_degree = k
        self.device = storage_device(device)
        self.idx = _int32(_checked_columns(idx, n), self.device).contiguous()
        self.val = _values(val, None, self.device, exact)
        self.nnz = int(torch.count_nonzero(self.val)) if nnz is None else nnz
        self.dtype = self.val.dtype

    def _multi_device(self):
        """True when ``idx`` and ``val`` are split by rows over a mesh
        (``core.device_solver.shard_operator``)."""
        return isinstance(self.val, ShardedRows)

    def matmat_t(self, xt):
        """(n, m) = A @ (n, m): operand and result transposed blocks."""
        if self._multi_device():
            return self.matmat_rows(xt.T.contiguous()).T
        return _ell_matmat(self.idx, self.val, xt.contiguous())

    def matmat_rows(self, x):
        """(m, n) = ((m, n) @ A) for a row-vector block, in x's dtype.
        With rows split over a mesh, x is a ``ShardedRows`` and so is the
        result; a plain tensor is split, applied and gathered again."""
        if self._multi_device():
            return _ell_sharded_apply(self.idx, self.val, x)
        return _ell_matmat_rows(self.idx, self.val, x)


# (value, operand) dtype pairs the ELL kernel has an instantiation for:
# f32 values with an f32 or bf16 operand (f32 sums), and an f64 operand
# with f32 or f64 values (f64 sums)
_ELL_NAMES = {torch.float32: 'f32', torch.bfloat16: 'bf16',
              torch.float64: 'f64'}
_ELL_PAIRS = [('f32', 'f32'), ('f32', 'bf16'), ('f32', 'f64'),
              ('f64', 'f64')]
# ELL kernel launches per (value dtype, operand dtype), counted where the
# kernel is launched.  The launches of a complex apply count under (value
# dtype, operand dtype, 'complex'), the dtypes those of the real parts it
# launches with.
ELL_LAUNCHES = {key: 0 for key in _ELL_PAIRS + [
    pair + ('complex',) for pair in _ELL_PAIRS if pair[1] != 'bf16']}


# (value, operand) dtype pairs of the Chebyshev step kernel
# (``_ell_step``): the ELL kernel's pairs but the bf16 operand
_ELL_STEP_PAIRS = [('f32', 'f32'), ('f32', 'f64'), ('f64', 'f64')]
# Chebyshev step kernel launches per (value dtype, operand dtype)
ELL_STEP_LAUNCHES = {key: 0 for key in _ELL_STEP_PAIRS}


def reset_launches():
    for counts in (ELL_LAUNCHES, ELL_STEP_LAUNCHES):
        for key in counts:
            counts[key] = 0


def _ell_matmat_plain(idx, val, xt):
    """y[i, :] = sum_k val[i, k] * xt[idx[i, k], :] by a loop over the
    padded-column axis: one gather and one multiply-add per step keep peak
    memory at one (n, m) temporary instead of an (n, K, m) cube.
    Accumulates in the promoted type of val and xt, returns xt's dtype
    (made complex for complex values).  The ELL kernel's plain version,
    any device and dtype."""
    n, k = idx.shape
    acc = torch.zeros((n, xt.shape[1]), device=xt.device,
                      dtype=torch.promote_types(val.dtype, xt.dtype))
    xt = xt.contiguous()
    for j in range(k):
        acc.addcmul_(val[:, j, None], xt.index_select(0, idx[:, j]))
    return acc.to(result_dtype(val.dtype, xt.dtype))


def _ell_check(idx, val, xt):
    """Raise on what the ELL kernel does not take."""
    devices = {t.device for t in (idx, val, xt)}
    if len(devices) != 1:
        raise ValueError('idx, val and x must share a device (got %s)'
                         % sorted(map(str, devices)))
    if (_ELL_NAMES.get(val.dtype), _ELL_NAMES.get(xt.dtype)) \
            not in _ELL_PAIRS:
        raise TypeError('the ELL kernel takes f32 values with an f32, bf16 '
                        'or f64 operand, or f64 values with an f64 operand, '
                        'not %s values with a %s operand'
                        % (val.dtype, xt.dtype))
    if idx.dtype != torch.int32:
        raise TypeError('the ELL kernel takes int32 idx (got %s)' % idx.dtype)
    if (idx.dim() != 2 or val.shape != idx.shape or xt.dim() != 2
            or (xt.shape[0] == 0 and idx.numel() > 0)):
        raise ValueError('shape mismatch: idx %s, val %s, x %s'
                         % (tuple(idx.shape), tuple(val.shape),
                            tuple(xt.shape)))
    if not all(t.is_contiguous() for t in (idx, val, xt)):
        raise ValueError('the ELL kernel takes contiguous tensors')
    if xt.device.type != 'cuda':
        raise ValueError('no ELL apply for device %s' % xt.device)


@spanned('raleigh.spmm')
def _ell_matmat(idx, val, xt, rows=False, tag=()):
    """(n, m) = A @ xt: y[i, :] = sum_k val[i, k] * xt[idx[i, k], :] for
    ELL arrays ``idx`` (n, K) int32 and ``val`` (n, K) and an (n_x, m)
    operand ``xt``, every idx in [0, n_x); with ``rows`` its (m, n)
    transpose, which the kernel writes directly.  Sums in the promoted
    type of val and xt, returns xt's dtype (made complex for complex
    values).  CUDA tensors go through the kernel (``csrc/ell_spmm.cu``)
    or raise, CPU tensors through ``_ell_matmat_plain``; complex operands
    or values through the real kernel (``ops/complex_rows.py``), their
    launches counted under ``tag``.  One ``raleigh.spmm`` span a call."""
    return _ell_apply(idx, val, xt, rows, tag)


def _ell_apply(idx, val, xt, rows, tag):
    """``_ell_matmat`` outside a span."""
    if xt.device.type == 'cpu':
        y = _ell_matmat_plain(idx, val, xt)
        return y.T.contiguous() if rows else y
    if xt.is_complex() or val.is_complex():
        y = complex_rows(
            lambda v, s: _ell_apply(idx, v, s.T.contiguous(), True,
                                    ('complex',)), val, xt.T)
        return y if rows else y.T.contiguous()
    _ell_check(idx, val, xt)
    key = (_ELL_NAMES[val.dtype], _ELL_NAMES[xt.dtype])
    return _ell_launch(idx, val, xt, rows, key, tag)


def _ell_launch(idx, val, xt, rows, key, tag):
    """One launch of the instantiation ``key`` (value, operand names) on
    checked CUDA tensors, counted under ``ELL_LAUNCHES[key + tag]``."""
    n, k = idx.shape
    m = xt.shape[1]
    y = torch.empty((m, n) if rows else (n, m), dtype=xt.dtype,
                    device=xt.device)
    if m == 0 or n == 0:
        return y
    index = xt.get_device()
    ys_row, ys_col = (1, n) if rows else (m, 1)
    entry = 'ell_spmm_%s_%s' % key
    err = getattr(_build.library(), entry)(
        idx.data_ptr(), val.data_ptr(), xt.data_ptr(), y.data_ptr(), n, k,
        m, m, ys_row, ys_col, index, _build.current_stream(index))
    if err != 0:
        raise RuntimeError('ELL kernel launch failed (%s): CUDA error %d'
                           % (entry, err))
    ELL_LAUNCHES[key + tag] += 1
    return y


def ell_occupancy(values, operand, m, device=None):
    """{'registers', 'blocks_per_sm', 'threads', 'local_bytes'} of the ELL
    kernel's instantiation for ``values`` and ``operand`` (names such as
    'f32') at m operand columns, as the card's runtime reports them;
    nothing is launched."""
    device = storage_device(device)
    if device.type != 'cuda':
        raise ValueError('ELL occupancy needs a CUDA device, not %s'
                         % device)
    out = (ctypes.c_int64 * 4)()
    err = _build.library().ell_spmm_occupancy(
        _ELL_PAIRS.index((values, operand)), m, device.index or 0,
        ctypes.addressof(out))
    if err != 0:
        raise RuntimeError('ell_spmm_occupancy failed: CUDA error %d' % err)
    return dict(zip(('registers', 'blocks_per_sm', 'threads',
                     'local_bytes'), out))


def _ell_matmat_rows(idx, val, x):
    """(m, n) = x A for an (m, n_x) row block ``x``, in x's dtype: the
    (n_x, m) copy the kernel gathers from is made here, once, and the
    kernel writes the (m, n) result directly."""
    return _ell_matmat(idx, val, x.T.contiguous(), rows=True)


def ell_step_pair(val, d):
    """True when the Chebyshev step kernel has an instantiation for
    values ``val`` and iterates ``d``: real f32 or f64 iterates, f32
    values or f64 values with f64 iterates."""
    return (_ELL_NAMES.get(val.dtype), _ELL_NAMES.get(d.dtype)) \
        in _ELL_STEP_PAIRS


def _ell_step_plain(idx, val, d, d_next, r, y, c1, c2, first, last):
    """``_ell_step``'s plain version: the recurrence's eager step, the same
    operations in the same order on (n, m) iterates, any device; r and y
    updated in place, d_next written (on the last step y alone)."""
    if first:
        y.copy_(d)
    else:
        y.add_(d)
    if last:
        return
    r.sub_(_ell_matmat_plain(idx, val, d).to(d.dtype))
    torch.mul(d, c1, out=d_next).add_(c2 * r)


def _ell_step_check(idx, val, d, d_next, r, y):
    """Raise on what the Chebyshev step kernel does not take."""
    ts = (idx, val, d, d_next, r, y)
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError('idx, val and the iterates must share a device '
                         '(got %s)' % sorted(map(str, devices)))
    if not ell_step_pair(val, d):
        raise TypeError('the Chebyshev step kernel takes f32 values with '
                        'f32 or f64 iterates, or f64 values with f64 '
                        'iterates, not %s values with %s iterates'
                        % (val.dtype, d.dtype))
    if idx.dtype != torch.int32:
        raise TypeError('the Chebyshev step kernel takes int32 idx (got %s)'
                        % idx.dtype)
    if any(t.dtype != d.dtype for t in (d_next, r, y)):
        raise TypeError('the iterates must share a dtype (got %s)'
                        % [str(t.dtype) for t in (d, d_next, r, y)])
    if (idx.dim() != 2 or val.shape != idx.shape or d.dim() != 2
            or d.shape[0] != idx.shape[0]
            or any(t.shape != d.shape for t in (d_next, r, y))):
        raise ValueError('shape mismatch: idx %s, val %s, iterates %s'
                         % (tuple(idx.shape), tuple(val.shape),
                            [tuple(t.shape) for t in (d, d_next, r, y)]))
    if not all(t.is_contiguous() for t in ts):
        raise ValueError('the Chebyshev step kernel takes contiguous '
                         'tensors')
    if len({t.data_ptr() for t in (d, d_next, r, y)}) != 4:
        raise ValueError('d, d_next, r and y must be four buffers')
    if d.device.type != 'cuda':
        raise ValueError('no Chebyshev step for device %s' % d.device)


@spanned('raleigh.spmm')
def _ell_step(idx, val, d, d_next, r, y, c1, c2, first, last):
    """One degree step of the Chebyshev recurrence on the ELL matrix
    (``idx``, ``val``) with (n, m) iterates, A's own rows: r -= A d, y = d
    on the ``first`` step and y += d after it, d_next = c1 d + c2 r; on
    the ``last`` step y alone.  r and y are updated in place and d_next
    written; d is read (and gathered), so d_next must be another buffer.
    Each operation rounds to the iterates' dtype as the eager step's do,
    c1 and c2 as Python floats against it, so the result is the eager
    step's bit for bit.  CUDA tensors go through one launch of the step
    kernel (``csrc/ell_spmm.cu``), counted in ``ELL_STEP_LAUNCHES``, on
    buffers the caller has checked (``_ell_step_check``: ``_ell_steps``
    checks once an apply, since its steps only swap d and d_next); CPU
    tensors through ``_ell_step_plain``.  One ``raleigh.spmm`` span a
    step."""
    if d.device.type == 'cpu':
        return _ell_step_plain(idx, val, d, d_next, r, y, c1, c2, first,
                               last)
    key = (_ELL_NAMES[val.dtype], _ELL_NAMES[d.dtype])
    n, k = idx.shape
    index = d.get_device()
    entry = 'ell_step_%s_%s' % key
    err = getattr(_build.library(), entry)(
        idx.data_ptr(), val.data_ptr(), d.data_ptr(), d_next.data_ptr(),
        r.data_ptr(), y.data_ptr(), c1, c2, n, k, d.shape[1], int(first),
        int(last), index, _build.current_stream(index))
    if err != 0:
        raise RuntimeError('Chebyshev step kernel launch failed (%s): CUDA '
                           'error %d' % (entry, err))
    ELL_STEP_LAUNCHES[key] += 1


def _ell_steps(ops, x, theta, coefficients):
    """The Chebyshev recurrence on the ELL matrix ``ops`` = (idx, val) for
    an (m, n) block ``x``, a step a launch (``_ell_step``), or None when the
    step kernel has no instantiation for ``val`` and x's dtype (or there
    is no step): r is a copy of x's transpose, d = r / theta, and step i
    takes ``coefficients[i]`` = (c1, c2); d and a second buffer swap after
    every step, and y is transposed back once.  Nothing is read back to
    the host, so a CUDA graph can capture an apply."""
    idx, val = ops
    if not coefficients or not ell_step_pair(val, x):
        return None
    r = x.T.clone(memory_format=torch.contiguous_format)
    d = r / theta
    d_next = torch.empty_like(d)
    y = torch.empty_like(d)
    if d.device.type != 'cpu':
        _ell_step_check(idx, val, d, d_next, r, y)
    last = len(coefficients) - 1
    for i, (c1, c2) in enumerate(coefficients):
        _ell_step(idx, val, d, d_next, r, y, c1, c2, i == 0, i == last)
        d, d_next = d_next, d
    return y.T.contiguous()


def _ell_sharded_apply(idx, val, x):
    """The ELL apply with ``idx`` and ``val`` split by rows: every shard
    multiplies its row block against the whole operand, gathered onto its
    device in the (n, m) layout once per device (indices stay global;
    traffic grows with n, valid for any pattern), one launch a shard."""
    if not isinstance(x, ShardedRows):
        return _ell_sharded_apply(
            idx, val, ShardedRows.split(x, val.sharding)).gather()
    back = x.sharding
    whole = {}
    parts = []
    for i, v in zip(idx.parts, val.parts):
        if v.device not in whole:
            whole[v.device] = torch.cat(
                [p.to(v.device) for p in x.parts], dim=1).T.contiguous()
        parts.append(_ell_matmat(i, v, whole[v.device], rows=True))
    return ShardedRows(parts, val.sharding).resplit(back)


class BsrMatrix:
    """Block-sparse (dense tile) device storage: the nonempty (bs x bs)
    tiles ``blocks`` in block-CSR order, tile t in block row
    ``block_rows[t]`` and block column ``block_cols[t]``, block row i
    holding tiles ``block_indptr[i]:block_indptr[i + 1]``.  ``dtype`` may
    be ``torch.bfloat16``: half the tile bytes, sums still in f32.

    ``block_indptr`` is a host array as in the JAX package;
    ``block_indptr_t`` is the same as an int32 tensor on ``device`` for the
    kernel."""

    def __init__(self, a, dtype=np.float32, bs=128, device=None,
                 exact=False):
        import scipy.sparse as scs
        a = _to_full_csr(a)
        n = a.shape[0]
        nb = -(-n // bs)
        store = torch_dtype(dtype)
        # tiles are cut from a matrix already in the host type nearest the
        # storage type, so no (nblocks, bs, bs) f64 copy is ever made
        wide = store in (torch.float64, torch.complex128)
        a = a.astype((np.complex128 if wide else np.complex64)
                     if store.is_complex or a.dtype.kind == 'c'
                     else (np.float64 if wide else np.float32))
        # pad to whole tiles: empty rows below, empty columns to the right
        indptr = np.concatenate(
            [a.indptr, np.full(nb * bs - n, a.indptr[-1], a.indptr.dtype)])
        ab = scs.csr_matrix((a.data, a.indices, indptr),
                            shape=(nb * bs, nb * bs)).tobsr((bs, bs))
        ab.sort_indices()
        self._init(ab.data, ab.indices, ab.indptr, n, int(a.nnz), store,
                   device, exact)

    @classmethod
    def from_arrays(cls, blocks, block_cols, block_indptr, n, nnz=None,
                    device=None):
        """The port's matrix from another BSR matrix's arrays, e.g. the
        ``np.asarray`` of a ``raleigh_tpu`` ``BsrMatrix``'s ``blocks`` and
        ``block_cols`` with its ``block_indptr`` and ``shape[0]``."""
        self = cls.__new__(cls)
        self._init(blocks, block_cols, block_indptr, n, nnz, None, device)
        return self

    def _init(self, blocks, block_cols, block_indptr, n, nnz, dtype, device,
              exact=False):
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
        self.blocks = _values(blocks, dtype, self.device, exact)
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
        if dm._multi_device():
            def fn(ops, x):
                return _ell_sharded_apply(ops[0], ops[1], x)
            return fn, (dm.idx, dm.val)

        def fn(ops, x):
            return _ell_matmat_rows(ops[0], ops[1], x)
        return fn, (dm.idx, dm.val)
    if isinstance(dm, BsrMatrix):
        n = dm.shape[0]

        def fn(ops, x):
            return bsr_matmat_rows(ops[0], ops[1], ops[2], x.contiguous(), n)
        return fn, (dm.blocks, dm.block_indptr_t, dm.block_cols)
    raise TypeError('unsupported device matrix %r' % type(dm).__name__)


def rows_step_operands(dm, stream_bf16):
    """``fn(operands, x, theta, coefficients)`` running the whole Chebyshev
    recurrence on the device matrix ``dm`` with each degree step one
    launch, on ``rows_matmat_operands(dm)``'s operands (``_ell_steps``:
    None for a block the step kernel does not take); or None when dm has
    no step kernel: an ``EllMatrix`` left whole has one, for iterates not
    streamed in bfloat16; DIA, BSR and a matrix split over a mesh take the
    recurrence's eager step."""
    if (not isinstance(dm, EllMatrix) or dm._multi_device()
            or stream_bf16):
        return None
    return _ell_steps


# The constants of the ELL/BSR choice below are the JAX package's, kept as
# they are so that both packages give a matrix the same layout; they are
# not measured on this card yet (ROADMAP queue 1, item 11).
BSR_MIN_FILL_WIDTH = 8.0        # fill * min(block width, 128) from which BSR
BSR_RESIDENT_BYTES = 64 * 2 ** 20   # operand block size of the second test
BSR_TILE_STREAM_RATE = 350e9    # bytes/s of tiles, BSR apply estimate
ELL_GATHER_RATE = 0.03e9        # nonzeros/s, ELL apply estimate
ELL_MAX_PADDING = 16            # padded ELL entries per nonzero


def device_sparse(a, dtype=np.float32, block_width_hint=32, bs=128,
                  device=None, exact=False):
    """Choose a device layout for the symmetric sparse matrix ``a``: DIA
    when the pattern collapses onto few populated diagonals (stencils,
    banded matrices — no gathers at all), BSR when tile fill times block
    width is high enough, or when the operand block is large and the
    estimated tile-stream time beats the estimated gather time, or when a
    few hub rows would inflate ELL's padding; ELL otherwise.  The values
    are stored in the canonical dtype of ``dtype`` (``canonical_dtype``),
    or in ``dtype`` itself when ``exact``."""
    return _device_layout(_to_full_csr(a), dtype, device, block_width_hint,
                          bs, exact)


def _device_layout(csr, dtype, device, block_width_hint=32, bs=128,
                   exact=False):
    """``device_sparse`` of a matrix already in full canonical CSR."""
    n = csr.shape[0]
    if n > 1:
        rows, offsets, k = _diagonals(csr)
        noff = len(offsets)
        if noff <= DIA_MAX_OFFSETS and noff * n <= DIA_MAX_WASTE * csr.nnz:
            val = _dia_values(csr, rows, offsets, k, dtype)
            return DiaMatrix.from_arrays(offsets, val, device, exact)
    if n >= bs:
        # number of nonempty tiles = distinct (row tile, column tile) pairs
        nb = -(-n // bs)
        row_t = np.repeat(np.arange(n) // bs, np.diff(csr.indptr))
        keys = row_t.astype(np.int64) * nb + (csr.indices // bs)
        ntiles = np.unique(keys).size
        fill = csr.nnz / (ntiles * bs * bs)
        if fill * min(block_width_hint, 128) >= BSR_MIN_FILL_WIDTH:
            return BsrMatrix(csr, dtype=dtype, bs=bs, device=device,
                             exact=exact)
        # large operand blocks: compare estimated apply times instead of
        # demanding high fill
        if n * block_width_hint * 4 > BSR_RESIDENT_BYTES:
            bsr_t = ntiles * bs * bs * 4 / BSR_TILE_STREAM_RATE
            ell_t = csr.nnz / ELL_GATHER_RATE
            if bsr_t < ell_t:
                return BsrMatrix(csr, dtype=dtype, bs=bs, device=device,
                             exact=exact)
    # ELL pads every row to the largest degree: a few hub rows (a
    # boundary-condition row coupled to everything, say) would inflate the
    # padded storage K*n arbitrarily — such patterns go to BSR, whose
    # storage is bounded by the nonempty tiles
    deg_max = int(np.diff(csr.indptr).max()) if n else 0
    if (n and deg_max * n > ELL_MAX_PADDING * max(csr.nnz, 1) and n >= bs):
        return BsrMatrix(csr, dtype=dtype, bs=bs, device=device,
                         exact=exact)
    return EllMatrix(csr, dtype=dtype, device=device, exact=exact)
