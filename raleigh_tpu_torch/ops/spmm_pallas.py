"""BSR SpMM on row-layout operand blocks: the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (``csrc/bsr_spmm.cu``) replaces the Pallas kernel
``raleigh_tpu/ops/spmm_pallas.py::_pallas_bsr_matmat`` (body
``_spmm_kernel``).  It computes the same tile contraction but not block by
block as the Pallas grid does: it works on the (m, n) row layout directly
(no transpose, pad or reshape around the call) and walks the block-CSR
arrays as they are, without padding every block row's tile list to the
longest one.

    y[r, i*bs + p] = sum_{t = indptr[i]}^{indptr[i+1]-1} sum_q
                     blocks[t, p, q] * x[r, cols[t]*bs + q]

``blocks`` (nblocks, bs, bs) f32 or bf16, ``block_indptr`` (nb + 1,) and
``block_cols`` (nblocks,) int32, ``x`` (m, n) f32 or bf16, ``n`` unpadded
(``nb = ceil(n / bs)``; rows and columns past n are masked).  Sums are
taken in f32 and the result has x's dtype.  The f64 instantiation serves
the core Solver's f64 blocks: x f64, tiles f32 or f64, sums in f64 (on
the f64 tensor cores where a tile row is a whole number of 16 bytes).
On a CUDA tensor the wrapper launches the kernel or raises; only a CPU
tensor takes the plain version.  A complex operand goes through the
kernel as one real block of its real and imaginary rows, complex tiles as
two launches, one with their real and one with their imaginary parts
(``ops/complex_rows.py``); the plain version takes complex tensors as
they are.
"""

import torch

from ..utils.profiling import spanned
from . import _build
from .complex_rows import complex_rows, result_dtype

_NAMES = {torch.float32: 'f32', torch.bfloat16: 'bf16',
          torch.float64: 'f64'}
# (block, operand) pairs with an instantiation: f32 or bf16 each, and the
# f64 operand with f32 or f64 tiles
_PAIRS = [(b, x) for b in ('f32', 'bf16') for x in ('f32', 'bf16')]
_WIDE_PAIRS = [('f32', 'f64'), ('f64', 'f64')]

# kernel launches per (block dtype, operand dtype), counted where the
# kernel is launched.  The launches of a complex apply count under (block
# dtype, operand dtype, 'complex'), the dtypes those of the real parts it
# launches with.
LAUNCHES = {key: 0 for key in _PAIRS + _WIDE_PAIRS + [
    key + ('complex',) for key in [('f32', 'f32')] + _WIDE_PAIRS]}


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def bsr_matmat_rows_plain(blocks, block_indptr, block_cols, x, n):
    """Plain PyTorch BSR row apply, any device and dtype (complex too):
    gather of the operand slabs, one batched product, ``index_add_`` per
    block row.  Accumulates in f32 or better (the promoted type of blocks,
    x and f32) and returns x's dtype (made complex for complex tiles)."""
    nblocks, bs, _ = blocks.shape
    nb = block_indptr.shape[0] - 1
    m = x.shape[0]
    acc = torch.promote_types(torch.promote_types(blocks.dtype, x.dtype),
                              torch.float32)
    xp = x.to(acc)
    pad = nb * bs - n
    if pad:
        xp = torch.nn.functional.pad(xp, (0, pad))
    # (nblocks, bs, m): the operand slab under every stored tile
    xg = xp.reshape(m, nb, bs).index_select(1, block_cols).permute(1, 2, 0)
    prod = torch.bmm(blocks.to(acc), xg)
    block_rows = torch.repeat_interleave(
        torch.arange(nb, device=x.device),
        (block_indptr[1:] - block_indptr[:-1]).long(), output_size=nblocks)
    y = torch.zeros((nb, bs, m), dtype=acc, device=x.device)
    y.index_add_(0, block_rows, prod)
    return y.reshape(nb * bs, m)[:n].T.to(
        result_dtype(blocks.dtype, x.dtype)).contiguous()


def _check(blocks, block_indptr, block_cols, x, n):
    """Raise on what the kernel does not take: tensors on two devices, a
    (block, operand) dtype pair with no instantiation, indices that are not
    int32, shapes that do not fit one another, strided tensors."""
    devices = {t.device for t in (blocks, block_indptr, block_cols, x)}
    if len(devices) != 1:
        raise ValueError('blocks, block_indptr, block_cols and x must share '
                         'a device (got %s)' % sorted(map(str, devices)))
    if (_NAMES.get(blocks.dtype), _NAMES.get(x.dtype)) not in LAUNCHES:
        raise TypeError('the BSR kernel takes f32 or bf16 blocks and '
                        'operands (or an f64 operand with f32 or f64 '
                        'blocks), not %s blocks with a %s operand'
                        % (blocks.dtype, x.dtype))
    if block_indptr.dtype != torch.int32 or block_cols.dtype != torch.int32:
        raise TypeError('the BSR kernel takes int32 block_indptr and '
                        'block_cols (got %s, %s)'
                        % (block_indptr.dtype, block_cols.dtype))
    if (blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]
            or blocks.shape[1] < 1 or x.dim() != 2 or x.shape[1] != n
            or block_indptr.dim() != 1 or block_cols.dim() != 1
            or block_cols.shape[0] != blocks.shape[0]
            or block_indptr.shape[0] != -(-n // blocks.shape[1]) + 1):
        raise ValueError('shape mismatch: blocks %s, block_indptr %s, '
                         'block_cols %s, x %s, n %d'
                         % (tuple(blocks.shape), tuple(block_indptr.shape),
                            tuple(block_cols.shape), tuple(x.shape), n))
    if not all(t.is_contiguous()
               for t in (blocks, block_indptr, block_cols, x)):
        raise ValueError('the BSR kernel takes contiguous tensors')


@spanned('raleigh.spmm')
def bsr_matmat_rows(blocks, block_indptr, block_cols, x, n):
    """(m, n) = BSR matrix applied to the (m, n) row block ``x``, in x's
    dtype.  CUDA tensors go through the kernel, CPU tensors through
    ``bsr_matmat_rows_plain``.  One ``raleigh.spmm`` span a call."""
    return _bsr_apply(blocks, block_indptr, block_cols, x, n)


def _bsr_apply(blocks, block_indptr, block_cols, x, n, tag=()):
    """``bsr_matmat_rows`` outside a span, its launches counted in
    ``LAUNCHES`` under the dtype names and ``tag``."""
    if x.device.type == 'cpu':
        return bsr_matmat_rows_plain(blocks, block_indptr, block_cols, x, n)
    if x.is_complex() or blocks.is_complex():
        return complex_rows(
            lambda b, s: _bsr_apply(b, block_indptr, block_cols, s, n,
                                    ('complex',)),
            blocks, x)
    if x.device.type != 'cuda':
        raise ValueError('no BSR apply for device %s' % x.device)
    _check(blocks, block_indptr, block_cols, x, n)
    y = torch.empty_like(x)
    m = x.shape[0]
    if m == 0 or n == 0:
        return y
    key = (_NAMES[blocks.dtype], _NAMES[x.dtype])
    fn = getattr(_build.library(), 'bsr_spmm_rows_%s_%s' % key)
    index = x.get_device()
    err = fn(blocks.data_ptr(), block_indptr.data_ptr(),
             block_cols.data_ptr(), x.data_ptr(), y.data_ptr(),
             blocks.shape[1], m, n, index, _build.current_stream(index))
    if err != 0:
        raise RuntimeError('BSR kernel launch failed: CUDA error %d' % err)
    LAUNCHES[key + tag] += 1
    return y
