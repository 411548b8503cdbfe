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
taken in f32 and the result has x's dtype.  On a CUDA tensor the wrapper
launches the kernel or raises; only a CPU tensor takes the plain version.
"""

import torch

from . import _build

_NAMES = {torch.float32: 'f32', torch.bfloat16: 'bf16'}

# kernel launches per (block dtype, operand dtype), counted where the
# kernel is launched
LAUNCHES = {(b, x): 0 for b in _NAMES.values() for x in _NAMES.values()}


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def bsr_matmat_rows_plain(blocks, block_indptr, block_cols, x, n):
    """Plain PyTorch BSR row apply, any device and dtype: gather of the
    operand slabs, one batched product, ``index_add_`` per block row.
    Accumulates in f32 or better (the promoted type of blocks, x and
    f32) and returns x's dtype."""
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
    return y.reshape(nb * bs, m)[:n].T.to(x.dtype).contiguous()


def _check(blocks, block_indptr, block_cols, x, n):
    devices = {t.device for t in (blocks, block_indptr, block_cols, x)}
    if len(devices) != 1:
        raise ValueError('blocks, block_indptr, block_cols and x must share '
                         'a device (got %s)' % sorted(map(str, devices)))
    if blocks.dtype not in _NAMES or x.dtype not in _NAMES:
        raise TypeError('the BSR kernel takes f32 or bf16 blocks and '
                        'operands, not %s blocks with a %s operand'
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


def bsr_matmat_rows(blocks, block_indptr, block_cols, x, n):
    """(m, n) = BSR matrix applied to the (m, n) row block ``x``, in x's
    dtype.  CUDA tensors go through the kernel, CPU tensors through
    ``bsr_matmat_rows_plain``."""
    if x.device.type == 'cpu':
        return bsr_matmat_rows_plain(blocks, block_indptr, block_cols, x, n)
    if x.device.type != 'cuda':
        raise ValueError('no BSR apply for device %s' % x.device)
    _check(blocks, block_indptr, block_cols, x, n)
    y = torch.empty_like(x)
    m = x.shape[0]
    if m == 0 or n == 0:
        return y
    key = (_NAMES[blocks.dtype], _NAMES[x.dtype])
    fn = getattr(_build.library(), 'bsr_spmm_rows_%s_%s' % key)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(blocks.data_ptr(), block_indptr.data_ptr(),
             block_cols.data_ptr(), x.data_ptr(), y.data_ptr(),
             blocks.shape[1], m, n, x.device.index, stream)
    if err != 0:
        raise RuntimeError('BSR kernel launch failed: CUDA error %d' % err)
    LAUNCHES[key] += 1
    return y
