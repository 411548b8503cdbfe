"""DIA SpMM on row-layout operand blocks: the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (``csrc/dia_spmm.cu``) replaces the sliding-window Pallas
kernel ``raleigh_tpu/ops/spmm_window.py::build_dia_window_ring``.  Its
TPU-only machinery does not carry over: the DMA ring through VMEM (L1/L2
give a coalesced kernel the same halo reuse), and the Mosaic limits
``n % 128 == 0``, ``m % 8 == 0`` and two or more lane tiles — the kernel
takes any shape.

    y[r, i] = sum_k val[k, i] * x[r, i + offsets[k]],  zero outside [0, n)

``val`` (noff, n), ``x`` (m, n), ``offsets`` an int32 (noff,) tensor on
the same device.  On a CUDA tensor the wrapper launches the kernel (x f32
or bf16, val f32) or raises; only a CPU tensor takes the plain version.

Two more kernels compute the same function for f32 operands, each through
an explicitly staged shared-memory window that reads x from device memory
once.  They are the A/B partners of the production kernel in
``benches/bench_window_tiles.py`` and serve no solver:

  * ``dia_matmat_rows_slide`` (``csrc/dia_spmm_slide.cu``) replaces
    ``build_dia_window_slide``: one circular window of tile + reach lanes
    per row, the next tile's lanes in flight while a tile is computed;
  * ``dia_matmat_rows_tiles`` (``csrc/dia_spmm_tiles.cu``) replaces
    ``build_dia_window_tiles``: a ring of four whole tiles per row and no
    halo, for max|offset| <= tile.

Their ``offsets`` are host ints (``DiaMatrix.offsets``): the launch sizes
its shared memory from them, and the kernel takes them as an argument.

``dia_matmat_rows_ext`` (``csrc/dia_spmm_ext.cu``) replaces
``build_dia_window_ring_ext``, the per-shard kernel of the mesh-partitioned
apply (``DiaMatrix.sharded_rows_fn``): the same sum over an operand that
the caller has extended by its neighbours' edge lanes, with the shard's own
values passed at run time and no range check.  Mosaic's limits
(``n % 128``, ``m % 8``, two or more tiles, halos rounded up to 128) do
not carry over, and bf16 operands go through the kernel too.
"""

import ctypes

import torch

from . import _build

# kernel launches, counted where the kernel is launched: the production
# kernel per operand dtype, and the two staged-window kernels
LAUNCHES = {'float32': 0, 'bfloat16': 0, 'slide': 0, 'tiles': 0,
            'ext_float32': 0, 'ext_bfloat16': 0}

# operand rows a block of a staged-window kernel can own, and the most
# diagonals it takes (they travel as a kernel argument)
ROWS_PER_BLOCK = (8, 4, 2, 1)
MAX_WINDOW_OFFSETS = 128

_ENTRY = {torch.float32: ('float32', 'dia_spmm_rows_f32'),
          torch.bfloat16: ('bfloat16', 'dia_spmm_rows_bf16')}
_EXT_ENTRY = {torch.float32: ('ext_float32', 'dia_spmm_rows_ext_f32'),
              torch.bfloat16: ('ext_bfloat16', 'dia_spmm_rows_ext_bf16')}


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def dia_matmat_rows_plain(val, x, offsets):
    """Plain PyTorch DIA row apply, any device and dtype; ``offsets`` a
    tensor or a sequence of ints.  Accumulates in
    the promoted type of val and x (f32 for bf16 operands with f32
    values), adding the diagonals in order, and returns x's dtype."""
    m, n = x.shape
    y = torch.zeros((m, n), dtype=torch.promote_types(val.dtype, x.dtype),
                    device=x.device)
    if isinstance(offsets, torch.Tensor):
        offsets = offsets.tolist()
    for k, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        if lo < hi:
            y[:, lo:hi] += val[k, lo:hi] * x[:, lo + off:hi + off]
    return y.to(x.dtype)


def _check(val, x, offsets):
    if not (val.device == x.device == offsets.device):
        raise ValueError('val, x and offsets must share a device (got %s, '
                         '%s, %s)' % (val.device, x.device, offsets.device))
    if x.dtype not in _ENTRY:
        raise TypeError('the DIA kernel takes f32 or bf16 operands, not %s'
                        % x.dtype)
    if val.dtype != torch.float32 or offsets.dtype != torch.int32:
        raise TypeError('the DIA kernel takes f32 values and int32 offsets '
                        '(got %s, %s)' % (val.dtype, offsets.dtype))
    if (val.dim() != 2 or x.dim() != 2 or offsets.dim() != 1
            or val.shape[1] != x.shape[1]
            or offsets.shape[0] != val.shape[0]):
        raise ValueError('shape mismatch: val %s, x %s, offsets %s'
                         % (tuple(val.shape), tuple(x.shape),
                            tuple(offsets.shape)))
    if not (val.is_contiguous() and x.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError('the DIA kernel takes contiguous tensors')


def dia_matmat_rows(val, x, offsets):
    """(m, n) = DIA matrix applied to the (m, n) row block ``x``, in x's
    dtype.  CUDA tensors go through the kernel, CPU tensors through
    ``dia_matmat_rows_plain``."""
    if x.device.type == 'cpu':
        return dia_matmat_rows_plain(val, x, offsets)
    if x.device.type != 'cuda':
        raise ValueError('no DIA apply for device %s' % x.device)
    _check(val, x, offsets)
    y = torch.empty_like(x)
    m, n = x.shape
    if m == 0 or n == 0:
        return y
    key, entry = _ENTRY[x.dtype]
    fn = getattr(_build.library(), entry)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(val.data_ptr(), x.data_ptr(), y.data_ptr(), offsets.data_ptr(),
             val.shape[0], m, n, x.device.index, stream)
    if err != 0:
        raise RuntimeError('DIA kernel launch failed: CUDA error %d' % err)
    LAUNCHES[key] += 1
    return y


def dia_matmat_rows_ext_plain(val, x_ext, offsets, halo_lo, n):
    """Plain PyTorch DIA row apply over a pre-extended operand, any device
    and dtype: ``x_ext`` carries ``halo_lo`` lanes before the ``n`` local
    ones and at least ``max(offsets)`` after, so every diagonal is one
    static slice.  Accumulates in the promoted type of val and x_ext,
    adding the diagonals in order, and returns x_ext's dtype."""
    m = x_ext.shape[0]
    y = torch.zeros((m, n), dtype=torch.promote_types(val.dtype, x_ext.dtype),
                    device=x_ext.device)
    if isinstance(offsets, torch.Tensor):
        offsets = offsets.tolist()
    for k, off in enumerate(offsets):
        y += val[k, :n] * x_ext[:, halo_lo + off:halo_lo + off + n]
    return y.to(x_ext.dtype)


def dia_matmat_rows_ext(val, x_ext, offsets, halo_lo, n, reach=None):
    """(m, n) = the shard's DIA values ``val`` (noff, n) applied to the
    extended row block ``x_ext`` (m, halo_lo + n + halo_hi) =
    [left halo | local lanes | right halo], in x_ext's dtype:

        y[r, i] = sum_k val[k, i] * x_ext[r, halo_lo + i + offsets[k]]

    with no range check, so ``halo_lo >= -min(offsets)`` and
    ``x_ext.shape[1] >= halo_lo + n + max(offsets)`` must hold; raises
    otherwise.  ``reach`` = (-min(offsets, 0), max(offsets, 0)) as host
    ints saves reading the offsets back from the device.  ``x_ext`` needs
    unit stride along the lanes and may have any row stride.  CUDA tensors
    go through the kernel (x_ext f32 or bf16, val f32), CPU tensors through
    ``dia_matmat_rows_ext_plain``."""
    halo_lo, n = int(halo_lo), int(n)
    if not (val.device == x_ext.device == offsets.device):
        raise ValueError('val, x_ext and offsets must share a device (got '
                         '%s, %s, %s)'
                         % (val.device, x_ext.device, offsets.device))
    if x_ext.device.type not in ('cpu', 'cuda'):
        raise ValueError('no DIA apply for device %s' % x_ext.device)
    if (val.dim() != 2 or x_ext.dim() != 2 or offsets.dim() != 1
            or val.shape[1] != n or offsets.shape[0] != val.shape[0]):
        raise ValueError('shape mismatch: val %s, x_ext %s, offsets %s, '
                         'n = %d' % (tuple(val.shape), tuple(x_ext.shape),
                                     tuple(offsets.shape), n))
    if reach is None:
        host = offsets.tolist()
        reach = (max(0, -min(host, default=0)), max(0, max(host, default=0)))
    if halo_lo < reach[0] or x_ext.shape[1] < halo_lo + n + reach[1]:
        raise ValueError('x_ext has %d lanes before and %d after the %d '
                         'local ones; the offsets reach %d before and %d '
                         'after' % (halo_lo, x_ext.shape[1] - halo_lo - n,
                                    n, reach[0], reach[1]))
    if x_ext.device.type == 'cpu':
        return dia_matmat_rows_ext_plain(val, x_ext, offsets, halo_lo, n)
    if x_ext.dtype not in _EXT_ENTRY:
        raise TypeError('the DIA kernel takes f32 or bf16 operands, not %s'
                        % x_ext.dtype)
    if val.dtype != torch.float32 or offsets.dtype != torch.int32:
        raise TypeError('the DIA kernel takes f32 values and int32 offsets '
                        '(got %s, %s)' % (val.dtype, offsets.dtype))
    m = x_ext.shape[0]
    if not (val.is_contiguous() and offsets.is_contiguous()
            and (x_ext.shape[1] <= 1 or x_ext.stride(1) == 1)):
        raise ValueError('the DIA kernel takes contiguous values and '
                         'offsets and an operand with unit stride along '
                         'the lanes')
    y = torch.empty((m, n), dtype=x_ext.dtype, device=x_ext.device)
    if m == 0 or n == 0:
        return y
    key, entry = _EXT_ENTRY[x_ext.dtype]
    stream = torch.cuda.current_stream(x_ext.device).cuda_stream
    err = getattr(_build.library(), entry)(
        val.data_ptr(), x_ext.data_ptr(), y.data_ptr(), offsets.data_ptr(),
        val.shape[0], m, n, x_ext.stride(0), halo_lo, x_ext.device.index,
        stream)
    if err != 0:
        raise RuntimeError('extended-operand DIA kernel launch failed: CUDA '
                           'error %d' % err)
    LAUNCHES[key] += 1
    return y


def _rows_per_block(m, lanes, what):
    """The most operand rows (of ``ROWS_PER_BLOCK``, no more than m needs)
    whose windows of ``lanes`` f32 lanes each fit one block's shared
    memory; raises when one row does not fit."""
    for rows in ROWS_PER_BLOCK:
        fits = rows * lanes * 4 <= _build.SMEM_PER_BLOCK
        if fits and (rows == 1 or rows < 2 * m):
            return rows
    raise ValueError('%s: one row\'s window of %d lanes takes %d bytes of '
                     'shared memory; a block has %d'
                     % (what, lanes, lanes * 4,
                        _build.SMEM_PER_BLOCK))


def _staged(entry, key, val, x, offsets, tile, lanes):
    """Checks, then the staged-window kernel ``entry`` with as many rows
    per block as ``lanes`` window lanes per row allow, or the plain version
    for CPU tensors."""
    if not val.device == x.device:
        raise ValueError('val and x must share a device (got %s, %s)'
                         % (val.device, x.device))
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError('no DIA apply for device %s' % x.device)
    if x.dtype != torch.float32 or val.dtype != torch.float32:
        raise TypeError('the staged-window DIA kernels take f32 values and '
                        'operands (got %s, %s)' % (val.dtype, x.dtype))
    if (val.dim() != 2 or x.dim() != 2 or val.shape[1] != x.shape[1]
            or len(offsets) != val.shape[0]):
        raise ValueError('shape mismatch: val %s, x %s, %d offsets'
                         % (tuple(val.shape), tuple(x.shape), len(offsets)))
    if not (val.is_contiguous() and x.is_contiguous()):
        raise ValueError('the DIA kernels take contiguous tensors')
    if len(offsets) > MAX_WINDOW_OFFSETS:
        raise ValueError('the staged-window DIA kernels take at most %d '
                         'diagonals, got %d'
                         % (MAX_WINDOW_OFFSETS, len(offsets)))
    m, n = x.shape
    rows = _rows_per_block(m, lanes, key)
    if x.device.type == 'cpu':
        return dia_matmat_rows_plain(val, x, offsets)
    y = torch.empty_like(x)
    if m == 0 or n == 0:
        return y
    host_offsets = (ctypes.c_int * len(offsets))(*offsets)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(_build.library(), entry)(
        val.data_ptr(), x.data_ptr(), y.data_ptr(), host_offsets,
        len(offsets), m, n, tile, rows, x.device.index, stream)
    if err != 0:
        raise RuntimeError('%s DIA kernel launch failed: CUDA error %d'
                           % (key, err))
    LAUNCHES[key] += 1
    return y


def _host_offsets(offsets, tile):
    """(offsets as a tuple of ints, tile as an int)."""
    tile = int(tile)
    if tile < 1:
        raise ValueError('tile must be at least 1 lane, got %d' % tile)
    return tuple(int(o) for o in offsets), tile


def dia_matmat_rows_slide(val, x, offsets, tile):
    """(m, n) = DIA matrix applied to the f32 (m, n) row block ``x`` through
    one sliding shared-memory window per row, ``tile`` lanes per step.
    ``offsets``: the diagonals as host ints.  A row's window holds
    reach + 2 * tile lanes (reach = the offsets' extent to the left plus to
    the right); if that does not fit a block's shared memory, raises
    ``ValueError``."""
    offsets, tile = _host_offsets(offsets, tile)
    reach = max(0, -min(offsets, default=0)) + max(0, max(offsets, default=0))
    return _staged('dia_spmm_rows_slide_f32', 'slide', val, x, offsets, tile,
                   reach + 2 * tile)


def dia_matmat_rows_tiles(val, x, offsets, tile):
    """(m, n) = DIA matrix applied to the f32 (m, n) row block ``x`` through
    a shared-memory ring of four whole tiles of ``tile`` lanes per row, with
    no halo.  ``offsets``: the diagonals as host ints, none larger than
    ``tile`` in size.  If four tiles do not fit a block's shared memory,
    raises ``ValueError``."""
    offsets, tile = _host_offsets(offsets, tile)
    if max((abs(o) for o in offsets), default=0) > tile:
        raise ValueError('tile-ring kernel needs max|offset| <= tile (got '
                         '%d > %d)' % (max(abs(o) for o in offsets), tile))
    return _staged('dia_spmm_rows_tiles_f32', 'tiles', val, x, offsets, tile,
                   4 * tile)


def _ring(val, x, offsets, tile=None):
    """The production kernel in the variants' signature: it has no tile
    parameter, and takes its offsets as a tensor on x's device."""
    if not isinstance(offsets, torch.Tensor):
        offsets = torch.tensor(offsets, dtype=torch.int32, device=x.device)
    return dia_matmat_rows(val, x, offsets)


# the three structures of one function, by the names the JAX package's
# tile sweep gives them
VARIANTS = {'ring': _ring, 'slide': dia_matmat_rows_slide,
            'tiles': dia_matmat_rows_tiles}
