"""Streaming scale ``y = a * x``: the card's stream rate as the port
measures it, and two other launch and pipeline structures of the same copy.

``stream_scale`` (``csrc/stream_scale.cu``, one contiguous span per thread
block) replaces the Pallas copy kernel
``bench.py::_extra_pallas_copy_roofline``, which reads an f32 array once
and writes it once.  ``2 * x.numel() * 4 / t`` is the rate the
memory-bound SpMM kernels are judged against.

``stream_scale_tiled`` and ``stream_scale_pipelined``
(``csrc/stream_probes.cu``) replace ``benches/bench_grid_shapes.py::
build_blockspec`` and ``build_manual``: one thread block per tile with no
grid stride, and one persistent grid whose blocks pipeline their chunks
through 2 or 4 shared-memory stages with bulk copies of the Tensor Memory
Accelerator.

``copy_lanes_many``, ``copy_lanes`` and ``hbm2hbm`` (``csrc/copy_lanes.cu``)
replace ``benches/bench_grid_shapes.py::build_hbm2hbm``, the copy with no
arithmetic and no on-chip buffer: a batch of strided 2-D copies between
pairs of views in one launch, which assembles the extended operands of the
row-partitioned ELL product (``parallel.mesh.ring_extended``); its one-copy
case; and the whole array copied in column tiles, the sweep's ``hbm2hbm``
line.

On a CUDA tensor each wrapper launches its kernel or raises; only a CPU
tensor takes the plain version (``torch.mul``; ``Tensor.copy_`` for the
copies).
"""

import ctypes

import torch

from . import _build

# the shape the reference streams: 32 rows of 39 tiles of 32768 lanes
REFERENCE_SHAPE = (32, 39 * 32768)
REFERENCE_SCALE = 0.99999
# timed launches of one reading, and the seed of the array they stream
RATE_REPS = 50
RATE_SEED = 0

PIPELINE_DEPTHS = (2, 4)
# bytes behind each stage of the pipelined kernel, its mbarrier and the
# index of its chunk (csrc/stream_probes.cu::kStageExtraBytes); a stage of
# tile * 4 bytes, tile a multiple of 4, keeps both 8-byte aligned
PIPELINE_STAGE_EXTRA_BYTES = 16

# kernel launches, counted where the kernel is launched: the stream
# kernel, the tiled one, the pipelined one per depth, and the copy kernel
LAUNCHES = {'float32': 0, 'tiled': 0, 'pipelined_depth2': 0,
            'pipelined_depth4': 0, 'copy_lanes': 0}

# element sizes the copy kernel moves one element at a time where 16-byte
# accesses do not fit
COPY_ELEMENT_SIZES = (1, 2, 4, 8)


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def stream_scale_plain(x, a):
    """Plain PyTorch version: one elementwise multiply."""
    return torch.mul(x, a)


def stream_scale(x, a):
    """``a * x`` for a contiguous f32 tensor, as a new tensor."""
    if x.device.type == 'cpu':
        return stream_scale_plain(x, a)
    if x.device.type != 'cuda':
        raise ValueError('no stream kernel for device %s' % x.device)
    if x.dtype != torch.float32:
        raise TypeError('the stream kernel takes f32, not %s' % x.dtype)
    if not x.is_contiguous():
        raise ValueError('the stream kernel takes a contiguous tensor')
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    stream = _build.current_stream(x.get_device())
    err = _build.library().stream_scale_f32(
        x.data_ptr(), y.data_ptr(), float(a), x.numel(), x.get_device(),
        stream)
    if err != 0:
        raise RuntimeError('stream kernel launch failed: CUDA error %d'
                           % err)
    LAUNCHES['float32'] += 1
    return y


def _check_probe(x, chunk, what):
    """What both probe kernels ask of their array and of the ``chunk``
    elements one block handles at a time; raises on the CPU as on the
    card."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError('no stream kernel for device %s' % x.device)
    if x.dtype != torch.float32:
        raise TypeError('the stream kernels take f32, not %s' % x.dtype)
    if x.dim() < 1 or not x.is_contiguous():
        raise ValueError('the stream kernels take a contiguous tensor')
    if chunk < 4 or chunk % 4:
        raise ValueError('%s must be a positive multiple of 4 elements '
                         '(16-byte accesses), got %d' % (what, chunk))
    if x.shape[-1] % chunk:
        raise ValueError('the row length %d is not a multiple of %s = %d'
                         % (x.shape[-1], what, chunk))
    if x.data_ptr() % 16:
        raise ValueError('the stream kernels take a 16-byte aligned tensor')


def stream_scale_tiled(x, a, tile, per_step=1):
    """``a * x`` for a contiguous f32 tensor, as a new tensor, by a grid of
    one thread block per ``per_step`` tiles of ``tile`` elements of a row
    (no grid stride).  The row length must be a multiple of
    ``tile * per_step``."""
    tile, per_step = int(tile), int(per_step)
    if per_step < 1:
        raise ValueError('per_step must be at least 1, got %d' % per_step)
    _check_probe(x, tile * per_step, 'tile * per_step')
    if x.device.type == 'cpu':
        return stream_scale_plain(x, a)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    stream = _build.current_stream(x.get_device())
    err = _build.library().stream_scale_tiled_f32(
        x.data_ptr(), y.data_ptr(), float(a), x.numel(), tile * per_step,
        x.get_device(), stream)
    if err != 0:
        raise RuntimeError('tiled stream kernel launch failed: CUDA error %d'
                           % err)
    LAUNCHES['tiled'] += 1
    return y


def pipeline_smem_bytes(tile, depth):
    """Bytes of dynamic shared memory a block of the pipelined kernel takes:
    ``depth`` stages of ``tile`` f32 elements, and a barrier and a chunk
    index per stage."""
    return depth * (tile * 4 + PIPELINE_STAGE_EXTRA_BYTES)


# the pipelined kernel's chunk counters (two uint64, zero between launches:
# the kernel's last block zeroes them), one per device and stream, so that
# no two launches in flight share one
_COUNTERS = {}


def _chunk_counter(device, stream):
    key = (device.index, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(2, dtype=torch.int64, device=device)
    return _COUNTERS[key].data_ptr()


def stream_scale_pipelined(x, a, tile, depth):
    """``a * x`` for a contiguous f32 tensor, as a new tensor, by one
    persistent grid whose blocks draw chunks of ``tile`` elements from a
    counter and stream them through ``depth`` (2 or 4) rotating
    shared-memory stages, each filled and drained by a bulk copy.  The row
    length must be a multiple of ``tile``, and
    ``pipeline_smem_bytes(tile, depth)`` must fit a block's shared
    memory."""
    tile, depth = int(tile), int(depth)
    if depth not in PIPELINE_DEPTHS:
        raise ValueError('depth must be one of %s, got %d'
                         % (PIPELINE_DEPTHS, depth))
    _check_probe(x, tile, 'tile')
    smem = pipeline_smem_bytes(tile, depth)
    if smem > _build.SMEM_PER_BLOCK:
        raise ValueError('%d stages of %d f32 elements, with a barrier and '
                         'a chunk index each, take %d bytes of shared '
                         'memory; a block has %d'
                         % (depth, tile, smem, _build.SMEM_PER_BLOCK))
    if x.device.type == 'cpu':
        return stream_scale_plain(x, a)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    stream = _build.current_stream(x.get_device())
    err = _build.library().stream_scale_pipelined_f32(
        x.data_ptr(), y.data_ptr(), float(a), x.numel(), tile, depth,
        _chunk_counter(x.device, stream), x.get_device(), stream)
    if err != 0:
        raise RuntimeError('pipelined stream kernel launch failed: CUDA '
                           'error %d' % err)
    LAUNCHES['pipelined_depth%d' % depth] += 1
    return y


def copy_lanes_plain(dst, src):
    """Plain PyTorch version of ``copy_lanes``: ``dst.copy_(src)``."""
    return dst.copy_(src)


def copy_lanes_many_plain(pairs):
    """Plain PyTorch version of ``copy_lanes_many``: ``dst.copy_(src)`` for
    every pair, in order."""
    for dst, src in pairs:
        dst.copy_(src)


def _copy_device(x):
    """The device of ``x``, where the copy kernel or its plain version
    runs; raises for any other."""
    device = x.device
    if device.type not in ('cpu', 'cuda'):
        raise ValueError('no copy kernel for device %s' % device)
    return device


def _copy_slots(dst, src, tile=0):
    """What the copy kernel asks of two views on one device (the callers
    check the device), checked (raises on the CPU as on the card), and the
    copy of ``src`` into ``dst`` as the kernel's slots, walked in column
    tiles of ``tile`` elements (0: whole rows); None for an empty copy.
    ``copy_lanes_many`` calls it for every pair of every call, so it reads
    each attribute of a view once."""
    dtype, shape = dst.dtype, dst.shape
    if dtype != src.dtype:
        raise TypeError('the copy kernel moves bytes and converts nothing '
                        '(got %s into %s)' % (src.dtype, dtype))
    size = dst.element_size()
    if size not in COPY_ELEMENT_SIZES:
        raise TypeError('the copy kernel takes elements of %s bytes, not %s'
                        % (COPY_ELEMENT_SIZES, dtype))
    if shape != src.shape or len(shape) not in (1, 2):
        raise ValueError('dst and src must be 1-D or 2-D views of one shape '
                         '(got %s, %s)' % (tuple(shape), tuple(src.shape)))
    if len(shape) == 1:
        rows, width = 1, shape[0]
        (dst_lane,), (src_lane,) = dst.stride(), src.stride()
        dst_row = src_row = width
    else:
        rows, width = shape
        dst_row, dst_lane = dst.stride()
        src_row, src_lane = src.stride()
    if width > 1 and not (dst_lane == src_lane == 1):
        raise ValueError('the copy kernel takes views with unit stride '
                         'along the lanes (got strides %s, %s)'
                         % (dst.stride(), src.stride()))
    if rows * width == 0:
        return None
    tile = tile or width
    if rows > 1 and dst_row == src_row == width and tile == width:
        # both contiguous: one long row
        rows, width, tile = 1, rows * width, rows * width
    return (dst.data_ptr(), src.data_ptr(), rows, width * size, tile * size,
            dst_row * size, src_row * size, size, 0)


# layout of the copy kernel's parameter block (csrc/copy_lanes.cu::Params),
# in int64 slots: the number of copies and a slot the kernel's entry point
# fills, then COPY_MAX copies of _COPY_SLOTS slots each
COPY_MAX = 56
_COPY_SLOTS = 9     # dst, src, rows, width, tile, dst stride, src stride
#                     (bytes), element size, a slot the entry point fills
_COPY_PARAMS = 2 + COPY_MAX * _COPY_SLOTS
_COPY_BLOCK = ctypes.c_int64 * _COPY_PARAMS


def _launch_copies(copies, index):
    """The copies (``_copy_slots``) on CUDA device ``index``, ``COPY_MAX``
    to a launch."""
    lib = _build.library()
    stream = _build.current_stream(index)
    for at in range(0, len(copies), COPY_MAX):
        batch = copies[at:at + COPY_MAX]
        params = _COPY_BLOCK()
        params[0] = len(batch)
        params[2:2 + len(batch) * _COPY_SLOTS] = [v for d in batch for v in d]
        err = lib.copy_lanes_many(ctypes.addressof(params),
                                  ctypes.sizeof(params), index, stream)
        if err != 0:
            raise RuntimeError('copy kernel launch failed: CUDA error %d'
                               % err)
        LAUNCHES['copy_lanes'] += 1


def copy_lanes_many(pairs):
    """``dst[...] = src`` for every (dst, src) pair of views in ``pairs``,
    all on one device: each pair as ``copy_lanes`` takes it (one dtype, 1-D
    or 2-D, unit stride along the lanes, any row stride).  On the card one
    launch moves them all (a launch per ``COPY_MAX`` copies), each copy
    with 16-byte accesses where its pointers, strides and width allow.  The
    destinations must not overlap any source."""
    if not pairs:
        return
    device = _copy_device(pairs[0][0])
    copies = []
    for dst, src in pairs:
        if dst.device != device or src.device != device:
            raise ValueError(
                'the copies must lie on one device, dst and src alike (got '
                '%s, %s and %s); Tensor.copy_ moves data between devices'
                % (device, dst.device, src.device))
        slots = _copy_slots(dst, src)
        if slots is not None:
            copies.append(slots)
    if device.type == 'cpu':
        copy_lanes_many_plain(pairs)
    elif copies:
        _launch_copies(copies, device.index)


def copy_lanes(dst, src):
    """``dst[...] = src`` for two (m, w) views of one dtype on one device
    with unit stride along the lanes and any row stride: a column slice of
    a row-major block into a slot of an extended operand, say.  No
    arithmetic and no conversion; f32, bf16 or any dtype of 1, 2, 4 or 8
    bytes.  The kernel uses 16-byte accesses where both base addresses,
    both row strides and the width allow, and one element per access
    elsewhere.  The one-copy case of ``copy_lanes_many``.  Returns
    ``dst``."""
    copy_lanes_many([(dst, src)])
    return dst


def hbm2hbm(x, tile):
    """A copy of the 2-D array ``x`` made in (m, ``tile``) column tiles, as
    a new tensor; ``x.shape[1]`` must be a multiple of ``tile``.

    The reference keeps four tile copies in flight on the TPU's DMA engine
    from one grid step, with no on-chip buffer.  An H100 has no
    device-to-device copy that a kernel can issue without passing an SM, so
    "four in flight" becomes "enough bytes in flight per SM": one launch
    whose blocks walk the tiles, every thread with four loads issued before
    its first store.  A launch per tile was not chosen: the stream runs
    launches in order, so every tile would pay a launch gap."""
    tile = int(tile)
    if x.dim() != 2:
        raise ValueError('hbm2hbm takes a 2-D array, got shape %s'
                         % (tuple(x.shape),))
    if tile < 1 or x.shape[1] % tile:
        raise ValueError('the row length %d is not a multiple of tile = %d'
                         % (x.shape[1], tile))
    _copy_device(x)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    slots = _copy_slots(y, x, tile)
    if x.device.type == 'cpu':
        copy_lanes_plain(y, x)
    elif slots is not None:
        _launch_copies([slots], x.get_device())
    return y


def stream_rate(device='cuda'):
    """The card's stream rate in bytes/s, read and write together, as the
    kernel measures it: ``RATE_REPS`` launches of ``y = REFERENCE_SCALE * x`` on
    a seeded f32 array of ``REFERENCE_SHAPE`` (164 MB in, 164 MB out, well
    past the L2), timed with CUDA events after a warm-up."""
    device = torch.device(device)
    if device.type != 'cuda':
        raise ValueError('the stream rate is a property of a CUDA device, '
                         'not of %s' % device)
    from ..benches.timing import time_ms
    gen = torch.Generator(device).manual_seed(RATE_SEED)
    x = torch.randn(REFERENCE_SHAPE, generator=gen, device=device)
    ms = time_ms(lambda: stream_scale(x, REFERENCE_SCALE), RATE_REPS, device)
    return 2 * x.numel() * x.element_size() / (ms / 1e3)
