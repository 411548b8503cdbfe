"""Streaming scale ``y = a * x``: the card's stream rate as the port
measures it, and two other launch and pipeline structures of the same copy.

``stream_scale`` (``csrc/stream_scale.cu``, a grid-stride kernel) replaces
the Pallas copy kernel ``bench.py::_extra_pallas_copy_roofline``, which
reads an f32 array once and writes it once.  ``2 * x.numel() * 4 / t`` is
the rate the memory-bound SpMM kernels are judged against.

``stream_scale_tiled`` and ``stream_scale_pipelined``
(``csrc/stream_probes.cu``) replace ``benches/bench_grid_shapes.py::
build_blockspec`` and ``build_manual``: one thread block per tile with no
grid stride, and one persistent grid whose blocks pipeline their chunks
through 2 or 4 shared-memory stages with asynchronous copies.

On a CUDA tensor each wrapper launches its kernel or raises; only a CPU
tensor takes the plain version, ``torch.mul``.
"""

import torch

from . import _build
from ..benches.timing import time_ms

# the shape the reference streams: 32 rows of 39 tiles of 32768 lanes
REFERENCE_SHAPE = (32, 39 * 32768)
REFERENCE_SCALE = 0.99999
# timed launches of one reading, and the seed of the array they stream
RATE_REPS = 50
RATE_SEED = 0

PIPELINE_DEPTHS = (2, 4)

# kernel launches, counted where the kernel is launched: the grid-stride
# kernel, the tiled one, and the pipelined one per depth
LAUNCHES = {'float32': 0, 'tiled': 0, 'pipelined_depth2': 0,
            'pipelined_depth4': 0}


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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.library().stream_scale_f32(
        x.data_ptr(), y.data_ptr(), float(a), x.numel(), x.device.index,
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.library().stream_scale_tiled_f32(
        x.data_ptr(), y.data_ptr(), float(a), x.numel(), tile * per_step,
        x.device.index, stream)
    if err != 0:
        raise RuntimeError('tiled stream kernel launch failed: CUDA error %d'
                           % err)
    LAUNCHES['tiled'] += 1
    return y


def stream_scale_pipelined(x, a, tile, depth):
    """``a * x`` for a contiguous f32 tensor, as a new tensor, by one
    persistent grid whose blocks stream chunks of ``tile`` elements through
    ``depth`` (2 or 4) rotating shared-memory stages.  The row length must
    be a multiple of ``tile``, and ``depth`` stages must fit a block's
    shared memory."""
    tile, depth = int(tile), int(depth)
    if depth not in PIPELINE_DEPTHS:
        raise ValueError('depth must be one of %s, got %d'
                         % (PIPELINE_DEPTHS, depth))
    _check_probe(x, tile, 'tile')
    if depth * tile * 4 > _build.SMEM_PER_BLOCK:
        raise ValueError('%d stages of %d f32 elements take %d bytes of '
                         'shared memory; a block has %d'
                         % (depth, tile, depth * tile * 4,
                            _build.SMEM_PER_BLOCK))
    if x.device.type == 'cpu':
        return stream_scale_plain(x, a)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.library().stream_scale_pipelined_f32(
        x.data_ptr(), y.data_ptr(), float(a), x.numel(), tile, depth,
        x.device.index, stream)
    if err != 0:
        raise RuntimeError('pipelined stream kernel launch failed: CUDA '
                           'error %d' % err)
    LAUNCHES['pipelined_depth%d' % depth] += 1
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
    gen = torch.Generator(device).manual_seed(RATE_SEED)
    x = torch.randn(REFERENCE_SHAPE, generator=gen, device=device)
    ms = time_ms(lambda: stream_scale(x, REFERENCE_SCALE), RATE_REPS, device)
    return 2 * x.numel() * x.element_size() / (ms / 1e3)
