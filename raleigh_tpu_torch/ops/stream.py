"""Streaming scale ``y = a * x``: the card's stream rate as the port
measures it.

The CUDA kernel (``csrc/stream_scale.cu``) replaces the Pallas copy kernel
``bench.py::_extra_pallas_copy_roofline``, which reads an f32 array once
and writes it once.  ``2 * x.numel() * 4 / t`` is the rate the
memory-bound SpMM kernels are judged against.  On a CUDA tensor the
wrapper launches the kernel or raises; only a CPU tensor takes the plain
version, ``torch.mul``.
"""

import torch

from . import _build

# the shape the reference streams: 32 rows of 39 tiles of 32768 lanes
REFERENCE_SHAPE = (32, 39 * 32768)
REFERENCE_SCALE = 0.99999
# timed launches of one reading, and the seed of the array they stream
RATE_REPS = 50
RATE_SEED = 0

# kernel launches, counted where the kernel is launched
LAUNCHES = {'float32': 0}


def reset_launches():
    LAUNCHES['float32'] = 0


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
    for _ in range(3):
        stream_scale(x, REFERENCE_SCALE)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(RATE_REPS):
        stream_scale(x, REFERENCE_SCALE)
    end.record()
    end.synchronize()
    seconds = start.elapsed_time(end) / 1e3 / RATE_REPS
    return 2 * x.numel() * x.element_size() / seconds
