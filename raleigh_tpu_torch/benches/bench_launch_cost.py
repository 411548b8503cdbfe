"""Host cost of one kernel launch through the port's wrappers, by part.

A sharded apply is many small launches (per shard three copies and one
SpMM), and at that size the host, not the card, sets the pace.  This
probe times, on the host clock over many calls with the device kept busy
but never waited for, one halo copy through ``ops.stream.copy_lanes``
(16 x 10,000 f32 lanes out of 16 x 160,000), the same copy through
``Tensor.copy_``, and the wrapper's parts on their own: its checks, the
look-up of the current stream, the reading of pointers and strides, and
the bare call into the kernel library.

Usage: python -m raleigh_tpu_torch.benches.bench_launch_cost [--reps R]

It needs the card (the parts are those of a CUDA launch) and raises
without one.
"""

import argparse
import time

import torch

from ..ops import _build
from ..ops import stream as st
from ..ops.spmm import storage_device

M, N_LOCAL, HALO = 16, 160000, 10000


def _host_us(fn, reps):
    """Microseconds of host time per call of ``fn`` over ``reps`` calls."""
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def main(argv=None):
    """Prints one line per part and returns {part: microseconds}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--reps', type=int, default=20000)
    args = ap.parse_args(argv)
    device = storage_device(None)
    src = torch.randn((M, N_LOCAL), device=device)
    ext = torch.zeros((M, N_LOCAL + 2 * HALO), device=device)
    sv, dk = src[:, N_LOCAL - HALO:], ext[:, :HALO]
    lib = _build.library()
    size = sv.element_size()
    raw = (dk.data_ptr(), sv.data_ptr(), M, HALO * size, HALO * size,
           dk.stride(0) * size, sv.stride(0) * size, size, dk.device.index,
           torch.cuda.current_stream(device).cuda_stream)
    parts = {
        'copy_lanes, the whole wrapper': lambda: st.copy_lanes(dk, sv),
        'Tensor.copy_': lambda: dk.copy_(sv),
        'the wrapper\'s checks': lambda: st._check_copy(dk, sv),
        'current stream look-up':
            lambda: torch.cuda.current_stream(dk.device).cuda_stream,
        'pointers, strides, sizes': lambda: (
            dk.data_ptr(), sv.data_ptr(), dk.stride(0), sv.stride(0),
            dk.element_size(), dk.shape),
        'call into the kernel library': lambda: lib.copy_lanes(*raw),
    }
    print('host time per call, halo copy of (%d, %d) f32 on %s'
          % (M, HALO, torch.cuda.get_device_name(device)))
    out = {}
    for name, fn in parts.items():
        out[name] = _host_us(fn, args.reps)
        print('%-32s %7.2f us' % (name, out[name]), flush=True)
    return out


if __name__ == '__main__':
    main()
