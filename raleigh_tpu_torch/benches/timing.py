"""The port's one timer: milliseconds per launch of a function.

On a CUDA device the time is taken by two CUDA events around ``reps``
launches after a warm-up, so it is device time and not the time to enqueue.
It takes the place of the JAX package's ``bench.py::_time_chain_marginal``,
whose differencing of two chain lengths cancels a dispatch round trip that
PyTorch on a local card does not have.  On the CPU, which the tests ask for
by name, the host clock times the same loop.
"""

import time

import torch

from ..ops.spmm import storage_device

WARMUP = 3


def time_ms(fn, reps, device=None):
    """Mean milliseconds of ``fn()`` over ``reps`` calls after ``WARMUP``
    calls, on ``device`` (the card unless named; raises without one)."""
    device = storage_device(device)
    for _ in range(WARMUP):
        fn()
    if device.type != 'cuda':
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
