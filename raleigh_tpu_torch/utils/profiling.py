"""Profiling helpers: the program's spans and device traces.

PyTorch port of ``raleigh_tpu/utils/profiling.py``.  ``device_trace``
records a ``torch.profiler`` trace of the host and the card.  ``span`` and
``spanned`` mark the program's layers in such a trace: each layer boundary
of a solve (``partial_hevp``, the LOBPCG and its steps, the core Solver,
the block algebra, the Chebyshev recurrence, the sparse applies, ``pca``
and the subspace engine's steps, the transfers to the host) is a
``raleigh.*`` span, a host event of the same
profiler session whose CUPTI records give the card's operations, on the
same clock.  A span exists only while a profiler records: otherwise it
costs one check and creates nothing.
"""

import contextlib
import functools
import os

from torch._C._autograd import _profiler_enabled
# the user-scope record function of ``torch.profiler.record_function``,
# entered from C++: ``record_function`` enters and leaves through two
# operator calls, which a running profiler records and times as well, and
# a solve holds thousands of spans
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()


def span(name):
    """A context that marks its block as the span ``name`` in a running
    ``torch.profiler`` trace; with no profiler recording, one shared null
    context."""
    if not _profiler_enabled():
        return _OFF
    return _RecordFunctionFast(name)


def spanned(name):
    """Decorator: every call of the function is the span ``name``
    (``span``)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with _RecordFunctionFast(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def device_trace(logdir):
    """Trace the block with ``torch.profiler``: host activity, the
    program's spans, and the card's kernels and copies where torch finds a
    card.  On leaving, the trace is written to ``logdir`` (made if missing)
    as a Chrome trace, ``trace.json``, which TensorBoard's profiler plugin
    and Perfetto read.  Yields the profiler, whose ``key_averages()`` give
    time by operator, kernel and span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))
