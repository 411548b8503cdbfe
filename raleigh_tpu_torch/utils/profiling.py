"""Profiling helpers: per-phase wall timers and device traces.

PyTorch port of ``raleigh_tpu/utils/profiling.py``.  The reference keeps
ad-hoc operator-time counters (e.g. _OperatorSVD.time, reference
interfaces/partial_svd.py:244-291); this module generalizes that into a
named-timer registry and adds a ``torch.profiler`` trace of the host and
the card for the device path.
"""

import contextlib
import os
import time
from collections import defaultdict


class Timers:
    """Named accumulating wall timers."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name):
        start = time.time()
        try:
            yield
        finally:
            self.total[name] += time.time() - start
            self.count[name] += 1

    def report(self):
        lines = []
        for name in sorted(self.total, key=self.total.get, reverse=True):
            lines.append('%-28s %8.3f s  x%d'
                         % (name, self.total[name], self.count[name]))
        return '\n'.join(lines)


timers = Timers()


@contextlib.contextmanager
def device_trace(logdir):
    """Trace the block with ``torch.profiler``: host activity, and the
    card's kernels and copies where torch finds a card.  On leaving, the
    trace is written to ``logdir`` (made if missing) as a Chrome trace,
    ``trace.json``, which TensorBoard's profiler plugin and Perfetto read.
    Yields the profiler, whose ``key_averages()`` give time by operator
    and kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


class TimedOperator:
    """Wrap any operator with an accumulated apply-time counter
    (parity with the reference's operator-time metric)."""

    def __init__(self, op, name='operator'):
        self.op = op
        self.name = name
        self.time = 0.0
        self.calls = 0

    def apply(self, x, y, **kw):
        start = time.time()
        self.op.apply(x, y, **kw)
        self.time += time.time() - start
        self.calls += 1

    def __getattr__(self, item):
        return getattr(self.op, item)
