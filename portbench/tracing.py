"""The traced run's reading of a ``torch.profiler`` trace (CUPTI on the
card): device operations and host operations inside the window that the
benchmark's own spans mark, one span a solve."""

from collections import defaultdict

import numpy as np

SPAN = 'portbench.solve'
# device operations that are copies or fills, not kernel launches
_COPIES = ('Memcpy', 'Memset')
# idle gaps whose host activity is looked up for the breakdown
_GAPS_LOOKED_UP = 200
_NAME_CHARS = 120


def _merged(intervals):
    """The union of (start, end) intervals as a sorted list of disjoint
    ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """Device and host operations of the solves inside the window, times
    in seconds.  ``device_ops`` and ``host_ops`` are (name, start, end)
    lists, clipped to the window (start of the first span to the end of
    the last)."""

    def __init__(self, device_ops, host_ops, spans):
        if not spans:
            raise ValueError('the trace holds no %r span' % SPAN)
        self.solves = len(spans)
        self.start = min(s for s, _ in spans)
        self.end = max(e for _, e in spans)
        self.window_s = self.end - self.start
        self.device_ops = [(n, max(s, self.start), min(e, self.end))
                           for n, s, e in device_ops
                           if e > self.start and s < self.end]
        self.host_ops = [(n, s, e) for n, s, e in host_ops
                         if e > self.start and s < self.end]
        self.busy = _merged((s, e) for _, s, e in self.device_ops)
        self.busy_s = sum(e - s for s, e in self.busy)

    def kernels(self):
        """(name, seconds) of every kernel launch in the window."""
        return [(n, e - s) for n, s, e in self.device_ops
                if not n.startswith(_COPIES)]

    def breakdown(self):
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing at their middle (the
        innermost host operation then running, or 'python' between
        operations): ten of each, in seconds."""
        by_name = defaultdict(float)
        for n, s, e in self.device_ops:
            by_name[n[:_NAME_CHARS]] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        edges = [self.start] + [t for iv in self.busy for t in iv] \
            + [self.end]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        names = [n for n, _, _ in self.host_ops]
        starts = np.array([s for _, s, _ in self.host_ops])
        ends = np.array([e for _, _, e in self.host_ops])
        idle = defaultdict(float)
        for length, s, e in gaps[:_GAPS_LOOKED_UP]:
            mid = 0.5 * (s + e)
            inside = np.flatnonzero((starts <= mid) & (ends >= mid)) \
                if len(names) else []
            if len(inside):
                host = names[inside[np.argmin(ends[inside]
                                              - starts[inside])]]
            else:
                host = 'python'
            idle['host: ' + host[:_NAME_CHARS]] += length
        gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {'device_ops': [[n, t] for n, t in ops],
                'idle_gaps': [[n, t] for n, t in gaps_out]}


def collect(prof):
    """The ``Trace`` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    device_ops, host_ops, spans = [], [], []
    for ev in prof.events():
        span = ev.name == SPAN
        start, end = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.device_type == DeviceType.CPU:
            (spans if span else host_ops).append(
                (start, end) if span else (ev.name, start, end))
        elif not (span or getattr(ev, 'is_user_annotation', False)):
            device_ops.append((ev.name, start, end))
    return Trace(device_ops, host_ops, spans)
