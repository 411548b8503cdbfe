"""Self time of the ``raleigh.subspace`` spans and those under it
(``raleigh.subspace.gram``, ``.iterate``, ``.rr``, ``.factors``) in the
traced window, in ms a solve: the subspace engine's host issue of its
products, QRs and ``eigh``, without the transfers (``raleigh.sync``)
inside.  Each instant inside the program's spans belongs to the
innermost one then open, as ``spans.self_seconds`` counts it; None where
the window holds no such span (a program without them)."""

from ..spans import spans

FAMILY = 'raleigh.subspace'


def _ours(name):
    return name == FAMILY or name.startswith(FAMILY + '.')


def read(record):
    t = record.trace
    found = [] if t is None else spans(t)
    if not any(_ours(n) for n, _, _ in found):
        return None
    took = 0.0
    open_ = []      # the spans that enclose the current one: [end, ours]
    for name, s, e in found:
        while open_ and open_[-1][0] <= s:
            open_.pop()
        here = _ours(name)
        if here:
            took += e - s
        if open_ and open_[-1][1]:
            took -= min(e, open_[-1][0]) - s
        open_.append([min(e, open_[-1][0]) if open_ else e, here])
    return 1e3 * took / t.solves
