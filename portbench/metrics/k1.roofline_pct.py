"""K1's share of its roofline in the traced window, in %: the sum of
each launch's byte bound (``rooflines/k1.py``) over the sum of the
launches' device times, at the cell's block width ``block``.  The
populated diagonals are counted here, in the traced run alone."""

from ..registry import module
from ..rooflines import share


def read(record):
    k1 = module('rooflines', 'k1')
    if record.trace is None or not any(
            k1.is_launch(name) for name, _ in record.trace.kernels()):
        return None
    stats = dict(record.stats,
                 noff=k1.populated_diagonals(record.problem['A']))
    return share(record.trace, stats, record.cell['block'],
                 k1.launch_bytes, record.peaks)
