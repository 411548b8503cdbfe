"""The Chebyshev step kernel's share of its roofline in the traced
window, in %: the sum of each launch's byte bound
(``rooflines/ell_step.py``, the mean over an apply of the cell's
Chebyshev ``degree`` steps) over the sum of the launches' device times,
at the cell's block width ``block``.  A cell whose solver narrows the
block as pairs converge (the core Solver) is not one to read: the trace
does not tell a launch's width."""

from ..registry import module
from ..rooflines import share


def read(record):
    chebyshev = record.cell.get('chebyshev')
    if not chebyshev:
        return None
    degree = chebyshev['degree']
    bound = module('rooflines', 'ell_step').launch_bytes

    def launch_bytes(name, stats, m):
        return bound(name, stats, m, degree)
    return share(record.trace, record.stats, record.cell['block'],
                 launch_bytes, record.peaks)
