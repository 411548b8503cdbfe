"""The Gram kernel's share of its roofline in the traced window, in %:
the sum of each Gram's byte bound (``rooflines/gram.py``: its blocks read
once, G written) over the sum of its two launches' device times.  Read on
the Laplacian alone: there every Gram's blocks (82-246 MB) are far past
the 50 MB L2, while the finite-element pencil's (8.9-26.7 MB) sit in L2
just after the kernel that wrote them, where a bound on device memory's
bytes could read over 100%."""

from ..registry import module
from ..rooflines import share


def read(record):
    return share(record.trace, record.stats, record.cell['block'],
                 module('rooflines', 'gram').launch_bytes, record.peaks)
