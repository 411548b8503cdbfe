"""E1's share of its roofline in the traced window, in %: the sum of
each launch's byte bound (``rooflines/e1.py``) over the sum of the
launches' device times, at the cell's block width ``block``."""

from ..registry import module
from ..rooflines import share


def read(record):
    return share(record.trace, record.stats, record.cell['block'],
                 module('rooflines', 'e1').launch_bytes, record.peaks)
