"""Self time of the ``raleigh.partial_hevp`` spans in the traced window, in
ms a solve: the entry's own host work (operator look-ups, preconditioner
operands, the result's sort)."""

from ..spans import layer_ms


def read(record):
    return layer_ms(record, 'interfaces')
