"""Self time of the ``raleigh.chebyshev`` spans in the traced window, in ms
a solve: the recurrence's elementwise issue and its operands' rebuilds."""

from ..spans import layer_ms


def read(record):
    return layer_ms(record, 'Chebyshev')
