"""Self time of the ``raleigh.dense.*`` spans in the traced window, in ms a
solve: the issue cost of the block-vector algebra contract."""

from ..spans import layer_ms


def read(record):
    return layer_ms(record, 'block algebra')
