"""Self time of the ``raleigh.spmm`` spans in the traced window, in ms a
solve: the sparse wrappers' checks and copies and the kernel calls."""

from ..spans import layer_ms


def read(record):
    return layer_ms(record, 'sparse ops')
