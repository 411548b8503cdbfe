"""Time inside the ``raleigh.sync`` spans in the traced window, in ms a
solve: the host blocked in a transfer until the card drains."""

from ..spans import layer_ms


def read(record):
    return layer_ms(record, 'host issue')
