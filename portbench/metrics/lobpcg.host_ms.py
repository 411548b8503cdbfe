"""Self time of the ``raleigh.lobpcg`` spans and those under it
(``raleigh.lobpcg.step``, ``raleigh.lobpcg.eigh``) in the traced window,
in ms a solve: the device LOBPCG's eager issue of its block operations,
``eigh`` included."""

from ..spans import layer_ms


def read(record):
    return layer_ms(record, 'device solver')
