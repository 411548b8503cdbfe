"""The ``raleigh.sync`` spans in the traced window over the solves traced:
the program's transfers to the host a solve."""

from ..spans import SYNC, count


def read(record):
    return count(record, SYNC)
