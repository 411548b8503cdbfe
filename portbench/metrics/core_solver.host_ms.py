"""Self time of the ``raleigh.core_solver`` span in the traced window, in
ms a solve: the core Solver's NumPy and SciPy work between its calls of
the block algebra."""

from ..spans import layer_ms


def read(record):
    return layer_ms(record, 'core solver')
