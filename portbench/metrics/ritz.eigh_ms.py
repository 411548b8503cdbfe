"""Device time of cuSOLVER's symmetric eigensolver kernels (``EIGH`` of
``rooflines/lobpcg_dense.py``) in the traced window, in ms a solve: the
device LOBPCG's whitenings at the block's width and its Rayleigh-Ritz
problem at three times it, in float64."""

from ..registry import module


def read(record):
    t = record.trace
    if t is None:
        return None
    roof = module('rooflines', 'lobpcg_dense')
    _, took = roof.seconds(t)
    return 1e3 * took / t.solves if took > 0 else None
