"""Device time of cuBLAS's matrix products (kernel names that hold
``gemm``, ``gemv``, ``nvjet`` or ``xmma``) in the traced window, in ms a
solve: the Grams and the Rayleigh-Ritz updates."""

import re

_GEMM = re.compile(r'gemm|gemv|nvjet|xmma', re.IGNORECASE)


def read(record):
    t = record.trace
    if t is None:
        return None
    took = sum(s for n, s in t.kernels() if _GEMM.search(n))
    return 1e3 * took / t.solves if took > 0 else None
