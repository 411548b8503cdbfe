"""Device time of cuSOLVER's Householder QR kernels in the traced window,
in ms a solve: the kernels whose names hold ``geqr``, ``larf``,
``orgqr``, ``org2r``, ``ormqr`` or ``orm2r`` (the GEMMs that cuSOLVER's
blocked QR launches count as GEMMs, not here)."""

import re

_QR = re.compile(r'geqr|larf|orgqr|org2r|ormqr|orm2r', re.IGNORECASE)


def read(record):
    t = record.trace
    if t is None:
        return None
    took = sum(s for n, s in t.kernels() if _QR.search(n))
    return 1e3 * took / t.solves if took > 0 else None
