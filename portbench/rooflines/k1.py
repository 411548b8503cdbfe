"""K1, the DIA SpMM (``raleigh_tpu_torch/csrc/dia_spmm.cu``): y (m, n) =
x A for an (m, n) row block.  ``dia_lanes_kernel<T>`` reads f32 values
and a T operand; ``wide::dia_lanes_kernel<V>`` reads V values and an f64
operand.  A launch needs the populated diagonals' values (noff x n), x
read and y written.  lap3d(100,100,128) at m = 16: f32 199,680,000 bytes
(0.0596 ms at 3.35 TB/s), bf16 x and y 117,760,000 (0.0352 ms)."""

import re

import numpy as np

from . import TYPE_BYTES

_NAME = re.compile(r'(wide::)?dia_lanes_kernel<\s*([\w:]+)\s*>')


def _found(name):
    found = _NAME.search(name)
    return None if 'prev::' in name else found   # the previous design


def is_launch(name):
    """Whether the profiler's ``name`` is a launch of K1."""
    return _found(name) is not None


def launch_bytes(name, stats, m):
    found = _found(name)
    if found is None:
        return None
    t = TYPE_BYTES[found.group(2).split('::')[-1]]
    val, x = (t, 8) if found.group(1) else (4, t)
    n = stats['n']
    return stats['noff'] * n * val + 2 * n * m * x


def populated_diagonals(a):
    """The number of A's diagonals that hold a nonzero (``noff``)."""
    a = a.tocsr()
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    return int(np.unique(a.indices - rows).size)
