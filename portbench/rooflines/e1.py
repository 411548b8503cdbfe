"""E1, the ELL SpMM (``raleigh_tpu_torch/csrc/ell_spmm.cu``,
``ell_rows_kernel<TV, TX, TA, V>``): y (n, m) = A x for an (n, m) operand.
A launch needs A's nonzeros as values of type TV with one int32 column
index each, the row pointer ((n + 1) int32), x read and y written in TX.
The ELL layout's padding to the widest row is not counted.  f32 values,
m = 16 on shipsec_like(): 80,927,096 bytes, 0.0242 ms at 3.35 TB/s.

The launches of a solve may apply A or, in a pencil, B; the bytes are
A's unless B has another number of nonzeros, when no launch can be
told apart and the reader reads nothing."""

import re

from . import TYPE_BYTES

_NAME = re.compile(r'ell_rows_kernel<\s*([\w:]+)\s*,\s*([\w:]+)\s*,')


def launch_bytes(name, stats, m):
    found = _NAME.search(name)
    if found is None or 'prev::' in name:   # the previous design: not E1
        return None
    if stats['nnz_b'] is not None and stats['nnz_b'] != stats['nnz']:
        return None
    tv, tx = (TYPE_BYTES[t.split('::')[-1]] for t in found.groups())
    n = stats['n']
    return stats['nnz'] * (tv + 4) + (n + 1) * 4 + 2 * n * m * tx
