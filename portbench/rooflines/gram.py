"""The Gram kernel (``raleigh_tpu_torch/csrc/gram.cu``): G (ma, mb) = A Bᵀ
for f32 row blocks A (ma, n) and B (mb, n), named by the profiler
``gram_gemm_kernel<T, ma, mb, self>``, then ``gram_gemm_sum_kernel<T, ma,
mb>``, which sums the first launch's partial tiles.  A Gram needs A and B
read once (A alone for a self-Gram, B being A) and G written: (ma + mb) n
or ma n values of T read, ma mb written, all counted on the first launch;
the sum reads and writes only what the first left in scratch, so it is
counted at 0 bytes and its time with the Gram's.  At n = 1,280,000: a
(16, 16) Gram 163,841,024 bytes (0.0489 ms at 3.35 TB/s), a self-Gram
81,921,024, a (48, 48) Gram 491,529,216 (0.1467 ms)."""

import re

from . import TYPE_BYTES

_NAME = re.compile(r'gram_gemm_(sum_)?kernel<\s*([\w:]+)\s*,\s*(\d+)\s*,'
                   r'\s*(\d+)\s*(?:,\s*(true|false)\s*)?>')


def launch_bytes(name, stats, m):
    """The bytes a launch named ``name`` needs at the problem's n
    (``stats['n']``; the widths come from the name, not from ``m``), or
    None when ``name`` is not the Gram kernel's."""
    found = _NAME.search(name)
    if found is None:
        return None
    if found.group(1):
        return 0
    t = TYPE_BYTES[found.group(2).split('::')[-1]]
    ma, mb = int(found.group(3)), int(found.group(4))
    rows = ma if found.group(5) == 'true' else ma + mb
    return (rows * stats['n'] + ma * mb) * t
