"""The Chebyshev step (``raleigh_tpu_torch/csrc/ell_spmm.cu``,
``ell_step_kernel<TV, TX, TA, V>``): one degree step of the recurrence
on (n, m) iterates, E1's row sums over the gathered d with the step's
update (r' = r - A d, y' = y + d, d' = c1 d + c2 r') as their epilogue.
A middle step needs what E1 needs of A (its nonzeros as values of type
TV with one int32 column index each, the (n + 1) int32 row pointer), d
read once, r and y read, and r', y' and d' written in TX: six (n, m)
blocks.  The first step reads no y (five blocks); the last gathers
nothing and reads d and y and writes y (three; two when it is the first
too).  An apply of ``degree`` steps is one first, ``degree`` - 2 middle
and one last step, and the profiler's name does not tell them apart, so
a launch is counted at the mean of its apply's steps.  f32 values, m =
16 on shipsec_like(): a middle step 116,557,720 bytes, 0.0348 ms at 3.35
TB/s; degree 32, the mean 113,472,007.25 (0.0339 ms)."""

import re

from . import TYPE_BYTES

_NAME = re.compile(r'ell_step_kernel<\s*([\w:]+)\s*,\s*([\w:]+)\s*,')


def step_bytes(name, stats, m, first, last):
    """The bytes one launch at its place in the recurrence needs, or None
    when ``name`` is not the step kernel."""
    found = _NAME.search(name)
    if found is None:
        return None
    tv, tx = (TYPE_BYTES[t.split('::')[-1]] for t in found.groups())
    n = stats['n']
    block = n * m * tx
    if last:
        return (2 if first else 3) * block
    return (stats['nnz'] * (tv + 4) + (n + 1) * 4
            + (5 if first else 6) * block)


def launch_bytes(name, stats, m, degree):
    """The mean bytes of a launch over an apply of ``degree`` steps, or
    None when ``name`` is not the step kernel."""
    steps = [step_bytes(name, stats, m, i == 0, i == degree - 1)
             for i in range(degree)]
    return None if not steps or steps[0] is None else sum(steps) / degree
