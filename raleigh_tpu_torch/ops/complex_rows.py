"""Complex operands and complex values on the real SpMM kernels.

A sparse row apply y = x A is linear in x and in A's values.  A complex
operand's real and imaginary rows stacked into one real (2m, n) block go
through a real-valued matrix in one launch: the two halves of the result
are the real and imaginary parts of x A.  A complex-valued matrix
A = Ar + i Ai takes two launches on that block, one with Ar's values and
one with Ai's:

    x A = (xr Ar - xi Ai) + i (xr Ai + xi Ar).

The kernels' wrappers use this on the card (the DIA kernel for c64
blocks and real operands only: a c128 block has an instantiation of its
own, ``csrc/dia_spmm.cu``); their plain versions take complex tensors
directly.  Products and sums are the real kernels'; the
sum of the two launches' halves is one more rounding for each entry of a
complex-valued matrix's result.
"""

import torch


def result_dtype(values, x):
    """The dtype of x A for values of dtype ``values`` and an operand of
    dtype ``x``: x's, made complex when the values are."""
    if x.is_complex or not values.is_complex:
        return x
    return torch.complex128 if x == torch.float64 else torch.complex64


def complex_rows(apply, values, x):
    """x A through real applies: ``apply(v, s)`` is the (rows of s, n)
    product of the real block ``s`` with the matrix whose values are the
    real tensor ``v``, for ``v`` one of ``values``' real and imaginary
    parts (or ``values`` itself when it is real).  ``x`` or ``values`` is
    complex.  Returns the complex (m, n) result."""
    return complex_parts(lambda vs, ss: [apply(vs[0], ss[0])], [values],
                         [x])[0]


def complex_parts(apply, values, xs):
    """``complex_rows`` for a matrix split into parts (the shards of a
    mesh): ``apply(vs, ss)`` takes a list of real value parts and a list of
    real operand parts and returns the list of results."""
    m = xs[0].shape[0]
    cx = xs[0].is_complex()
    s = [torch.cat((x.real, x.imag), dim=0) if cx else x for x in xs]
    if not values[0].is_complex():
        return [torch.complex(y[:m], y[m:]) for y in apply(values, s)]
    yr = apply([v.real.contiguous() for v in values], s)
    yi = apply([v.imag.contiguous() for v in values], s)
    if not cx:
        return [torch.complex(a, b) for a, b in zip(yr, yi)]
    return [torch.complex(a[:m] - b[m:], b[:m] + a[m:])
            for a, b in zip(yr, yi)]
