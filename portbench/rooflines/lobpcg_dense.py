"""The least work of the device LOBPCG's block products in one iteration
(the program's ``core/device_solver.py::_Step``), counted from the shapes
alone, whatever implements them: for block m, n rows, and B given
(a generalized problem),

* the (3m x 3m) Rayleigh-Ritz A-Gram of the basis S = [X; W; P],
  symmetric: 3m (3m + 1) n;
* the new X, AX and BX from S, AS and BS: 3 x 2 (3m) m n;
* the new P, AP and BP from the W and P rows alone: 3 x 2 (2m) m n.

Without B, BX and BP are X and P, and two of each three products go.
The whitening Grams, the orthogonalisations and the ``eigh`` calls are
left out.  m = 64, n = 139,179 with B: 22,259,732,544 FLOP, 0.333 ms at
``F32_PEAK`` (TF32 off: f32 outside the tensor cores).

The kernels the products run in, and those of the ``eigh`` calls, by the
names the profiler gives them (read on an H100 in a traced solve of
``shipsec1_modal48.lobpcg48``):

* ``PRODUCTS``: cuBLAS's matrix products (``gemm``, ``gemv``, ``nvjet``,
  ``xmma``), the sums of its split-K products (``splitKreduce``) and the
  Gram kernel (``gram_gemm_kernel``, ``gram_gemm_sum_kernel``);
* ``EIGH``: cuSOLVER's symmetric eigensolvers.  The whitenings' f32
  problems run in its batched Jacobi (``syevbj_batch``, ``row_rotate``,
  ``column_rotate``, ``offA``, ``batch_FnrmA``, ``colperm``,
  ``batch_symmetrize``, ``batch_eye``, ``lascl``, the ``syevj`` kernels
  and its ``pegasus`` sorts), the Rayleigh-Ritz problem's f64 in its
  divide and conquer (``sytrd``, ``setup_vhat``, ``syr2k``, ``larft``,
  ``ormtr``, ``gemmcn_skinny``, the f64 products ``f64f64``, ``stedc``'s
  ``laed``, ``steqr``, ``merge_ker``, ``scale_max``, ``lansy``,
  ``lacpy``), and both in the info kernels.  The iteration's own
  products are f32, so an f64 product in the window is an ``eigh``'s.

A kernel that both match counts as ``EIGH``'s alone."""

import re

from .subspace_pca import F32_PEAK  # noqa: F401  (the readers' peak)

PRODUCTS = re.compile(r'gemm|gemv|nvjet|xmma|splitKreduce', re.IGNORECASE)
EIGH = re.compile(
    r'syev|row_rotate|column_rotate|offA_stage|batch_FnrmA|colperm|'
    r'batch_symmetrize|batch_eye|lascl|pegasus|sytrd|setup_vhat|syr2k|'
    r'larft|ormtr|orgtr|gemmcn_skinny|f64f64|stedc|laed|steqr|sterf|'
    r'merge_ker|scale_max|lansy|lacpy|info_ker', re.IGNORECASE)


def flops(m, n, generalized=True):
    """The least FLOP count of one iteration (an integer)."""
    images = 3 if generalized else 2
    return (3 * m * (3 * m + 1) * n + images * 2 * 3 * m * m * n
            + images * 2 * 2 * m * m * n)


def seconds(trace):
    """(products, eigh): the device seconds of the traced window's kernels
    that ``PRODUCTS`` and ``EIGH`` match, each kernel counted once."""
    products = eigh = 0.0
    for name, took in trace.kernels():
        if EIGH.search(name):
            eigh += took
        elif PRODUCTS.search(name):
            products += took
    return products, eigh
