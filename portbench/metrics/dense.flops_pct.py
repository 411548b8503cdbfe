"""The device LOBPCG's block products at the card's f32 peak, in %: the
least work of the traced solves' iterations (``rooflines/lobpcg_dense.py``,
at the cell's block ``block``, the inputs' n, generalized where B is
given) over the device time of the matrix-product kernels in the traced
window (``PRODUCTS``: cuBLAS's, its split-K sums, the Gram kernel),
cuSOLVER's ``eigh`` kernels left out.  The least work is no more than
what is issued, so the share cannot pass 100%."""

from ..registry import module


def read(record):
    t = record.trace
    its = [i for i in record.iterations if i is not None]
    if t is None or not record.peaks or not its \
            or record.cell['engine'] == 'core':
        return None
    roof = module('rooflines', 'lobpcg_dense')
    took, _ = roof.seconds(t)
    if took <= 0:
        return None
    work = sum(its) * roof.flops(record.cell['block'], record.stats['n'],
                                 record.stats['nnz_b'] is not None)
    return 100.0 * work / roof.F32_PEAK / took
