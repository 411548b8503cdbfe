"""Device time of PyTorch's elementwise kernels (the names that hold
``elementwise_kernel``: arithmetic, casts, copies) in the traced window,
in ms a solve: the Chebyshev recurrence's and the block algebra's eager
ops."""


def read(record):
    t = record.trace
    if t is None:
        return None
    took = sum(s for n, s in t.kernels() if 'elementwise_kernel' in n)
    return 1e3 * took / t.solves if took > 0 else None
