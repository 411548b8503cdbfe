"""Kernel launches on the device in the traced window over the solves
traced."""


def read(record):
    t = record.trace
    if t is None:
        return None
    launches = len(t.kernels())
    return launches / t.solves if launches else None
