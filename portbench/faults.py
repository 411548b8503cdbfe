"""Faults planted under the timed path, for the readings that set the
upper ends of the limits and for the tests that see ``correct`` come out
false: each is a context manager that breaks the program while it is
open.  A cell on one card can have three: a step that returns its state
unchanged, half of the block left out, an answer altered where it is
produced.  (The fourth, the exchange between cards left out, needs a cell
on several cards.)"""

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(module, **new):
    old = {name: getattr(module, name) for name in new}
    for name, fn in new.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in old.items():
            setattr(module, name, fn)


def unchanged():
    """Every sparse apply returns its operand: A x = x."""
    from raleigh_tpu_torch.ops import spmm
    return _patched(
        spmm, dia_matmat_rows=lambda val, x, off: x,
        _ell_matmat=lambda idx, val, xt, rows=False, tag=():
        xt.T.contiguous() if rows else xt)


def half_left_out():
    """Every sparse apply leaves the second half of the block's vectors
    out of its result."""
    from raleigh_tpu_torch.ops import spmm
    dia, ell = spmm.dia_matmat_rows, spmm._ell_matmat

    def dia_half(val, x, off):
        y = dia(val, x, off).clone()
        y[x.shape[0] // 2:] = 0
        return y

    def ell_half(idx, val, xt, rows=False, tag=()):
        y = ell(idx, val, xt, rows, tag).clone()
        if rows:
            y[xt.shape[1] // 2:] = 0
        else:
            y[:, xt.shape[1] // 2:] = 0
        return y
    return _patched(spmm, dia_matmat_rows=dia_half, _ell_matmat=ell_half)


def altered_answer():
    """``partial_hevp`` returns its first eigenvector with the entries
    moved one place along."""
    import raleigh_tpu_torch
    inner = raleigh_tpu_torch.partial_hevp

    def altered(*args, **kw):
        lmd, x, status = inner(*args, **kw)
        if x is not None:
            x = x.copy()
            x[:, 0] = np.roll(x[:, 0], 1)
        return lmd, x, status
    return _patched(raleigh_tpu_torch, partial_hevp=altered)


FAULTS = {'unchanged': unchanged, 'half_left_out': half_left_out,
          'altered_answer': altered_answer}
