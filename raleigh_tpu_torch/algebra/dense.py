"""Backend selection and the architecture-aware dense-matrix wrapper.

The port's twin of ``raleigh_tpu/algebra/dense.py`` (the reference's
``dense_cpu.py`` try-import selector and ``AMatrix`` arch switch,
raleigh/algebra/dense_cpu.py:10-17, dense_matrix.py:10-64):

  arch='cpu'             host NumPy algebra (dense_numpy)
  arch='gpu' / 'cuda'    torch algebra on the card (dense_torch); without a
                         card its blocks raise when they are made
  arch='gpu!' / 'cuda!'  the same, and raise at once if torch finds no card
"""

import numpy as np


def _have_accelerator():
    try:
        import torch
        return torch.cuda.is_available()
    except Exception:
        return False


def best_backend(arch='gpu'):
    """Return (module, name) for the requested architecture string."""
    arch = str(arch).lower()
    if arch.startswith(('gpu', 'cuda')):
        if arch.endswith('!') and not _have_accelerator():
            raise RuntimeError('cannot use the GPU: torch finds no CUDA '
                               'device')
        from . import dense_torch
        return dense_torch, 'torch'
    from . import dense_numpy
    return dense_numpy, 'numpy'


def data_matrix(a, arch=None, device=None, copy_data=False):
    """The ``AMatrix`` the dense front ends (truncated_svd, LRA, pca) work
    on: host NumPy algebra for ``arch='cpu'`` with no ``device``, else torch
    algebra on ``device`` — the card unless it names another, raising
    where torch finds none (``algebra.sparse.resolve_device``)."""
    from .sparse import resolve_device
    dev = resolve_device(arch, device)
    if dev is None:
        return AMatrix(a, arch='cpu', copy_data=copy_data)
    return AMatrix(a, arch='gpu', copy_data=copy_data, device=dev)


class AMatrix:
    """Architecture-aware wrap of a dense 2D array (reference
    raleigh/algebra/dense_matrix.py:10-64).  On the torch backend the
    array goes to ``device`` (the card unless it names another)."""

    def __init__(self, a, arch='cpu', copy_data=False, sharding=None,
                 device=None):
        self.__arch = arch
        backend, name = best_backend(arch)
        self.__backend = backend
        self.__backend_name = name
        if name == 'torch':
            self.__op = backend.Matrix(a, sharding=sharding, device=device)
        else:
            self.__op = backend.Matrix(a.copy() if copy_data else a)
        self.__vectors = None
        self.__scale = float(np.max(np.abs(a)) if a.size else 0.0)

    def as_operator(self):
        return self.__op

    def as_vectors(self):
        if self.__vectors is None:
            self.__vectors = self.__backend.Vectors(self.__op, shallow=True)
        return self.__vectors

    def arch(self):
        return self.__arch

    def backend(self):
        return self.__backend

    def backend_name(self):
        return self.__backend_name

    def gpu(self):
        # reference API compat (dense_matrix.py:50): truthy when on device
        return None

    def dots(self):
        return self.__op.dots()

    def data_type(self):
        return self.__op.data_type()

    def shape(self):
        return self.__op.shape()

    def order(self):
        return self.__op.order()

    def scale(self):
        return self.__scale
