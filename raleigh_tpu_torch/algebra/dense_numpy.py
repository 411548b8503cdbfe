"""Host (NumPy) implementation of the block-vector algebra contract.

The contract (method set and semantics) is the abstract ``Vectors`` /
``Matrix`` duck type the core solver is written against; it is documented in
the reference at raleigh/core/solver.py:22-96 and implemented there in
raleigh/algebra/dense_ndarray.py + dense_numpy.py.  This file is an
independent implementation serving two roles in the TPU-native framework:

  * the differential-test oracle for the JAX device backend, and
  * the fast path for host-resident workloads (e.g. the sparse shift-invert
    pipeline, where the LDL^T solves run on the host CPU and shipping block
    vectors to the device every iteration would waste PCIe/ICI bandwidth).

Storage convention: a block of ``m`` vectors of dimension ``n`` is a
C-contiguous ``(m, n)`` ndarray — vectors are rows, so every hot contract op
is a BLAS-3 GEMM on long, contiguous operands.
"""

import numbers

import numpy as np


def _adj(a):
    """Conjugate transpose for ndarrays of any dtype kind."""
    return a.conj().T if a.dtype.kind == 'c' else a.T


def _cj(a):
    return a.conj() if a.dtype.kind == 'c' else a


class Vectors:
    """A selectable window over a block of row-vectors, NumPy storage."""

    def __init__(self, arg, nvec=0, data_type=None, shallow=False):
        if isinstance(arg, Vectors):
            f, k = arg.selected()
            block = arg._array[f:f + k, :]
            self._array = block if shallow else block.copy()
        elif isinstance(arg, Matrix):
            block = arg.data()
            self._array = block if shallow else block.copy()
            if not self._array.flags['C_CONTIGUOUS']:
                raise ValueError('Vectors storage must be C-contiguous')
        elif isinstance(arg, np.ndarray):
            self._array = arg
        elif isinstance(arg, numbers.Number):
            dt = np.float64 if data_type is None else data_type
            self._array = np.zeros((nvec, int(arg)), dtype=dt)
        else:
            # accept any array-like (e.g. a jax.Array): fetch to host
            try:
                self._array = np.ascontiguousarray(arg)
            except Exception:
                raise ValueError('cannot build Vectors from %r' % type(arg))
        m, _n = self._array.shape
        self._sel = (0, m)

    # ---- storage / selection -------------------------------------------

    def dimension(self):
        return self._array.shape[1]

    def nvec(self):
        return self._sel[1]

    def select(self, nv, first=0):
        assert first >= 0 and first + nv <= self._array.shape[0]
        self._sel = (first, nv)

    def select_all(self):
        self._sel = (0, self._array.shape[0])

    def selected(self):
        return self._sel

    def data_type(self):
        return self._array.dtype.type

    def is_complex(self):
        return self._array.dtype.kind == 'c'

    def all_data(self):
        return self._array

    def data(self, i=None):
        f, k = self._sel
        return self._array[f:f + k, :] if i is None else self._array[f + i, :]

    def new_vectors(self, arg=0, dim=None):
        if isinstance(arg, np.ndarray):
            return Vectors(arg.astype(self.data_type(), copy=True)
                           if arg.dtype != self._array.dtype else arg.copy())
        if dim is None:
            dim = self.dimension()
        return Vectors(dim, arg, self.data_type())

    def clone(self):
        return Vectors(self)

    def reference(self):
        return Vectors(self, shallow=True)

    def append(self, other, axis=0):
        if axis == 0:
            self._array = np.concatenate((self.data(), other.data()))
        else:
            self._array = np.concatenate((self._array, other.all_data()),
                                         axis=1)
        self.select_all()

    # ---- fills ----------------------------------------------------------

    def zero(self):
        self.data()[:, :] = 0

    def fill(self, value):
        self.data()[:, :] = value

    def fill_random(self):
        k, n = self.nvec(), self.dimension()
        self.data()[:, :] = 2 * np.random.rand(k, n) - 1

    def fill_orthogonal(self):
        k, n = self.nvec(), self.dimension()
        if n < k:
            raise ValueError('fill_orthogonal: more vectors than dimension')
        _hadamard_like_fill(self.data())

    # ---- contract ops (all BLAS-3 on the long dimension) ----------------

    def copy(self, other, ind=None):
        if ind is None:
            assert self.nvec() == other.nvec()
            other.data()[:, :] = self.data()
        else:
            j, _ = other.selected()
            other.all_data()[j:j + len(ind), :] = self._array[ind, :]

    def scale(self, s, multiply=False):
        k = self.nvec()
        col = np.asarray(s)[:k].reshape(k, 1)
        if multiply:
            self.data()[:, :] *= col
        else:
            safe = np.where(col == 0, 1, col)
            self.data()[:, :] /= safe

    def dots(self, other, transp=False, keep=False):
        if transp:
            # per-component dot products across the block: shape (n,)
            return np.einsum('ij,ij->j', _cj(other.data()), self.data())
        return np.einsum('ij,ij->i', _cj(other.data()), self.data())

    def dot(self, other, keep=False):
        # Gram block: rows indexed by other's vectors, cols by self's
        return _cj(other.data()) @ self.data().T

    def multiply(self, q, output):
        assert output.nvec() == q.shape[1]
        np.dot(q.T, self.data(), out=output.data())

    def add(self, other, s, q=None):
        if np.isscalar(s):
            if q is None:
                self.data()[:, :] += s * other.data()
            else:
                self.data()[:, :] += s * (q.T @ other.data())
        else:
            k = self.nvec()
            self.data()[:, :] += np.asarray(s)[:k].reshape(k, 1) * other.data()

    # ---- backend extras used by the interfaces --------------------------

    def orthogonalize(self, other):
        q = _cj(other.data()) @ self.data().T
        self.data()[:, :] -= q.T @ other.data()
        return self.new_vectors(q)

    def svd(self):
        if self.nvec() > self.dimension():
            raise ValueError(
                'cannot orthonormalize %d vectors in a %d-dimensional '
                'space; truncate the block first' %
                (self.nvec(), self.dimension()))
        u, sigma, vh = np.linalg.svd(self.data(), full_matrices=False)
        self.data()[:, :] = vh
        return sigma, _cj(u)

    def apply(self, A, output, transp=False):
        A.apply(self, output, transp=transp)


class Matrix:
    """Dense operator over NumPy storage; rows of operand blocks are vectors,
    so ``apply`` is ``y = x @ A^T`` (and ``y = x @ conj(A)`` for the adjoint),
    matching the reference semantics at raleigh/algebra/dense_numpy.py:151-186.
    """

    def __init__(self, arg):
        data = arg.data() if isinstance(arg, Vectors) else arg
        if not isinstance(data, np.ndarray):
            # accept any array-like (e.g. a jax.Array produced on device
            # and handed to the host backend): fetch to host memory
            try:
                data = np.ascontiguousarray(data)
            except Exception:
                raise ValueError('cannot build Matrix from %r' % type(arg))
        if data.flags['C_CONTIGUOUS']:
            self._order = 'C_CONTIGUOUS'
        elif data.flags['F_CONTIGUOUS']:
            self._order = 'F_CONTIGUOUS'
        else:
            raise ValueError('Matrix data must be C- or F-contiguous')
        self._data = data

    def data(self):
        return self._data

    def shape(self):
        return self._data.shape

    def data_type(self):
        return self._data.dtype.type

    def is_complex(self):
        return self._data.dtype.kind == 'c'

    def order(self):
        return self._order

    def apply(self, x, y, transp=False):
        a = self._data
        if transp:
            np.dot(x.data(), _cj(a), out=y.data())
        else:
            np.dot(x.data(), a.T, out=y.data())

    def dots(self):
        v = Vectors(self, shallow=True)
        return v.dots(v)

    def new_vectors(self, dim=None, nv=0):
        if dim is None:
            dim = self._data.shape[1]
        return Vectors(dim, nv, self.data_type())


# ---------------------------------------------------------------------------
# module-level helpers the core solver uses to batch backend round-trips;
# on the host backend they are trivial
# ---------------------------------------------------------------------------

def fetch(*arrays):
    """Materialize backend-native small arrays on the host (no-op here)."""
    return tuple(np.asarray(a) for a in arrays)


def stage_coeff(a, rows=None, cols=None):
    """Prepare a host coefficient matrix for repeated combine() use."""
    return np.asarray(a)


def combine(a, b):
    """Small-matrix product in the backend's native space."""
    return np.dot(a, b)


def rootabs(a):
    return np.sqrt(np.abs(np.asarray(a).real))


def diag_ratio(a, b):
    """re(diag(a) / diag(b)), zero where diag(b) is exactly zero (padded
    slots); host counterpart of the device helper in dense_jax.  Returned
    in float64 so downstream block combinations accumulate exactly like
    coefficients taken from the solver's float64 ``lmd`` array."""
    da = np.asarray(a).diagonal()
    db = np.asarray(b).diagonal()
    r = np.where(db == 0, np.zeros_like(da), da / np.where(db == 0, 1, db))
    r = r.real if np.iscomplexobj(r) else r
    return r.astype(np.float64)


def conjugation_beta(zay, zby, lmd_y, lmdz, sy, sz, dtype):
    """Jacobi-conjugation coefficients with the overflow guard
    (reference core/solver.py:1331-1347)."""
    zay = np.asarray(zay)
    nz, ny = zay.shape
    lmd_y = np.asarray(lmd_y)[:ny]
    lmdz = np.asarray(lmdz)[:nz]
    num = zay - np.asarray(zby) * lmd_y[None, :]
    den = lmdz[:, None] - lmd_y[None, :]
    sy = np.sqrt(np.abs(np.asarray(sy).real))[:ny]
    sz = np.sqrt(np.abs(np.asarray(sz).real))[:nz]
    ratio = sy[None, :] / np.where(sz[:, None] == 0, 1, sz[:, None])
    with np.errstate(divide='ignore', invalid='ignore'):
        beta = np.where(np.abs(num) >= 100 * ratio * np.abs(den),
                        np.zeros_like(num), num / den)
    return np.where(np.isfinite(beta), beta, 0.0).astype(dtype)


def _hadamard_like_fill(a):
    """Fill rows of ``a`` with mutually orthogonal +-1 patterns
    (Hadamard-style doubling; parity with reference
    raleigh/algebra/dense_ndarray.py:154-175)."""
    a.fill(0.0)
    m, n = a.shape
    a[0, 0] = 1.0
    i = 1
    while 2 * i < m:
        a[i:2 * i, :i] = a[:i, :i]
        a[:i, i:2 * i] = a[:i, :i]
        a[i:2 * i, i:2 * i] = -a[:i, :i]
        i *= 2
    k, j = i, 2 * i
    if j > n:
        for i in range(k, m):
            a[i, i] = 1.0
        return
    while j <= n:
        a[:k, i:j] = a[:k, :i]
        i, j = j, 2 * j
    j = i // 2
    a[k:m, :j] = a[:m - k, :j]
    a[k:m, j:i] = -a[:m - k, j:i]
