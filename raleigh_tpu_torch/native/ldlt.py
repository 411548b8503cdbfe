"""ctypes binding for the native sparse LDL^T solver (ldlt.cpp).

The port's copy of ``raleigh_tpu/native/ldlt.py``, with the C++ sources
(``ldlt.cpp``, ``amd.cpp``, ``nd.cpp``, ``mf.cpp``, ``ilut.cpp``) copied
byte for byte: analyse / factorize / block solve / inertia on the host,
the reference's PARDISO route (raleigh/algebra/mkl_wrap.py:350-545)
replaced by native code.  The shared library is built with g++ at first
use into ``raleigh_tpu_torch/_build/libldlt.so`` (ignored by git), never
beside the sources: the build writes a temporary name and moves it into
place with ``os.replace``, so that processes building at once do not
load a half-written library.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = [os.path.join(_HERE, 'ldlt.cpp'), os.path.join(_HERE, 'amd.cpp'),
        os.path.join(_HERE, 'nd.cpp'), os.path.join(_HERE, 'mf.cpp'),
        os.path.join(_HERE, 'ilut.cpp')]
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), '_build')
_LIB = os.path.join(_BUILD_DIR, 'libldlt.so')
_lock = threading.Lock()
_lib = None
_blas_ready = False


def _find_blas():
    """Locate a BLAS shared library to power the multifrontal fronts:
    SciPy's bundled OpenBLAS first (symbol prefix 'scipy_'), the system
    BLAS otherwise."""
    import glob
    for pattern, prefix in [
            (os.path.join(os.path.dirname(np.__file__), '..', 'scipy.libs',
                          'libscipy_openblas*.so*'), 'scipy_'),
            ('/usr/lib/x86_64-linux-gnu/libblas.so.3*', ''),
    ]:
        hits = sorted(glob.glob(pattern))
        if hits:
            return hits[0], prefix
    return None, None


def _build():
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = '%s.%d.tmp' % (_LIB, os.getpid())
    cmd = ['g++', '-O3', '-march=native', '-funroll-loops', '-fopenmp',
           '-shared', '-fPIC'] + _SRC + ['-o', tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except subprocess.CalledProcessError:
        cmd.remove('-fopenmp')
        subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)   # atomic against a concurrent build


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from ..utils import env
        path = env.native_lib_path or _LIB
        if not os.path.exists(path) or (
                path == _LIB and any(os.path.getmtime(s) >
                                     os.path.getmtime(path) for s in _SRC)):
            _build()
        lib = ctypes.CDLL(path)
        i64 = ctypes.c_int64
        p64 = ctypes.POINTER(ctypes.c_int64)
        pd = ctypes.POINTER(ctypes.c_double)
        lib.ldlt_create.restype = ctypes.c_void_p
        lib.ldlt_create.argtypes = [i64, p64, p64, pd]
        lib.ldlt_destroy.argtypes = [ctypes.c_void_p]
        lib.ldlt_analyse.restype = i64
        lib.ldlt_analyse.argtypes = [ctypes.c_void_p]
        lib.ldlt_factorize.restype = i64
        lib.ldlt_factorize.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.ldlt_solve.argtypes = [ctypes.c_void_p, i64, pd, pd]
        lib.ldlt_inertia.argtypes = [ctypes.c_void_p, p64, p64, p64]
        lib.ldlt_factor_nnz.restype = i64
        lib.ldlt_factor_nnz.argtypes = [ctypes.c_void_p]
        lib.ldlt_perturbed.restype = i64
        lib.ldlt_perturbed.argtypes = [ctypes.c_void_p]
        lib.amd_order.restype = i64
        lib.amd_order.argtypes = [i64, p64, p64, p64]
        lib.nd_order.restype = i64
        lib.nd_order.argtypes = [i64, p64, p64, p64]
        lib.nd_order_salted.restype = i64
        lib.nd_order_salted.argtypes = [i64, p64, p64, p64, i64]
        lib.symbolic_lnz.restype = i64
        lib.symbolic_lnz.argtypes = [i64, p64, p64, p64]
        lib.ldltmf_create.restype = ctypes.c_void_p
        lib.ldltmf_create.argtypes = [i64, p64, p64, pd]
        lib.ldltmf_destroy.argtypes = [ctypes.c_void_p]
        lib.ldltmf_factorize.restype = i64
        lib.ldltmf_factorize.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.ldltmf_solve.argtypes = [ctypes.c_void_p, i64, pd, pd]
        lib.ldltmf_inertia.argtypes = [ctypes.c_void_p, p64, p64, p64]
        lib.ldltmf_factor_nnz.restype = i64
        lib.ldltmf_factor_nnz.argtypes = [ctypes.c_void_p]
        lib.ldltmf_perturbed.restype = i64
        lib.ldltmf_perturbed.argtypes = [ctypes.c_void_p]
        lib.ldltmf_set_blas.restype = i64
        lib.ldltmf_set_blas.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        # complex Hermitian engine (LDL^H, real D); complex data crosses
        # the boundary as interleaved float64 pairs
        lib.zldltmf_create.restype = ctypes.c_void_p
        lib.zldltmf_create.argtypes = [i64, p64, p64, pd]
        lib.zldltmf_destroy.argtypes = [ctypes.c_void_p]
        lib.zldltmf_factorize.restype = i64
        lib.zldltmf_factorize.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.zldltmf_solve.argtypes = [ctypes.c_void_p, i64, pd, pd]
        lib.zldltmf_inertia.argtypes = [ctypes.c_void_p, p64, p64, p64]
        lib.zldltmf_factor_nnz.restype = i64
        lib.zldltmf_factor_nnz.argtypes = [ctypes.c_void_p]
        lib.zldltmf_perturbed.restype = i64
        lib.zldltmf_perturbed.argtypes = [ctypes.c_void_p]
        # threshold incomplete LU (ilut.cpp)
        lib.ilut_create.restype = ctypes.c_void_p
        lib.ilut_create.argtypes = [i64, p64, p64, pd]
        lib.ilut_destroy.argtypes = [ctypes.c_void_p]
        lib.ilut_factorize.restype = i64
        lib.ilut_factorize.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                       i64]
        lib.ilut_factor_nnz.restype = i64
        lib.ilut_factor_nnz.argtypes = [ctypes.c_void_p]
        lib.ilut_solve.argtypes = [ctypes.c_void_p, i64, pd]
        global _blas_ready
        path, prefix = _find_blas()
        if path is not None:
            _blas_ready = lib.ldltmf_set_blas(
                path.encode(), prefix.encode()) == 0
        _lib = lib
        return lib


def _pattern64(a):
    import scipy.sparse as scs
    a = scs.csc_matrix(a)
    return (a.shape[0], a.indptr.astype(np.int64),
            a.indices.astype(np.int64))


def _order_native(fn_name, n, ap, ai):
    lib = _load()
    perm = np.empty(n, dtype=np.int64)
    status = getattr(lib, fn_name)(ctypes.c_int64(n), _ptr64(ap),
                                   _ptr64(ai), _ptr64(perm))
    if status != 0:
        raise RuntimeError('%s failed with status %d' % (fn_name, status))
    return perm


def amd_ordering(a):
    """Fill-reducing AMD permutation of a symmetric scipy sparse matrix
    (native amd.cpp)."""
    return _order_native('amd_order', *_pattern64(a))


def nd_ordering(a):
    """Incomplete nested-dissection permutation (native nd.cpp)."""
    return _order_native('nd_order', *_pattern64(a))


def symbolic_factor_nnz(a, perm):
    """Exact LDL^T factor nnz of P A P^T for a candidate ordering (native
    elimination-tree column counts; nd.cpp)."""
    lib = _load()
    n, ap, ai = _pattern64(a)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    return int(lib.symbolic_lnz(ctypes.c_int64(n), _ptr64(ap), _ptr64(ai),
                                _ptr64(perm)))


# process-level ordering cache: fill-reducing orderings depend only on
# the sparsity PATTERN, and production workloads factorize the same
# structure many times (shift sweeps, buckling continuation, repeated
# solves) — the reference's PARDISO likewise separates analyse from
# factorize for exactly this reuse (reference mkl_wrap.py:411-436)
_ORDER_CACHE = {}
_ORDER_CACHE_MAX = 8


def _pattern_key(n, ap, ai):
    import hashlib
    h = hashlib.sha1()
    h.update(ap.tobytes())
    h.update(ai.tobytes())
    return (int(n), int(ai.size), h.hexdigest())


def best_ordering(a, verb=0):
    """AMD and nested-dissection permutations are both cheap next to the
    numeric factorization; count the exact symbolic fill of each and keep
    the winner — the same ordering competition PARDISO runs internally.
    The two candidates (and their exact fill counts) run concurrently:
    ctypes releases the GIL, so the competition costs one ordering, not
    two, in wall-clock."""
    from concurrent.futures import ThreadPoolExecutor

    n, ap, ai = _pattern64(a)
    lib = _load()

    key = _pattern_key(n, ap, ai)
    hit = _ORDER_CACHE.get(key)
    if hit is not None:
        if verb > 0:
            print('ordering: pattern cache hit')
        return hit

    # stencil fast path: a regular-grid pattern collapses onto a handful
    # of distinct diagonals, and nested dissection is the known winner
    # on grid graphs (grid separators are asymptotically optimal;
    # measured 5.8x on the FE-class pin, STATUS.md) — skip the AMD
    # candidate and its exact symbolic count
    if n >= 50000:
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ap))
        if np.unique(ai - rows).size <= 32:
            if verb > 0:
                print('ordering: stencil pattern -> nd')
            perm = _order_native('nd_order', n, ap, ai)
            _order_cache_put(key, perm)
            return perm

    def _candidate(fn_name, salt=None):
        if salt is None:
            perm = _order_native(fn_name, n, ap, ai)
        else:
            perm = np.empty(n, dtype=np.int64)
            status = lib.nd_order_salted(ctypes.c_int64(n), _ptr64(ap),
                                         _ptr64(ai), _ptr64(perm),
                                         ctypes.c_int64(salt))
            if status != 0:
                raise RuntimeError('nd_order_salted failed (%d)' % status)
        fill = int(lib.symbolic_lnz(ctypes.c_int64(n), _ptr64(ap),
                                    _ptr64(ai), _ptr64(perm)))
        return perm, fill

    # three candidates, ranked by exact symbolic fill: AMD plus two
    # salted nested dissections (the salt reseeds every matching /
    # initial-cut tie-break — measured ±3% fill spread, so the
    # best-of-2 is a real quality lever).  ctypes releases the GIL, so
    # the competition overlaps on the available cores.
    with ThreadPoolExecutor(max_workers=5) as pool:
        futs = [pool.submit(_candidate, 'amd_order')] + [
            pool.submit(_candidate, 'nd_order', s) for s in range(4)]
        results = [f.result() for f in futs]
    fills = [f for _, f in results]
    best = int(np.argmin(fills))
    if verb > 0:
        print('ordering: amd fill %d, nd fills %s -> %s'
              % (fills[0], fills[1:],
                 'amd' if best == 0 else 'nd%d' % (best - 1)))
    perm = results[best][0]
    _order_cache_put(key, perm)
    return perm


def _order_cache_put(key, perm):
    if len(_ORDER_CACHE) >= _ORDER_CACHE_MAX:
        _ORDER_CACHE.pop(next(iter(_ORDER_CACHE)))
    _ORDER_CACHE[key] = perm


def native_available():
    try:
        _load()
        return True
    except Exception:
        return False


def _ptr64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _ptrd(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class SparseLDLT:
    """LDL^T factorization of a real symmetric scipy sparse matrix with a
    fill-reducing permutation computed host-side (reverse Cuthill-McKee).

    Parity with the capability set of reference mkl_wrap.ParDiSo:
    ``analyse`` ~ phase 11, ``factorize`` ~ phase 22, ``solve`` ~ phase 33
    with block RHS, ``inertia`` ~ iparm[21..22].
    """

    def __init__(self, a, pivot_rel_eps=1e-14, ordering='auto', method='mf'):
        import scipy.sparse as scs

        a = scs.csr_matrix(a)
        n = a.shape[0]
        if a.shape[0] != a.shape[1]:
            raise ValueError('matrix must be square')
        self.n = n
        self._lib = _load()
        if method == 'auto':
            method = 'mf'
        self.complex = a.dtype.kind == 'c'
        if self.complex and method != 'mf':
            method = 'mf'   # the Hermitian LDL^H lives in the mf engine only
        self.method = method
        if self.complex:
            self._pre = 'zldltmf_'
        else:
            self._pre = 'ldltmf_' if method == 'mf' else 'ldlt_'
        if ordering == 'auto':
            perm = best_ordering(a)
        elif ordering == 'amd':
            perm = amd_ordering(a)
        elif ordering == 'nd':
            perm = nd_ordering(a)
        elif ordering == 'rcm':
            from scipy.sparse.csgraph import reverse_cuthill_mckee
            perm = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True),
                              dtype=np.int64)
        else:  # 'natural'
            perm = np.arange(n, dtype=np.int64)
        self.perm = perm
        self.iperm = np.empty_like(perm)
        self.iperm[perm] = np.arange(n, dtype=np.int64)
        ap = a[perm, :][:, perm]
        # upper-tri CSC == lower-tri CSR of the permuted matrix
        upper_csc = scs.triu(ap, format='csc')
        upper_csc.sort_indices()
        scalar = np.complex128 if self.complex else np.float64
        data = np.ascontiguousarray(upper_csc.data.astype(scalar))
        self._ind = (upper_csc.indptr.astype(np.int64),
                     upper_csc.indices.astype(np.int64), data)
        self._h = getattr(self._lib, self._pre + 'create')(
            ctypes.c_int64(n), _ptr64(self._ind[0]), _ptr64(self._ind[1]),
            _ptrd(self._ind[2].view(np.float64)))
        self._pivot_rel_eps = pivot_rel_eps
        self.factor_nnz = 0

    def analyse(self):
        if self.method == 'mf':
            return 0   # symbolic analysis runs inside create/factorize
        return int(self._lib.ldlt_analyse(self._h))

    def factorize(self):
        status = int(getattr(self._lib, self._pre + 'factorize')(
            self._h, ctypes.c_double(self._pivot_rel_eps)))
        if status < 0:
            raise RuntimeError('LDL^T factorization failed at column %d'
                               % (-status - 1))
        self.factor_nnz = int(getattr(self._lib,
                                      self._pre + 'factor_nnz')(self._h))
        return status

    def solve(self, b, x=None):
        """Solve A x = b; ``b`` is (nrhs, n) (rows are right-hand sides) or
        (n,).  Returns x of the same shape."""
        scalar = np.complex128 if self.complex else np.float64
        b = np.asarray(b, dtype=scalar)
        one_d = b.ndim == 1
        if one_d:
            b = b.reshape(1, -1)
        nrhs, n = b.shape
        # permute and transpose to RHS-contiguous (n, nrhs) layout
        bp = np.ascontiguousarray(b[:, self.perm].T)
        getattr(self._lib, self._pre + 'solve')(
            self._h, ctypes.c_int64(nrhs), _ptrd(bp.view(np.float64)),
            _ptrd(bp.view(np.float64)))
        out = bp.T[:, self.iperm]
        if x is not None:
            x[...] = out.reshape(x.shape)
            return x
        return out[0] if one_d else out

    def inertia(self):
        neg = ctypes.c_int64()
        pos = ctypes.c_int64()
        zero = ctypes.c_int64()
        getattr(self._lib, self._pre + 'inertia')(self._h, ctypes.byref(neg), ctypes.byref(pos),
                               ctypes.byref(zero))
        return int(neg.value), int(pos.value)

    def perturbed_pivots(self):
        return int(getattr(self._lib, self._pre + 'perturbed')(self._h))

    def __del__(self):
        try:
            if getattr(self, '_h', None):
                getattr(self._lib, self._pre + 'destroy')(self._h)
                self._h = None
        except Exception:
            pass


class ILUT:
    """Native threshold incomplete-LU factorization (ilut.cpp) with the
    reference's knobs: drop tolerance relative to the row norm and a
    per-row fill cap derived from the average input row density
    (reference raleigh/algebra/mkl_wrap.py:305-331 dcsrilut semantics:
    ``max_fill_abs = min(n - 1, avg_row_nnz * max_fill_rel)``)."""

    def __init__(self, a):
        import scipy.sparse as scs

        a = scs.csr_matrix(a).astype(np.float64)
        a.sort_indices()
        n = a.shape[0]
        if a.shape[0] != a.shape[1]:
            raise ValueError('matrix must be square')
        self.n = n
        self.avg_row_nnz = max(1, a.nnz // n)
        self._lib = _load()
        self._ind = (a.indptr.astype(np.int64),
                     a.indices.astype(np.int64),
                     np.ascontiguousarray(a.data))
        self._h = self._lib.ilut_create(
            ctypes.c_int64(n), _ptr64(self._ind[0]), _ptr64(self._ind[1]),
            _ptrd(self._ind[2]))
        self.factor_nnz = 0

    def factorize(self, tol=1e-6, max_fill=1):
        maxfil = int(min(self.n - 1, self.avg_row_nnz * max_fill))
        nnz = int(self._lib.ilut_factorize(
            self._h, ctypes.c_double(tol), ctypes.c_int64(max(1, maxfil))))
        if nnz < 0:
            raise RuntimeError('ILUT broke down at row %d (zero row?)'
                               % (-nnz - 1))
        self.factor_nnz = nnz
        return nnz

    def solve(self, b):
        """Solve L U x = b for block ``b`` of row right-hand sides
        ((nrhs, n) or (n,)); returns x of the same shape."""
        if self.factor_nnz == 0:
            self.factorize()
        b = np.asarray(b, dtype=np.float64)
        one_d = b.ndim == 1
        if one_d:
            b = b.reshape(1, -1)
        nrhs = b.shape[0]
        # RHS-contiguous (n, nrhs); unconditional copy — the native solve
        # overwrites its buffer in place, and for nrhs == 1 an
        # ascontiguousarray of b.T would alias the caller's data
        bt = b.T.copy(order='C')
        self._lib.ilut_solve(self._h, ctypes.c_int64(nrhs), _ptrd(bt))
        out = bt.T
        return out[0] if one_d else out

    def __del__(self):
        try:
            if getattr(self, '_h', None):
                self._lib.ilut_destroy(self._h)
                self._h = None
        except Exception:
            pass
