"""Sparse symmetric operators, direct solver, and preconditioners.

PyTorch port of ``raleigh_tpu/algebra/sparse.py``:

  * ``SparseSymmetricMatrix``  SpMM on (m, n) row blocks — host SciPy CSR
    for ndarrays and host ``Vectors``, the DIA, ELL or BSR device matrix
    (ops/spmm.py) for tensors and ``dense_torch.Vectors``, sharded ones
    too;
  * ``SparseSymmetricSolver``  shift-and-invert operator (A - sigma B)^-1
    backed by the native C++ LDL^T (native/ldlt.cpp) with inertia;
  * ``IncompleteLU``           threshold ILU preconditioner (native ILUT);
  * ``spectral_bounds``        (lo, hi) bounds on a spectrum, on the host;
  * ``Chebyshev``              polynomial approximation to A^-1 on
    [lo, hi], a recurrence of ``degree`` SpMMs that runs on the device;
  * ``Operator``               adapter giving an object with an
    ndarray-level ``apply`` the tensor and ``Vectors`` interfaces.
"""

import numpy as np
import scipy.sparse as scs
import torch

from ..ops.spmm import (_device_layout, _to_full_csr, rows_matmat_operands,
                        rows_step_operands, storage_device, torch_dtype)
from ..parallel.mesh import ShardedRows
from ..utils import verbosity
from ..utils.profiling import span, spanned


def _vec_data(x):
    """The host array of a ``Vectors`` (one transfer from the card for
    ``dense_torch``), or x itself."""
    d = getattr(x, 'data', None)
    return x if d is None or not callable(d) else d()


def _rows_apply(dev, x):
    """x A on the device matrix ``dev`` for a tensor or ``ShardedRows``
    block ``x``: a sharded block meets a matrix whose values are split over
    the same mesh shard by shard (``core.device_solver.shard_operator``:
    DIA through the mesh kernel, ELL by row blocks), and any other matrix
    (BSR, or one left whole) gathered, applied and split again."""
    multi = getattr(dev, '_multi_device', None)
    if isinstance(x, ShardedRows) and (multi is None or not multi()):
        return ShardedRows.split(dev.matmat_rows(x.gather()), x.sharding)
    return dev.matmat_rows(x)


def resolve_device(arch=None, device=None):
    """The torch.device the device engines run on, or None for the host.
    ``device`` names it; otherwise the card, unless ``arch='cpu'`` asks for
    the host.  A CUDA device with no card raises: nothing falls back to
    the CPU."""
    if device is None and arch == 'cpu':
        return None
    return storage_device(device)


class SparseSymmetricMatrix:
    """y = A x for blocks of row-vectors; A real symmetric in any SciPy
    sparse format.  The device matrix is built as well, on the card
    unless ``device`` names another device; ``arch='cpu'`` keeps the
    matrix on the host alone.  Its values take the canonical dtype of the
    matrix's (``ops.spmm.canonical_dtype``), or stay as they are with
    ``exact=True``: an f64 problem of the core Solver keeps f64 values."""

    def __init__(self, matrix, arch=None, dtype=None, bs=128, device=None,
                 exact=False):
        a = scs.csr_matrix(matrix)
        if dtype is not None:
            a = a.astype(dtype)
        self.__csr_full = _to_full_csr(a)
        self.__csr = a
        device = resolve_device(arch, device)
        self.__dev = None
        if device is not None:
            self.__dev = _device_layout(self.__csr_full,
                                        self.__csr_full.dtype.type, device,
                                        bs=bs, exact=exact)

    def size(self):
        return self.__csr.shape[0]

    def shape(self):
        return self.__csr.shape

    def data_type(self):
        return self.__csr.data.dtype

    def csr(self):
        return self.__csr

    def csr_full(self):
        return self.__csr_full

    def device_matrix(self):
        return self.__dev

    def apply(self, x, y):
        """y = x A for an (m, n) block: a tensor or a ``dense_torch``
        block (sharded too, ``_rows_apply``) on the device matrix, an
        ndarray or a host block on the host CSR."""
        if isinstance(x, torch.Tensor):
            if self.__dev is None:
                raise ValueError('tensor operand but no device matrix: '
                                 "build without arch='cpu'")
            y.copy_(self.__dev.matmat_rows(x))
            return
        if self.__dev is not None and hasattr(x, 'device_data'):
            y.fill(_rows_apply(self.__dev, x.device_data()))
            return
        out = self.__csr_full.dot(_vec_data(x).T).T
        if callable(getattr(y, 'data', None)):   # Vectors
            y.fill(out)
        else:
            y[...] = out


class SparseSymmetricSolver:
    """Shift-and-invert operator: factorize A - sigma*B once (native LDL^T),
    then ``apply`` solves with block right-hand sides
    (reference sparse_mkl.py:51-120).  A ``dense_torch`` block comes to
    the host in one transfer, is solved there and goes back in one
    upload."""

    def __init__(self, dtype=np.float64, pos_def=False):
        self.__dtype = np.dtype(dtype).type
        self.__pos_def = pos_def
        self.__ldlt = None
        self.__n = None
        self.__sigma = 0
        self.__complex = np.dtype(dtype).kind == 'c'

    def analyse(self, a, sigma=0, b=None):
        if sigma != 0:
            if b is None:
                b = scs.eye(a.shape[0], dtype=a.dtype, format='csr')
            a_s = a - sigma * b
        else:
            a_s = a
        from ..native.ldlt import SparseLDLT
        from ..utils import env
        self.__complex = np.dtype(self.__dtype).kind == 'c'
        self.__embedded = False
        if self.__complex and env.complex_via_embedding:
            # fallback route: Hermitian A = Ar + i*Ai factors through its
            # real symmetric embedding K = [[Ar, -Ai], [Ai, Ar]]:
            # eigenvalues double, so inertia halves; solves embed [Re; Im]
            # per right-hand side.  Twice the size of the native LDL^H.
            a_s = scs.csr_matrix(a_s)
            ar = scs.csr_matrix((a_s.data.real, a_s.indices, a_s.indptr),
                                shape=a_s.shape)
            ai = scs.csr_matrix((a_s.data.imag, a_s.indices, a_s.indptr),
                                shape=a_s.shape)
            k = scs.bmat([[ar, -ai], [ai, ar]], format='csr')
            self.__ldlt = SparseLDLT(k)
            self.__embedded = True
        elif self.__complex:
            # native Hermitian LDL^H (zldltmf_* engine, real D -> inertia)
            self.__ldlt = SparseLDLT(scs.csr_matrix(a_s,
                                                    dtype=np.complex128))
        else:
            self.__ldlt = SparseLDLT(a_s)
        nnz_l = self.__ldlt.analyse()
        if verbosity.level > 0:
            print('LDL^T factor nnz: %d' % nnz_l)
        self.__n = a.shape[0]
        self.__sigma = sigma

    def factorize(self):
        try:
            self.__ldlt.factorize()
        except RuntimeError as e:
            raise RuntimeError('factorization failed (near singular '
                               'matrix?): %s' % e)

    def solve(self, b, x):
        bd = _vec_data(b)
        if self.__embedded:
            bc = np.asarray(bd, dtype=np.complex128)
            be = np.concatenate((bc.real, bc.imag), axis=-1)
            oe = self.__ldlt.solve(be)
            out = oe[..., :self.__n] + 1j * oe[..., self.__n:]
        elif self.__complex:
            out = self.__ldlt.solve(np.asarray(bd, dtype=np.complex128))
        else:
            out = self.__ldlt.solve(np.asarray(bd, dtype=np.float64))
        if callable(getattr(x, 'data', None)):   # Vectors
            x.fill(out.astype(np.dtype(bd.dtype), copy=False))
        else:
            x[...] = out

    def apply(self, b, x):
        self.solve(b, x)

    def inertia(self):
        neg, pos = self.__ldlt.inertia()
        if self.__embedded:
            neg, pos = neg // 2, pos // 2
        return neg, pos

    def size(self):
        return self.__n

    def data_type(self):
        return self.__dtype

    def sigma(self):
        return self.__sigma

    def solver(self):
        return self.__ldlt


class IncompleteLU:
    """Threshold incomplete-LU preconditioner backed by the native ILUT
    engine (native/ilut.cpp), honoring the reference's
    ``factorize(tol, max_fill)`` semantics — drop tolerance relative to
    the row norm, per-row fill cap of ``max_fill`` times the average
    input row density (reference sparse_mkl.py:122-140 + the MKL
    dcsrilut wrapper mkl_wrap.py:305-331).  Falls back to SuperLU's
    ILUTP only when the native toolchain is unavailable.  It runs on the
    host: a ``dense_torch`` block makes a round trip."""

    def __init__(self, matrix):
        self.__a = scs.csr_matrix(matrix)
        self.__ilu = None
        self.__native = None

    def factorize(self, tol=1e-6, max_fill=1):
        from ..native.ldlt import native_available
        if native_available():
            from ..native.ldlt import ILUT
            self.__native = ILUT(self.__a)
            self.__native.factorize(tol=tol, max_fill=max_fill)
        else:
            import scipy.sparse.linalg as spl
            self.__ilu = spl.spilu(scs.csc_matrix(self.__a), drop_tol=tol,
                                   fill_factor=1.0 + max_fill)

    def factor_nnz(self):
        return self.__native.factor_nnz if self.__native is not None else 0

    def apply(self, x, y):
        if self.__native is None and self.__ilu is None:
            self.factorize()
        xd = np.asarray(_vec_data(x))
        x2 = np.atleast_2d(xd)
        if self.__native is not None:
            if x2.dtype.kind == 'c':
                # real factors: solve real/imag parts as extra RHS rows
                re = self.__native.solve(np.concatenate((x2.real, x2.imag)))
                out = re[:x2.shape[0]] + 1j * re[x2.shape[0]:]
            else:
                out = self.__native.solve(x2)
        else:
            out = self.__ilu.solve(x2.T).T
        out = out.reshape(xd.shape)
        if callable(getattr(y, 'data', None)):   # Vectors
            y.fill(out.astype(xd.dtype, copy=False))
        else:
            y[...] = out


# spectral_bounds calls, those of them that took the Lanczos branch, and
# the Lanczos steps those made, since the last reset
BOUNDS_COUNTS = {'calls': 0, 'lanczos': 0, 'lanczos_steps': 0}

# a Gershgorin lower bound at most this share of ``hi`` is rounding, not a
# bound: a row's radius sums its off-diagonal magnitudes, each rounded by
# half an epsilon of the running sum, so on an FE row of ~80 entries, at
# half of ``hi``, the residue reaches 20 epsilons of ``hi``
_ROUNDING_EPS = 64


def reset_bounds_counts():
    for key in BOUNDS_COUNTS:
        BOUNDS_COUNTS[key] = 0


@spanned('raleigh.chebyshev.bounds')
def spectral_bounds(matrix, iters=20, seed=7):
    """(lo, hi) bounds on the spectrum of a symmetric sparse matrix:
    Gershgorin upper bound, and a Lanczos estimate of the smallest
    eigenvalue when Gershgorin's lower bound is non-positive (it is for
    nearly every FE/Laplacian matrix, and a fudged ``lo`` silently degrades
    the Chebyshev polynomial this feeds).  A handful of Lanczos steps gives
    the right order of magnitude, which is all [lo, hi] needs.

    Where the JAX package takes Gershgorin's ``lo`` whenever it is
    positive, this takes the Lanczos branch also for a ``lo`` that is
    positive by rounding alone, within ``_ROUNDING_EPS`` epsilons of
    ``hi``: on the 7-point Laplacian ``d - radius`` is 0 in exact
    arithmetic and rounds to either side of it.  Under a profiler the call
    is the span ``raleigh.chebyshev.bounds``; ``BOUNDS_COUNTS`` counts
    always."""
    BOUNDS_COUNTS['calls'] += 1
    a = scs.csr_matrix(matrix)
    d = a.diagonal()
    radius = np.abs(a).sum(axis=1).A.ravel() - np.abs(d)
    hi = float((d + radius).max())
    lo = float((d - radius).min())
    eps = np.finfo(np.result_type(d.dtype, np.float32)).eps
    if lo <= _ROUNDING_EPS * eps * hi:
        BOUNDS_COUNTS['lanczos'] += 1
        # Lanczos (full orthogonalization at these tiny iteration counts)
        rng = np.random.RandomState(seed)
        n = a.shape[0]
        k = int(min(max(iters, 8), n - 1, 40))
        q = rng.standard_normal(n)
        q /= np.linalg.norm(q)
        Q = np.zeros((k + 1, n))
        Q[0] = q
        alpha = np.zeros(k)
        beta = np.zeros(k)
        j = 0
        for j in range(k):
            w = a @ Q[j]
            alpha[j] = Q[j] @ w
            w -= Q[:j + 1].T @ (Q[:j + 1] @ w)   # full reorthogonalization
            b = np.linalg.norm(w)
            beta[j] = b
            if b <= 1e-12 * hi:
                j += 1
                break
            Q[j + 1] = w / b
        else:
            j = k
        BOUNDS_COUNTS['lanczos_steps'] += j
        T = np.diag(alpha[:j])
        if j > 1:
            T += np.diag(beta[:j - 1], 1) + np.diag(beta[:j - 1], -1)
        ritz = np.linalg.eigvalsh(T)
        # the smallest Ritz value converges to lmin from above (and slowly
        # on Laplacian-like clustered low ends): take a quarter of it for a
        # safe under-estimate — a 4x margin costs the Chebyshev degree only
        # a factor 2, against the 1e8 condition of the old hi*1e-8 fudge
        lo = 0.25 * float(ritz[0])
        if lo <= 0:
            lo = hi * 1e-8
    return lo, hi


def _eager_step(mat_fn, ops, d, r, y, c1, c2):
    """One degree step of the Chebyshev recurrence as eager ops on (m, n)
    blocks, ``mat_fn(ops, d)`` the apply and y None before the first step:
    (d', r', y')."""
    y = d if y is None else y + d
    r = r - mat_fn(ops, d).to(d.dtype)
    return c1 * d + c2 * r, r, y


class Chebyshev:
    """Polynomial (Chebyshev) approximation to A^-1 on [lo, hi] applied by
    a short SpMM recurrence: every application is ``degree`` SpMMs on the
    device, with no factorization and no triangular solves.  ``matrix``
    is kept as given, so ``partial_hevp`` can tell when A's device matrix
    is already built."""

    def __init__(self, matrix, lo, hi, degree=8, arch=None,
                 device_matrix=None, device=None):
        """The matrix's device matrix is built on the card unless
        ``device`` names another device or ``arch='cpu'`` the host.
        ``device_matrix`` (optional): a device sparse matrix built
        before (ops/spmm.py) that the recurrence uses instead of building
        its own — a ``BsrMatrix`` made by hand, say, which
        ``device_sparse`` would not choose, or a matrix that
        ``core.device_solver.shard_operator`` has split over a mesh: the
        recurrence then runs on ``ShardedRows`` blocks, shard by shard."""
        self.matrix = matrix
        if device_matrix is not None and device is None and arch is None:
            arch = 'cpu'    # the recurrence runs on device_matrix alone
        self.__op = (matrix if isinstance(matrix, SparseSymmetricMatrix)
                     else SparseSymmetricMatrix(matrix, arch=arch,
                                                device=device))
        self.__dev_override = device_matrix
        self.lo = float(lo)
        self.hi = float(hi)
        self.degree = int(degree)
        self.__rows = {}

    def device_matrix(self):
        return self.__dev_override or self.__op.device_matrix()

    def device_rows_operands(self, m, n=None, dtype=None, stream_bf16=None):
        """(fn, operands) with ``fn(operands, w)`` applying the whole
        ``degree``-step recurrence to an (m, n) row block — the form
        ``core.device_solver.lobpcg(precond=...)`` takes.

        ``stream_bf16`` runs the iterates in bfloat16 (f32 values and f32
        accumulation inside the SpMM, the caller's dtype in and out): a
        preconditioner is an approximate inverse, so bf16 iterates cost
        the outer iteration nothing while the SpMMs stream half the
        bytes.  ``None`` = auto: on when the matrix is DIA, the outer
        iteration is f32 and the recurrence's working set exceeds the
        device matrix's ``WINDOW_HBM_BYTES``; ELL and BSR matrices stream
        bf16 only when asked.  Each call of ``fn`` is one
        ``raleigh.chebyshev`` span, and ``fn.device_matrix`` is the matrix
        it applies.  The same arguments give the same pair while the
        device matrix keeps its layout, so that ``lobpcg`` finds the CUDA
        graphs it captured with it again."""
        dev = self.device_matrix()
        if n is None:
            n = dev.shape[0]
        dtype = torch.float32 if dtype is None else torch_dtype(dtype)
        if stream_bf16 is None:
            noff = len(getattr(dev, 'offsets', ()))
            ws = 2 * m * n * 4 + noff * n * 4
            stream_bf16 = (noff > 0 and dtype == torch.float32
                           and ws > dev.WINDOW_HBM_BYTES)
        key = (m, n, dtype, stream_bf16,
               getattr(dev, '_multi_device', bool)())
        if key not in self.__rows:
            fn, ops = self._recurrence(stream_bf16)
            fn = spanned('raleigh.chebyshev')(fn)
            fn.device_matrix = dev
            self.__rows[key] = fn, ops
        return self.__rows[key]

    def _recurrence(self, stream_bf16):
        """``device_rows_operands`` of any block shape outside a span, its
        iterates in bfloat16 or not.  Where the device matrix has a step
        kernel (``ops/spmm.py::rows_step_operands``: an ``EllMatrix`` left
        whole, iterates not in bfloat16) and it takes the block (real f32
        or f64), each degree step is one launch, with the eager step's
        result bit for bit; every other matrix and block takes the eager
        step (``_eager_step``)."""
        dev = self.device_matrix()
        mat_fn, ops = rows_matmat_operands(dev)
        step_fn = rows_step_operands(dev, stream_bf16)
        multi = getattr(dev, '_multi_device', None)
        sharded_apply = multi is not None and multi()
        theta = 0.5 * (self.hi + self.lo)
        delta = 0.5 * (self.hi - self.lo)
        sigma1 = theta / delta
        # each step's (c1, c2) of d' = c1 d + c2 r'
        coefficients = []
        rho = 1.0 / sigma1
        for _ in range(self.degree):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            coefficients.append((rho * rho_new, 2.0 * rho_new / delta))
            rho = rho_new

        def fn(ops, x):
            if isinstance(x, ShardedRows) and not sharded_apply:
                # a matrix that knows no shards runs the recurrence on the
                # gathered block, as core.device_solver._rows_matmat
                # applies such an operator
                return ShardedRows.split(fn(ops, x.gather()), x.sharding)
            x_in = x
            x = x.contiguous()
            if step_fn is not None:
                y = step_fn(ops, x, theta, coefficients)
                if y is not None:
                    return y
            if stream_bf16:
                x = x.to(torch.bfloat16)
            d = x / theta
            r = x
            y = None
            for c1, c2 in coefficients:
                d, r, y = _eager_step(mat_fn, ops, d, r, y, c1, c2)
            return y.to(x_in.dtype)

        return fn, ops

    def _device_fused_rows(self):
        """The recurrence as a plain (m, n) -> (m, n) callable, iterating
        in the operand's dtype."""
        def run(x):
            fn, ops = self._recurrence(stream_bf16=False)
            return fn(ops, x)
        return run

    def apply(self, x, y):
        """y ~= A^-1 x: Chebyshev iteration for A y = x with y0 = 0 — on
        the device, in the operand's dtype, for a tensor or a
        ``dense_torch`` block (a sharded block shard by shard on a matrix
        split over its mesh, else gathered); on the host CSR for an
        ndarray or a host block.  A device apply, the recurrence's operands
        included, is one ``raleigh.chebyshev`` span."""
        if isinstance(x, torch.Tensor):
            with span('raleigh.chebyshev'):
                y.copy_(self._device_fused_rows()(x))
            return
        if self.device_matrix() is not None and hasattr(x, 'device_data'):
            with span('raleigh.chebyshev'):
                y.fill(self._device_fused_rows()(x.device_data()))
            return
        theta = 0.5 * (self.hi + self.lo)
        delta = 0.5 * (self.hi - self.lo)
        sigma1 = theta / delta
        rho = 1.0 / sigma1
        # work blocks of the same kind as x
        d = _clone_zero(x)      # search direction
        r = _clone_copy(x)      # residual (starts as x, since y0 = 0)
        ay = _clone_zero(x)
        _scale_add(d, r, 1.0 / theta, reset=True)
        _zero(y)
        for _ in range(self.degree):
            _axpy(y, d, 1.0)                 # y += d
            self.__op.apply(d, ay)           # ay = A d
            _axpy(r, ay, -1.0)               # r -= A d
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            coef = rho * rho_new
            _scale_add(d, r, 2.0 * rho_new / delta, scale=coef)
            rho = rho_new

    def preconditioner(self):
        return self


# -- tiny helpers working on either Vectors or ndarrays ---------------------

def _clone_zero(x):
    try:
        v = x.new_vectors(x.nvec())
        v.zero()
        return v
    except AttributeError:
        return np.zeros_like(x)


def _clone_copy(x):
    try:
        return x.clone()
    except AttributeError:
        return x.copy()


def _zero(x):
    try:
        x.zero()
    except AttributeError:
        x[...] = 0


def _axpy(y, x, a):
    try:
        y.add(x, a)
    except AttributeError:
        y += a * x


def _scale_add(d, r, coef_r, scale=0.0, reset=False):
    """d := scale * d + coef_r * r (reset: d := coef_r * r)."""
    try:
        if reset or scale == 0.0:
            d.zero()
        else:
            d.scale(np.full(d.nvec(), 1.0 / scale))
        d.add(r, coef_r)
    except AttributeError:
        if reset or scale == 0.0:
            d[...] = coef_r * r
        else:
            d[...] = scale * d + coef_r * r


class Operator:
    """Tensor- and Vectors-aware adapter for any object exposing
    apply(ndarray, ndarray) (reference sparse_mkl.py:143-154): a tensor or
    a ``dense_torch`` block makes a round trip through host memory."""

    def __init__(self, op):
        self.__op = op

    def apply(self, x, y):
        if isinstance(x, torch.Tensor):
            xd = x.detach().cpu().numpy()
            yd = np.empty_like(xd)
            self.__op.apply(xd, yd)
            y.copy_(torch.from_numpy(yd))
            return
        try:
            xd = x.data()
        except AttributeError:
            self.__op.apply(x, y)
            return
        yd = np.empty_like(xd)
        self.__op.apply(xd, yd)
        y.fill(yd)
