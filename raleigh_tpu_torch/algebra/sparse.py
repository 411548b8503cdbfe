"""Sparse symmetric operators and the Chebyshev preconditioner.

PyTorch port of the device half of ``raleigh_tpu/algebra/sparse.py``:

  * ``SparseSymmetricMatrix``  SpMM on (m, n) row blocks — host SciPy CSR
    for ndarrays, the DIA, ELL or BSR device matrix (ops/spmm.py) for
    tensors;
  * ``spectral_bounds``        (lo, hi) bounds on a spectrum, on the host;
  * ``Chebyshev``              polynomial approximation to A^-1 on
    [lo, hi], a recurrence of ``degree`` SpMMs that runs on the device;
  * ``Operator``               adapter giving an object with an
    ndarray-level ``apply`` the tensor interface.

``SparseSymmetricSolver`` and ``IncompleteLU`` come with the shift-invert
path (ROADMAP queue 1, item 7).
"""

import numpy as np
import scipy.sparse as scs
import torch

from ..ops.spmm import (_device_layout, _to_full_csr, rows_matmat_operands,
                        storage_device, torch_dtype)


def resolve_device(arch='cpu', device=None):
    """The torch.device the device engines run on, or None for the host.
    ``device`` names it; otherwise arch 'gpu' means CUDA.  A CUDA device
    with no card raises: nothing falls back to the CPU."""
    if device is None:
        if arch != 'gpu':
            return None
    return storage_device(device)


class SparseSymmetricMatrix:
    """y = A x for blocks of row-vectors; A real symmetric in any SciPy
    sparse format.  A device arch or ``device`` builds the device matrix
    as well."""

    def __init__(self, matrix, arch='cpu', dtype=None, bs=128, device=None):
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
                                        bs=bs)

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
        """y = x A for an (m, n) block: a tensor on the device matrix, an
        ndarray on the host CSR."""
        if isinstance(x, torch.Tensor):
            if self.__dev is None:
                raise ValueError('tensor operand but no device matrix: '
                                 "build with arch='gpu' or device=")
            y.copy_(self.__dev.matmat_rows(x))
            return
        y[...] = self.__csr_full.dot(np.asarray(x).T).T


def spectral_bounds(matrix, iters=20, seed=7):
    """(lo, hi) bounds on the spectrum of a symmetric sparse matrix:
    Gershgorin upper bound, and a Lanczos estimate of the smallest
    eigenvalue when Gershgorin's lower bound is non-positive (it is for
    nearly every FE/Laplacian matrix, and a fudged ``lo`` silently degrades
    the Chebyshev polynomial this feeds).  A handful of Lanczos steps gives
    the right order of magnitude, which is all [lo, hi] needs."""
    a = scs.csr_matrix(matrix)
    d = a.diagonal()
    radius = np.abs(a).sum(axis=1).A.ravel() - np.abs(d)
    hi = float((d + radius).max())
    lo = float((d - radius).min())
    if lo <= 0:
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


class Chebyshev:
    """Polynomial (Chebyshev) approximation to A^-1 on [lo, hi] applied by
    a short SpMM recurrence: every application is ``degree`` SpMMs on the
    device, with no factorization and no triangular solves.  ``matrix``
    is kept as given, so ``partial_hevp`` can tell when A's device matrix
    is already built."""

    def __init__(self, matrix, lo, hi, degree=8, arch='cpu',
                 device_matrix=None, device=None):
        """``device_matrix`` (optional): a device sparse matrix built
        before (ops/spmm.py) that the recurrence uses instead of building
        its own — a ``BsrMatrix`` made by hand, say, which
        ``device_sparse`` would not choose."""
        self.matrix = matrix
        self.__op = (matrix if isinstance(matrix, SparseSymmetricMatrix)
                     else SparseSymmetricMatrix(matrix, arch=arch,
                                                device=device))
        self.__dev_override = device_matrix
        self.lo = float(lo)
        self.hi = float(hi)
        self.degree = int(degree)

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
        bf16 only when asked."""
        dev = self.device_matrix()
        if n is None:
            n = dev.shape[0]
        dtype = torch.float32 if dtype is None else torch_dtype(dtype)
        if stream_bf16 is None:
            noff = len(getattr(dev, 'offsets', ()))
            ws = 2 * m * n * 4 + noff * n * 4
            stream_bf16 = (noff > 0 and dtype == torch.float32
                           and ws > dev.WINDOW_HBM_BYTES)
        mat_fn, ops = rows_matmat_operands(dev)
        theta = 0.5 * (self.hi + self.lo)
        delta = 0.5 * (self.hi - self.lo)
        sigma1 = theta / delta
        degree = self.degree

        def fn(ops, x):
            x_in = x
            x = x.contiguous()
            if stream_bf16:
                x = x.to(torch.bfloat16)
            rho = 1.0 / sigma1
            d = x / theta
            r = x
            y = None
            for _ in range(degree):
                y = d if y is None else y + d
                r = r - mat_fn(ops, d).to(x.dtype)
                rho_new = 1.0 / (2.0 * sigma1 - rho)
                d = (rho * rho_new) * d + (2.0 * rho_new / delta) * r
                rho = rho_new
            return y.to(x_in.dtype)

        return fn, ops

    def _device_fused_rows(self):
        """The recurrence as a plain (m, n) -> (m, n) callable, iterating
        in the operand's dtype."""
        def run(x):
            fn, ops = self.device_rows_operands(*x.shape, stream_bf16=False)
            return fn(ops, x)
        return run

    def apply(self, x, y):
        """y ~= A^-1 x: Chebyshev iteration for A y = x with y0 = 0 — on
        the device for a tensor, on the host CSR for an ndarray."""
        if isinstance(x, torch.Tensor):
            y.copy_(self._device_fused_rows()(x))
            return
        theta = 0.5 * (self.hi + self.lo)
        delta = 0.5 * (self.hi - self.lo)
        sigma1 = theta / delta
        rho = 1.0 / sigma1
        x = np.asarray(x)
        d = x / theta           # search direction
        r = x.copy()            # residual (starts as x, since y0 = 0)
        ay = np.empty_like(d)
        y[...] = 0
        for _ in range(self.degree):
            y += d
            self.__op.apply(d, ay)
            r -= ay
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = (rho * rho_new) * d + (2.0 * rho_new / delta) * r
            rho = rho_new


class Operator:
    """Tensor-aware adapter for any object exposing apply(ndarray,
    ndarray) (reference sparse_mkl.py:143-154): a tensor operand makes a
    round trip through host memory."""

    def __init__(self, op):
        self.__op = op

    def apply(self, x, y):
        if not isinstance(x, torch.Tensor):
            self.__op.apply(x, y)
            return
        xd = x.detach().cpu().numpy()
        yd = np.empty_like(xd)
        self.__op.apply(xd, yd)
        y.copy_(torch.from_numpy(yd))
