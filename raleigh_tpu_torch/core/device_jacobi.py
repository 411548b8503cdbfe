"""Device-resident block Jacobi-CG engine with per-vector convergence
control (chunked iteration).

PyTorch port of ``raleigh_tpu/core/device_jacobi.py``.  The
host-orchestrated ``core.solver.Solver`` fetches small results from the
device a few times an iteration; this engine is the device formulation of
the same iteration for *standard* and *generalized* problems at one
spectrum margin (the dense SVD/PCA workload, reference
interfaces/partial_svd.py:52-122):

  * ``chunk`` iterations run on the device between two host looks:
    residuals, constraint deflation, hierarchical orthonormalization,
    Rayleigh-Ritz over span[X, W, P] (device ``eigh``), basis update.  The
    JAX package compiles a chunk into one program; here it is an eager
    loop of torch calls (the pattern of core/device_solver.py's
    ``lobpcg``), and the host fetches the chunk's statistics in ONE
    transfer (``dense_torch.fetch``).  The Jacobi conjugation of the
    reference (core/solver.py:1321-1355) appears as the locally-optimal
    three-term recurrence: the RR over [X, W, P] yields the same
    optimally-conjugated new directions.
  * ONE operator application per iteration: the A-images (and B-images)
    of X, P and the locked constraints transform exactly under row-mixing,
    so only the fresh direction W needs the operator.
  * per-vector convergence control stays intact: every chunk returns the
    per-iteration eigenvalue history and Ritz-mixing norms (tiny arrays),
    from which the host maintains the same kinematic + residual error
    estimates, stagnation/cluster logic and convergence sweeps as the
    host solver — by *borrowing* ``Solver``'s own methods.  User-supplied
    ``convergence_criteria`` / ``stopping_criteria`` objects are evaluated
    unchanged against this engine.
  * converged vectors are locked into the constraint block, and their
    slots refilled with fresh random rows drawn on the host with NumPy's
    global generator, in the JAX package's order: a NumPy-seeded run
    iterates like the JAX package's.

Blocks are (m, n) row tensors.  f32 products run at full f32 (TF32 stays
off).  Not carried over: the JAX package's shared store of compiled
kernels (it serves a remote compiler) and speculative chunk pipelining
(``pipeline``; its default of 1 was the only setting in use).

Where this engine departs from the JAX package's (whose f32 runs returned
a quarter of the values asked at nsv = 300, and whose f64 runs restarted
on rounding and locked pairs as stagnated before they converged):

  * the Rayleigh-Ritz solves the pencil of S = [X, W, P] with S's own
    (B-)Gram, so the new X is orthonormal to rounding whatever the
    whitening of W left in S; the chunk-exit check then restarts only on a
    block that really lost orthonormality;
  * the new P is an orthonormal mixing of S (the old X's part that the new
    X left), not a renormalized difference, so the tracked images of P
    take no amplified rounding from one iteration to the next;
  * below the rounding of the Ritz values the eigenvalue history records
    the decrements that the Rayleigh-Ritz predicts, as the host Solver
    does, so the kinematic error estimates go on falling and pairs lock on
    the convergence test, not as stagnated;
  * the whitening's flags of dead rows no longer land on live rows, and
    complex blocks take the coefficients <basis, row>, not their
    conjugates, and a whitening of (V Lambda^-1/2)^T.
"""

import math

import numpy as np
import torch

from ..algebra import dense_torch
from ..algebra.dense_torch import fetch
from ..ops.spmm import storage_device
from .device_solver import _gram
from .solver import (Solver, Options, DefaultConvergenceCriteria, HISTORY,
                     _find_clusters, _shift_slot_data, EstimatedErrors)


def _cj(a):
    return a.conj() if a.is_complex() else a


def svd_normal_matmat(adata, transp, shift, aves=None):
    """The row-block normal operator of the (implicitly mean-shifted) data
    matrix: x (mb, d) -> x (B B^H)^T with B = A - e a^T, matching
    _OperatorSVD.apply (reference partial_svd.py:258-291).

    Returns (matmat, operands): ``matmat(operands, x)``."""
    m = adata.shape[0]
    operands = (adata, aves) if shift else (adata,)
    if transp:
        def matmat(ops, x):
            adata = ops[0]
            z = torch.matmul(x, _cj(adata))
            if shift:
                s = torch.sum(x, dim=1, keepdim=True)      # x e
                z = z - s * ops[1][None, :].to(z.dtype)
            y = torch.matmul(z, adata.T)
            if shift:
                y = y - torch.matmul(z, _cj(ops[1])[:, None])
            return y
    else:
        def matmat(ops, x):
            adata = ops[0]
            z = torch.matmul(x, adata.T)
            if shift:
                for _ in range(2):   # double orthogonalization for accuracy
                    z = z - torch.sum(z, dim=1, keepdim=True) / m
            return torch.matmul(z, _cj(adata))
    return matmat, operands


def _coef(block, bbasis):
    """The coefficients <basis_j, block_i> of ``block``'s rows along a
    (B-)orthonormal basis, read from the basis's B-image: block := block -
    coef @ basis projects the basis out.  (``_gram(block, bbasis)`` is
    their conjugate, which only real blocks may use in their place.)"""
    return _gram(bbasis, block).T


def _row_dots(a, b):
    """Re <a_i, b_i> for every row."""
    return (_cj(a) * b).sum(1).real


def _eigh(h):
    """``torch.linalg.eigh``, or NaNs where it does not converge (a
    non-finite block, say): what ``jnp.linalg.eigh`` returns there, and
    what the chunk-exit check reads as a non-finite chunk to restart."""
    try:
        return torch.linalg.eigh(h)
    except torch.linalg.LinAlgError:
        nan = torch.full_like(h, float('nan'))
        return torch.diagonal(nan).real.clone(), nan


class DeviceJacobi:
    """Chunked device engine computing the ``nwanted`` largest eigenpairs
    of a symmetric/Hermitian operator on row blocks, with Solver-compatible
    observability (criteria and stopping objects see the same attribute
    surface as ``core.solver.Solver``)."""

    # borrowed Solver machinery: identical observability/estimation logic
    convergence_data = Solver.convergence_data
    _estimate_errors = Solver._estimate_errors
    _sweep = Solver._sweep
    _print_iterate_table = Solver._print_iterate_table

    def __init__(self, matmat, dim, dtype=np.float32, precond=None,
                 operands=None, matmat_b=None, operands_b=None):
        """``matmat``: the operator on an (m, dim) row block, called as
        ``matmat(operands, x)`` when ``operands`` is given, else
        ``matmat(x)``.

        ``precond``: None, a row-layout callable, or an ``(fn, operands)``
        pair such as ``Chebyshev.device_rows_operands()``.

        ``matmat_b`` (optional): right-hand operator of a generalized
        pencil A x = lmd B x (B symmetric/Hermitian positive definite);
        the whole iteration then runs in the B-inner product with exact
        tracking of B-images alongside the A-images.

        The blocks live on the device of the first operand, or on the card
        when no operands are given (CUDA with no card raises)."""
        self.matmat = matmat
        self.dim = int(dim)
        self.dtype = np.dtype(dtype).type
        if isinstance(precond, tuple):
            fn, ops = precond
            self.precond = lambda w: fn(ops, w)
        else:
            self.precond = precond
        self._operands = operands
        self.matmat_b = matmat_b
        self._operands_b = operands_b
        self.has_b = matmat_b is not None
        self.device = storage_device(operands[0].device if operands
                                     else None)
        # Solver-compatible public state
        self.iteration = 0
        self.restarts = 0
        self.lcon = 0
        self.rcon = 0
        self.eigenvalues = np.zeros((0,), dtype=np.float64)
        self.eigenvalue_errors = EstimatedErrors()
        self.eigenvector_errors = EstimatedErrors()
        self.residual_norms = np.zeros((0,), dtype=np.float32)
        self.convergence_status = np.zeros((0,), dtype=np.int32)
        self.block_size = None
        self.cnv = None
        self.lmd = None
        self.res = None
        self.err_lmd = None
        self.err_X = None
        # locked rows and their A- (and B-) images, exactly _nc rows
        self._xc = self._axc = self._bxc = None
        self._nc = 0
        eps = float(np.finfo(np.dtype(self.dtype).type(0).real.dtype).eps)
        self._eps_rel = 100 * eps
        self._sqrt_eps = math.sqrt(eps)
        # the small dense problems (Grams, whitening, Rayleigh-Ritz) are
        # solved in f64 whatever the blocks' precision: more accurate, and
        # on the H100 cuSOLVER's f64 eigh is faster than its f32 one
        self._small = torch.complex128 if np.dtype(self.dtype).kind == 'c' \
            else torch.float64

    # -- Solver API surface used by stopping criteria ---------------------

    @property
    def eigenvectors(self):
        """Converged eigenvectors as a ``dense_torch.Vectors`` (rows), for
        stopping-criteria consumers (truncated_svd.py)."""
        if self._nc == 0:
            return dense_torch.Vectors(self.dim, 0, self.dtype,
                                       device=self.device)
        return dense_torch.Vectors(self._xc)

    def problem(self):
        return self

    def _mm(self, x):
        if self._operands is not None:
            return self.matmat(self._operands, x).to(x.dtype)
        return self.matmat(x).to(x.dtype)

    def _mm_b(self, x):
        if not self.has_b:
            return x
        if self._operands_b is not None:
            return self.matmat_b(self._operands_b, x).to(x.dtype)
        return self.matmat_b(x).to(x.dtype)

    # -- row-block numerics (the JAX package's, function for function) ----

    def _norm_drop(self, block, dead0=None, bblock=None):
        """Unit-normalize rows; rows that collapsed below sqrt(eps) of the
        block's largest are noise — zero and flag.  Norms are B-norms when
        ``bblock`` (the tracked B-image) is given; the image receives the
        identical row scaling (exact).  Returns (block, image, dead,
        norms)."""
        other = block if bblock is None else bblock
        norms = torch.sqrt(torch.clamp(_row_dots(block, other), min=0.0))
        ref = torch.clamp(norms.max(), min=1e-30)
        dead = norms <= self._sqrt_eps * ref
        if dead0 is not None:
            dead = dead | dead0
        safe = torch.where(norms == 0, 1.0, norms).to(block.dtype)
        out = torch.where(dead[:, None], 0.0, block / safe[:, None])
        bout = None if bblock is None else \
            torch.where(dead[:, None], 0.0, bblock / safe[:, None])
        return out, bout, dead, norms

    def _whitening(self, block, other, cutoff):
        """The row mixing that (B-)orthonormalizes ``block`` by
        eigh-whitening of its (B-)Gram, directions below ``cutoff`` times
        the largest eigenvalue dropped: rows := mix @ rows."""
        g = _gram(block, other).to(self._small)
        g = 0.5 * (g + g.conj().T)
        # a zero row (a dead one) takes eigenvalue -1, below the cutoff
        # and apart from the live spectrum: LAPACK's eigh failed to
        # converge on an f32 Gram with 75 exact zero rows of 128
        zero = torch.diagonal(g).real == 0
        w, v = _eigh(g - torch.diag(zero.to(g.dtype)))
        wmax = torch.clamp(w[-1], min=0.0)
        dead_g = w <= wmax * cutoff
        inv = torch.where(dead_g, 0.0,
                          1.0 / torch.sqrt(torch.where(dead_g, 1.0, w)))
        return (v * inv[None, :]).T.to(block.dtype)

    def _whiten(self, block, bblock=None):
        """(B-)orthonormalize rows; near-dependent directions zeroed and
        flagged.  The rows out are the Gram's eigendirections, not the rows
        in: a dead row in (zero) is a dropped direction out, wherever it
        lands, so the flags in do not carry over by index."""
        mix = self._whitening(block, block if bblock is None else bblock,
                              self._eps_rel)
        bw = torch.matmul(mix, block)
        bbw = None if bblock is None else torch.matmul(mix, bblock)
        return self._norm_drop(bw, bblock=bbw)[:3]

    @staticmethod
    def _ortho_rows(block, basis, bbasis):
        """Two-pass classical Gram-Schmidt against a (B-)orthonormal basis
        (coefficients from the basis's B-image)."""
        for _ in range(2):
            block = block - torch.matmul(_coef(block, bbasis), basis)
        return block

    def _deflate(self, x, ax, bx):
        """Rows (B-)orthogonal to the locked set, their A/B-images
        following exactly (row operations commute with the operators)."""
        q = _coef(x, self._bxc)
        x = x - torch.matmul(q, self._xc)
        ax = ax - torch.matmul(q, self._axc)
        bx = bx - torch.matmul(q, self._bxc) if self.has_b else x
        return x, ax, bx

    def _step(self, state, hist, dx_h, t):
        """One iteration: residuals, deflation, the new direction W (the
        one operator application), Rayleigh-Ritz over S = [X, W, P] with
        S's own (B-)Gram, and the new X and P."""
        x, ax, bx, p, ap, bp = state
        xc, bxc = self._xc, self._bxc
        has_b = self.has_b
        m = x.shape[0]
        # re-deflate X and P against the locked set every iteration: a
        # locked direction with a larger eigenvalue amplifies any leak
        # exponentially through the Rayleigh-Ritz maximization, so the leak
        # must be reset to rounding level each step
        x, ax, bx = self._deflate(x, ax, bx)
        p, ap, bp = self._deflate(p, ap, bp)
        # P rows are unit or zero (empty after an entry): a short one is
        # dropped so that every dead row of S is exactly zero
        dead_p = _row_dots(p, bp) < 0.25
        p, ap, bp = (torch.where(dead_p[:, None], 0.0, v) for v in (p, ap, bp))
        lam = _row_dots(x, ax)
        hist[0, t] = lam
        w = ax - lam[:, None].to(x.dtype) * bx
        if self.precond is not None:
            w = self.precond(w).to(w.dtype)
        # W: deflated against the locked constraints, then (B-)orthogonal
        # to X and P; B-inner products contract against the B-images
        w = self._ortho_rows(w, xc, bxc)
        w, _, dead_w, _ = self._norm_drop(w)
        xp = torch.cat((x, p), dim=0)
        w = self._ortho_rows(w, xp, torch.cat((bx, bp), dim=0)
                             if has_b else xp)
        if has_b:
            bw = self._mm_b(w)
            w, bw, dead_w, _ = self._norm_drop(w, dead_w, bw)
            w, bw, dead_w = self._whiten(w, bw)
        else:
            w, _, dead_w, _ = self._norm_drop(w, dead_w)
            w, _, dead_w = self._whiten(w)
            bw = w
        aw = self._mm(w)

        s = torch.cat((x, w, p), dim=0)                  # (3m, n) rows
        a_s = torch.cat((ax, aw, ap), dim=0)
        b_s = torch.cat((bx, bw, bp), dim=0) if has_b else s
        dead = torch.cat((torch.zeros(m, dtype=torch.bool, device=x.device),
                          dead_w, dead_p))
        # Rayleigh-Ritz as the pencil (h, g) with g S's own Gram: S is
        # orthonormal only to the whitening's rounding (in f32 that is far
        # above eps), and the pencil keeps the new X orthonormal to
        # rounding instead of inheriting S's error.  Dead rows of S are
        # zero: a unit diagonal in g keeps the Cholesky factor regular, and
        # a failed factorization turns into NaNs that the chunk-exit check
        # restarts from
        hg = _gram(s, torch.cat((a_s, b_s), dim=0)).to(self._small)
        h, g = hg[:, :3 * m], hg[:, 3 * m:]
        g = 0.5 * (g + g.conj().T) + torch.diag(dead.to(g.dtype))
        low, info = torch.linalg.cholesky_ex(g)
        low = low + torch.where(info > 0, float('nan'), 0.0).to(low.dtype)
        h = torch.linalg.solve_triangular(low, h, upper=False)
        h = torch.linalg.solve_triangular(low, h.conj().T, upper=False)
        h = 0.5 * (h + h.conj().T)
        # push dead columns just below the live spectrum so the top-m Ritz
        # selection never picks them; a shift of the live diagonal's scale
        # keeps ||H||, and with it eigh's absolute error, of the order of
        # the live eigenvalues (a shift of order 1 swamped the decrements
        # of Ritz values near 1e-4 in f32)
        big = torch.diagonal(h).real.abs().max() * 3.0
        big = torch.where(big > 0, big, 1.0)
        h = h - torch.diag(torch.where(dead, big, 0.0).to(h.dtype))
        _, v = _eigh(h)                                  # ascending
        # the predicted decrement of each new Ritz value: with v = [a; b]
        # split at the old X's coordinates, rho(a) - theta = -Re(a^H H12
        # b) / |a|^2 exactly (H12 the X-to-rest block of h), a product of
        # small terms, so unlike the difference of two Ritz values it
        # stays accurate after the decrement falls below rounding of the
        # eigenvalue (the host Solver's predicted decrements, from its
        # Rayleigh-Ritz data, serve the same end)
        a, b = v[:m, 2 * m:], v[m:, 2 * m:]
        a2 = _row_dots(a.T, a.T)
        num = _row_dots(a.T, torch.matmul(h[:m, m:], b).T)
        hist[1, t] = torch.where(a2 > 0, -num / torch.where(a2 > 0, a2, 1.0),
                                 0.0)
        # v's coordinates are those of the orthonormal basis that the
        # Cholesky factor makes of S, and the first m of them span the old
        # X.  The new X are the top m columns.  The new P span what the old
        # X had that the new X has not: the old X's coordinates in the
        # other columns vr, orthonormalized (Householder QR), which makes
        # P an orthonormal mixing of vr.  So both are orthonormal mixings,
        # the tracked images of X and P take no growing error from them,
        # and span[X, P] is that of the classical P = X_new - X_old C.
        # Columns of vr that belong to dead rows of S carry no direction
        # and are dropped, and so are the QR's columns whose diagonal of R
        # is at rounding: directions the old X has barely left, where the
        # QR's completion could fall on those dead rows
        vr = v[:, :2 * m]
        on_dead = _row_dots(vr.T, torch.where(dead[:, None], vr, 0.0).T)
        vr = torch.where((on_dead > 0.5)[None, :], 0.0, vr)
        q, r = torch.linalg.qr(vr[:m].conj().T)          # (2m, m)
        q = torch.where((torch.diagonal(r).abs() > self._eps_rel)[None, :],
                        q, 0.0)
        coef = torch.linalg.solve_triangular(
            low.conj().T, torch.cat((v[:, 2 * m:], torch.matmul(vr, q)),
                                    dim=1), upper=True).to(s.dtype)
        # kinematic dX: norms of the (W, P)-components of the new X
        cm = coef[:, :m]
        dx_h[t] = torch.sqrt(_row_dots(cm[m:].T, cm[m:].T))
        coef_t = coef.T
        xn, pn = torch.matmul(coef_t, s).split(m)
        axn, apn = torch.matmul(coef_t, a_s).split(m)
        if has_b:
            bxn, bpn = torch.matmul(coef_t, b_s).split(m)
        else:
            bxn, bpn = xn, pn
        return xn, axn, bxn, pn, apn, bpn

    def _run_chunk(self, state, iters):
        """``iters`` iterations, then the chunk-exit statistics: (state,
        lam, res, hist, dx_h, gram_err), all on the device: ``hist[0]``
        holds each iteration's Ritz values, ``hist[1]`` the decrements its
        Rayleigh-Ritz predicted."""
        x = state[0]
        m = x.shape[0]
        # the eigenvalue history carries the engine's REAL dtype: an f32
        # history under an f64 iteration quantizes decrements at
        # ~eps32*|lam|, and that noise reads as fake progress to the
        # stagnation/kinematic machinery (pairs never lock)
        hist = torch.zeros((2, iters, m), dtype=x.real.dtype,
                           device=x.device)
        dx_h = torch.zeros((iters, m), dtype=torch.float32, device=x.device)
        for t in range(iters):
            state = self._step(state, hist, dx_h, t)
        x, ax, bx, p, ap, bp = state
        # deflate the last update's leak, then refresh the tracked A/B-
        # images of X at chunk exit: RR-updated images drift by rounding,
        # and the lock/convergence decisions made from this chunk's exit
        # data must be trustworthy
        x = x - torch.matmul(_coef(x, self._bxc), self._xc)
        ax = self._mm(x)
        bx = self._mm_b(x)
        lam = _row_dots(x, ax)
        r = ax - lam[:, None].to(x.dtype) * bx
        res = torch.sqrt(_row_dots(r, r))
        g = _gram(x, bx)
        gram_err = torch.max(torch.abs(g - torch.eye(m, dtype=g.dtype,
                                                     device=g.device)))
        return (x, ax, bx, p, ap, bp), lam, res, hist, dx_h, gram_err

    def _orthonormal_entry(self, x):
        """(B-)orthonormalize a (re)filled block against the locked set
        and return the fresh state with its images and no conjugate
        directions."""
        if self.has_b:
            bx = self._mm_b(x)
            for _ in range(2):
                q = _coef(x, self._bxc)
                x = x - torch.matmul(q, self._xc)
                bx = bx - torch.matmul(q, self._bxc)
            x, bx = self._norm_drop(x, bblock=bx)[:2]
            x, bx, _ = self._whiten(x, bx)
        else:
            for _ in range(2):
                x = x - torch.matmul(_coef(x, self._xc), self._xc)
            x = torch.matmul(self._whitening(x, x, self._eps_rel), x)
            bx = x
        z = torch.zeros_like(x)
        return (x, self._mm(x), bx, z, z, z)

    def _random_rows(self, k):
        """k rows uniform in [-1, 1) from NumPy's global generator (a
        complex block takes a second draw for the imaginary parts), in the
        JAX package's order."""
        rows = (2 * np.random.rand(k, self.dim) - 1).astype(self.dtype)
        if np.dtype(self.dtype).kind == 'c':
            rows = rows + 1j * (2 * np.random.rand(k, self.dim) - 1).astype(
                np.float32)
        return torch.from_numpy(rows).to(self.device)

    # -- driver ------------------------------------------------------------

    def solve(self, eigenvectors, options=None, nwanted=-1, chunk=8,
              verb=0):
        """Compute eigenpairs at the upper margin; converged eigenvectors
        are appended (as rows) to ``eigenvectors``, whose rows on entry are
        constraints.  Returns a Solver-compatible status: 0 success, 1 no
        room for more constraints, 2 iteration limit."""
        if options is None:
            options = Options()
        verb = max(verb, options.verbosity)
        criteria = (options.convergence_criteria or
                    DefaultConvergenceCriteria())
        stopping = options.stopping_criteria
        detect_stagn = options.detect_stagnation
        n = self.dim
        m = options.block_size
        if m is None or m < 1:
            m = 128 if (nwanted < 0 or nwanted > 100) else \
                max(16, nwanted + nwanted // 4)
        m = min(m, max(8, n // 4))
        self.block_size = m
        max_iter = options.max_iter if options.max_iter >= 0 else 100
        min_iter = options.min_iter
        # the capacity of the locked set, grown on demand as the JAX
        # package grows its fixed-shape buffers
        K = self._cap_for(nwanted, m)
        dtype = self.dtype

        # host-side per-slot state (Solver-compatible names)
        self.cnv = np.zeros((m,), dtype=np.int32)
        self.lmd = np.zeros((m,), dtype=np.float64)
        self.res = -np.ones((m,), dtype=np.float32)
        self.err_lmd = -np.ones((2, m), dtype=np.float32)
        self.err_X = -np.ones((2, m), dtype=np.float32)
        iterations = np.zeros((m,), dtype=np.int32)
        dlmd = np.zeros((m, HISTORY), dtype=np.float32)
        dX = np.ones((m,), dtype=np.float32)
        acf = np.ones((2, m), dtype=np.float32)
        cluster = np.zeros((2, m), dtype=np.int32)
        rec = 0
        dlmd_min_right = 0.0
        epsilon = float(np.finfo(np.dtype(dtype).type(0).real.dtype).eps)

        # initial block: reproducible host randomness (the backends'
        # fill_random convention)
        x = self._random_rows(m)
        # any pre-existing constraints
        nc0 = eigenvectors.nvec()
        if nc0 > 0:
            rows = eigenvectors.device_data().to(self.device, x.dtype)
            self._xc = rows.clone()
            self._axc = self._mm(rows)
            self._bxc = self._mm_b(rows) if self.has_b else self._xc
        else:
            self._xc = x.new_zeros((0, n))
            self._axc = self._bxc = self._xc
        self._nc = nc0
        state = self._orthonormal_entry(x)

        self.iteration = 0
        self.restarts = 0
        self.rcon = 0
        self.lcon = 0
        status = 2
        dispatched = 0            # iterations run (restarted ones too)
        sqeps = math.sqrt(epsilon)

        while True:
            if np.amax(iterations) >= max_iter or dispatched >= max_iter:
                status = 2
                break
            iters = int(min(chunk, max_iter - dispatched))
            state, *stats = self._run_chunk(state, iters)
            dispatched += iters
            # the chunk's one host round trip
            lam, res, hist, dx_h, gram_err = fetch(*stats)
            lam_h, pred_h = hist
            if gram_err > sqeps or not np.all(np.isfinite(lam)):
                # Ritz-quality restart (reference core/solver.py:854-920):
                # re-orthonormalize the block against the constraints,
                # recompute its images, reset conjugate directions
                if verb > 0:
                    print('restarting (block non-orthonormality %.1e)...'
                          % gram_err)
                x = torch.nan_to_num(state[0], nan=0.0, posinf=0.0,
                                     neginf=0.0)
                state = self._orthonormal_entry(x)
                self.restarts += 1
                rec = 0
                dlmd[:] = 0
                iterations += iters
                self.iteration += iters
                continue
            # replay the in-chunk trajectories iteration by iteration so
            # the kinematic machinery evolves exactly as it does in the
            # host loop (estimates computed while decrements are still
            # above the recording threshold persist after convergence;
            # _estimate_errors only overwrites entries it has fresh
            # information for)
            for t in range(iters):
                before = lam_h[t].astype(np.float64)
                after = (lam_h[t + 1].astype(np.float64) if t + 1 < iters
                         else lam.astype(np.float64))
                if rec == HISTORY:
                    dlmd[:, :-1] = dlmd[:, 1:]
                else:
                    rec += 1
                # the actual decrement where it stands above rounding,
                # else the predicted one (the host loop's rule)
                delta = before - after
                eps_d = sqeps * np.maximum(np.abs(before), np.abs(after))
                dlmd[:, rec - 1] = np.where(np.abs(delta) > eps_d,
                                            delta, pred_h[t])
                dX[:] = dx_h[t]
                self.lmd[:] = after
                self._estimate_errors(0, m, 0, m, m, rec, dlmd, dX, acf,
                                      self.lmd, self.res, self.err_lmd,
                                      self.err_X, False, verb)
            iterations += iters
            self.iteration += iters
            self.lmd[:] = lam
            self.res[:] = res
            if verb > 1:
                self._print_iterate_table(m, self.lmd, self.res,
                                          self.err_lmd, self.err_X, acf)
            eps_stag = epsilon ** 0.67
            dlmd_min_rgt = eps_stag * np.amax(np.abs(dlmd[:, rec - 1]))
            if self.iteration <= 2 * chunk:
                dlmd_min_right = dlmd_min_rgt
            _find_clusters(cluster, self.lmd, 0, m, 0.0, dlmd_min_rgt)

            rcon = self._sweep(side='right', count=m, left=0, right=max(
                nwanted, 1) if nwanted > 0 else m, ix=0, nx=m,
                shift_invert=False, lmd=self.lmd, iterations=iterations,
                min_iter=min_iter, criteria=criteria,
                detect_stagn=detect_stagn, dlmd=dlmd, rec=rec,
                dlmd_min=dlmd_min_right, cluster=cluster, res=self.res,
                err_X=self.err_X, verb=verb)
            if nwanted > 0:
                rcon = min(rcon, nwanted - self.rcon)

            if rcon > 0 and self._nc + rcon > K:
                # grow the constraint capacity; only reachable in
                # tolerance/interactive-driven mode
                K2 = min(max(2 * K, self._nc + rcon + m), n)
                if K2 <= K:
                    status = 1
                    break
                K = K2

            if rcon > 0:
                first = m - rcon
                # record in ascending slot order (reference _lock order,
                # core/solver.py:1197-1263)
                self.eigenvalues = np.concatenate(
                    (self.eigenvalues, self.lmd[first:]))
                self.eigenvalue_errors.append(self.err_lmd[:, first:])
                self.eigenvector_errors.append(self.err_X[:, first:])
                self.residual_norms = np.concatenate(
                    (self.residual_norms, self.res[first:]))
                self.convergence_status = np.concatenate(
                    (self.convergence_status, self.cnv[first:]))
                self.rcon += rcon
                fresh = self._random_rows(rcon)
                # lock: the top rcon slots (with their exact images) join
                # the constraints, fresh random rows take their place
                x, ax, bx = state[:3]
                self._xc = torch.cat((self._xc, x[first:]))
                self._axc = torch.cat((self._axc, ax[first:]))
                self._bxc = torch.cat((self._bxc, bx[first:])) \
                    if self.has_b else self._xc
                self._nc += rcon
                state = self._orthonormal_entry(
                    torch.cat((x[:first], fresh)))
                # slide per-slot host data: slots keep ascending-eigenvalue
                # identity; top rcon slots are fresh
                _shift_slot_data(self.cnv, self.lmd, self.res, acf,
                                 self.err_lmd, dlmd, self.err_X, dX,
                                 iterations, 0, rcon, m, 0, 0)

            if stopping is not None and rcon > 0:
                if stopping.satisfied(self):
                    status = 0
                    break
            if nwanted > 0 and self.rcon >= nwanted:
                status = 0
                break
            if stopping is None and nwanted < 0:
                status = 0
                break

        # deliver converged rows to the caller's Vectors (locking order)
        if self._nc > nc0:
            rows = self._xc[nc0:self._nc]
            if isinstance(eigenvectors, dense_torch.Vectors):
                eigenvectors.append(dense_torch.Vectors(rows))
            else:
                eigenvectors.append(
                    eigenvectors.new_vectors(rows.cpu().numpy()))
        return status

    @staticmethod
    def _cap_for(nwanted, m):
        if nwanted > 0:
            return int(nwanted + m)
        return int(4 * m)
