"""Block Jacobi-conjugated-gradients core eigensolver.

The port's copy of ``raleigh_tpu/core/solver.py``: the RALEIGH core
algorithm (reference raleigh/core/solver.py) for standard
(A x = lmd x), generalized (A x = lmd B x) and product (A B x = lmd x)
real-symmetric / Hermitian eigenvalue problems, written against the
abstract block-vector contract implemented in ``raleigh_tpu_torch.algebra``
(NumPy host backend ``dense_numpy`` or the torch device backend
``dense_torch``).  The host control flow is the JAX package's, line for
line; only this docstring and the comments that named the TPU differ.

Division of labour:

  * every O(m*n) operation — operator applications, Gram matrices,
    residuals, linear block combinations — is a contract op, i.e. one or two
    device GEMMs (cuBLAS on the card);
  * the data-dependent control flow — convergence / stagnation sweeps,
    cluster handling, block rebalancing, restarts — runs in host Python on
    O(m^2) data between those device calls.

Capability parity notes (checked against the reference):
  - Options fields and semantics          reference core/solver.py:141-197
  - Problem types std/gen/pro             reference core/solver.py:224-258
  - result attributes and statuses        reference core/solver.py:261-302
  - convergence_data query strings        reference core/solver.py:333-387
  - kinematic + residual error estimates  reference core/solver.py:976-1049
  - cluster-aware stagnation handling     reference core/solver.py:1076-1179
  - deflation via approximate Gram
    inverse of converged constraints      reference core/solver.py:754-775
  - Ritz-quality restart                  reference core/solver.py:854-920
  - pivoted-Cholesky direction dropping   reference core/solver.py:1401-1418
  - dense Rayleigh-Ritz fallback          reference core/solver.py:496-585
"""

import math
import sys

import numpy as np
import scipy.linalg as sla

from .dense_small import (adj, cj, re, col_norms, congruence_inv,
                          pivoted_cholesky, default_block_size)


def _backend_helpers(vector):
    """Module-level helper functions of the block-vector backend (fetch,
    combine, stage_coeff, rootabs, conjugation_beta) used to batch device
    round-trips; falls back to the host helpers for third-party backends
    implementing only the plain contract."""
    be = sys.modules.get(type(vector).__module__)
    if be is not None and hasattr(be, 'fetch') and hasattr(be, 'combine') \
            and hasattr(be, 'diag_ratio'):
        return be
    from ..algebra import dense_numpy
    return dense_numpy

# length of the per-vector eigenvalue-decrement history ring buffer
HISTORY = 100


class DefaultConvergenceCriteria:
    """Default per-eigenpair convergence test (reference
    core/solver.py:125-138)."""

    def __init__(self):
        self.tolerance = 1e-3
        self.error = 'kinematic eigenvector error'

    def set_error_tolerance(self, error, tolerance):
        self.error = error
        self.tolerance = tolerance

    def satisfied(self, solver, i):
        err = solver.convergence_data(self.error, i)
        return 0 <= err <= self.tolerance


class Options:
    """Solver options (field-for-field parity with reference
    core/solver.py:141-197; negative values mean "let the solver decide").

    ``threads`` survives as the block-granularity hint: default block sizes
    are rounded to a multiple of it.
    """

    def __init__(self):
        self.verbosity = 0
        self.max_iter = -1
        self.min_iter = 0
        self.block_size = -1
        self.threads = -1
        self.sigma = None
        self.convergence_criteria = None
        self.stopping_criteria = None
        self.detect_stagnation = True
        self.max_quota = 0.75
        # 'auto' lets device-backed interfaces route the iteration to the
        # chunked device engine; 'host' forces the host-orchestrated loop
        self.device_engine = 'auto'


class EstimatedErrors:
    """Pair of (kinematic, residual-based) error-estimate arrays
    (reference core/solver.py:200-221)."""

    def __init__(self):
        self.kinematic = np.zeros((0,), dtype=np.float32)
        self.residual = np.zeros((0,), dtype=np.float32)

    def __getitem__(self, item):
        return self.kinematic[item], self.residual[item]

    def append(self, est):
        self.kinematic = np.concatenate((self.kinematic, est[0, :]))
        self.residual = np.concatenate((self.residual, est[1, :]))

    def reorder(self, ind):
        self.kinematic = self.kinematic[ind]
        self.residual = self.residual[ind]


class Problem:
    """Eigenvalue problem specification (reference core/solver.py:224-258).

    type 'std': A x = lmd x;  'gen': A x = lmd B x;  'pro': A B x = lmd x
    (B positive definite).
    """

    def __init__(self, v, A, B=None, prod=None):
        self.__v = v
        self.__A = A
        self.__B = B
        if B is None:
            self.__type = 'std'
        elif prod is None:
            self.__type = 'gen'
        else:
            self.__type = 'pro'

    def A(self):
        return self.__A

    def B(self):
        return self.__B

    def type(self):
        return self.__type[0]

    def vector(self):
        return self.__v


class _Fatal(Exception):
    pass


class Solver:
    """Core solver driver; public attribute/status parity with reference
    core/solver.py:261-302,419-428."""

    def __init__(self, problem):
        self.__problem = problem
        self.__P = None
        self.iteration = 0
        self.lcon = 0
        self.rcon = 0
        self.eigenvalues = np.zeros((0,), dtype=np.float64)
        self.eigenvalue_errors = EstimatedErrors()
        self.eigenvector_errors = EstimatedErrors()
        self.residual_norms = np.zeros((0,), dtype=np.float32)
        self.convergence_status = np.zeros((0,), dtype=np.int32)
        self.eigenvectors = None
        self.eigenvectors_im = None
        self.block_size = None
        self.cnv = None
        self.lmd = None
        self.res = None
        self.err_lmd = None
        self.err_X = None

    def set_preconditioner(self, P):
        self.__P = P

    def problem(self):
        return self.__problem

    def preconditioner(self):
        return self.__P

    # ------------------------------------------------------------------

    def convergence_data(self, what='residual', which=0):
        """Observability query API (reference core/solver.py:333-387)."""
        w = what.lower()
        if 'block' in w:
            return self.block_size
        if 'res' in w and 'vec' not in w:
            max_lmd = np.amax(np.abs(self.lmd))
            if self.lcon + self.rcon > 0:
                max_lmd = max(max_lmd, np.amax(np.abs(self.eigenvalues)))
            return self.res[which] / max_lmd
        if 'val' in w:
            if 'max' in w:
                max_lmd = np.amax(np.abs(self.lmd))
                if self.lcon + self.rcon > 0:
                    max_lmd = max(max_lmd, np.amax(np.abs(self.eigenvalues)))
                return max_lmd
            if 'err' in w:
                err = self.err_lmd[:, which]
                return err[0] if 'k' in w else err[1]
            return self.lmd[which]
        if 'vec' in w:
            err = self.err_X[:, which]
            return err[0] if 'k' in w else err[1]
        raise ValueError('convergence data %s not found' % what)

    # ------------------------------------------------------------------

    def solve(self, eigenvectors, options=None, which=(-1, -1),
              extra=(-1, -1), init=(None, None)):
        """Compute eigenpairs; see reference core/solver.py:389-428 for the
        parameter/status contract.

        Returns 0 success, 1 iteration limit, 2 no search directions,
        3/4 some requested left/right eigenvalues may not exist, <0 fatal.
        """
        if options is None:
            options = Options()
        verb = options.verbosity

        left, right, largest = _parse_which(which)
        if left == 0 and right == 0:
            if verb > -1:
                print('No eigenpairs requested, quit')
            return 0

        m = int(options.block_size)
        if m < 0:
            ic = (init[0].nvec() if init[0] is not None else 0,
                  init[1].nvec() if init[1] is not None else 0)
            m = default_block_size(left, right, extra, ic, options.threads)
        else:
            min_m = 3 if ((left == 0 or right == 0) and not largest) else 4
            if m < min_m:
                if verb > -1:
                    print('Block size %d too small, using %d' % (m, min_m))
                m = min_m
        self.block_size = m

        n = eigenvectors.dimension()

        self.iteration = 0
        self.lcon = 0
        self.rcon = 0
        self.eigenvalues = np.zeros((0,), dtype=np.float64)
        self.eigenvalue_errors = EstimatedErrors()
        self.eigenvector_errors = EstimatedErrors()
        self.residual_norms = np.zeros((0,), dtype=np.float32)
        self.convergence_status = np.zeros((0,), dtype=np.int32)

        if m < n // 2:
            try:
                status = self._iterate(eigenvectors, options, which, extra,
                                       init)
            except (_Fatal, np.linalg.LinAlgError, sla.LinAlgError) as err:
                if verb > -1:
                    print('solver error: %s' % err)
                return -1
            if status > 1:
                if verb > -1:
                    print('core solver return status %d' % status)
                return status - 1
            if status == 0:
                self._maybe_refine_eigenvalues(eigenvectors, verb)
                return 0
        # CG could not (or was not asked to) compute everything: finish with
        # a dense Rayleigh-Ritz procedure in the orthogonal complement of the
        # converged eigenvectors (reference core/solver.py:496-585)
        self._dense_complement_rr(eigenvectors, verb)
        self._maybe_refine_eigenvalues(eigenvectors, verb)
        return 0

    def _maybe_refine_eigenvalues(self, Xc, verb=0):
        """Final compensated Rayleigh-quotient pass: when the iterated
        Vectors advertise compensated reductions
        (``Vectors(compensated=True)``: f32 storage whose fetched Grams
        are taken in f64), re-evaluate every converged eigenvalue as
        <x, A x> / <x, B x> through those f64 dots.  The hot iteration
        keeps its device-resident f32 Grams — only this one per-solve
        reduction pays the f64 cost, and it removes the ~1e-7 f32
        ceiling the device-kept Ritz values carry (the converged VECTORS
        are far more accurate than the f32 Rayleigh quotients that
        reported them)."""
        active = getattr(Xc, '_comp_active', None)
        if active is None or not active(Xc, False):
            return
        k = min(Xc.nvec(), self.eigenvalues.size)
        if k == 0:
            return
        problem = self.__problem
        ptype = problem.type()
        opA, opB = problem.A(), problem.B()
        n = Xc.dimension()
        sel = Xc.selected()
        try:
            Xc.select(k)
            Y = Xc.new_vectors(k, n)
            if ptype == 'p':                      # A B x = lmd x
                Z = Xc.new_vectors(k, n)
                opB.apply(Xc, Z)
                opA.apply(Z, Y)
                num = Xc.dots(Y)
                den = Xc.dots(Xc)
            else:
                opA.apply(Xc, Y)
                num = Xc.dots(Y)
                if ptype == 'g':                  # A x = lmd B x
                    Z = Xc.new_vectors(k, n)
                    opB.apply(Xc, Z)
                    den = Xc.dots(Z)
                else:
                    den = Xc.dots(Xc)
            refined = np.real(np.asarray(num)) / np.real(np.asarray(den))
            self.eigenvalues = self.eigenvalues.copy()
            self.eigenvalues[:k] = refined[:k]
            if verb > 1:
                print('compensated eigenvalue refinement over %d pairs' % k)
        finally:
            Xc.select(sel[1], sel[0])

    # ------------------------------------------------------------------

    def _dense_complement_rr(self, eigenvectors, verb):
        problem = self.__problem
        std = problem.type() == 's'
        pro = problem.type() == 'p'
        Xc = eigenvectors
        nc = Xc.nvec()
        n = Xc.dimension()
        m = n - nc
        if verb > -1:
            print('%d eigenpairs not computed by CG, applying Rayleigh-Ritz'
                  ' procedure in the complement subspace...' % m)
        data_type = eigenvectors.data_type()
        X = eigenvectors.new_vectors(m)
        X.fill_random()
        Y = X.new_vectors(m)
        Z = X.new_vectors(m)
        opA = problem.A()
        opB = problem.B()

        if nc > 0:
            if not std:
                BXc = eigenvectors.clone()
                opB.apply(Xc, BXc)
            else:
                BXc = Xc
            Gc = BXc.dot(Xc)
            Gci = 2 * np.identity(nc, dtype=data_type) - Gc
            for _ in range(2):  # double orthogonalization against constraints
                Q = np.dot(Gci, X.dot(BXc))
                X.add(Xc, -1.0, Q)

        if not std:
            opB.apply(X, Y)
            XBX = Y.dot(X)
        else:
            XBX = X.dot(X)
        lmd, Q = sla.eigh(-XBX)
        lmd = -lmd
        epsilon = 100 * np.finfo(data_type).eps
        k = int(np.sum(lmd <= epsilon * lmd[0]))
        if k > 0:
            if verb > -1:
                print('dropping %d linear dependent vectors from the'
                      ' Rayleigh-Ritz procedure...' % k)
            X.multiply(Q, Z)
            Z.copy(X)
            Y.multiply(Q, Z)
            Z.copy(Y)
            m -= k
            X.select(m)
            Y.select(m)
            Z.select(m)
            if not std:
                opB.apply(X, Y)
                XBX = Y.dot(X)
            else:
                XBX = X.dot(X)
        if pro:
            opA.apply(Y, Z)
            XAX = Z.dot(Y)
        else:
            opA.apply(X, Z)
            XAX = Z.dot(X)
        lmdx, Q = sla.eigh(XAX, XBX)
        X.multiply(Q, Z)
        Z.copy(X)
        eigenvectors.append(X)
        self.eigenvalues = np.concatenate((self.eigenvalues, lmdx))

    # ------------------------------------------------------------------

    def _iterate(self, eigenvectors, options, which, extra, init):
        """The block Jacobi-CG iteration (reference core/solver.py:587-1665).

        Internal status codes: 0 success, 1 max_quota reached (caller runs
        the dense fallback), 2 iteration limit, 3 no search directions,
        4 requested left eigenvalues may not exist (shift-invert),
        5 same for right.
        """
        verb = options.verbosity
        shift_invert = options.sigma is not None

        left, right, largest = _parse_which(which)
        if largest:
            left = right = which if np.isscalar(which) else int(which)

        m = self.block_size
        # split the block between the two spectrum margins
        if left == 0 and not largest:
            left_ratio, l = 0.0, 1
        elif right == 0:
            left_ratio, l = 1.0, m - 1
        elif left > 0 and right > 0:
            left_ratio = left / (left + 1.0 * right)
            l = min(max(int(round(left_ratio * m)), 2), m - 2)
        else:
            left_ratio, l = 0.5, m // 2
        block_size = m
        left_block_size = l

        extra_left, extra_right = int(extra[0]), int(extra[1])
        left_total = right_total = 0
        if left >= 0:
            left_total = (left + extra_left if extra_left > 0
                          else max(left + 1, left_block_size))
        if right >= 0:
            right_total = (right + extra_right if extra_right > 0
                           else max(right + 1, block_size - left_block_size))
        if verb > 0:
            print('left block size %d, right block size %d' % (l, m - l))

        problem = self.__problem
        vector = problem.vector()
        ptype = problem.type()
        std, gen, pro = ptype == 's', ptype == 'g', ptype == 'p'
        data_type = vector.data_type()
        epsilon = float(np.finfo(data_type).eps)
        single = np.finfo(data_type).eps > 1e-10

        # per-slot convergence data exposed through convergence_data()
        self.cnv = np.zeros((m,), dtype=np.int32)
        self.lmd = np.zeros((m,), dtype=np.float64)
        self.res = -np.ones((m,), dtype=np.float32)
        self.err_lmd = -np.ones((2, m), dtype=np.float32)
        self.err_X = -np.ones((2, m), dtype=np.float32)
        lmd, res, err_lmd, err_X = self.lmd, self.res, self.err_lmd, self.err_X

        criteria = options.convergence_criteria or DefaultConvergenceCriteria()
        detect_stagn = options.detect_stagnation

        # convergence history
        iterations = np.zeros((m,), dtype=np.int32)
        dlmd = np.zeros((m, HISTORY), dtype=np.float32)
        dX = np.ones((m,), dtype=np.float32)
        acf = np.ones((2, m), dtype=np.float32)
        cluster = np.zeros((2, m), dtype=np.int32)
        dlmd_min_left = dlmd_min_right = 0.0

        # workspace blocks
        X = vector.new_vectors(m)
        X.fill_random()
        Y = vector.new_vectors(m)
        Z = vector.new_vectors(m)
        W = vector.new_vectors(m)
        AX = vector.new_vectors(m)
        AY = vector.new_vectors(m)
        if not std:
            BX = vector.new_vectors(m)
            BY = vector.new_vectors(m)
        else:
            BX, BY = X, Y
        AZ, BZ = AY, BY

        opA = problem.A()
        opB = problem.B()
        A = opA.apply
        B = opB.apply if opB is not None else None
        P = self.__P.apply if self.__P is not None else None

        # initial guesses
        l = left_block_size
        init_left = 0
        if init[0] is not None:
            init_left = min(l, init[0].nvec())
            X.select(init_left)
            init[0].select(init_left)
            init[0].copy(X)
        if init[1] is not None:
            init_right = min(m - l, init[1].nvec())
            X.select(init_right, init_left)
            init[1].select(init_right)
            init[1].copy(X)

        # replace zero guesses with random vectors, then normalize
        X.select(m)
        s = X.dots(X)
        for i in range(m):
            if s[i] == 0.0:
                if verb > -1:
                    print('Zero initial guess, replacing with random')
                X.select(1, i)
                X.fill_random()
                s[i:i + 1] = X.dots(X)
        X.select(m)
        X.scale(np.sqrt(X.dots(X).real))

        # constraints: previously computed eigenvectors
        self.eigenvectors = eigenvectors
        Xc = eigenvectors
        nc = Xc.nvec()
        if not std:
            BXc = eigenvectors.clone()
            if nc > 0:
                B(Xc, BXc)
            self.eigenvectors_im = BXc
        else:
            BXc = Xc
        be = _backend_helpers(vector)
        Gci = None
        Gci_k = None   # staged (device-resident) copy for combine()
        Gc = None
        if nc > 0:
            Gc = BXc.dot(Xc)
            # approximate inverse of the constraint Gram matrix: adequate
            # while off-diagonal entries stay below sqrt(eps)
            Gci = 2 * np.identity(nc, dtype=data_type) - Gc
            Gci_k = be.stage_coeff(Gci)

        leftX = left_block_size
        rightX = block_size - leftX
        rec = 0           # valid history length
        ix = 0            # first active slot
        nx = block_size   # number of active slots
        ny = block_size
        nz = 0            # number of previous search directions
        lmdz = None

        if nc > 0:
            Q = np.dot(Gci, X.dot(BXc))
            X.add(Xc, -1.0, Q)

        if not std:
            B(X, BX)
        XBX = BX.dot(X)

        # eliminate linearly dependent initial vectors
        U, order, dropped = pivoted_cholesky(XBX, 0, 1e-2)
        if dropped > 0:
            if verb > 0:
                print('dropped %d initial vectors out of %d' % (dropped, nx))
            nx -= dropped
            keep = order[:nx]
            if nx > 0:
                W.select(nx)
                X.copy(W, keep)
                X.select(nx)
                W.copy(X)
            X.select(dropped, nx)
            X.fill_random()
            if not std:
                if nx > 0:
                    BX.copy(W, keep)
                    BX.select(nx)
                    W.copy(BX)
                BX.select(dropped, nx)
                B(X, BX)
            if nc > 0:
                Q = np.dot(Gci, X.dot(BXc))
                Xc.multiply(Q, W)
                X.add(W, -1.0)
                if not std:
                    BXc.multiply(Q, W)
                    BX.add(W, -1.0)
            nx = m
            X.select(nx)
            if not std:
                BX.select(nx)
            XBX = BX.dot(X)

        # Rayleigh-Ritz in the initial subspace
        if pro:
            A(BX, AX)
            XAX = AX.dot(BX)
        else:
            A(X, AX)
            XAX = AX.dot(X)
        lmdx, Q = sla.eigh(XAX, XBX)
        W.select(m)
        X.multiply(Q, W)
        W.copy(X)
        AX.multiply(Q, W)
        W.copy(AX)
        if not std:
            BX.multiply(Q, Z)
            Z.copy(BX)

        max_iter = options.max_iter if options.max_iter >= 0 else 100
        min_iter = options.min_iter
        self.iteration = 0

        # ======================= main CG loop ==========================
        while True:
            maxit = 0
            if left != 0 and left_block_size > 0:
                maxit = np.amax(iterations[:left_block_size])
            if right != 0 and left_block_size < block_size:
                maxit = max(maxit, np.amax(iterations[left_block_size:]))
            if maxit >= max_iter:
                if verb > -1:
                    print('iterations limit of %d exceeded, terminating'
                          % max_iter)
                return 2
            if verb > 0:
                print('------------- iteration %d' % self.iteration)

            def residual_dots(neg_lmd):
                """W := AX - (B)X*lmd orthogonalized against the constraint
                set; returns the backend-kept residual-norm dots handle.
                ``neg_lmd`` may be backend-resident (no host round-trip)."""
                W.select(nx, ix)
                Y.select(nx)
                AX.copy(W)
                W.add(BX if gen else X, neg_lmd)
                if Xc.nvec() > 0:
                    Qc = be.combine(Gci_k,
                                    W.dot(BXc if pro else Xc, keep=True))
                    if gen:
                        W.add(BXc, -1.0, Qc)
                    else:
                        W.add(Xc, -1.0, Qc)
                if pro:
                    W.copy(Y)
                    B(Y, W)
                    return W.dots(Y, keep=True)
                return W.dots(W, keep=True)

            xax_k = AX.dot(BX if pro else X, keep=True)
            xbx_k = BX.dot(X, keep=True)
            # residuals are formed speculatively with backend-resident Ritz
            # values so their norms ride the same device round-trip as the
            # Gram matrices (one fetch instead of two per iteration; the
            # rare restart path below recomputes them)
            s_k = residual_dots(-be.diag_ratio(xax_k, xbx_k))
            XAX, XBX, s = be.fetch(xax_k, xbx_k, s_k)
            XAX = XAX[:nx, :nx]
            XBX = XBX[:nx, :nx]
            new_lmd = re(XAX.diagonal() / XBX.diagonal())

            # Ritz-quality check: restart on lost orthonormality/accuracy
            rv_err = np.amax(np.abs(new_lmd - lmdx)) / np.amax(np.abs(lmdx))
            rv_no = np.amax(np.abs(XBX - np.eye(nx)))
            if verb > 2:
                print('Ritz values error: %.1e' % rv_err)
                print('Ritz vectors non-orthonormality: %.1e' % rv_no)
            if max(rv_err, rv_no) > math.sqrt(epsilon):
                if verb > 0:
                    print('restarting (rv_err %.1e, rv_no %.1e)...'
                          % (rv_err, rv_no))
                rec = 0
                nz = 0
                X.svd()  # re-orthonormalize the active block
                if std:
                    XBX = X.dot(X)
                else:
                    B(X, BX)
                    XBX = BX.dot(X)
                if pro:
                    A(BX, AX)
                    XAX = AX.dot(BX)
                else:
                    A(X, AX)
                    XAX = AX.dot(X)
                lmdx, Q = sla.eigh(XAX, XBX)
                W.select(nx)
                X.multiply(Q, W)
                W.copy(X)
                AX.multiply(Q, W)
                W.copy(AX)
                if not std:
                    BX.multiply(Q, W)
                    W.copy(BX)
                if pro:
                    XAX = AX.dot(BX)
                else:
                    XAX = AX.dot(X)
                XBX = X.dot(X) if std else BX.dot(X)
                new_lmd = re(XAX.diagonal() / XBX.diagonal())
                s = be.fetch(residual_dots(-new_lmd))[0]

            iterations[ix:ix + nx] += 1
            if rec > 0:
                # record actual eigenvalue decrements into the history slot
                # predicted at the end of the previous iteration
                for i in range(nx):
                    delta = lmd[ix + i] - new_lmd[i]
                    eps_d = math.sqrt(epsilon) * max(abs(lmd[ix + i]),
                                                     abs(new_lmd[i]))
                    if abs(delta) > eps_d:
                        dlmd[ix + i, rec - 1] = delta

            lmd[ix:ix + nx] = new_lmd

            # residual norms (std W = A X - X L, gen W = A X - B X L,
            # pro W = A B X - X L) were computed by residual_dots above
            res[ix:ix + nx] = np.sqrt(np.abs(np.asarray(s)[:nx]))

            self._estimate_errors(ix, nx, leftX, rightX, block_size, rec,
                                  dlmd, dX, acf, lmd, res, err_lmd, err_X,
                                  gen, verb)

            if verb > 1:
                self._print_iterate_table(block_size, lmd, res, err_lmd,
                                          err_X, acf)

            # stagnation thresholds and eigenvalue clusters
            eps_stag = epsilon ** 0.67
            lbs = left_block_size
            dlmd_min_lft = dlmd_min_rgt = 0.0
            if lbs > 0:
                dlmd_min_lft = eps_stag * np.amax(np.abs(dlmd[:lbs, rec - 1]))
            if lbs < block_size:
                dlmd_min_rgt = eps_stag * np.amax(np.abs(dlmd[lbs:, rec - 1]))
            if self.iteration == 2:
                dlmd_min_left = dlmd_min_lft
                dlmd_min_right = dlmd_min_rgt
            if self.iteration >= 2:
                _find_clusters(cluster, lmd, left_block_size, block_size,
                               dlmd_min_lft, dlmd_min_rgt)
                if verb > 2:
                    print(cluster[0, :])
                    print(cluster[1, :])

            # convergence/stagnation sweeps from both block edges
            lcon = self._sweep(side='left', count=leftX, left=left,
                               right=right, ix=ix, nx=nx,
                               shift_invert=shift_invert, lmd=lmd,
                               iterations=iterations, min_iter=min_iter,
                               criteria=criteria, detect_stagn=detect_stagn,
                               dlmd=dlmd, rec=rec,
                               dlmd_min=dlmd_min_left, cluster=cluster,
                               res=res, err_X=err_X, verb=verb)
            rcon = self._sweep(side='right', count=rightX, left=left,
                               right=right, ix=ix, nx=nx,
                               shift_invert=shift_invert, lmd=lmd,
                               iterations=iterations, min_iter=min_iter,
                               criteria=criteria, detect_stagn=detect_stagn,
                               dlmd=dlmd, rec=rec,
                               dlmd_min=dlmd_min_right, cluster=cluster,
                               res=res, err_X=err_X, verb=verb)

            if largest:
                # make sure eigenvalues of largest magnitude converge first
                cnv = self.cnv
                if lcon > 0:
                    i = ix + lcon - 1
                    j = ix + nx - rcon - 1
                    while lcon > 0 and abs(lmd[i]) < abs(lmd[j]):
                        cnv[i] = 0
                        lcon -= 1
                        i -= 1
                if rcon > 0:
                    i = ix + lcon
                    j = ix + nx - rcon
                    while rcon > 0 and abs(lmd[i]) > abs(lmd[j]):
                        cnv[j] = 0
                        rcon -= 1
                        j += 1

            # move converged eigenvectors into the constraint set
            ncon = Xc.nvec()
            if lcon > 0:
                ncon, Gc = self._lock(Xc, BXc, X, BX, std, ix, lcon, ncon,
                                      Gc, lmd, res, err_lmd, err_X)
            if rcon > 0:
                jx = ix + nx
                ncon, Gc = self._lock(Xc, BXc, X, BX, std, jx - rcon, rcon,
                                      ncon, Gc, lmd, res, err_lmd, err_X)
            if ncon > 0 and (lcon > 0 or rcon > 0):
                if verb > 2:
                    print('Gram error: %e'
                          % np.linalg.norm(Gc - np.identity(ncon)))
                Gci = 2 * np.identity(ncon, dtype=data_type) - Gc
                Gci_k = be.stage_coeff(Gci)

            self.lcon += lcon
            self.rcon += rcon
            if options.stopping_criteria is not None:
                if options.stopping_criteria.satisfied(self):
                    return 0
            if largest and right > 0 and self.lcon + self.rcon >= right:
                return 0
            left_converged = 0 <= left <= self.lcon
            right_converged = 0 <= right <= self.rcon
            if left_converged and right_converged:
                return 0
            if shift_invert:
                # in shift-invert mode, a positive (negative) eigenvalue of
                # the transformed operator lying safely away from zero means
                # no further eigenvalues exist on that side of the shift
                if right_converged:
                    i = ix + lcon
                    err_i = err_lmd[0, i]
                    if lmd[i] > 0 and err_i != -1.0 and err_i < lmd[i] / 4:
                        return 4
                if left_converged:
                    i = ix + nx - rcon - 1
                    err_i = err_lmd[0, i]
                    if lmd[i] < 0 and err_i != -1.0 and err_i < -lmd[i] / 4:
                        return 5
            if eigenvectors.nvec() > options.max_quota * eigenvectors.dimension():
                return 1

            leftX -= lcon
            rightX -= rcon

            iy, ny = ix, nx
            ix += lcon
            nx -= lcon + rcon
            X.select(nx, ix)
            AX.select(nx, ix)
            if not std:
                BX.select(nx, ix)
            XAX = XAX[lcon:lcon + nx, lcon:lcon + nx]
            XBX = XBX[lcon:lcon + nx, lcon:lcon + nx]

            # new search directions: preconditioned residuals
            if not pro:
                if P is None:
                    W.copy(Y)
                else:
                    P(W, Y)

            if nz > 0:
                # Jacobi conjugation: B-orthogonalize new directions against
                # previous ones using eigenvalue differences as denominators;
                # the coefficient matrix is formed in backend-native space
                # (on device) — no host round-trip
                zay_k = (W if pro else Y).dot(AZ, keep=True)
                zby_k = Y.dot(Z if std else BZ, keep=True)
                ny = Y.nvec()
                Beta = be.conjugation_beta(zay_k, zby_k, lmd[iy:iy + ny],
                                           np.asarray(lmdz),
                                           Y.dots(Y, keep=True),
                                           Z.dots(Z, keep=True), data_type)
                AZ.select(ny)
                Y.add(Z, -1.0, Beta)
                if pro:
                    W.add(BZ, -1.0, Beta)
                    BY.select(ny)
                    W.copy(BY)
            elif pro:
                BY.select(ny)
                W.copy(BY)

            Qxy = Y.dot(BX, keep=True)
            Y.add(X, -1.0, Qxy)
            if pro:
                BY.add(BX, -1.0, Qxy)

            if Xc.nvec() > 0:
                Qc = be.combine(Gci_k, Y.dot(BXc, keep=True))
                Y.add(Xc, -1.0, Qc)
                if pro:
                    BY.add(BXc, -1.0, Qc)

            # (B-)Gram matrix of (X, Y)
            if std:
                s = be.rootabs(Y.dots(Y, keep=True))
                Y.scale(s)
                if nx > 0:
                    xby_k = Y.dot(X, keep=True)
                yby_k = Y.dot(Y, keep=True)
            else:
                BY.select(Y.nvec())
                if not pro:
                    B(Y, BY)
                s = be.rootabs(BY.dots(Y, keep=True))
                Y.scale(s)
                BY.scale(s)
                if nx > 0:
                    xby_k = BY.dot(X, keep=True)
                yby_k = BY.dot(Y, keep=True)
            nyc = Y.nvec()

            # A-images of ALL candidate directions before the linear-
            # dependence drop, so the A- and B-Gram blocks come back in ONE
            # device round-trip.  The (rare) dropped directions cost one
            # wasted operator column each; the saved fetch latency is paid
            # on every iteration.  The post-drop Gram matrices are then
            # submatrices of the precomputed ones (Gram entries are pairwise
            # inner products, so permutation of the basis = permutation of
            # the matrix).
            AY.select(nyc)
            if pro:
                A(BY, AY)
                if nx > 0:
                    xay_k = AY.dot(BX, keep=True)
                yay_k = AY.dot(BY, keep=True)
            else:
                A(Y, AY)
                if nx > 0:
                    xay_k = AY.dot(X, keep=True)
                yay_k = AY.dot(Y, keep=True)
            if nx > 0:
                XBY, YBY, XAY, YAY = be.fetch(xby_k, yby_k, xay_k, yay_k)
                XBY = XBY[:nx, :nyc]
                XAY = XAY[:nx, :nyc]
                GB = np.block([[XBX, XBY], [adj(XBY), YBY[:nyc, :nyc]]])
                GA_full = np.block([[XAX, XAY],
                                    [adj(XAY), YAY[:nyc, :nyc]]])
            else:
                YBY, YAY = be.fetch(yby_k, yay_k)
                GB = YBY[:nyc, :nyc]
                GA_full = YAY[:nyc, :nyc]

            # drop linearly dependent search directions
            ny = nyc
            eps_dep = 1e-3 if single else 1e-8
            U, order, dropped = pivoted_cholesky(GB, nx, eps_dep)
            if dropped > 0 and verb > 0:
                print('dropped %d search directions out of %d'
                      % (dropped, ny))
            ny -= dropped
            if ny < 1:
                if verb > -1:
                    print('no search directions left, terminating')
                return 3
            nxy = nx + ny
            U = U[:nxy, :nxy]
            indy = order[nx:nxy] - nx
            GA = GA_full[np.ix_(order[:nxy], order[:nxy])]
            if dropped > 0 or not np.array_equal(indy, np.arange(ny)):
                W.select(ny)
                Y.copy(W, indy)
                Y.select(ny)
                W.copy(Y)
                AY.copy(W, indy)
                AY.select(ny)
                W.copy(AY)
                if not std:
                    BY.copy(W, indy)
                    BY.select(ny)
                    W.copy(BY)
            else:
                Y.select(ny)
                AY.select(ny)
                if not std:
                    BY.select(ny)

            # Rayleigh-Ritz in span(X, Y): G = U^-H GA U^-1, pre-rotated by
            # the eigenbasis of its Y-block for numerical stability, then a
            # full float64 eigendecomposition
            G = congruence_inv(GA, U)
            lmdy, Qy = sla.eigh(G[nx:nxy, nx:nxy])
            G[:, nx:nxy] = np.dot(G[:, nx:nxy], Qy)
            if nx > 0:
                G[nx:nxy, :nx] = adj(G[:nx, nx:nxy])
            G[nx:nxy, nx:nxy] = np.dot(adj(Qy), G[nx:nxy, nx:nxy])
            G = G.astype(np.complex128 if G.dtype.kind == 'c' else np.float64)
            lmdxy, Q = sla.eigh(G)
            lmdxy = lmdxy.astype(lmdy.dtype)
            Q = Q.astype(Qy.dtype)

            # predicted eigenvalue/eigenvector changes (kinematic data)
            lmdx_pred = np.concatenate((lmdxy[:leftX], lmdxy[nxy - rightX:]))
            lmdy_mid = lmdxy[leftX:nxy - rightX]
            QX = np.concatenate((Q[:, :leftX], Q[:, nxy - rightX:]), axis=1)
            QYX = QX[nx:, :]
            Delta = (lmdy_mid[:, None] - lmdx_pred[None, :]) * QYX * QYX
            dX[ix:ix + nx] = col_norms(QYX)
            if rec == HISTORY:
                dlmd[:, :-1] = dlmd[:, 1:]
            else:
                rec += 1
            dlmd[ix:ix + nx, rec - 1] = re(np.sum(Delta, axis=0))

            # rebalance the block between the two margins
            (shift_left, shift_right, leftX_new, rightX_new,
             left_block_size_new, ix_new, left_ratio) = \
                self._rebalance(left, right, lcon, rcon, ix, nx, ny, nxy,
                                leftX, rightX, block_size, left_block_size,
                                left_total, right_total, left_ratio, verb)
            nx_new = leftX_new + rightX_new
            if verb > 2:
                print('left X: was %d, now %d' % (leftX, leftX_new))
                print('right X: was %d, now %d' % (rightX, rightX_new))
                print('new ix %d, new nx %d, nxy %d' % (ix_new, nx_new, nxy))

            _shift_slot_data(self.cnv, lmd, res, acf, err_lmd, dlmd, err_X,
                             dX, iterations, shift_left, shift_right,
                             block_size, left_block_size,
                             left_block_size_new)

            # Rayleigh-Ritz basis change: pull Q back to the (X, Y) basis,
            # then split its columns - the outer (kept Ritz-pair) columns
            # rebuild X, the interior ones become the conjugate history Z
            Q[nx:nxy, :] = np.dot(Qy, Q[nx:nxy, :])
            Q = sla.solve_triangular(U, Q)
            outer = np.r_[0:leftX_new, nxy - rightX_new:nxy]
            lmdx = lmdxy[outer]
            lmdz = lmdxy[leftX_new:nxy - rightX_new]
            cX = np.ascontiguousarray(Q[:, outer])
            cZ = np.ascontiguousarray(Q[:, leftX_new:nxy - rightX_new])
            nz = cZ.shape[1]

            def retarget(top, bot, dst_x, dst_z, via):
                """dst_x <- [top; bot] cX and dst_z <- [top; bot] cZ on
                the backend.  Both combinations are formed in scratch
                (W resp. ``via``) before either destination is written:
                the workspace aliases dst_x with ``top`` and — for the
                A-/B-image triples — dst_z with ``bot`` (AZ is AY, BZ is
                BY), so a destination write before both reads would
                corrupt the other combination's source."""
                zbuf = dst_z if via is None else via
                if nz > 0:
                    zbuf.select(nz)
                    bot.multiply(cZ[nx:], zbuf)
                    if nx > 0:
                        zbuf.add(top, 1.0, cZ[:nx])
                W.select(nx_new)
                if nx > 0:
                    top.multiply(cX[:nx], W)
                    W.add(bot, 1.0, cX[nx:])
                else:
                    bot.multiply(cX[nx:], W)
                if nz > 0 and via is not None:
                    dst_z.select(nz)
                    zbuf.copy(dst_z)
                dst_x.select(nx_new, ix_new)
                W.copy(dst_x)

            retarget(AX, AY, AX, AZ, via=Z)
            if std:
                BZ = Z
            else:
                retarget(BX, BY, BX, BZ, via=Z)
            retarget(X, Y, X, Z, via=None)
            Z.select(nz if nz > 0 else nx_new)

            nx = nx_new
            ix = ix_new
            leftX = leftX_new
            rightX = rightX_new
            left_block_size = left_block_size_new
            self.iteration += 1

    # ------------------------------------------------------------------

    def _estimate_errors(self, ix, nx, leftX, rightX, block_size, rec,
                         dlmd, dX, acf, lmd, res, err_lmd, err_X, gen, verb):
        """Kinematic (convergence-history) and residual-based (Lehmann /
        extended-gap Davis-Kahan) error estimates; parity with reference
        core/solver.py:976-1049."""
        if rec > 3:
            for i in range(nx):
                if dX[ix + i] > 0.01:
                    err_X[0, ix + i] = -1.0
                    continue
                k = 0
                s = 0.0
                for r in range(rec - 1, rec - rec // 3 - 2, -1):
                    d = abs(dlmd[ix + i, r])
                    if d == 0:
                        break
                    k += 1
                    s += d
                if k < 2 or s == 0:
                    continue
                qi = abs(dlmd[ix + i, rec - 1]) / s
                if qi <= 0:
                    continue
                qi = qi ** (1.0 / (k - 1))
                acf[1, ix + i] = acf[0, ix + i]
                acf[0, ix + i] = qi
                if qi >= 1.0:
                    continue
                theta = qi / (1 - qi)
                err_lmd[0, ix + i] = abs(theta * dlmd[ix + i, rec - 1])
                qx = math.sqrt(qi)
                err_X[0, ix + i] = dX[ix + i] * qx / (1 - qx)

        if not gen:
            # residual-based estimates need a spectral gap "pole"; invalid
            # for the generalized problem
            l = 0
            for k in range(1, leftX):
                i = ix + k
                if dX[i] > 0.01:
                    break
                if lmd[i] - lmd[i - 1] > res[i]:
                    l = k
            if l > 0:
                t = lmd[ix + l]
                if verb > 2:
                    print('using left pole at lmd[%d] = %e' % (ix + l, t))
                for k in range(l):
                    i = ix + k
                    s = res[i]
                    err_lmd[1, i] = s * s / (t - lmd[i])
                    err_X[1, i] = s / (t - lmd[i])
            l = 0
            for k in range(1, rightX):
                i = ix + nx - k - 1
                if dX[i] > 0.01:
                    break
                if lmd[i + 1] - lmd[i] > res[i]:
                    l = k
            if l > 0:
                t = lmd[ix + nx - l - 1]
                if verb > 2:
                    print('using right pole at lmd[%d] = %e'
                          % (ix + nx - l - 1, t))
                for k in range(l):
                    i = ix + nx - k - 1
                    s = res[i]
                    err_lmd[1, i] = s * s / (lmd[i] - t)
                    err_X[1, i] = s / (lmd[i] - t)

    def _print_iterate_table(self, block_size, lmd, res, err_lmd, err_X, acf):
        print('  eigenvalue   residual   estimated errors'
              ' (kinematic/residual)      a.c.f.')
        print('                             eigenvalue            eigenvector')
        for i in range(block_size):
            print('%14e %8.1e  %8.1e / %8.1e    %.1e / %.1e  %.3e  %d'
                  % (lmd[i], res[i], err_lmd[0, i], err_lmd[1, i],
                     abs(err_X[0, i]), abs(err_X[1, i]), acf[0, i],
                     self.cnv[i]))

    def _sweep(self, side, count, left, right, ix, nx, shift_invert, lmd,
               iterations, min_iter, criteria, detect_stagn, dlmd, rec,
               dlmd_min, cluster, res, err_X, verb):
        """Contiguous convergence/stagnation sweep from one block edge
        (reference core/solver.py:1100-1179)."""
        cnv = self.cnv
        ncon = 0
        for i in range(count - count // 4):
            if side == 'left':
                if left == 0:
                    return ncon
                k = ix + i
                j = self.lcon + i
                if shift_invert and lmd[k] > 0:
                    return ncon
            else:
                if right == 0:
                    return ncon
                k = ix + nx - i - 1
                j = self.rcon + i
                if shift_invert and lmd[k] < 0:
                    return ncon
            it = iterations[k]
            if it < min_iter:
                return ncon
            dlmd1 = abs(dlmd[k, max(0, rec - 1)])
            dlmd2 = abs(dlmd[k, max(0, rec - 3)])
            if criteria.satisfied(self, k):
                if verb > 0:
                    print('%s eigenpair %d converged after %d iterations,\n'
                          ' eigenvalue %e, error %.1e / %.1e'
                          % (side, j, it, lmd[k], err_X[0, k], err_X[1, k]))
                ncon += 1
                cnv[k] = self.iteration + 1
            elif detect_stagn and it > 2 and dlmd1 <= dlmd_min \
                    and (dlmd1 > dlmd2 or dlmd1 == 0.0):
                if verb > 0:
                    print('%s eigenpair %d stagnated,\n'
                          ' eigenvalue %e, error %.1e / %.1e'
                          % (side, j, lmd[k], err_X[0, k], err_X[1, k]))
                ncon += 1
                cnv[k] = -self.iteration - 1
            else:
                # an unconverged iterate invalidates trailing stagnation
                # flags inside the same eigenvalue cluster
                if cluster[0, k] > 0:
                    rng = (range(k - 1, k - cluster[1, k], -1)
                           if side == 'left'
                           else range(k + 1, k + cluster[1, k]))
                    for idx in rng:
                        if cnv[idx] == -self.iteration - 1:
                            cnv[idx] = 0
                            ncon -= 1
                            if verb > 0:
                                print('stagnation of %e cancelled' % lmd[idx])
                return ncon
        return ncon

    def _lock(self, Xc, BXc, X, BX, std, first, count, ncon, Gc,
              lmd, res, err_lmd, err_X):
        """Append ``count`` converged iterates starting at slot ``first`` to
        the constraint set, record their data, and update the constraint
        Gram matrix incrementally (only the new cross blocks are computed on
        device; reference core/solver.py:1197-1263)."""
        self.eigenvalues = np.concatenate(
            (self.eigenvalues, lmd[first:first + count]))
        self.eigenvalue_errors.append(err_lmd[:, first:first + count])
        self.eigenvector_errors.append(err_X[:, first:first + count])
        self.residual_norms = np.concatenate(
            (self.residual_norms, res[first:first + count]))
        self.convergence_status = np.concatenate(
            (self.convergence_status, self.cnv[first:first + count]))
        X.select(count, first)
        be = _backend_helpers(X)
        gu_k = X.dot(BXc if not std else Xc, keep=True) if ncon > 0 else None
        Xc.append(X)
        if not std:
            BX.select(count, first)
            BXc.append(BX)
            gl_k = BXc.dot(X, keep=True) if ncon > 0 else None
        else:
            gl_k = Xc.dot(X, keep=True) if ncon > 0 else None
        if ncon > 0:
            Gu, Gl = be.fetch(gu_k, gl_k)
            Gu = Gu[:ncon, :count]
            Gl = Gl[:count, :ncon + count]
            Gc = np.concatenate((np.concatenate((Gc, Gu), axis=1), Gl))
        else:
            Gc = BXc.dot(Xc) if not std else Xc.dot(Xc)
        return ncon + count, Gc

    def _rebalance(self, left, right, lcon, rcon, ix, nx, ny, nxy,
                   leftX, rightX, block_size, left_block_size,
                   left_total, right_total, left_ratio, verb):
        """Redistribute block slots between the two spectrum margins for
        the next iteration (capability of reference core/solver.py:
        1495-1541).  Each margin claims as many fresh slots as it still
        has wanted eigenpairs outstanding (everything available when the
        margin is open-ended), total claims are scaled to the ny new
        directions by the running left/right ratio, and a margin that
        has fully converged donates its entire allocation to the other
        side (negative shift = its slots leave the window)."""
        def claim(margin_wanted, margin_con, outstanding, capacity):
            if margin_wanted < 0:                 # open-ended margin
                return capacity
            if margin_con > 0:                    # converged some: refill
                return min(capacity, max(0, outstanding))
            return 0

        want_l = claim(left, lcon, left_total - self.lcon - leftX, ix)
        want_r = claim(right, rcon, right_total - self.rcon - rightX,
                       block_size - ix - nx)
        if want_l + want_r > ny:
            want_l = min(want_l, int(round(left_ratio * ny)))
            want_r = min(want_r, ny - want_l)

        if left > 0 and lcon > 0 and self.lcon >= left:
            if verb > 0:
                print('left-hand side converged')
            # everything (old left allocation included) goes to the right
            pool = left_block_size + rightX + want_r
            kept = min(nxy, pool)
            return (-(leftX + lcon), want_r, 0, kept, pool - kept,
                    pool - kept, 0.0)
        if right > 0 and rcon > 0 and self.rcon >= right:
            if verb > 0:
                print('right-hand side converged')
            ix_new = ix - want_l
            kept = min(nxy, block_size - ix_new)
            return (want_l, -(rightX + rcon), kept, 0, ix_new + kept,
                    ix_new, 1.0)
        return (want_l, want_r, leftX + want_l, rightX + want_r,
                left_block_size, ix - want_l, left_ratio)


# ---------------------------------------------------------------------------


def _parse_which(which):
    if np.isscalar(which):
        w = int(which)
        if w >= 0:
            return w // 2, w - w // 2, True
        return -1, -1, True
    if len(which) != 2:
        raise ValueError('which must be an integer or a pair of integers')
    return int(which[0]), int(which[1]), False


def _find_clusters(cluster, lmd, left_block_size, block_size,
                   dlmd_min_lft, dlmd_min_rgt):
    """Mark clusters of nearly equal eigenvalues on each margin
    (reference core/solver.py:1076-1098)."""
    cluster[:, :] = 0
    nc = 0
    for i in range(left_block_size - 1):
        if abs(lmd[i + 1] - lmd[i]) <= dlmd_min_lft:
            if cluster[0, i] == 0:
                nc += 1
                cluster[0, i] = nc
                cluster[1, i] = 1
            cluster[0, i + 1] = cluster[0, i]
            cluster[1, i + 1] = cluster[1, i] + 1
    for j in range(block_size - left_block_size - 1):
        i = block_size - j - 1
        if abs(lmd[i - 1] - lmd[i]) <= dlmd_min_rgt:
            if cluster[0, i] == 0:
                nc += 1
                cluster[0, i] = nc
                cluster[1, i] = 1
            cluster[0, i - 1] = cluster[0, i]
            cluster[1, i - 1] = cluster[1, i] + 1


def _shift_slot_data(cnv, lmd, res, acf, err_lmd, dlmd, err_X, dX,
                     iterations, shift_left, shift_right, block_size,
                     left_block_size, left_block_size_new):
    """Slide the per-slot convergence records (status, eigenvalue,
    residual, a.c.f., error-estimate and decrement histories) when the
    iterated block's margins move, and blank the slots newly entering
    the window.  Capability of reference core/solver.py:1543-1587,
    vectorized over slots instead of per-slot loops; a negative shift
    means the margin's slots all left the window, so its whole half is
    blanked."""
    m, l, nl = block_size, left_block_size, left_block_size_new
    # every tracked record, paired with the axis that indexes the slot
    tracks = ((cnv, 0), (lmd, 0), (res, 0), (acf, 1), (err_lmd, 1),
              (dlmd, 0), (err_X, 1), (dX, 0), (iterations, 0))

    def slide(dst, src, count):
        if dst != src and count > 0:
            for rec, axis in tracks:
                v = rec if axis == 0 else np.swapaxes(rec, 0, 1)
                v[dst:dst + count] = v[src:src + count].copy()

    def blank(lo, hi):
        if hi > lo:
            sl = slice(lo, hi)
            cnv[sl] = 0
            iterations[sl] = 0
            dlmd[sl, :] = 0
            res[sl] = -1.0
            err_lmd[:, sl] = -1.0
            err_X[:, sl] = -1.0
            acf[:, sl] = 1.0
            dX[sl] = 1.0

    if shift_left > 0:
        slide(0, shift_left, l - shift_left)
        blank(l - shift_left, nl)
    elif shift_left == 0:
        blank(l, nl)
    else:
        blank(0, l)
    if shift_right > 0:
        slide(l + shift_right, l, m - l - shift_right)
        blank(nl, l + shift_right)
    elif shift_right == 0:
        blank(nl, l)
    else:
        blank(l, m)
