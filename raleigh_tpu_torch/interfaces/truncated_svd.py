"""Truncated SVD with tolerance-driven, capped, or interactive stopping.

PyTorch port of ``raleigh_tpu/interfaces/truncated_svd.py``; capability
parity with reference raleigh/interfaces/truncated_svd.py:
top-k or tolerance-driven truncation in three error norms ('s' spectral,
'f' Frobenius, 'm' max row norm), an incremental per-row residual-norm
error calculator (truncated_svd.py:131-202), interactive "more?" stopping
(truncated_svd.py:277), a user-pluggable stopping criterion that recomputes
the current (U, Sigma) from converged right vectors (truncated_svd.py:
322-385), and side-effect-free restoration of user options
(truncated_svd.py:121-126).
"""

import math
import time

import numpy as np
import numpy.linalg as nla

from ..core.solver import Options
from ..algebra.dense import data_matrix
from .partial_svd import PartialSVD


def truncated_svd(A, opt=None, nsv=-1, tol=0, norm='s', msv=-1, vtol=0,
                  arch=None, verb=0, device=None):
    """Compute the leading part of the SVD of a dense matrix A.

    Parameters follow the reference contract (truncated_svd.py:24-92):
    ``nsv`` requested number of singular triplets (negative: driven by
    ``tol`` in norm ``norm``, or interactively when ``tol == 0``); ``msv``
    caps the number computed; ``vtol`` is the singular-vector error
    tolerance.  The blocks live on the card (``dense_torch``, the chunked
    device engine) unless ``device`` names another device, or ``arch='cpu'``
    asks for the host algebra (``dense_numpy``, the core Solver); with no
    card and neither, it raises.

    Returns (u, sigma, vt).
    """
    if opt is None:
        opt = Options()
    matrix = data_matrix(A, arch, device)
    psvd = PartialSVD(matrix)

    user_bs = opt.block_size
    if user_bs < 1 and (nsv < 0 or nsv > 100):
        opt.block_size = 128
    no_cc = opt.convergence_criteria is None
    if no_cc:
        if vtol <= 0:
            vtol = math.sqrt(np.finfo(A.dtype).eps)
        opt.convergence_criteria = _DefaultSVDConvergenceCriteria(vtol)
    no_sc = opt.stopping_criteria is None and nsv < 0
    if no_sc:
        opt.stopping_criteria = DefaultStoppingCriteria(
            matrix, tol, norm, msv, verb)
        opt.stopping_criteria.err_calc.set_up(psvd.op_svd(), psvd.vectors(),
                                              shift=False)

    psvd.compute(matrix, opt, nsv=(0, nsv))
    u = psvd.left()
    v = psvd.right()
    sigma = psvd.sigma
    if msv > 0 and u.shape[1] > msv:
        u = u[:, :msv]
        v = v[:, :msv]
        sigma = sigma[:msv]

    # undo the defaults installed above so the caller's Options object
    # leaves this function exactly as it came in
    if no_sc:
        opt.stopping_criteria = None
    if no_cc:
        opt.convergence_criteria = None
    opt.block_size = user_bs
    return u, sigma, v.T


class TruncatedSVDErrorCalculator:
    """Per-row truncation-error tracker for the residual D = A - U S V'.

    Invariant maintained: ``err[i]**2 = ||row_i(A[-mean])||**2 - (row
    energy of the converged components)``; converged singular components
    project every row onto mutually orthogonal directions, so each new
    batch lowers the squared row norms by the per-row energy of its
    image block (Pythagoras).  Capability of reference
    truncated_svd.py:131-202, reorganized around squared-norm state and
    a single per-batch row-energy helper.
    """

    def __init__(self, a):
        self.m, self.n = a.shape()
        self.dt = a.data_type()
        row_sq = np.maximum(a.dots().real.reshape(self.m, 1), 0.0)
        self.norms = np.sqrt(row_sq)
        self._err2 = row_sq.copy()
        self.err = np.sqrt(self._err2)
        self.op = None
        self.shift = False
        self.ncon = 0
        self.aves = None

    def set_up(self, op, eigenvectors, shift=False):
        self.op, self.eigenvectors = op.op, eigenvectors
        self.shift = shift
        if shift:
            self.ones, self.aves = op.ones, op.aves
            # mean-centred rows: ||a_i - c||^2 expands to
            # ||a_i||^2 - 2 Re(a_i . c) + ||c||^2 with c the column means
            img = eigenvectors.new_vectors(1, self.m)
            self.op.apply(self.aves, img)
            dot_rows_mean = img.data().reshape(self.m, 1).real
            mean_sq = self.aves.dots(self.aves).real
            self._err2 = np.abs(self.norms ** 2 - 2 * dot_rows_mean
                                + mean_sq)
            self.err = np.sqrt(self._err2)
        self.err_init = np.amax(self.err)
        self.err_init_f = nla.norm(self.err)

    def update_errors(self):
        """Absorb components converged since the last call; return the
        refreshed per-row error norms."""
        x = self.eigenvectors
        batch = x.nvec() - self.ncon
        if batch > 0:
            window = x.selected()
            x.select(batch, self.ncon)
            gain = self._batch_row_energy(x, batch)
            x.select(window[1], window[0])
            self._err2 = np.maximum(
                self._err2 - gain.reshape(self.m, 1), 0.0)
            self.err = np.sqrt(self._err2)
            self.ncon += batch
        return self.err

    def _batch_row_energy(self, x, batch):
        """Per-row energy (length-m vector) captured by the ``batch``
        converged vectors currently selected in ``x``."""
        if self.m < self.n:
            # the iterated side is the row side: x holds left singular
            # vectors; push through A' and back, contract per row
            z = x.new_vectors(batch, self.n)
            self.op.apply(x, z, transp=True)
            if self.shift:
                z.add(self.aves, -1, x.dot(self.ones))
            y = x.new_vectors(batch, self.m)
            self.op.apply(z, y)
            if self.shift:
                y.add(self.ones, -1, z.dot(self.aves))
            return np.maximum(x.dots(y, transp=True).real, 0.0)
        # x holds right singular vectors: the image block A x is exactly
        # sigma_j u_j, whose per-row energy is the captured projection
        y = x.new_vectors(batch, self.m)
        self.op.apply(x, y)
        if self.shift:
            # two centring passes: the second scrubs rounding leakage,
            # which otherwise biases the energies of late components
            for _ in range(2):
                y.add(self.ones, -1.0 / self.m, y.dot(self.ones))
        return y.dots(y, transp=True).real


class DefaultStoppingCriteria:
    """Stops when the truncation error in the chosen norm drops below the
    tolerance, a maximum count is reached, or — interactively — the user
    says stop (reference truncated_svd.py:205-283)."""

    def __init__(self, a, err_tol=0, norm='f', max_nsv=0, verb=0):
        # stop policy: tolerance sign selects relative (+) vs absolute (-),
        # zero with max_nsv < 1 means interactive
        self.err_tol = err_tol
        self.norm = norm
        self.max_nsv = max_nsv
        self.verb = verb
        # row-energy calculator over the (possibly shifted) operator; the
        # squared Frobenius mass still to capture lives in self.f once the
        # first converged batch fixes the scale sigma[0]
        self.err_calc = TruncatedSVDErrorCalculator(a)
        self.f = 0.0
        self.sigma = 1.0
        # progress counters + wall-clock bookkeeping for the printout
        self.ncon = 0
        self.iteration = 0
        self.elapsed_time = 0.0
        self.start_time = time.time()

    def satisfied(self, solver):
        fresh = solver.rcon - self.ncon
        if fresh < 1:
            return False
        sigma = np.sort(np.sqrt(np.abs(
            solver.eigenvalues[self.ncon:solver.rcon])))[::-1]
        if self.ncon == 0:
            # first batch fixes the scale and the full squared Frobenius
            # mass still to be captured
            self.sigma = sigma[0]
            self.err = self.err_calc.err
            self.f = float(np.sum(self.err_calc.err ** 2))
        smallest = sigma[fresh - 1]
        smallest_rel = smallest / self.sigma

        # truncation error in the requested norm, absolute and relative
        if self.norm == 'f':
            self.f -= float(np.sum(sigma ** 2))
            err_abs = math.sqrt(max(0.0, self.f))
            err_rel = err_abs / self.err_calc.err_init_f
        elif self.norm == 'm':
            self.err = self.err_calc.update_errors()
            err_abs = float(np.amax(self.err))
            err_rel = err_abs / self.err_calc.err_init
        else:
            err_abs, err_rel = smallest, smallest_rel

        self.elapsed_time += time.time() - self.start_time
        head = '%.2f sec: sigma[%d]' % (self.elapsed_time, solver.rcon - 1)
        if self.norm in ('f', 'm'):
            msg = '%s = %.2e*sigma[0], truncation error = %.2e' \
                % (head, smallest_rel, err_rel)
        else:
            msg = '%s = %e = %.2e*sigma[0]' % (head, smallest, smallest_rel)

        self.ncon = solver.rcon
        self.iteration = solver.iteration
        interactive = self.err_tol == 0 and self.max_nsv < 1
        if self.verb > 0 and not interactive:
            print(msg)
        if interactive:
            done = input(msg + ', more? ') == 'n'
        elif self.err_tol > 0:
            done = err_rel <= self.err_tol
        elif self.err_tol < 0:
            done = err_abs <= -self.err_tol
        else:
            done = False
        self.start_time = time.time()
        return done or 0 < self.max_nsv <= self.ncon


class DefaultProbe:
    """Interactive probe reporting truncation errors of the current
    approximation (reference truncated_svd.py:286-319)."""

    def __init__(self, data, shift):
        self.data = data
        self.shape = data.shape
        m = self.shape[0]
        n = int(np.prod(self.shape[1:]))
        data2d = data.reshape((m, n))
        t = nla.norm(data2d, axis=1).reshape((m, 1))
        if not shift:
            self.nrms = t.reshape((m,))
        else:
            mean = np.mean(data2d, axis=0).reshape((1, n))
            s = nla.norm(mean)
            b = (data2d @ mean.conj().T).real
            x = t * t - 2 * b + s * s * np.ones((m, 1))
            self.nrms = np.sqrt(abs(x)).reshape((m,))
        self.nsv = 0

    def inspect(self, mean, sigma, left, right):
        u = left * sigma[None, :]
        proj = nla.norm(u, axis=1)
        errs_sqr = self.nrms * self.nrms - proj * proj
        err_mx2 = math.sqrt(max(0.0, np.amax(errs_sqr))
                            / np.amax(self.nrms * self.nrms))
        err_fro = math.sqrt(max(0.0, np.sum(errs_sqr))
                            / np.sum(self.nrms * self.nrms))
        i = sigma.shape[0] - 1
        msg = ('sigma[%d] = %.1e*sigma[0], trunc. err. max 2: %.1e, fro:'
               ' %.1e' % (i, sigma[i] / sigma[0], err_mx2, err_fro))
        return input(msg + ', more? ') == 'n'


class UserStoppingCriteria:
    """Recomputes (U, Sigma) from the converged right vectors on every check
    and delegates the stop/continue decision to a probe
    (reference truncated_svd.py:322-385)."""

    def __init__(self, data, shift=False, probe=None):
        from ..algebra.dense_numpy import Matrix, Vectors

        self.shape = data.shape
        self.probe = probe if probe is not None else DefaultProbe(data, shift)
        m = self.shape[0]
        n = int(np.prod(self.shape[1:]))
        self.transpose = m < n
        self.data = np.reshape(data, (m, n))
        self.shift = shift
        self.matrix = Matrix(self.data)
        self.mean = np.mean(self.data, axis=0).reshape((1, n))
        dtype = data.dtype
        sigma_dtype = np.dtype(abs(self.data[0, 0])).type
        self.sigma = np.zeros((0,), dtype=sigma_dtype)
        self.left = Vectors(m, data_type=dtype)
        self.right = Vectors(n, data_type=dtype)
        self.ones = np.ones((1, m), dtype=dtype)
        self.__ones = Vectors(self.ones)
        self.__mean = Vectors(self.mean.astype(dtype))
        self.ncon = 0

    def satisfied(self, solver):
        batch = solver.rcon - self.ncon
        if batch < 1:
            return False
        conv = solver.eigenvectors.reference()
        conv.select(batch, self.ncon)
        # the solver iterates the short side of A; one application of A
        # (or A') recovers the long-side images sigma_j * u_j
        short, long_ = ((self.left, self.right) if self.transpose
                        else (self.right, self.left))
        v = short.new_vectors(batch)
        v.fill(conv.data())
        img = long_.new_vectors(batch)
        self.matrix.apply(v, img, transp=self.transpose)
        if self.shift:
            # remove the column-mean component from the images
            if self.transpose:
                img.add(self.__mean, -1, v.dot(self.__ones))
            else:
                img.add(self.__ones, -1, v.dot(self.__mean))
        # in-place SVD of the image block: img becomes the orthonormal
        # long-side factor; the rotation realigns the short-side vectors
        # with the singular directions
        sigma, rot = img.svd()
        aligned = v.new_vectors(batch)
        v.multiply(rot, aligned)
        self.sigma = np.concatenate((self.sigma, sigma))
        short.append(aligned)
        long_.append(img)
        self.ncon += batch
        return self.probe.inspect(self.mean, self.sigma,
                                  self.left.data().T, self.right.data().T)


class _DefaultSVDConvergenceCriteria:
    """Vector i converges when its kinematic error estimate lands in
    [0, tol] (negative means "no estimate yet")."""

    def __init__(self, tol):
        self.tolerance = tol

    def set_tolerance(self, tol):
        self.tolerance = tol

    def satisfied(self, solver, i):
        kin = solver.convergence_data('kinematic vector error', i)
        return 0 <= kin <= self.tolerance
