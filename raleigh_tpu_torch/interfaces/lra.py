"""Lower-rank approximation L R ~= A (optionally mean-shifted), with warm
update and incremental (streaming) modes.

PyTorch port of ``raleigh_tpu/interfaces/lra.py``; capability parity with
reference raleigh/interfaces/lra.py: compute (lra.py:46-156), update of a
previously computed approximation when new data rows arrive —
re-orthogonalization path chosen by the conditioning of the factor Grams
(lra.py:208-223,296-312), mean update for the grown dataset
(lra.py:233-251), tolerance-driven rank truncation (lra.py:314-359) — and
icompute, the batch-at-a-time streaming driver (lra.py:381-422).
"""

import math

import numpy as np
import numpy.linalg as nla
import scipy.linalg as sla

from ..core.solver import Options
from ..algebra.dense import data_matrix
from .partial_svd import PartialSVD
from .truncated_svd import DefaultStoppingCriteria


class LowerRankApproximation:
    """Holds and refines a lower-rank approximation of a dense matrix."""

    def __init__(self, mlr=None):
        self.__mean, self.__left, self.__right = mlr or (None, None, None)
        self.__rank = 0 if mlr is None else self.__right.shape[0]
        self.__dtype = None if mlr is None else self.__left.dtype.type
        self.__mean_v = self.__left_v = self.__right_v = None
        self.__tol, self.__svtol = -1, 1e-3
        self.__norm = self.__arch = None
        self.__opt = Options()
        self.ortho = 1.0
        self.iterations = -1

    def compute(self, matrix, opt=None, rank=-1, tol=0, norm='f',
                max_rank=-1, svtol=1e-3, shift=False, verb=0):
        """L R ~= A (shift=False) or A - e a (shift=True, a = row mean);
        rows of R orthonormal, columns of L by descending norm.  See
        reference lra.py:46-108 for the parameter contract."""
        if opt is None:
            opt = Options()
        if matrix.order() != 'C_CONTIGUOUS':
            raise ValueError('matrix must be C_CONTIGUOUS')
        psvd = PartialSVD(matrix, shift)

        user_bs = opt.block_size
        if user_bs < 1 and (rank < 0 or rank > 100):
            opt.block_size = 128
        no_cc = opt.convergence_criteria is None
        if no_cc:
            opt.convergence_criteria = _DefaultLRAConvergenceCriteria(svtol)
        no_sc = opt.stopping_criteria is None and rank < 0
        if no_sc:
            opt.stopping_criteria = DefaultStoppingCriteria(
                matrix, tol, norm, max_rank, verb)
            opt.stopping_criteria.err_calc.set_up(psvd.op_svd(),
                                                  psvd.vectors(), shift)

        psvd.compute(matrix, opt=opt, nsv=(0, rank), refine=self.ortho)
        self.__left_v, self.__right_v = psvd.left_v(), psvd.right_v()
        self.__left_v.scale(psvd.sigma, multiply=True)
        self.__mean_v = psvd.mean_v()
        self.__rank = self.__left_v.nvec()
        self.__opt = opt
        self._note_config(matrix, tol, svtol, norm)
        cap = rank if rank > 0 else max_rank
        if cap > 0 and self.__left_v.nvec() > cap:
            # the block sweep may lock a few extra pairs in its last
            # iteration; deliver exactly what was asked for
            self.__left_v.select(cap)
            self.__right_v.select(cap)
            self.__rank = cap
        self.iterations = psvd.iterations
        self._drop_ndarray_views()

        # hand the user's Options object back unmodified (side-effect-free
        # restore, reference truncated_svd.py:121-126)
        opt.block_size = user_bs
        if no_cc:
            opt.convergence_criteria = None
        if no_sc:
            opt.stopping_criteria = None

    def update(self, matrix, opt=None, rank=-1, max_rank=-1,
               tol=None, norm=None, svtol=None, verb=0):
        """Update a previously computed LRA of matrix0 into the LRA of
        vstack((matrix0, matrix)) (reference lra.py:158-379)."""
        if self.__rank == 0:
            raise RuntimeError('no existing LRA data to update')
        # unset parameters inherit the values of the previous compute/update
        opt = self.__opt if opt is None else opt
        tol = self.__tol if tol is None else tol
        norm = self.__norm if norm is None else norm
        svtol = self.__svtol if svtol is None else svtol
        if tol == 0.0 and rank < 1:
            rank = self.__rank
        if norm not in ('f', 'm', 's'):
            raise ValueError('norm %r is not supported' % norm)
        v = matrix.as_vectors()
        s = np.abs(v.dots(v).real)
        maxl2norm = np.amax(np.sqrt(s))
        if maxl2norm == 0.0:
            return
        dtype = self.__dtype

        if self.__left_v is None:
            # rebuild Vectors state from the (mean, L, R) ndarray triple
            left_data = np.ascontiguousarray(self.__left.T)
            self.__left_v = v.new_vectors(left_data)
            self.__right_v = v.new_vectors(self.__right)
            self.__mean_v = (v.new_vectors(self.__mean)
                             if self.__mean is not None else None)
            self.__arch = matrix.arch()
        elif self.__arch != matrix.arch() or dtype != matrix.data_type():
            raise ValueError('incompatible matrix passed to update')
        left0 = self.__left_v
        right0 = self.__right_v

        if self.ortho < 1.0:
            self._reorthogonalize(left0, right0)

        shift = self.__mean_v is not None
        sigma = np.sqrt(np.abs(left0.dots(left0).real))
        sigma0 = sigma[0]
        n0 = left0.dimension()
        n1 = v.nvec()
        n = n0 + n1
        e0 = np.ones((n0, 1), dtype=dtype)
        e1 = np.ones((n1, 1), dtype=dtype)

        if shift:
            vmean = self._fold_mean_change(v, left0, right0, e0, e1,
                                           n0, n1, dtype)
        else:
            vmean = None

        s = np.abs(v.dots(v).real)
        fnorm = math.sqrt(np.sum(s))
        maxl2norm = np.amax(np.sqrt(s))

        left1 = v.orthogonalize(right0)

        # compute new components of the residual data
        lra_new = LowerRankApproximation()
        if rank < 0:
            if norm == 'f':
                update_tol = -tol * fnorm
            elif norm == 'm':
                update_tol = -tol * maxl2norm
            else:
                update_tol = -tol * sigma0
            urank = max_rank * n1 // (n0 + n1)
            lra_new.compute(matrix, opt, tol=update_tol, norm=norm,
                            max_rank=urank, verb=verb)
        else:
            urank = rank * n1 // (n0 + n1)
            if verb > 0:
                print('computing new %d components...' % urank)
            lra_new.compute(matrix, opt, rank=urank, verb=verb)

        left11 = lra_new.left_v()
        right10 = lra_new.right_v()

        # the merged basis cannot exceed the feature dimension: cap the
        # appended new components (sorted descending, so keeping the head
        # is the right truncation) — an overcomplete block would break the
        # SVD re-orthonormalization downstream
        avail = right0.dimension() - right0.nvec()
        if left11.nvec() > avail:
            left11.select(max(avail, 0))
            right10.select(max(avail, 0))

        # merge: grow left0 with zero block, stack rows, append new comps
        new = left11.nvec()
        if new > 0:
            pad = left0.new_vectors(new)
            pad.zero()
            left0.append(pad)
            left1.append(left11)
            right0.append(right10)
        merged = np.concatenate((left0.data(), left1.data()), axis=1)
        left0 = left0.new_vectors(merged)
        self.__left_v = left0
        self.__right_v = right0

        self._reorthogonalize(left0, right0, full=True)

        # tolerance-driven truncation of trailing components
        if rank < 0:
            ncomp = right0.nvec()
            keep = self._trailing_keep(left0, sigma, norm, tol, ncomp)
            if verb > 0 and keep < ncomp:
                print('discarding %d components out of %d'
                      % (ncomp - keep, ncomp))
            ncomp = keep
        else:
            ncomp = rank

        left0.select(ncomp)
        right0.select(ncomp)
        self._drop_ndarray_views()
        if shift:
            self.__mean_v = vmean
        self.__rank = ncomp
        self._note_config(matrix, tol, svtol, norm)
        if 0 < max_rank < ncomp:
            self.__left_v.select(max_rank)
            self.__right_v.select(max_rank)
            self.__rank = max_rank
        self.iterations += lra_new.iterations

    def _note_config(self, matrix, tol, svtol, norm):
        self.__tol, self.__svtol, self.__norm = tol, svtol, norm
        self.__arch = matrix.arch()
        self.__dtype = matrix.data_type()

    def _drop_ndarray_views(self):
        """Invalidate cached ndarray copies; accessors re-materialize
        them from the backend Vectors state on demand."""
        self.__mean = self.__left = self.__right = None

    def _fold_mean_change(self, v, left0, right0, e0, e1, n0, n1, dtype):
        """Merge the stored row mean with the mean of the new rows and
        absorb the resulting change of centre into the old factors
        (capability of reference lra.py:233-251).

        Writing the old centred data as e0 mean0' + L0 R0 and recentring
        at the pooled mean, the difference d = mean0 - mean splits into
        its in-span coefficients (folded into L0 as a rank-one update
        along e0) and an out-of-span direction (appended as one extra
        component when the feature dimension still has room).  The new
        rows in ``v`` are centred at the pooled mean in place.  Returns
        the pooled-mean Vectors object."""
        n = n0 + n1
        colsum = v.new_vectors(1, v.dimension())
        v.multiply(e1, colsum)
        pooled = (n0 / n) * self.__mean_v.data() \
            + (1.0 / n) * colsum.data()
        d = v.new_vectors((self.__mean_v.data() - pooled).astype(dtype))
        in_span = d.orthogonalize(right0)          # d -= (coeffs) R0
        e0v = v.new_vectors(e0.T)
        left0.add(e0v, 1.0, in_span.data().T)
        leftover = nla.norm(d.data()) * e0[:1]
        d.scale(leftover)                          # unit out-of-span dir
        if right0.nvec() < right0.dimension():
            # when the old basis already spans the feature space the
            # leftover is pure rounding and appending would overflow
            e0v.scale(leftover, multiply=True)
            left0.append(e0v)
            right0.append(d)
        vmean = v.new_vectors(pooled.astype(dtype))
        v.add(vmean, -1.0, e1.T)
        return vmean

    @staticmethod
    def _trailing_keep(left0, sigma, norm, tol, ncomp):
        """Number of leading components to keep: the longest trailing run
        whose cumulative truncation error (in the requested norm) stays
        within a quarter of tol times the norm's scale.  Vectorized
        equivalent of the reference's component-at-a-time scan
        (lra.py:314-359): reverse-cumulative error profiles replace the
        incremental loop."""
        if norm == 'f':
            comp_sq = left0.dots(left0).real          # per-component ||l||^2
            scale = math.sqrt(max(np.sum(comp_sq), 0.0))
            profile = np.sqrt(np.cumsum(comp_sq[::-1]))[:ncomp - 1]
        elif norm == 'm':
            row_sq = left0.dots(left0, transp=True).real
            scale = math.sqrt(max(np.amax(np.abs(row_sq)), 0.0))
            ldata = left0.data()
            rev_rows = np.cumsum((ldata * ldata.conj()).real[::-1], axis=0)
            profile = np.sqrt(np.amax(rev_rows, axis=1))[:ncomp - 1]
        else:
            scale = sigma[0]
            tail = np.arange(ncomp - 1, 0, -1)
            profile = np.where(tail < len(sigma),
                               sigma[np.minimum(tail, len(sigma) - 1)], 0.0)
        over = np.nonzero(profile > scale * tol / 4)[0]
        drop = int(over[0]) if over.size else ncomp - 1
        return ncomp - drop

    def _reorthogonalize(self, left0, right0, full=False):
        """Restore the LRA invariant (R rows orthonormal, L columns
        orthogonal, descending): cheap generalized-eigenproblem route when
        the right Gram is well conditioned, two-sided SVD otherwise
        (reference lra.py:208-223,296-312)."""
        wl = left0.new_vectors(left0.nvec())
        wr = right0.new_vectors(right0.nvec())
        H = right0.dot(right0)
        mu = sla.eigh(H, eigvals_only=True)
        q = mu[0] if full else mu[0] / mu[-1]
        if q < 0.5:
            _lra_ortho(left0, right0, wl, wr)
        else:
            G = left0.dot(left0)
            lmd, x = sla.eigh(-G, H)
            y = nla.inv(x.T)
            left0.multiply(y, wl)
            wl.copy(left0)
            right0.multiply(x, wr)
            wr.copy(right0)

    def icompute(self, matrix, batch_size, opt=None, rank=-1, tol=0,
                 norm='f', max_rank=-1, svtol=1e-3, shift=False,
                 arch=None, verb=0, device=None):
        """Streaming LRA: compute on the first batch of rows, update on each
        subsequent batch (reference lra.py:381-422).  ``arch`` and
        ``device`` place each batch as ``algebra.dense.data_matrix`` does:
        on the card unless either says otherwise."""
        opt = opt if opt is not None else Options()
        total = matrix.shape[0]
        step = min(batch_size, total)
        start = 0
        if self.__rank == 0:
            # cold start: the first batch seeds the approximation
            if verb > 0:
                print('processing batch 0 of size %d' % step)
            self.compute(data_matrix(matrix[:step, :], arch, device),
                         opt=opt,
                         rank=rank, tol=tol, norm=norm, max_rank=max_rank,
                         svtol=svtol, shift=shift, verb=verb)
            start = step
        for k, lo in enumerate(range(start, total, step), 1):
            hi = min(total, lo + step)
            if verb > 0:
                print('processing batch %d of size %d' % (k, hi - lo))
            self.update(data_matrix(matrix[lo:hi, :], arch, device,
                                    copy_data=True),
                        opt=opt, rank=rank, tol=tol, norm=norm,
                        max_rank=max_rank, svtol=svtol, verb=verb)

    # -- result accessors --------------------------------------------------

    def mean(self):
        if self.__mean is None:
            self.__mean = None if self.__mean_v is None \
                else self.__mean_v.data()
        return self.__mean

    def left(self):
        if self.__left is None:
            self.__left = None if self.__left_v is None \
                else self.__left_v.data().T
        return self.__left

    def right(self):
        if self.__right is None:
            self.__right = None if self.__right_v is None \
                else self.__right_v.data()
        return self.__right

    def mean_v(self):
        return self.__mean_v

    def left_v(self):
        return self.__left_v

    def right_v(self):
        return self.__right_v


class _DefaultLRAConvergenceCriteria:
    """Relative-residual test scaled by (lmd/lmd_max)^1.5
    (reference lra.py:452-463)."""

    def __init__(self, tol):
        self.tolerance = tol

    def set_tolerance(self, tolerance):
        self.tolerance = tolerance

    def satisfied(self, solver, i):
        res, lmd, lmd_max = (solver.convergence_data(q, i) for q in
                             ('residual', 'eigenvalue', 'max eigenvalue'))
        return res >= 0 and \
            res * res <= abs(lmd / lmd_max) ** 1.5 * self.tolerance


def _lra_ortho(left, right, wl, wr):
    """Two-sided SVD re-orthogonalization of the factor pair (capability
    of reference lra.py:473-482): first pass orthonormalizes the right
    factor in scratch and rotates/rescales the left factor to match;
    second pass SVDs the rebuilt left factor and pushes its rotation back
    onto the right."""
    right.copy(wr)
    sr, rot_r = wr.svd()
    left.multiply(rot_r, wl)
    wl.scale(sr, multiply=True)
    wl.copy(left)
    sl, rot_l = left.svd()
    wr.multiply(rot_l, right)
    left.scale(sl, multiply=True)
