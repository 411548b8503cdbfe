"""Partial SVD of a dense matrix via the core eigensolver on the (implicitly
shifted) normal operator.

PyTorch port of ``raleigh_tpu/interfaces/partial_svd.py`` (capability
parity with reference raleigh/interfaces/partial_svd.py): the normal
operator A^T A or A A^T (whichever is smaller, partial_svd.py:25-27), the
implicit mean-shift trick that never materializes the centered matrix
(partial_svd.py:252-287), and the iterated-Cholesky finalization of the
left factor (partial_svd.py:162-235): device Gram, host small factor,
device rotation.

The blocks are ``dense_torch`` (on the card, or the device the matrix was
given) or ``dense_numpy`` (``arch='cpu'``).  On ``dense_torch`` the
eigensolve runs on the chunked device engine (core/device_jacobi.py)
unless ``opt.device_engine == 'host'`` asks for the host-orchestrated
``Solver``.
"""

import time

import numpy as np
import numpy.linalg as nla
import scipy.linalg as sla

from ..core.solver import Problem, Solver, Options


def _cj(a):
    return a.conj() if np.iscomplexobj(a) else a


class _OperatorSVD:
    """y = A^H A x (or A A^H x), optionally with the rank-one mean shift
    applied implicitly on both sides."""

    def __init__(self, matrix, v, transp=False, shift=False):
        self.op = matrix.as_operator()
        self.gpu = matrix.gpu()
        self.transp = transp
        self.shift = shift
        self.time = 0.0
        m, n = self.op.shape()
        self.w = v.new_vectors(0, n if transp else m)
        if shift:
            dt = self.op.data_type()
            ones = np.ones((1, m), dtype=dt)
            self.ones = v.new_vectors(1, m)
            self.ones.fill(ones)
            self.aves = v.new_vectors(1, n)
            # column means: a = A^T e / m
            self.op.apply(self.ones, self.aves, transp=True)
            self.aves.scale(m * ones[0, :1])

    def apply(self, x, y):
        m, n = self.op.shape()
        k = x.nvec()
        start = time.time()
        if self.w.nvec() < k:
            self.w = x.new_vectors(k, n if self.transp else m)
        z = self.w
        z.select(k)
        if self.transp:
            # y = A (A^H x), both shifted by the mean where requested
            self.op.apply(x, z, transp=True)
            if self.shift:
                s = x.dot(self.ones)
                z.add(self.aves, -1, s)
            self.op.apply(z, y)
            if self.shift:
                s = z.dot(self.aves)
                y.add(self.ones, -1, s)
        else:
            # y = A^H (A x), rows of A x shifted to zero mean
            self.op.apply(x, z)
            if self.shift:
                for _ in range(2):  # double orthogonalization for accuracy
                    s = z.dot(self.ones)
                    z.add(self.ones, -1.0 / m, s)
            self.op.apply(z, y, transp=True)
        self.time += time.time() - start

    def mean(self):
        return self.aves.data() if self.shift else None

    def mean_v(self):
        return self.aves if self.shift else None


class PartialSVD:
    """Engine computing extreme singular triplets of an AMatrix
    (reference partial_svd.py:19-235)."""

    def __init__(self, matrix, shift=False):
        op = matrix.as_operator()
        rows, cols = matrix.shape()
        # iterate on the SHORT side of A: the normal operator acting
        # there has the same nonzero spectrum at a fraction of the cost
        self.__transp = rows < cols
        self.__shape = (max(rows, cols), min(rows, cols))
        self.__op = op
        self.__shift = shift
        self.__v = op.new_vectors(self.__shape[1])
        self.__opsvd = _OperatorSVD(matrix, self.__v, self.__transp,
                                    shift)
        self.sigma = None
        self.__left_v = self.__right_v = self.__mean_v = None
        self.iterations = -1

    def op_svd(self):
        return self.__opsvd

    def vectors(self):
        return self.__v

    def compute(self, matrix, opt=None, nsv=(-1, -1), refine=1.0):
        if opt is None:
            opt = Options()
        op = self.__op
        m, n = self.__shape
        transp = self.__transp
        v = self.__v
        opSVD = self.__opsvd
        shift = self.__shift

        status, iterations = self._solve_evp(v, opSVD, opt, nsv)
        if status < 0:
            self.__mean_v = self.__left_v = self.__right_v = None
            return
        if opt.verbosity > 0:
            print('operator application time: %.2e' % opSVD.time)

        nv = v.nvec()
        u = v.new_vectors(nv, m)
        if nv > 0:
            u, sigma, v = self._recover_long_side(
                v, u, 0.0 if nv < 2 else float(refine))
        else:
            sigma = np.zeros((0,), dtype=v.data_type())
        self.sigma = sigma
        self.__mean_v = opSVD.mean_v()
        self.iterations = iterations
        # the iterated side holds the short-dimension singular vectors
        long_is_left = not transp
        self.__left_v = u if long_is_left else v
        self.__right_v = v if long_is_left else u

    def _recover_long_side(self, v, u, eps):
        """From converged short-side vectors v, recover the long-side
        factor u = (shifted) A v and put (u, sigma, v) into SVD form.

        eps == 1: one in-place SVD of the image block; 0 < eps < 1: the
        iterated-Cholesky scheme with orthonormality target eps;
        eps == 0 (single vector / exactly orthogonal images): just
        scale and order by descending sigma."""
        op = self.__op
        transp = self.__transp
        nv = v.nvec()
        op.apply(v, u, transp)
        if self.__shift:
            self._subtract_mean_images(v, u)
        sigma = np.sqrt(np.abs(u.dots(u).real))
        if eps == 0.0 and np.amin(sigma) > 0.0:
            u.scale(sigma)
            order = np.argsort(-sigma)
            for blk in (u, v):
                tmp = blk.new_vectors(nv)
                blk.copy(tmp, order)
                tmp.copy(blk)
            return u, sigma[order], v
        if eps == 1.0:
            sigma, rot = u.svd()
            aligned = v.new_vectors(nv)
            v.multiply(rot, aligned)
            aligned.copy(v)
            return u, sigma, v
        return self._finalize_svd(v, u, eps)

    def _subtract_mean_images(self, v, u):
        """Remove the rank-one mean term from the image block, matching
        the implicitly-shifted operator the eigensolver iterated."""
        op = self.__op
        mm, nn = op.shape()
        ones = np.ones((1, mm), dtype=op.data_type())
        e = v.new_vectors(1, mm)
        e.fill(ones)
        col_means = v.new_vectors(1, nn)
        op.apply(e, col_means, transp=True)
        col_means.scale(mm * ones[0, :1])
        if self.__transp:
            u.add(col_means, -1, v.dot(e))
        else:
            u.add(e, -1, v.dot(col_means))

    def _solve_evp(self, v, opSVD, opt, nsv):
        """Run the normal-operator eigensolver: the chunked device engine
        (core/device_jacobi.py) when the blocks live on a torch device —
        one host fetch per ``chunk`` iterations — or the host-orchestrated
        Solver otherwise."""
        from ..algebra import dense_torch

        use_device = (isinstance(v, dense_torch.Vectors)
                      and getattr(opt, 'device_engine', 'auto') != 'host'
                      and nsv[0] == 0)
        if use_device:
            from ..core.device_jacobi import DeviceJacobi, svd_normal_matmat

            adata = self.__op.device_array()
            aves = (opSVD.aves.device_data()[0] if self.__shift else None)
            matmat, operands = svd_normal_matmat(adata, self.__transp,
                                                 self.__shift, aves)
            engine = DeviceJacobi(matmat, self.__shape[1],
                                  dtype=v.data_type(), operands=operands)
            t0 = time.time()
            status = engine.solve(v, options=opt, nwanted=nsv[1],
                                  verb=opt.verbosity)
            opSVD.time += time.time() - t0
            return status, engine.iteration
        solver = Solver(Problem(v, opSVD))
        status = solver.solve(v, options=opt, which=nsv)
        return status, solver.iteration

    # -- result accessors (numpy views, columns = singular vectors) -------

    def mean(self):
        return self.__mean_v.data() if self.__mean_v is not None else None

    def left(self):
        return self.__left_v.data().T if self.__left_v is not None else None

    def right(self):
        return self.__right_v.data().T if self.__right_v is not None else None

    def mean_v(self):
        return self.__mean_v

    def left_v(self):
        return self.__left_v

    def right_v(self):
        return self.__right_v

    @staticmethod
    def _finalize_svd(v, Av, eps):
        """Given approximate right singular vectors v and their images Av,
        produce (u, sigma, v) with A v = u sigma: fast iterated-Cholesky
        orthonormalization of u when the Gram of Av is well conditioned, a
        full SVD of Av otherwise (reference partial_svd.py:162-235)."""
        nsv = v.nvec()
        Gram = Av.dot(Av)

        diag = np.diag(Gram).real
        if np.amin(diag) <= 0.0:
            icond = 0.0
        else:
            lmd = sla.eigh(Gram, np.diag(diag), eigvals_only=True)
            icond = lmd[0] / lmd[-1]
        delta = 100 * np.finfo(diag.dtype).eps
        if icond < delta:
            # Av too ill-conditioned: full SVD of Av
            sigma, q = Av.svd()
            u = Av
            w = v.new_vectors(nsv)
            v.multiply(q, w)
            w.copy(v)
            return u, sigma, v

        w = Av.new_vectors(nsv)
        U = _cj(nla.cholesky(Gram).T)            # Gram = U^H U
        p, sigma, qh = sla.svd(U)                # A v = w p sigma qh
        q = _cj(qh.T)
        Ui = sla.inv(U)
        Av.multiply(np.dot(Ui, p), w)
        u = Av
        w.copy(u)

        # cheap orthonormality probe on a trailing sub-block
        probe = u.reference()
        nv = int(min(32, nsv / 2))
        probe.select(nv, nsv - nv)
        G = probe.dot(probe)
        no_max = np.amax(np.abs(G - np.eye(nv, dtype=G.dtype)))
        if no_max < eps:
            w = v.new_vectors(nsv)
            v.multiply(q, w)
            w.copy(v)
            return u, sigma, v

        Gram = u.dot(u)
        no_max = np.amax(np.abs(Gram - np.eye(nsv, dtype=Gram.dtype)))
        it = 0
        while no_max > eps and it < 2:
            U = _cj(nla.cholesky(Gram).T)
            Ui = sla.inv(U)
            u.multiply(Ui, w)
            p, sigma, qh = sla.svd(U * sigma)
            q = np.dot(q, _cj(qh.T))
            w.multiply(p, u)
            Gram = u.dot(u)
            no_max = np.amax(np.abs(Gram - np.eye(nsv)))
            it += 1
        w = v.new_vectors(nsv)
        v.multiply(q, w)
        w.copy(v)
        return u, sigma, v
