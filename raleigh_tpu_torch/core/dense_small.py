"""Small dense host-side numerics used by the core solver.

Everything here operates on block-sized (O(m^2), m = block size) matrices on
the host — mirroring the reference's choice to keep Gram-matrix
factorizations in SciPy (reference core/solver.py:1749-1845) while all O(n)
work stays on the block-vector backend (device).
"""

import numpy as np
import scipy.linalg as sla


def adj(a):
    return a.conj().T if np.iscomplexobj(a) else a.T


def cj(a):
    return a.conj() if np.iscomplexobj(a) else a


def re(a):
    return a.real if np.iscomplexobj(a) else a


def col_norms(a):
    return np.sqrt(np.einsum('ij,ij->j', a.conj(), a).real)


def congruence_inv(g, u):
    """Return U^{-H} G U^{-1} (congruence by the inverse of an upper factor);
    parity with reference core/solver.py:1685-1688."""
    b = sla.solve_triangular(adj(u), adj(g), lower=True)
    return sla.solve_triangular(adj(u), adj(b), lower=True)


def _factor_lmax(u):
    """1-norm bound on the largest eigenvalue of U^H U."""
    ut = np.triu(u)
    return sla.norm(adj(ut) @ ut, ord=1)


def _factor_lmin(u):
    """Rayleigh-quotient estimate of the smallest eigenvalue of U^H U via a
    few inverse-power steps (two triangular solves each); parity with
    reference core/solver.py:1831-1845."""
    n = u.shape[0]
    tr = 2 if np.iscomplexobj(u) else 1
    x = np.ones((n,), dtype=u.dtype)
    s = np.dot(x, x)
    rq = s
    for _ in range(3):
        y = sla.solve_triangular(u, x, trans=tr)
        t = np.dot(y, y).real
        rq = s / t
        x = sla.solve_triangular(u, y)
        s = np.dot(x, x).real
    return rq


def pivoted_cholesky(g, fixed, eps):
    """Pivoted Cholesky factorization G[p, p] = U^H U with the leading
    ``fixed`` rows kept in place, dropping trailing pivots that are
    non-positive/tiny or that would make the factor ill-conditioned
    (condition estimate <= eps), as the reference does at
    core/solver.py:1749-1826.

    Returns (U, order, dropped): ``U`` upper triangular with the dropped
    trailing rows zeroed, ``order`` the permutation applied (identity on the
    first ``fixed`` entries), ``dropped`` the number of discarded vectors.
    """
    a = np.array(g)
    n = a.shape[0]
    order = np.arange(n)
    dropped = 0
    if fixed > 0:
        u = sla.cholesky(a[:fixed, :fixed])
        a[:fixed, :fixed] = u
        a[:fixed, fixed:] = sla.solve_triangular(adj(u), a[:fixed, fixed:],
                                                 lower=True)
        a[fixed:, :fixed] = 0.0
        a[fixed:, fixed:] -= adj(a[:fixed, fixed:]) @ a[:fixed, fixed:]
    for i in range(fixed, n):
        d = np.real(np.diag(a[i:, i:]))
        j = i + int(np.argmax(d))
        if j != i:
            a[[i, j], :] = a[[j, i], :]
            a[:, [i, j]] = a[:, [j, i]]
            order[[i, j]] = order[[j, i]]
        piv = a[i, i].real
        if piv <= eps:
            a[i:, :] = 0.0
            dropped = n - i
            break
        r = np.sqrt(piv)
        a[i, i] = r
        a[i, i + 1:] /= r
        a[i + 1:, i] = 0.0
        row = a[i, i + 1:]
        a[i + 1:, i + 1:] -= np.outer(cj(row), row)

    def _ill(p):
        u = a[:p, :p]
        lmax = _factor_lmax(u)
        if lmax <= 0:
            return True
        return _factor_lmin(u) / lmax <= eps

    kept = n - dropped
    lo = max(fixed, 1)
    if kept > lo and _ill(kept):
        hi = kept
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if _ill(mid):
                hi = mid
            else:
                lo = mid
        a[lo:, :] = 0.0
        dropped = n - lo
    return a, order, dropped


def default_block_size(left, right, extra, init_counts, threads):
    """Default block-size policy; parity with reference
    core/solver.py:1690-1734.  ``threads`` plays the role of the hardware
    granularity hint: block sizes are rounded up to a multiple of it (on TPU
    a multiple of 8 keeps blocks aligned to VPU sublanes)."""
    import math
    extra_left, extra_right = int(extra[0]), int(extra[1])
    init_left, init_right = init_counts
    if threads <= 8:
        threads = 8
    if left == 0 and right == 0:
        return 0
    if left <= 0 and right <= 0:
        if init_left == 0 and init_right == 0:
            return 2 * threads if (left < 0 and right < 0) else threads
        m = init_left + init_right
        m = threads * ((m - 1) // threads + 1)
        if left < 0 or right < 0:
            m = max(m, 2 * threads)
        return m
    left_total = 0
    right_total = 0
    if left > 0:
        if extra_left >= 0:
            left_total = max(left + extra_left, init_left)
        else:
            left_total = int(math.floor(max(left, init_left) * 1.2))
    if right > 0:
        if extra_right >= 0:
            right_total = max(right + extra_right, init_right)
        else:
            right_total = int(math.floor(max(right, init_right) * 1.2))
    if left < 0:
        left_total = right_total
    if right < 0:
        right_total = left_total
    m = int(left_total + right_total)
    m = threads * ((m - 1) // threads + 1)
    if left < 0 or right < 0:
        m = max(m, 2 * threads)
    return m
