"""Device-resident preconditioned block eigensolver (LOBPCG).

PyTorch port of ``raleigh_tpu/core/device_solver.py``.  The whole
iteration — SpMM, polynomial preconditioning, constraint
orthogonalization, Gram matrices, the Rayleigh–Ritz eigenproblem of a
(3m x 3m) matrix, basis update and residual norms — runs on the device.
The JAX package compiles ``chunk`` iterations into one program; here they
run as an eager loop, and the host still looks at the (m,) eigenvalues and
residuals only once per chunk to decide termination.

Blocks are stored as (m, n) row-vector tensors, vectors as rows; the
public contract stays column-major ((n, k) eigenvectors, (n, nc)
constraints) like the reference's.  Algorithm, masks and thresholds are
the JAX package's: classical LOBPCG with hierarchical block
orthonormalization (X ⊥ W ⊥ P, two-pass Gram–Schmidt, eigh-whitening with
dead-row masking), in the B-inner product for generalized problems, with
optional deflation against ``constraints``.  f32 products run at full f32
(TF32 stays off).
"""

import numpy as np
import torch

from ..ops.spmm import torch_dtype


def _gram(a, b):
    """Xᴴ Y for row-stored blocks: contraction over the vector
    dimension."""
    return torch.matmul(a.conj(), b.transpose(0, 1))


def _eigh_small(h):
    """Eigendecomposition of the (3m x 3m) Rayleigh–Ritz matrix, always
    in float64: the reference solves its Ritz problem in float64 whatever
    the vector dtype (core/solver.py:1437-1473), and the H100 has native
    f64, so f32 iterations resolve eigenvalue clusters that an all-f32
    Ritz step cannot."""
    wide = torch.complex128 if h.is_complex() else torch.float64
    w, v = torch.linalg.eigh(h.to(wide))
    return w.to(h.real.dtype), v.to(h.dtype)


def _bnorms(block, bblock):
    """Per-row B-norms given the block and its B-image (2-norms when
    bblock is block itself)."""
    return torch.sqrt(torch.clamp((block.conj() * bblock).sum(1).real,
                                  min=0.0))


def _normalize_drop_pair(block, bblock, sqrt_eps, dead0=None):
    """Normalize rows to unit B-length; a row whose norm collapsed below
    sqrt(eps) relative to the block's largest row is rounding noise —
    zero it and flag it dead.  Row scaling commutes with the operators,
    so the B-image follows exactly."""
    norms = _bnorms(block, bblock)
    ref = torch.clamp(norms.max(), min=1e-30)
    dead = norms <= sqrt_eps * ref
    if dead0 is not None:
        dead = dead | dead0
    safe = torch.where(norms == 0, 1.0, norms).to(block.real.dtype)
    out = torch.where(dead[:, None], 0.0, block / safe[:, None])
    bout = out if bblock is block else \
        torch.where(dead[:, None], 0.0, bblock / safe[:, None])
    return out, bout, dead


def _whiten_pair(block, bblock, eps_rel, sqrt_eps, dead0=None):
    """B-orthonormalize the rows of ``block`` by eigh-whitening of its
    B-Gram matrix; near-dependent directions are zeroed and flagged.

    Returns (whitened block, whitened B-image, dead mask (m,))."""
    g = _gram(block, bblock)
    g = 0.5 * (g + g.conj().transpose(0, 1))
    w, v = torch.linalg.eigh(g)            # ascending, w >= 0 up to noise
    wmax = torch.clamp(w[-1], min=0.0)
    dead_g = w <= wmax * eps_rel
    inv = torch.where(dead_g, 0.0,
                      1.0 / torch.sqrt(torch.where(dead_g, 1.0, w)))
    mix = v * inv[None, :]
    # row blocks combine from the left: X_new = X mix  <=>  R_new = mixᵀ R
    bw = torch.matmul(mix.transpose(0, 1), block)
    bbw = bw if bblock is block else torch.matmul(mix.transpose(0, 1),
                                                  bblock)
    # a correctly whitened row is unit up to rounding; anything that is
    # not was noise-dominated — run the scale test once more
    return _normalize_drop_pair(bw, bbw, sqrt_eps, dead0)


def _ortho_against_pair(block, basis, bbasis, *extra):
    """Two-pass classical Gram–Schmidt of ``block`` against the
    B-orthonormal ``basis`` in the B-inner product.  Any ``extra``
    (image, basis image) pairs receive the same row operation exactly."""
    outs = list(extra)
    for _ in range(2):
        q = _gram(bbasis, block)
        block = block - torch.matmul(q.transpose(0, 1), basis)
        for i, (img, bas_img) in enumerate(outs):
            outs[i] = (img - torch.matmul(q.transpose(0, 1), bas_img),
                       bas_img)
    if not extra:
        return block
    return (block,) + tuple(img for img, _ in outs)


def _rows_matmat(op):
    """Adapt the operator form the caller gave to the row-layout
    (m, n) -> (m, n) apply the iteration uses: a device sparse matrix
    (``matmat_rows`` or ``matmat_t``) or a bare column-layout callable."""
    if op is None:
        return None
    if hasattr(op, 'matmat_rows'):
        return op.matmat_rows
    if hasattr(op, 'matmat_t'):
        def apply_rows(v):
            return op.matmat_t(v.transpose(0, 1)).transpose(0, 1)
        return apply_rows

    def apply_rows(v):
        return op(v.transpose(0, 1)).transpose(0, 1)
    return apply_rows


def default_block(k, n):
    """Default iteration block for ``k`` wanted pairs: k plus slack,
    rounded up to a multiple of 8 (kept from the JAX package, so both
    iterate the same block; the CUDA kernel itself takes any m)."""
    m = min(n, k + max(8, k // 4))
    return min(n, -(-m // 8) * 8)


def lobpcg(op, k, n=None, opB=None, precond=None, block_size=None,
           tol=1e-4, maxit=500, chunk=16, largest=False, x0=None,
           constraints=None, seed=1, dtype=torch.float32, verb=0,
           sharding=None, device=None):
    """Compute the ``k`` algebraically smallest (or largest) eigenpairs of
    a symmetric positive (semi-)definite operator — or of the generalized
    pencil (A, B) when ``opB`` is given — on the device.

    Parameters
    ----------
    op : a device sparse matrix from ops/spmm.py (``matmat_rows``), an
        object with ``matmat_t((n, m)) -> (n, m)``, or a bare column-layout
        callable on tensors.
    k : number of wanted eigenpairs.
    n : problem dimension (required when ``op`` is a bare callable).
    opB : optional right-hand operator of a generalized problem
        A x = λ B x, symmetric positive definite, in the same forms.  The
        returned eigenvectors are B-orthonormal.
    precond : None, a row-layout (m, n) -> (m, n) callable, or an
        ``(fn, operands)`` pair such as
        ``Chebyshev.device_rows_operands(m, n)``.
    block_size : iteration block m >= k (default ``default_block(k, n)``).
    tol : convergence on ||A x - lmd B x|| <= tol * anorm_est per wanted
        pair, anorm_est = running max |lmd| (scipy.lobpcg convention).
    chunk : iterations between host convergence checks.
    x0 : optional (n, >=m) initial block (ndarray or tensor).  Without
        it the start block is ``torch.randn`` from a generator seeded with
        ``seed``; it cannot reproduce the JAX package's random bits, so
        comparisons between the packages pass ``x0``.
    constraints : optional (n, nc) block of prior eigenvectors; the
        iteration is deflated against their B-orthonormalized span, so it
        computes the *next* k pairs.
    dtype : iteration dtype (torch or numpy).
    sharding : multi-device runs are not ported yet (ROADMAP queue 1,
        item 13); anything but None raises.
    device : device of the iteration (default: ``op.device``, else CPU).

    Returns (lmd (k,), x (n, k), resid (k,), niter, status) as NumPy
    arrays, status 0 = converged, 2 = iteration limit, 3 = no search
    directions (reference core/solver.py:305-331).
    """
    if sharding is not None:
        raise NotImplementedError('sharded LOBPCG is not ported yet '
                                  '(ROADMAP queue 1, item 13)')
    if n is None:
        n = op.shape[0]
    if device is None:
        device = getattr(op, 'device', 'cpu')
    device = torch.device(device)
    dtype = torch_dtype(dtype)
    m = block_size or default_block(k, n)
    if m < k:
        raise ValueError('block_size < k')
    matmat_a = _rows_matmat(op)
    matmat_b_rows = _rows_matmat(opB)
    real = torch.empty((), dtype=dtype).real.dtype
    eps = torch.finfo(real).eps
    eps_rel = 100 * eps
    sqrt_eps = float(np.sqrt(eps))
    sign = -1.0 if largest else 1.0

    # the operator (and preconditioner) may hold values in a different
    # precision; the iteration dtype is authoritative for the carries
    def matmat(v):
        return matmat_a(v).to(v.dtype)

    if opB is None:
        def matmat_b(v):
            return v
    else:
        def matmat_b(v):
            return matmat_b_rows(v).to(v.dtype)

    if precond is None:
        def apply_precond(w):
            return w
    elif isinstance(precond, tuple):
        precond_fn, ops_p = precond

        def apply_precond(w):
            return precond_fn(ops_p, w)
    else:
        apply_precond = precond

    def as_rows(block):
        """(n, j) column block (ndarray or tensor) -> (j, n) rows."""
        if not isinstance(block, torch.Tensor):
            block = torch.from_numpy(np.array(block))   # writable copy
        t = block.to(dtype=dtype, device=device)
        return t.transpose(0, 1).contiguous()

    # ---- constraints: B-orthonormalize once, precompute A/B-images -----
    if constraints is not None and np.size(constraints) > 0:
        y = as_rows(constraints)
        by0 = matmat_b(y)
        y, by0, dead_y = _normalize_drop_pair(y, by0, sqrt_eps)
        y, by0, dead_y = _whiten_pair(y, by0, eps_rel, sqrt_eps, dead_y)
        ay = matmat(y)
        by = matmat_b(y)
    else:
        y = torch.zeros((0, n), dtype=dtype, device=device)
        ay = by = y

    def step(x, ax, bx, p, ap, bp, anorm):
        # re-deflate X against the constraints every iteration with exact
        # image tracking: a leaked constraint direction with a more
        # extreme eigenvalue is amplified by the Rayleigh–Ritz step
        q = _gram(by, x)
        x = x - torch.matmul(q.transpose(0, 1), y)
        ax = ax - torch.matmul(q.transpose(0, 1), ay)
        if opB is not None:
            bx = bx - torch.matmul(q.transpose(0, 1), by)
        else:
            bx = x
        lam = (x.conj() * ax).sum(1).real
        anorm = torch.maximum(anorm, lam.abs().max())
        w = ax - lam[:, None].to(x.dtype) * bx
        w = apply_precond(w).to(w.dtype)
        # hierarchical B-orthonormalization: X is B-orthonormal;
        # W ⊥_B Y, X; P ⊥_B Y, X, W.  Dead (noise or rank-deficient) rows
        # are zeroed and masked out of the Rayleigh–Ritz selection.
        w, _, dead_w = _normalize_drop_pair(w, w, sqrt_eps)
        w = _ortho_against_pair(w, y, by)
        w = _ortho_against_pair(w, x, bx)
        bw = matmat_b(w)
        w, bw, dead_w = _normalize_drop_pair(w, bw, sqrt_eps, dead_w)
        w, bw, dead_w = _whiten_pair(w, bw, eps_rel, sqrt_eps, dead_w)
        aw = matmat(w)
        p, _, dead_p = _normalize_drop_pair(p, p, sqrt_eps)
        p = _ortho_against_pair(p, y, by)
        p = _ortho_against_pair(p, x, bx)
        p = _ortho_against_pair(p, w, bw)
        bp = matmat_b(p)
        p, bp, dead_p = _normalize_drop_pair(p, bp, sqrt_eps, dead_p)
        p, bp, dead_p = _whiten_pair(p, bp, eps_rel, sqrt_eps, dead_p)
        ap = matmat(p)
        s = torch.cat((x, w, p), dim=0)
        a_s = torch.cat((ax, aw, ap), dim=0)
        h = _gram(s, a_s)
        h = 0.5 * (h + h.conj().transpose(0, 1)) * sign
        dead = torch.cat((torch.zeros(m, dtype=torch.bool, device=device),
                          dead_w, dead_p))
        # push dead (zeroed) basis rows past the live spectrum, which is
        # bounded by 3m * max|diag| for a B-orthonormal basis, so the Ritz
        # selection never picks them
        big = (torch.diagonal(h).abs().max() + 1.0) * (4.0 * s.shape[0])
        h = h + torch.diag(torch.where(dead, big, 0.0).to(h.dtype))
        _, c = _eigh_small(h)
        cm = c[:, :m]
        xn = torch.matmul(cm.transpose(0, 1), s)
        axn = torch.matmul(cm.transpose(0, 1), a_s)
        # conjugate directions: the W/P components of the update
        cwp = cm.clone()
        cwp[:m] = 0
        pn = torch.matmul(cwp.transpose(0, 1), s)
        apn = torch.matmul(cwp.transpose(0, 1), a_s)
        if opB is not None:
            b_s = torch.cat((bx, bw, bp), dim=0)
            bxn = torch.matmul(cm.transpose(0, 1), b_s)
            bpn = torch.matmul(cwp.transpose(0, 1), b_s)
        else:
            bxn, bpn = xn, pn
        return xn, axn, bxn, pn, apn, bpn, anorm

    def run_chunk(state, iters):
        for _ in range(iters):
            state = step(*state)
        x, ax, bx, p, ap, bp, anorm = state
        # chunk exit: re-deflate and refresh the images so the host's
        # convergence decision sees trustworthy residuals
        q = _gram(by, x)
        x = x - torch.matmul(q.transpose(0, 1), y)
        ax = matmat(x)
        bx = matmat_b(x)
        lam = (x.conj() * ax).sum(1).real
        anorm = torch.maximum(anorm, lam.abs().max())
        resid = torch.linalg.vector_norm(ax - lam[:, None].to(x.dtype) * bx,
                                         dim=1)
        order = torch.argsort(sign * lam)
        return (x[order], ax[order], bx[order], p, ap, bp, anorm), \
            lam[order], resid[order]

    # ---- initial block -----------------------------------------------
    gen = torch.Generator(device).manual_seed(seed)
    if x0 is not None:
        x = as_rows(x0)[:m]
        if x.shape[0] < m:
            extra = torch.randn((m - x.shape[0], n), generator=gen,
                                dtype=dtype, device=device)
            x = torch.cat((x, extra), dim=0)
    else:
        x = torch.randn((m, n), generator=gen, dtype=dtype, device=device)

    x = _ortho_against_pair(x, y, by)
    bx = matmat_b(x)
    x, bx, dead_x = _normalize_drop_pair(x, bx, sqrt_eps)
    x, bx, _ = _whiten_pair(x, bx, eps_rel, sqrt_eps, dead_x)
    ax = matmat(x)
    lam0 = (x.conj() * ax).sum(1).real
    r0 = torch.linalg.vector_norm(ax - lam0[:, None].to(x.dtype) * bx,
                                  dim=1)
    p = torch.zeros_like(x)
    ap = torch.zeros_like(x)
    bp = p if opB is None else torch.zeros_like(x)
    anorm = torch.zeros((), dtype=real, device=device)
    lam_h, resid_h = lam0.cpu().numpy(), r0.cpu().numpy()
    anorm_h = float(np.max(np.abs(lam_h)))

    state = (x, ax, bx, p, ap, bp, anorm)
    niter = 0
    status = 2
    restarts = 0
    stall = 0
    best = np.inf
    while niter < maxit:
        iters = min(chunk, maxit - niter)
        new_state, lam, resid = run_chunk(state, iters)
        niter += iters
        lam_t = lam.cpu().numpy()
        resid_t = resid.cpu().numpy()
        anorm_t = float(new_state[-1])
        if not (np.all(np.isfinite(lam_t)) and np.all(np.isfinite(resid_t))):
            # post-convergence noise blocks can degenerate when the caller
            # over-iterates far past the engine's accuracy floor: roll back
            # to the pre-chunk state, reset the conjugate directions, and
            # retry; give up (status 3) on repeat
            x, ax, bx, _, _, _, anorm = state
            p = torch.zeros_like(x)
            ap = torch.zeros_like(x)
            bp = p if opB is None else torch.zeros_like(x)
            state = (x, ax, bx, p, ap, bp, anorm)
            restarts += 1
            if verb > 0:
                print('iter %4d: non-finite chunk, rolling back (%d)'
                      % (niter, restarts))
            if restarts > 2:
                status = 3
                break
            continue
        state = new_state
        lam_h, resid_h, anorm_h = lam_t, resid_t, anorm_t
        if verb > 0:
            print('iter %4d: lmd[:%d] %s, resid %s' % (
                niter, min(k, 4), np.round(lam_h[:min(k, 4)], 6),
                np.format_float_scientific(resid_h[:k].max(), 2)))
        rmax = float(resid_h[:k].max())
        if np.all(resid_h[:k] <= tol * max(anorm_h, 1e-30)):
            status = 0
            break
        # stall detection: once the residual stops improving the iterate
        # sits at the engine's accuracy floor
        if rmax > 0.99 * best:
            stall += 1
            if stall >= 4:
                break
        else:
            stall = 0
        best = min(best, rmax)
    x = state[0]
    return (np.asarray(lam_h[:k]), x[:k].transpose(0, 1).cpu().numpy(),
            np.asarray(resid_h[:k]), niter, status)
