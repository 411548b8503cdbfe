"""The smallest eigenvalues of a sparse symmetric pencil A x = lambda B x
(B symmetric positive definite) by a plain float64 LOBPCG in PyTorch,
preconditioned by a Chebyshev approximation of A^-1 on [hi * lo_ratio,
hi], hi the Gershgorin bound of A.  The sparse products are
``torch.sparse`` CSR products (cuSPARSE on the card); the basis of each
Rayleigh-Ritz step is B-whitened by an eigendecomposition of its Gram
matrix, dropping dependent directions.  It shares no code with the
program; its start block comes from a generator of its own."""

import warnings

import numpy as np
import torch


def csr_tensor(a, device):
    """The f64 CSR tensor of the SciPy matrix ``a`` on ``device``."""
    a = a.tocsr()
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', UserWarning)   # "in beta state"
        return torch.sparse_csr_tensor(
            torch.as_tensor(a.indptr.astype(np.int32)),
            torch.as_tensor(a.indices.astype(np.int32)),
            torch.as_tensor(a.data, dtype=torch.float64),
            size=a.shape, check_invariants=False).to(device)


def gershgorin_hi(a):
    a = a.tocsr()
    return float(np.add.reduceat(np.abs(a.data), a.indptr[:-1]).max())


def chebyshev(apply_a, lo, hi, degree):
    """r -> p(A) r ~ A^-1 r: ``degree`` steps of the Chebyshev iteration
    for A y = r from y = 0 on [lo, hi] (Saad, Iterative Methods, 2nd ed.,
    Algorithm 12.1)."""
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma1 = theta / delta

    def run(r):
        rho = 1.0 / sigma1
        d = r / theta
        y = d
        res = r - apply_a(d)
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * res
            y = y + d
            res = res - apply_a(d)
            rho = rho_new
        return y
    return run


def smallest(apply_a, apply_b, n, k, m, precond, tol, maxit, seed, device):
    """(lambda (k,), X (n, k), iterations) of the k smallest eigenpairs,
    each with ||A x - lambda B x|| <= tol |lambda| ||B x||.  Raises when
    ``maxit`` iterations do not get there."""
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn((n, m), generator=gen, dtype=torch.float64,
                    device=device)
    w = p = None
    for it in range(1, maxit + 1):
        s = torch.cat([b for b in (x, w, p) if b is not None], dim=1)
        a_s = apply_a(s)
        b_s = apply_b(s)
        g = s.T @ b_s
        scale = torch.sqrt(torch.clamp(torch.diagonal(g), min=1e-300))
        g = g / scale[:, None] / scale[None, :]
        d, v = torch.linalg.eigh(0.5 * (g + g.T))
        keep = d > 1e-12 * d[-1]
        coef = v[:, keep] / torch.sqrt(d[keep])[None, :] / scale[:, None]
        h = coef.T @ (s.T @ a_s) @ coef
        theta, y = torch.linalg.eigh(0.5 * (h + h.T))
        z = coef @ y[:, :m]
        x = s @ z
        ax = a_s @ z
        bx = b_s @ z
        lam = theta[:m]
        r = ax - bx * lam[None, :]
        rel = (torch.linalg.vector_norm(r, dim=0)
               / (lam.abs() * torch.linalg.vector_norm(bx, dim=0)))
        if bool((rel[:k] <= tol).all()):
            return lam[:k].cpu().numpy(), x[:, :k], it
        w = precond(r)
        p = s[:, m:] @ z[m:] if s.shape[1] > m else None
    raise RuntimeError('the float64 reference did not reach %.0e in %d '
                       'iterations (%s)' % (tol, maxit,
                                            rel[:k].cpu().numpy()))


def eigenvalues(problem, k, spec, device):
    a = csr_tensor(problem['A'], device)
    b = None if problem['B'] is None else csr_tensor(problem['B'], device)
    hi = gershgorin_hi(problem['A'])

    def apply_a(v):
        return a @ v

    def apply_b(v):
        return v if b is None else b @ v
    precond = chebyshev(apply_a, hi * spec['lo_ratio'], hi, spec['degree'])
    lam, _, _ = smallest(apply_a, apply_b, a.shape[0], k, spec['block'],
                         precond, spec['tol'], spec['maxit'], spec['seed'],
                         device)
    return lam
