"""What decides ``correct``: the eigenpairs the timed path returned,
against the configuration's plain reference, in float64.

Three numbers a cell, each held to the limit its workload file states:

* ``eig_err``: the largest relative gap between a returned eigenvalue and
  the reference's, over the ``which`` smallest of every solve judged;
* ``resid``: the largest relative residual ||A x - lambda B x||_2 /
  (|lambda| ||B x||_2) of a returned pair, over the solves sampled from
  the seed, with the matrices the benchmark made (never the program's
  copies);
* ``ortho``: the largest entry of |X^T B X - I| over the same solves:
  both engines return B-orthonormal eigenvectors.

A solve that returns a status other than 0, fewer pairs than asked, or a
value that is not finite fails outright.  The limits and the readings
they were set from are in ``PERF.md``.
"""

import sys

import numpy as np

# top-level module names that no run may hold once its window has closed:
# JAX and the JAX package, and the JAX-era benchmark at the repository's
# root (``bench.py``, ``benches/``); compared whole, since the program's
# own name, raleigh_tpu_torch, begins with raleigh_tpu
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'raleigh_tpu', 'bench', 'benches')

NUMBERS = ('eig_err', 'resid', 'ortho')


def forbidden_modules(names=None):
    """The forbidden top-level names among ``names`` (default: the
    modules this process has loaded), sorted."""
    tops = {name.split('.')[0] for name in (sys.modules if names is None
                                            else names)}
    return sorted(tops & set(FORBIDDEN))


def structural(solve, n, k):
    """None when ``solve`` returned k finite pairs of length n with status
    0, else why not."""
    if solve.status != 0:
        return 'status %s' % (solve.status,)
    if solve.lmd is None or len(solve.lmd) < k:
        return 'fewer than %d eigenvalues' % k
    if not np.all(np.isfinite(solve.lmd)):
        return 'eigenvalues not finite'
    if solve.x is not None:
        if solve.x.shape[0] != n or solve.x.shape[1] < k:
            return 'eigenvectors of shape %s' % (solve.x.shape,)
        if not np.all(np.isfinite(solve.x)):
            return 'eigenvectors not finite'
    return None


def eig_err(lmd, ref):
    """Largest relative gap of the k smallest of ``lmd`` from ``ref``."""
    got = np.sort(np.asarray(lmd, dtype=np.float64))[:len(ref)]
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


def resid_ortho(apply_a, apply_b, lmd, x, k, device):
    """(largest relative residual, largest entry of |X^T B X - I|) of the
    k smallest returned pairs, in float64 on ``device``."""
    import torch
    order = np.argsort(np.asarray(lmd))[:k]
    lam = torch.as_tensor(np.asarray(lmd, dtype=np.float64)[order],
                          device=device)
    xs = torch.as_tensor(np.ascontiguousarray(x[:, order]),
                         device=device).to(torch.float64)
    bx = apply_b(xs)
    r = apply_a(xs) - bx * lam[None, :]
    rel = (torch.linalg.vector_norm(r, dim=0)
           / (lam.abs() * torch.linalg.vector_norm(bx, dim=0)))
    gram = xs.T @ bx - torch.eye(k, dtype=torch.float64, device=device)
    return float(rel.max()), float(gram.abs().max())


def judge(problem, k, solves, ref, device):
    """(numbers, failed, reasons) for the solves: ``numbers`` maps each of
    ``NUMBERS`` to its reading (None when no solve could be read),
    ``failed`` counts the solves that failed outright."""
    from .references.lobpcg64 import csr_tensor
    n = problem['A'].shape[0]
    reasons = {}
    good = []
    for i, s in enumerate(solves):
        why = structural(s, n, k)
        if why is None:
            good.append(s)
        else:
            reasons[i] = why
    numbers = dict.fromkeys(NUMBERS)
    if good:
        numbers['eig_err'] = max(eig_err(s.lmd, ref) for s in good)
        sampled = [s for s in good if s.x is not None]
        if sampled:
            a = csr_tensor(problem['A'], device)
            b = (None if problem['B'] is None
                 else csr_tensor(problem['B'], device))

            def apply_b(v):
                return v if b is None else b @ v
            pairs = [resid_ortho(lambda v: a @ v, apply_b, s.lmd, s.x, k,
                                 device) for s in sampled]
            numbers['resid'] = max(p[0] for p in pairs)
            numbers['ortho'] = max(p[1] for p in pairs)
    return numbers, len(reasons), reasons


def verdict(numbers, failed, limits):
    """``correct``, and one line a number: its reading beside its
    limit."""
    lines = []
    correct = failed == 0
    for name in NUMBERS:
        value, limit = numbers.get(name), limits.get(name)
        ok = value is not None and limit is not None and value <= limit
        correct = correct and ok
        lines.append('check %s %s limit %s %s' % (
            name, 'none' if value is None else repr(value),
            'none' if limit is None else repr(limit),
            'ok' if ok else 'FAIL'))
    lines.append('check failed_solves %d limit 0 %s'
                 % (failed, 'ok' if failed == 0 else 'FAIL'))
    return correct, lines
