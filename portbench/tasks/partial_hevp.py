"""The eigensolver's task: ``partial_hevp`` on a sparse pencil A x =
lambda B x (B None for a standard problem), preconditioned by the
program's ``Chebyshev``, judged against the configuration's plain
float64 reference.

Three checks, each held to the limit its workload file states:

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

import contextlib
import io
import re
from types import SimpleNamespace

import numpy as np

from .. import registry

NUMBERS = ('eig_err', 'resid', 'ortho')

_ITERATIONS = re.compile(r'iterations: (\d+), solve time:')


def stats(problem):
    """What the rooflines need of the inputs: n, A's nonzeros, and B's
    nonzeros (None without B)."""
    b = problem['B']
    return {'n': int(problem['A'].shape[0]), 'nnz': int(problem['A'].nnz),
            'nnz_b': None if b is None else int(b.nnz)}


class Program:
    """The program's set-up of one problem and its solve.  It holds copies
    of the inputs, so that dropping it frees whatever the program built
    from them.  ``control`` puts the program on its lower-precision path:
    'tf32' lets its float32 matrix products run in TF32, 'f32' gives it
    float32 matrices, so that its core Solver iterates in float32."""

    def __init__(self, cell, problem, device=None, control=None):
        from raleigh_tpu_torch import Chebyshev, spectral_bounds
        wl = cell.workload
        self.a = problem['A'].copy()
        self.b = None if problem['B'] is None else problem['B'].copy()
        cheb = wl['chebyshev']
        lo, hi = spectral_bounds(self.a)
        if 'lo_ratio' in cheb:
            lo = hi * cheb['lo_ratio']
        self.t = Chebyshev(self.a, lo, hi, degree=cheb['degree'],
                           device=device)
        self.a_in, self.b_in = self.a, self.b
        if control == 'f32':
            self.a_in = self.a.astype(np.float32)
            self.b_in = None if self.b is None else self.b.astype(np.float32)
        elif control not in (None, 'tf32'):
            raise ValueError('unknown control %r' % (control,))
        self.control = control
        self.kw = dict(which=wl['which'], tol=wl['tol'], engine=wl['engine'],
                       device=device)

    def solve(self):
        """One ``partial_hevp`` call: SimpleNamespace(lmd, x, status,
        iterations), its printed lines captured."""
        from raleigh_tpu_torch import partial_hevp
        import torch
        out = io.StringIO()
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.control == 'tf32'
        try:
            with contextlib.redirect_stdout(out):
                lmd, x, status = partial_hevp(self.a_in, B=self.b_in,
                                              T=self.t, **self.kw)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        found = _ITERATIONS.findall(out.getvalue())
        return SimpleNamespace(lmd=lmd, x=x, status=status,
                               iterations=int(found[-1]) if found else None)


def reference(cell, problem, device):
    """The ``which`` smallest eigenvalues of ``problem`` by the
    configuration's plain reference, on ``device``."""
    spec = cell.config['reference']
    ref = registry.module('references', spec['name'], cell.root)
    return ref.eigenvalues(problem, cell.workload['which'], spec, device)


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


def compare(problem, k, solves, ref, device):
    """(numbers, failed, reasons) of the solves against the reference's
    eigenvalues ``ref``: ``numbers`` maps each of ``NUMBERS`` to its
    reading (None when no solve could be read), ``failed`` counts the
    solves that failed outright, ``reasons`` says why, by solve."""
    from ..references.lobpcg64 import csr_tensor
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


def judge(cell, problem, solves, device):
    """(numbers, failed, reasons) of ``solves`` against the plain
    reference of ``problem``, worked out on ``device``."""
    ref = reference(cell, problem, device)
    return compare(problem, cell.workload['which'], solves, ref, device)
