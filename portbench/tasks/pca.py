"""The dense PCA task: ``pca(A, npc)`` on an (m, n) f32 matrix that stays
on the card, the factors fetched to the host as a user gets them, judged
against the configuration's plain float64 reference.

The timed call is the program's public ``pca`` with its defaults
(``method='auto'``, which on the card is the subspace engine with its own
oversampling, iterations and seed).  Four checks, each held to the limit
its workload file states, over the solves sampled from the seed, in
float64 on the device:

* ``err_excess``: ||A - e mean - trans comps||_F / e_opt - 1, e_opt the
  optimal rank-npc error of the centred data (the mean returned is part
  of the approximation held);
* ``sv_err``: the largest relative gap of the column norms of ``trans``
  (the singular values the program found) from the reference's
  sigma_1 ... sigma_npc;
* ``ortho``: the largest entry of |comps comps^T - I|;
* ``trans_ortho``: the largest entry of |U^T U - I| for U, trans with its
  columns scaled to unit norm (the left singular vectors).

The first three measure the engine's truncation as much as its
arithmetic: at this cell's size its tail components are not converged
(``sv_err`` about 1.4e-2 at component 800), and products in TF32 read the
same.  U is orthonormal by construction, converged or not, so
``trans_ortho`` reads the precision of the products alone: f32 about
1e-6, TF32 about 3e-4.

A solve that returns factors of the wrong shape or a value that is not
finite fails outright.  The limits and the readings they were set from
are in ``PERF.md``.
"""

import inspect
from types import SimpleNamespace

import numpy as np

from .. import registry

NUMBERS = ('err_excess', 'sv_err', 'ortho', 'trans_ortho')


def stats(problem):
    """What the rooflines need of the inputs: m, n."""
    m, n = problem['A'].shape
    return {'m': int(m), 'n': int(n)}


class Program:
    """The program's set-up of one problem and its solve.  It holds the
    maker's matrix itself, which ``pca`` reads and never writes: a copy
    would double the data on the card.  ``control`` 'tf32' lets the
    products run in TF32."""

    def __init__(self, cell, problem, device=None, control=None):
        from raleigh_tpu_torch.interfaces import randomized
        wl = cell.workload
        # the engine's defaults are what the workload (and the FLOP count
        # of rooflines/subspace_pca.py) states
        defaults = inspect.signature(randomized.subspace_pca).parameters
        for key in ('oversample', 'iters'):
            if defaults[key].default != wl[key]:
                raise ValueError('the engine runs %s %s, the workload '
                                 'states %s' % (key, defaults[key].default,
                                                wl[key]))
        if control not in (None, 'tf32'):
            raise ValueError('unknown control %r' % (control,))
        self.a = problem['A']
        self.npc = wl['npc']
        self.device = device
        self.control = control

    def solve(self):
        """One ``pca`` call: SimpleNamespace(status, iterations, x), x the
        host arrays (mean, trans, comps)."""
        import torch
        from raleigh_tpu_torch.interfaces.pca import pca
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.control == 'tf32'
        try:
            x = pca(self.a, npc=self.npc, device=self.device)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return SimpleNamespace(status=0, iterations=None, x=x)


def structural(x, m, n, k):
    """None when ``x`` is (mean (1, n), trans (m, k), comps (k, n)), all
    finite, else why not."""
    shapes = tuple(np.shape(t) for t in x)
    if shapes != ((1, n), (m, k), (k, n)):
        return 'factors of shapes %s' % (shapes,)
    if not all(np.all(np.isfinite(t)) for t in x):
        return 'factors not finite'
    return None


def readings(a, x, ref, device):
    """(err_excess, sv_err, ortho, trans_ortho) of the factors ``x`` of
    ``a`` against the reference's spectrum ``ref``, in float64 on
    ``device``."""
    import torch
    mean, trans, comps = (torch.as_tensor(t).to(device=device,
                                                dtype=torch.float64)
                          for t in x)
    flags = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        r = torch.as_tensor(a).to(device=device, dtype=torch.float64)
        r -= mean
        r -= trans @ comps
        err = float(torch.linalg.vector_norm(r))
        del r
        sv = torch.linalg.vector_norm(trans, dim=0)
        eye = torch.eye(len(sv), dtype=torch.float64, device=device)
        ortho = float((comps @ comps.T - eye).abs().max())
        u = trans / sv
        trans_ortho = float((u.T @ u - eye).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags
    sigma = ref['sigma']
    sv = sv.cpu().numpy()
    return (err / ref['e_opt'] - 1.0,
            float(np.max(np.abs(sv - sigma) / sigma)), ortho, trans_ortho)


def judge(cell, problem, solves, device):
    """(numbers, failed, reasons) of ``solves`` against the plain
    reference of ``problem``, worked out on ``device``."""
    spec = cell.config['reference']
    a = problem['A']
    m, n = a.shape
    k = cell.workload['npc']
    reasons = {}
    sampled = []
    for i, s in enumerate(solves):
        if s.x is None:
            continue
        why = structural(s.x, m, n, k)
        if why is None:
            sampled.append(s)
        else:
            reasons[i] = why
    numbers = dict.fromkeys(NUMBERS)
    if sampled:
        ref = registry.module('references', spec['name'], cell.root
                              ).spectrum(a, k, device)
        read = [readings(a, s.x, ref, device) for s in sampled]
        for j, name in enumerate(NUMBERS):
            numbers[name] = max(r[j] for r in read)
    return numbers, len(reasons), reasons
