"""Buckling eigenvalue demo: smallest buckling load factors of the pencil
K x = lmd Ks x, compared against scipy eigsh in buckling mode
(reference examples/buckling_evp.py).

Usage:
    python -m raleigh_tpu_torch.examples.buckling_evp [nev] [sigma]
        [K.mtx Ks.mtx] [arch]

The block algebra and K's product run on the card (the factorization of
K - sigma Ks and its solves on the host); ``arch`` 'cpu' keeps everything
on the host.

Without matrix files a synthetic plate-like pencil is generated: K the 2D
Laplacian stiffness, Ks a negative-definite geometric stiffness.
"""

import sys
import time

import numpy as np
import scipy.sparse as scs


if __package__ in (None, ''):     # runnable as a plain script
    import os as _os
    import sys as _sys
    _sys.path.insert(0, _os.path.join(
        _os.path.dirname(_os.path.abspath(__file__)), '..', '..'))

def synthetic_pencil(nx=40, ny=40, nz=40):
    """Stiffness/stress-like pencil with 3D-FE fill structure (the regime
    of the reference's panel_buckle benchmarks, README.md:22-25, where a
    factorization per ARPACK solve is the expensive part)."""
    from raleigh_tpu_torch.examples.laplace import lap3d
    k = lap3d(nx, ny, nz, 1.0, 1.0, 1.0)
    n = k.shape[0]
    rng = np.random.RandomState(1)
    ks = scs.diags(-(1.0 + rng.rand(n)), format='csr')
    return k, ks


def run(nev=3, sigma=-10.0, matrices=None, tol=1e-4, verb=0, arch=None,
        device=None):
    from raleigh_tpu_torch.interfaces.partial_hevp import partial_hevp

    if matrices is None:
        K, Ks = synthetic_pencil()
    else:
        from scipy.io import mmread
        K = mmread(matrices[0]).tocsr()
        Ks = mmread(matrices[1]).tocsr()
    print('pencil size %d' % K.shape[0])

    np.random.seed(1)
    start = time.time()
    lmd, x, status = partial_hevp(K, B=Ks, buckling=True, sigma=sigma,
                                  which=nev, tol=tol, verb=verb, arch=arch,
                                  device=device)
    t_r = time.time() - start
    print('raleigh_tpu_torch buckling: %.2f s, status %d' % (t_r, status))
    print('load factors:', lmd[:nev])

    from scipy.sparse.linalg import eigsh
    start = time.time()
    w = eigsh(K, k=nev, M=Ks, sigma=sigma, mode='buckling', which='LA',
              return_eigenvectors=False)
    t_e = time.time() - start
    print('scipy eigsh(buckling): %.2f s' % t_e)
    print('agreement: %.1e;  speedup: %.1fx'
          % (np.abs(np.sort(lmd[:nev]) - np.sort(w)).max()
             / np.abs(w).max(), t_e / max(t_r, 1e-9)))
    return t_r, t_e, lmd


if __name__ == '__main__':
    args = sys.argv[1:]
    nev = int(args[0]) if len(args) > 0 else 3
    sigma = float(args[1]) if len(args) > 1 else -10.0
    mats = (args[2], args[3]) if len(args) > 3 else None
    arch = args[4] if len(args) > 4 else None
    run(nev, sigma, mats, arch=arch)
