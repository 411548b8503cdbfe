"""Sparse eigenvalue benchmark/demo: eigenvalues nearest a shift, timed
against scipy.sparse.linalg.eigsh (reference examples/sparse_evp.py).

Usage:
    python -m raleigh_tpu_torch.examples.sparse_evp [nev] [sigma]
        [path|lap3d] [tol] [arch]

The block algebra runs on the card (the LDL^T factorization and solves on
the host); ``arch`` 'cpu' keeps everything on the host.

With no path (or 'lap3d') the 3D Laplacian from lap3d.par-style defaults
(30 x 30 x 30, reference lap3d.par) is used; otherwise the path must point
to a MatrixMarket .mtx file.
"""

import sys
import time

import numpy as np


if __package__ in (None, ''):     # runnable as a plain script
    import os as _os
    import sys as _sys
    _sys.path.insert(0, _os.path.join(
        _os.path.dirname(_os.path.abspath(__file__)), '..', '..'))

def run(nev=6, sigma=0.0, source='lap3d', tol=1e-4, verb=0,
        compare_eigsh=True, lap_dims=(30, 30, 30, 1.0, 1.01, 1.02),
        arch=None, device=None):
    from raleigh_tpu_torch.examples.laplace import lap3d
    from raleigh_tpu_torch.interfaces.partial_hevp import partial_hevp

    if source == 'lap3d':
        nx, ny, nz, ax, ay, az = lap_dims
        A = lap3d(int(nx), int(ny), int(nz), ax, ay, az)
    else:
        from scipy.io import mmread
        A = mmread(source).tocsr()
    n = A.shape[0]
    print('matrix size %d, nnz %d' % (n, A.nnz))

    np.random.seed(1)
    start = time.time()
    lmd, x, status = partial_hevp(A, sigma=sigma, which=nev, tol=tol,
                                  verb=verb, arch=arch, device=device)
    t_raleigh = time.time() - start
    print('raleigh_tpu_torch partial_hevp: %.2f s, status %d'
          % (t_raleigh, status))
    print('eigenvalues:', lmd[:nev])

    if compare_eigsh:
        from scipy.sparse.linalg import eigsh
        start = time.time()
        w = eigsh(A, k=nev, sigma=sigma, which='LM',
                  return_eigenvectors=False)
        t_eigsh = time.time() - start
        print('scipy eigsh: %.2f s' % t_eigsh)
        err = np.abs(np.sort(lmd[:nev]) - np.sort(w)).max() \
            / np.abs(w).max()
        print('agreement: %.1e;  speedup vs eigsh: %.1fx'
              % (err, t_eigsh / max(t_raleigh, 1e-9)))
        return t_raleigh, t_eigsh, lmd
    return t_raleigh, None, lmd


if __name__ == '__main__':
    args = sys.argv[1:]
    nev = int(args[0]) if len(args) > 0 else 6
    sigma = float(args[1]) if len(args) > 1 else 0.0
    source = args[2] if len(args) > 2 else 'lap3d'
    tol = float(args[3]) if len(args) > 3 else 1e-4
    arch = args[4] if len(args) > 4 else None
    run(nev, sigma, source, tol, arch=arch)
