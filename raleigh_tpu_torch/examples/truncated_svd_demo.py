"""Truncated SVD demo vs scipy.sparse.linalg.svds
(reference examples/truncated_svd.py).

Usage:
    python -m raleigh_tpu_torch.examples.truncated_svd_demo [m] [n] [rank]
        [nsv] [arch]

Runs on the card (the chunked Jacobi engine); ``arch`` 'cpu' keeps
everything on the host (the core Solver).
"""

import sys
import time

import numpy as np


if __package__ in (None, ''):     # runnable as a plain script
    import os as _os
    import sys as _sys
    _sys.path.insert(0, _os.path.join(
        _os.path.dirname(_os.path.abspath(__file__)), '..', '..'))


def run(m=2000, n=1000, rank=400, nsv=100, arch=None, device=None):
    from raleigh_tpu_torch.examples.generate_matrix import generate
    from raleigh_tpu_torch.interfaces.truncated_svd import truncated_svd

    np.random.seed(1)
    A, sigma0, u0, v0 = generate(m, n, rank)
    print('matrix %d x %d, rank %d' % (m, n, rank))

    start = time.time()
    u, sigma, vt = truncated_svd(A, nsv=nsv, arch=arch, device=device)
    t_r = time.time() - start
    print('raleigh_tpu_torch truncated_svd: %.2f s' % t_r)

    from scipy.sparse.linalg import svds
    start = time.time()
    us, ss, vts = svds(A, k=nsv)
    t_s = time.time() - start
    print('scipy svds: %.2f s' % t_s)

    err = np.abs(sigma[:nsv] - ss[::-1][:nsv]).max() / ss.max()
    print('sigma agreement: %.1e;  speedup: %.1fx'
          % (err, t_s / max(t_r, 1e-9)))
    return t_r, t_s, err


if __name__ == '__main__':
    a = sys.argv[1:]
    run(*(int(x) for x in a[:4]), arch=(a[4] if len(a) > 4 else None))
