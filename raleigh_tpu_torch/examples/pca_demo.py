"""PCA demo suite: simple / tolerance-driven / update / incremental /
interactive modes, compared against scikit-learn where it is installed
(reference examples/pca/pca_simple.py, pca_smart.py, pca_update.py,
incremental_pca.py, interactive_pca.py).

Usage:
    python -m raleigh_tpu_torch.examples.pca_demo [mode] [m] [n] [rank]
        [npc] [arch]
    mode in {simple, tol, update, incremental, interactive}

Runs on the card (the subspace engine for the non-interactive modes);
``arch`` 'cpu' keeps everything on the host.
"""

import sys
import time

import numpy as np


if __package__ in (None, ''):     # runnable as a plain script
    import os as _os
    import sys as _sys
    _sys.path.insert(0, _os.path.join(
        _os.path.dirname(_os.path.abspath(__file__)), '..', '..'))


def _data(m, n, rank):
    from raleigh_tpu_torch.examples.generate_matrix import generate
    np.random.seed(1)
    A, sigma0, u0, v0 = generate(m, n, rank, pca=True)
    return A


def run(mode='simple', m=3000, n=2000, rank=1000, npc=300, arch=None,
        tol=0.05, verb=0, device=None):
    from raleigh_tpu_torch.interfaces.pca import pca, pca_error

    A = _data(m, n, rank)
    where = dict(arch=arch, device=device, verb=verb)
    print('data: %d samples x %d features' % (m, n))
    start = time.time()
    if mode == 'simple':
        mean, trans, comps = pca(A, npc=npc, **where)
    elif mode == 'tol':
        mean, trans, comps = pca(A, tol=tol, **where)
    elif mode == 'update':
        m0 = 4 * m // 5
        mean, trans, comps = pca(A[:m0], tol=tol, **where)
        mean, trans, comps = pca(A[m0:], have=(mean, trans, comps),
                                 **where)
    elif mode == 'incremental':
        mean, trans, comps = pca(A, batch_size=m // 3, tol=tol, **where)
    elif mode == 'interactive':
        mean, trans, comps = pca(A, **{**where, 'verb': 1})
    else:
        raise ValueError('unknown mode %r' % mode)
    t_r = time.time() - start
    em, ef = pca_error(A, mean, trans, comps)
    print('raleigh_tpu_torch pca[%s]: %.2f s, %d components, '
          'err max2 %.1e fro %.1e' % (mode, t_r, comps.shape[0], em, ef))

    try:
        from sklearn.decomposition import PCA as skPCA
    except ImportError:
        return t_r
    k = comps.shape[0]
    start = time.time()
    skPCA(n_components=k).fit_transform(A)
    t_s = time.time() - start
    print('sklearn PCA(%d): %.2f s;  speedup: %.1fx'
          % (k, t_s, t_s / max(t_r, 1e-9)))
    return t_r


if __name__ == '__main__':
    a = sys.argv[1:]
    mode = a[0] if a else 'simple'
    nums = [int(x) for x in a[1:5]]
    arch = a[5] if len(a) > 5 else None
    run(mode, *nums, arch=arch)
