"""Principal Component Analysis front end.

PyTorch port of ``raleigh_tpu/interfaces/pca.py``; capability parity with
reference raleigh/interfaces/pca.py:16-179: fixed component count,
tolerance-driven count, warm-start update of previously computed
components (``have=``), incremental/streaming mode (``batch_size=``), and
the host/card switch (``arch='cpu'`` / ``device=``).

Usage example (matches the reference doctest problem, pca.py:95-133):

    >>> import numpy
    >>> from raleigh_tpu_torch.examples.generate_matrix import generate
    >>> numpy.random.seed(1)
    >>> A, sigma, u, v = generate(3000, 2000, 1000, pca=True)
    >>> mean, trans, comps = pca(A, npc=300, arch='cpu')
    >>> em, ef = pca_error(A, mean, trans, comps)
    >>> em < 6e-2 and ef < 2e-1
    True
"""

import numpy as np
import numpy.linalg as nla

from ..core.solver import Options
from ..algebra.dense import data_matrix
from ..utils.profiling import spanned
from .lra import LowerRankApproximation


@spanned('raleigh.pca')
def pca(A, npc=-1, tol=0, have=None, batch_size=None, verb=0, arch=None,
        norm='f', mpc=-1, svtol=1e-3, opt=None, method='auto', device=None):
    """PCA of the dataset whose samples are the rows of A.

    Computes mean (1, n), trans=L (m, k) and comps=R (k, n) with
    L R ~= A - e mean; rows of R (principal components) orthonormal, columns
    of L orthogonal in descending norm order.  ``npc`` fixes k; otherwise
    ``tol`` (in norm 's'/'f'/'m') or interactive stopping decides; ``have``
    warm-starts from a previous (mean, L, R); ``batch_size`` streams.
    See reference pca.py:16-133 for the full contract.

    Everything runs on the card unless ``device`` names another device or
    ``arch='cpu'`` asks for the host algebra; with no card and neither, it
    raises.

    ``method``: 'jacobi' is the reference-parity block Jacobi-CG engine
    (per-vector convergence control: the chunked device engine on torch
    blocks, the core Solver on host blocks); 'subspace' is the
    device-resident subspace-iteration engine (near-optimal truncation
    error, covering fixed-npc, tolerance-driven, warm-start and streaming
    modes); 'auto' (default) picks 'subspace' for every non-interactive
    mode on the card (``arch`` None, 'gpu' or 'cuda') and 'jacobi'
    otherwise.

    The factors come back as NumPy arrays.  From the card the subspace
    engine fetches them into pinned host memory from PyTorch's caching
    host allocator: each array owns its block, and a block freed with its
    array is kept for reuse by a later fetch of the same size.

    Under a profiler the call is the span ``raleigh.pca``.
    """
    if opt is None:
        opt = Options()
    if method == 'auto':
        interactive = npc < 1 and tol == 0
        on_card = arch is None or str(arch).lower().startswith(
            ('gpu', 'cuda'))
        method = 'subspace' if on_card and not interactive else 'jacobi'
    if method == 'subspace':
        from . import randomized as rz

        if npc < 1 and tol == 0:
            raise ValueError("method='subspace' is non-interactive: give "
                             'npc or tol')
        if device is None and arch == 'cpu':
            device = 'cpu'      # the host: torch on the CPU
        if batch_size is not None:
            if have is not None:
                raise ValueError('have= and batch_size= are exclusive')
            return rz.subspace_pca_stream(A, batch_size, npc=npc, tol=tol,
                                          norm=norm, max_npc=mpc,
                                          verb=verb, device=device)
        if have is not None:
            return rz.subspace_pca_update(have, A, npc=npc, tol=tol,
                                          norm=norm, max_npc=mpc,
                                          verb=verb, device=device)
        if npc > 0:
            return rz.subspace_pca(A, npc, device=device)
        return rz.subspace_pca_tol(A, tol, norm=norm, max_npc=mpc,
                                   verb=verb, device=device)
    lra = LowerRankApproximation(have)
    if batch_size is None:
        if have is None:
            matrix = data_matrix(A, arch, device)
            m, n = A.shape
            lra.ortho = svtol if m < n else 0
            lra.compute(matrix, opt=opt, rank=npc, tol=tol, norm=norm,
                        max_rank=mpc, svtol=svtol, shift=True, verb=verb)
        else:
            matrix = data_matrix(A, arch, device, copy_data=True)
            lra.update(matrix, opt=opt, rank=npc, tol=tol, norm=norm,
                       max_rank=mpc, svtol=svtol, verb=verb)
    else:
        lra.icompute(A, batch_size, opt=opt, rank=npc, tol=tol, norm=norm,
                     max_rank=mpc, svtol=svtol, shift=True, verb=verb,
                     arch=arch, device=device)
    return lra.mean(), lra.left(), lra.right()


def pca_error(data, mean, trans, comps):
    """(max relative row 2-norm, relative Frobenius norm) of the PCA
    approximation error (reference pca.py:167-175)."""
    ones = np.ones((data.shape[0], 1), dtype=data.dtype)
    mean = np.reshape(mean, (1, comps.shape[1]))
    data_s = data - ones @ mean
    err = trans @ comps - data_s
    em = np.amax(nla.norm(err, axis=1)) / np.amax(nla.norm(data_s, axis=1))
    ef = nla.norm(err, ord='fro') / nla.norm(data_s, ord='fro')
    return em, ef
