"""Partial eigenvalue solver for sparse symmetric problems.

PyTorch port of ``raleigh_tpu/interfaces/partial_hevp.py``, preconditioned
device path: a standard or generalized problem with a Chebyshev
preconditioner runs on the device-resident LOBPCG engine
(core/device_solver.py), with the JAX package's status codes and return
contract.  Not ported yet, and raising ``NotImplementedError``:
shift-invert (``T=None``, ROADMAP queue 1, item 7), the host-orchestrated
``engine='core'`` (item 3) and ``engine='jacobi'`` (item 10).
"""

import time

import numpy as np
import torch

from ..algebra.sparse import SparseSymmetricMatrix, resolve_device
from ..core.device_solver import default_block, lobpcg
from ..core.solver import Options
from ..ops.spmm import canonical_dtype


def partial_hevp(A, B=None, T=None, buckling=False, sigma=0, which=6,
                 tol=1e-4, verb=0, opt=None, arch='cpu', engine='auto',
                 device=None):
    """Compute the ``which`` smallest eigenpairs of the sparse symmetric
    problem A x = λ x (or A x = λ B x, B positive definite) with the
    preconditioner ``T`` (a ``Chebyshev``).

    ``arch='gpu'`` runs on CUDA and raises when there is no card;
    ``device`` names the device explicitly (``'cpu'`` included).
    ``engine``: 'auto' and 'device' both select the device LOBPCG engine.

    Returns (lmd, x, status): status 0 = converged, 2 = iteration limit,
    3 = no search directions.
    """
    if opt is None:
        opt = Options()
    if buckling and sigma >= 0:
        raise ValueError('sigma must be negative in buckling mode')
    if engine not in ('auto', 'device', 'core', 'jacobi'):
        raise ValueError('unknown engine %r' % (engine,))
    if T is None:
        raise NotImplementedError('the shift-invert path (T=None) is not '
                                  'ported yet (ROADMAP queue 1, item 7)')
    if engine == 'core':
        raise NotImplementedError("engine='core' (the host-orchestrated "
                                  'Solver) is not ported yet (ROADMAP '
                                  'queue 1, item 3)')
    if engine == 'jacobi':
        raise NotImplementedError("engine='jacobi' is not ported yet "
                                  '(ROADMAP queue 1, item 10)')
    if buckling:
        raise ValueError('preconditioning for buckling problems is not'
                         ' supported')
    if isinstance(which, tuple):
        raise ValueError('which must be an integer when preconditioning'
                         ' is used')
    dev = resolve_device(arch, device)
    if dev is not None and hasattr(T, 'device_rows_operands'):
        return _device_path(A, B, T, which, tol, verb, opt, dev)
    if engine == 'device':
        raise ValueError("engine='device' needs a device (arch='gpu' or "
                         'device=) and a Chebyshev preconditioner')
    raise NotImplementedError('the host-orchestrated path (core Solver) '
                              'is not ported yet (ROADMAP queue 1, item 3)')


def _device_path(A, B, T, which, tol, verb, opt, device):
    """Preconditioned std/gen problem on the device LOBPCG engine
    (B-inner-product iteration when B is given)."""
    dev = _device_matrix(A, T, device)
    devB = (SparseSymmetricMatrix(B, device=device).device_matrix()
            if B is not None else None)
    maxit = getattr(opt, 'max_iter', -1)
    if maxit is None or maxit < 0:
        maxit = 600
    block = getattr(opt, 'block_size', -1)
    block = None if block is None or block < which else block
    # float64 only for an f64 matrix while float64 is torch's default
    # dtype — the JAX package's rule with jax_enable_x64
    dtype = torch.float64 if (np.dtype(A.dtype).itemsize >= 8 and
                              torch.get_default_dtype() == torch.float64) \
        else torch.float32
    n = dev.shape[0]
    # must match lobpcg's own default: the preconditioner is built for
    # exactly this block shape
    m = block or default_block(which, n)
    precond = T.device_rows_operands(m, n, dtype=dtype)
    start = time.time()
    lmd, x, resid, niter, status = lobpcg(
        dev, which, opB=devB, precond=precond, block_size=block, tol=tol,
        maxit=maxit, verb=max(verb, 0), dtype=dtype, device=device)
    if verb > -1:
        print('iterations: %d, solve time: %.2e'
              % (niter, time.time() - start))
    return lmd, x, status


def _device_matrix(A, T, device):
    """A's device matrix.  A preconditioner built from this very matrix on
    this device already holds it, and A then sits on the device once."""
    dev = T.device_matrix() if getattr(T, 'matrix', None) is A else None
    if (dev is None or dev.device != device
            or dev.dtype != canonical_dtype(A.dtype)):
        dev = SparseSymmetricMatrix(A, device=device).device_matrix()
    return dev
