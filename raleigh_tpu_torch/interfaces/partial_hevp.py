"""Partial eigenvalue solver for sparse symmetric/Hermitian problems.

PyTorch port of ``raleigh_tpu/interfaces/partial_hevp.py`` (capability
parity with reference raleigh/interfaces/partial_hevp.py:21-257):

  * shift-and-invert via the native LDL^T factorization, with the
    factorization-accuracy probe, the inertia-driven split of ``which``
    around the shift and the product problem when ``B`` is given;
  * buckling mode with its load-factor back-transform;
  * the preconditioned path: the device LOBPCG engine for a Chebyshev
    preconditioner (``engine='auto'``/``'device'``), the chunked
    per-vector Jacobi engine (``engine='jacobi'``, core/device_jacobi.py),
    or the core block Jacobi-CG ``Solver`` (``engine='core'``) with any
    preconditioner;
  * the same status codes and return contract.

The core Solver iterates on ``dense_torch`` blocks on the card, or on
``dense_numpy`` blocks for ``arch='cpu'`` and when the link probe
(utils/link.py) or ``opt.orchestration`` asks for host orchestration.
"""

import time
import weakref

import numpy as np
import torch

from ..algebra import dense_torch
from ..algebra.sparse import (Operator, SparseSymmetricMatrix,
                              SparseSymmetricSolver, resolve_device)
from ..core.device_jacobi import DeviceJacobi
from ..core.device_solver import default_block, lobpcg
from ..core.solver import (DefaultConvergenceCriteria, Options, Problem,
                           Solver)
from ..ops.spmm import canonical_dtype, rows_matmat_operands
from ..utils.profiling import span, spanned

# the operators partial_hevp built, by (id of the matrix, device, value
# dtype): each entry holds a weak reference to its matrix and goes with it
_OPERATORS = {}


@spanned('raleigh.partial_hevp')
def partial_hevp(A, B=None, T=None, buckling=False, sigma=0, which=6,
                 tol=1e-4, verb=0, opt=None, arch=None, engine='auto',
                 device=None):
    """Compute eigenpairs of a sparse symmetric problem near a shift
    (factorization path, ``T=None``) or at the lower end of the spectrum
    (preconditioned path).  See reference partial_hevp.py:21-95 for the
    parameter/status contract.

    Everything runs on the card, and raises when there is none, unless
    ``device`` names another device (``'cpu'`` included) or
    ``arch='cpu'`` asks for the host: host CSR operators and the
    ``dense_numpy`` algebra.

    ``engine`` selects the iteration engine of the preconditioned path:
    'core' is the host-orchestrated block Jacobi-CG ``Solver``; 'device'
    the device-resident LOBPCG (std/gen problems with a Chebyshev
    preconditioner, block convergence control); 'jacobi' the chunked
    device engine with per-vector convergence control (std/gen problems
    with a Chebyshev preconditioner); 'auto' picks 'device' whenever it
    applies on a device.

    Returns (lmd, x, status): status 0 = converged, -1 = factorization
    too inaccurate (``(None, None, -1)``), other values as the Solver's.

    Under a profiler the call is a ``raleigh.partial_hevp`` span, and the
    core Solver's solve inside it a ``raleigh.core_solver`` span
    (``utils/profiling.py``).
    """
    if opt is None:
        opt = Options()
    if buckling and sigma >= 0:
        raise ValueError('sigma must be negative in buckling mode')
    if engine not in ('auto', 'device', 'core', 'jacobi'):
        raise ValueError('unknown engine %r' % (engine,))
    if buckling and B is None:
        raise RuntimeError('stress stiffness matrix missing in buckling '
                           'mode')
    dev = resolve_device(arch, device)

    if T is not None:
        if buckling:
            raise ValueError('preconditioning for buckling problems is not'
                             ' supported')
        if isinstance(which, tuple):
            raise ValueError('which must be an integer when preconditioning'
                             ' is used')
        if (engine != 'core' and dev is not None
                and hasattr(T, 'device_rows_operands')):
            if engine == 'jacobi':
                return _device_jacobi_path(A, B, T, which, tol, verb, opt,
                                           dev)
            return _device_path(A, B, T, which, tol, verb, opt, dev)
        if engine in ('device', 'jacobi'):
            raise ValueError("engine='%s' needs a device (not arch='cpu') "
                             'and a Chebyshev preconditioner' % engine)

    if dev is not None and T is None:
        # factorization path on a device: the LDL^T solve runs on the
        # host, so device-orchestrated block algebra ships the solve block
        # across the link every iteration.  Decide from a measured link
        # probe (utils/link.py); ``opt.orchestration`` ('host'/'device')
        # overrides.
        from ..utils.link import choose_orchestration
        choice = getattr(opt, 'orchestration', 'auto')
        if choice == 'auto':
            blk = getattr(opt, 'block_size', -1)
            blk = blk if blk and blk > 0 else 32
            n_hint = A.size() if isinstance(A, SparseSymmetricSolver) \
                else A.shape[0]
            choice = choose_orchestration(n_hint, blk, device=dev)
        if choice == 'host':
            if verb > 0:
                print('link probe: host-side orchestration')
            dev = None
    if dev is not None:
        from ..algebra import dense_torch as backend
    else:
        from ..algebra import dense_numpy as backend

    def vectors(n, k, dtype):
        if dev is None:
            return backend.Vectors(n, k, data_type=dtype)
        return backend.Vectors(n, k, data_type=dtype, device=dev)

    if T is None:
        # ---------------- shift-and-invert via factorization ------------
        if isinstance(A, SparseSymmetricSolver):
            n = A.size()
            dtype = A.data_type()
            sigma = A.sigma()
            solver = A
        else:
            m, n = A.shape
            if m != n:
                raise ValueError('the matrix must be square')
            dtype = A.data.dtype.type
            solver = SparseSymmetricSolver(dtype=dtype)
            if verb > -1:
                print('setting up the linear system solver...')
            start = time.time()
            solver.analyse(A, sigma, B)
            solver.factorize()

            # factorization-accuracy probe: solve on random data and abort
            # when the relative error exceeds 1% (reference
            # partial_hevp.py:128-167)
            opA_probe = _operator(A, None, dtype)
            b = vectors(n, 3, dtype)
            x = vectors(n, 3, dtype)
            y = vectors(n, 3, dtype)
            x.fill_random()
            opA_probe.apply(x, b)
            if B is not None:
                _operator(B, None, dtype).apply(x, y)
                z = y
            else:
                z = x
            s = x.dots(x).real
            if sigma != 0:
                b.add(z, -sigma)
            solver.solve(b, y)
            y.add(x, -1)
            t = y.dots(y).real
            err = np.amax(np.sqrt(np.abs(t / s)))
            if err > 0.01:
                if verb > -1:
                    print('factorization too inaccurate: relative error '
                          '%.1e, consider moving shift slightly' % err)
                return None, None, -1
            elif verb > -1:
                print('estimated factorization error: %.1e' % err)
                print('setup time: %.2e' % (time.time() - start))

        opB = _operator(A if buckling else B, dev, dtype) \
            if B is not None else None
        opAinv = solver
        neg, pos = solver.inertia()
        if verb > -1:
            print('positive eigenvalues: %d' % pos)
            print('negative eigenvalues: %d' % neg)
        if isinstance(which, tuple):
            if len(which) != 2:
                raise ValueError('which must be an integer or a pair')
            which = (min(which[0], neg), min(which[1], pos))
        else:
            if buckling:
                which = (neg, 0) if which < neg else (neg, which - neg)
            elif neg < 1:
                which = (0, which)
            elif pos < 1:
                which = (which, 0)
            # else: leave ``which`` an integer — in shift-invert the
            # transformed spectrum 1/(lmd - sigma) makes "largest
            # magnitude" mean "nearest to sigma on either side"
        eigenvectors = vectors(n, 0, dtype)
        if B is None:
            evp = Problem(eigenvectors, opAinv)
        else:
            evp = Problem(eigenvectors, opAinv, opB, 'pro')
        evp_solver = Solver(evp)
        sigma_opt = sigma
    else:
        # ---------------- preconditioned path: the core Solver ----------
        dtype = np.dtype(A.dtype).type
        opA = _operator(A, dev, dtype)
        n = opA.size()
        opB = _operator(B, dev, dtype) if B is not None else None
        eigenvectors = vectors(n, 0, dtype)
        opT = T if hasattr(T, 'apply') and not _ndarray_level(T) \
            else Operator(T)
        if B is None:
            evp = Problem(eigenvectors, opA)
        else:
            # A x = lmd B x: Problem reads any fourth argument as the
            # product problem (the JAX package passes 'gen' there)
            evp = Problem(eigenvectors, opA, opB)
        evp_solver = Solver(evp)
        evp_solver.set_preconditioner(opT)
        sigma_opt = None
        which = (which, 0)

    opt.convergence_criteria = DefaultConvergenceCriteria()
    opt.convergence_criteria.set_error_tolerance('k eigenvector error', tol)
    opt.sigma = sigma_opt

    start = time.time()
    with span('raleigh.core_solver'):
        status = evp_solver.solve(eigenvectors, opt, which=which)
    if status < 0:
        return None, None, status
    solve_time = time.time() - start
    if T is None:
        if buckling:
            lmd = sigma / (1 - 1 / evp_solver.eigenvalues)
        else:
            lmd = sigma + 1.0 / evp_solver.eigenvalues
    else:
        lmd = evp_solver.eigenvalues
    ind = np.argsort(-lmd) if buckling else np.argsort(lmd)
    lmd = lmd[ind]
    ne = eigenvectors.nvec()
    if verb > -1:
        print('iterations: %d, solve time: %.2e'
              % (evp_solver.iteration, solve_time))
    x = eigenvectors.data().T
    if ne > 0:
        x = x[:, ind]
    return lmd, x, status


def _operator(matrix, device, dtype):
    """The ``SparseSymmetricMatrix`` of ``matrix`` for the core Solver:
    its host CSR, and on ``device`` (None: host only) its device matrix
    with values in the problem's ``dtype`` (f64 stays f64: the Solver's
    blocks keep the caller's type)."""
    return _cached(matrix, (str(device), np.dtype(dtype).str), lambda:
                   SparseSymmetricMatrix(
                       matrix, arch='cpu' if device is None else None,
                       device=device, exact=True))


def _cached(matrix, tag, build):
    """``build()``, made at the first call with this matrix object and
    ``tag`` and kept while the object lives: a second call with the same
    A or B builds nothing."""
    key = (id(matrix),) + tag
    hit = _OPERATORS.get(key)
    if hit is not None and hit[0]() is matrix:
        return hit[1]
    made = build()
    try:
        ref = weakref.ref(matrix, lambda _r, k=key: _OPERATORS.pop(k, None))
    except TypeError:       # a matrix type with no weak references
        return made
    _OPERATORS[key] = (ref, made)
    return made


def _device_path(A, B, T, which, tol, verb, opt, device):
    """Preconditioned std/gen problem on the device LOBPCG engine
    (B-inner-product iteration when B is given)."""
    dev = _device_matrix(A, T, device)
    devB = (_shared_device_matrix(B, device) if B is not None else None)
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


def _device_jacobi_path(A, B, T, which, tol, verb, opt, device):
    """Preconditioned std/gen problem on the chunked per-vector engine
    (core/device_jacobi.py): Solver-compatible convergence criteria and
    per-vector locking, on the device.  The smallest eigenpairs of (A, B)
    are the LARGEST of (-A, B), so the engine runs on the negated operator
    (the preconditioner commutes with the sign) and the eigenvalues are
    negated back.  The iteration keeps the problem's dtype, and so do A's
    and B's device values (f64 stays f64); the Chebyshev recurrence runs
    in it on its own device matrix."""
    dtype = np.dtype(A.dtype).type
    fnA, opsA = rows_matmat_operands(
        _operator(A, device, dtype).device_matrix())
    n = A.shape[0]

    def neg_matmat(ops, x):
        return -fnA(ops, x)

    fnB = opsB = None
    if B is not None:
        fnB, opsB = rows_matmat_operands(
            _operator(B, device, dtype).device_matrix())
    # fix the block size now so the preconditioner is built for the exact
    # block shape the engine will iterate; the caller's Options is
    # restored afterwards
    block_user = getattr(opt, 'block_size', -1)
    block = block_user
    if block is None or block < 1:
        block = 128 if which > 100 else max(16, which + which // 4)
    block = min(block, max(8, n // 4))
    opt.block_size = block
    precond = T.device_rows_operands(block, n, dtype=dtype)
    engine = DeviceJacobi(neg_matmat, n, dtype=dtype, precond=precond,
                          operands=opsA, matmat_b=fnB, operands_b=opsB)
    cc_user = opt.convergence_criteria
    max_iter_user = opt.max_iter
    opt.convergence_criteria = cc_user or DefaultConvergenceCriteria()
    opt.convergence_criteria.set_error_tolerance('k eigenvector error',
                                                 tol)
    if opt.max_iter is None or opt.max_iter < 0:
        opt.max_iter = 600
    v = dense_torch.Vectors(n, data_type=dtype, device=device)
    start = time.time()
    try:
        status = engine.solve(v, options=opt, nwanted=which,
                              verb=max(verb, 0))
    finally:
        # full restore: a caller reusing the same Options across calls
        # must not inherit the tolerance/criteria/max_iter set here
        opt.block_size = block_user
        opt.convergence_criteria = cc_user
        opt.max_iter = max_iter_user
    if verb > -1:
        print('iterations: %d, solve time: %.2e'
              % (engine.iteration, time.time() - start))
    lmd = -engine.eigenvalues
    ind = np.argsort(lmd)
    x = v.data().T
    if x.shape[1] > 0:
        x = x[:, ind]
    return lmd[ind], x, status


def _shared_device_matrix(matrix, device):
    """The device matrix of ``matrix`` in its canonical dtype, built once
    per matrix object (``_cached``)."""
    return _cached(matrix, (str(device), str(canonical_dtype(matrix.dtype))),
                   lambda: SparseSymmetricMatrix(
                       matrix, device=device).device_matrix())


def _device_matrix(A, T, device):
    """A's device matrix.  A preconditioner built from this very matrix on
    this device already holds it, and A then sits on the device once."""
    dev = T.device_matrix() if getattr(T, 'matrix', None) is A else None
    if (dev is None or dev.device != device
            or dev.dtype != canonical_dtype(A.dtype)):
        dev = _shared_device_matrix(A, device)
    return dev


def _ndarray_level(T):
    """True when T.apply expects plain ndarrays (needs the Operator
    adapter) rather than Vectors: any object not of this package (the
    JAX package's objects included)."""
    return not type(T).__module__.startswith('raleigh_tpu_torch.')
