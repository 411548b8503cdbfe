"""Solver options and the default convergence criteria.

The port's own copy of the jax-free head of ``raleigh_tpu/core/solver.py``
(``Options``, ``DefaultConvergenceCriteria``), field for field.  The block
Jacobi-CG ``Solver`` itself is not ported yet (ROADMAP queue 1, item 3).
"""


class DefaultConvergenceCriteria:
    """Default per-eigenpair convergence test (reference
    core/solver.py:125-138)."""

    def __init__(self):
        self.tolerance = 1e-3
        self.error = 'kinematic eigenvector error'

    def set_error_tolerance(self, error, tolerance):
        self.error = error
        self.tolerance = tolerance

    def satisfied(self, solver, i):
        err = solver.convergence_data(self.error, i)
        return 0 <= err <= self.tolerance


class Options:
    """Solver options (field-for-field parity with reference
    core/solver.py:141-197; negative values mean "let the solver decide").

    ``threads`` survives as the block-granularity hint: default block sizes
    are rounded to a multiple of it.
    """

    def __init__(self):
        self.verbosity = 0
        self.max_iter = -1
        self.min_iter = 0
        self.block_size = -1
        self.threads = -1
        self.sigma = None
        self.convergence_criteria = None
        self.stopping_criteria = None
        self.detect_stagnation = True
        self.max_quota = 0.75
        # 'auto' lets device-backed interfaces route the iteration to the
        # chunked device engine; 'host' forces the host-orchestrated loop
        self.device_engine = 'auto'
