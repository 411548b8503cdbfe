"""What decides ``correct``, for every task: each of the task's checks
(``tasks/<name>.py``'s ``NUMBERS``) held to the limit of that name in
the workload file, and no solve failed outright; and what no run may
hold once its window has closed, the modules of JAX and the JAX
package."""

import sys

# top-level module names that no run may hold once its window has closed:
# JAX and the JAX package, and the JAX-era benchmark at the repository's
# root (``bench.py``, ``benches/``); compared whole, since the program's
# own name, raleigh_tpu_torch, begins with raleigh_tpu
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'raleigh_tpu', 'bench', 'benches')


def forbidden_modules(names=None):
    """The forbidden top-level names among ``names`` (default: the
    modules this process has loaded), sorted."""
    tops = {name.split('.')[0] for name in (sys.modules if names is None
                                            else names)}
    return sorted(tops & set(FORBIDDEN))


def verdict(numbers, failed, limits, names):
    """``correct``, and one line a check: its reading beside its limit,
    for each of the task's ``names`` and then the solves that failed
    outright.  A check with no reading or no limit fails."""
    lines = []
    correct = failed == 0
    for name in names:
        value, limit = numbers.get(name), limits.get(name)
        ok = value is not None and limit is not None and value <= limit
        correct = correct and ok
        lines.append('check %s %s limit %s %s' % (
            name, 'none' if value is None else repr(value),
            'none' if limit is None else repr(limit),
            'ok' if ok else 'FAIL'))
    lines.append('check failed_solves %d limit 0 %s'
                 % (failed, 'ok' if failed == 0 else 'FAIL'))
    return correct, lines
