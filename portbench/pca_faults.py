"""Faults planted under the dense PCA task's timed path (``tasks/pca.py``),
as ``faults.py`` plants them under the eigensolver's: each is a context
manager that breaks the program's subspace engine while it is open.  A
step left out (the power iterations skipped), half of the answer left
out (the second half of the components zeroed), an answer altered where
it is produced (the first component's entries moved one place along)."""

import numpy as np

from .faults import _patched


def iteration_skipped():
    """The subspace iteration runs no power iteration: one product of the
    Gram with the random start, then Rayleigh-Ritz."""
    from raleigh_tpu_torch.interfaces import randomized
    inner = randomized._gram_subspace
    return _patched(randomized,
                    _gram_subspace=lambda G, q, iters: inner(G, q, 0))


def half_zeroed():
    """The right factors come back with their second half of components
    (rows of comps) zeroed."""
    from raleigh_tpu_torch.interfaces import randomized
    inner = randomized._right_factors

    def half(a, mean, u, sigma):
        trans, comps = inner(a, mean, u, sigma)
        comps = comps.clone()
        comps[comps.shape[0] // 2:] = 0
        return trans, comps
    return _patched(randomized, _right_factors=half)


def comps_perturbed():
    """The fetched comps have their first component's entries moved one
    place along."""
    from raleigh_tpu_torch.interfaces import randomized
    inner = randomized._host

    def moved(*ts):
        out = inner(*ts)
        if len(out) == 3:
            comps = out[2].copy()
            comps[0] = np.roll(comps[0], 1)
            out = out[:2] + (comps,)
        return out
    return _patched(randomized, _host=moved)


FAULTS = {'iteration_skipped': iteration_skipped, 'half_zeroed': half_zeroed,
          'comps_perturbed': comps_perturbed}
