"""Checkpoint / resume for solver results and LRA/PCA factors.

The port's copy of ``raleigh_tpu/utils/checkpoint.py`` (NumPy only): a
file written by either package loads in the other.

The reference has no file-based checkpointing but designs warm restart into
every API (reference core/solver.py:112-114 constraints, interfaces/lra.py
update/have=); this module adds the missing serialization so those warm
paths work across processes: save computed eigenpairs (or a PCA/LRA
(mean, L, R) triple) to an .npz, load them back and continue with
``Solver.solve(eigenvectors=...)`` or ``pca(..., have=...)``.
"""

import numpy as np


def save_eigenpairs(path, solver, eigenvectors):
    """Persist a solver's results: eigenvalues, their error estimates,
    residual norms, convergence status, and the eigenvector block."""
    np.savez_compressed(
        path,
        eigenvalues=solver.eigenvalues,
        eigenvalue_errors_k=solver.eigenvalue_errors.kinematic,
        eigenvalue_errors_r=solver.eigenvalue_errors.residual,
        eigenvector_errors_k=solver.eigenvector_errors.kinematic,
        eigenvector_errors_r=solver.eigenvector_errors.residual,
        residual_norms=solver.residual_norms,
        convergence_status=solver.convergence_status,
        eigenvectors=eigenvectors.data(),
        iteration=np.asarray(solver.iteration),
    )


def load_eigenpairs(path, backend=None):
    """Load a checkpoint; returns (eigenvalues, eigenvectors_Vectors,
    info dict).  The Vectors block can be passed straight back into
    Solver.solve as the constraint/warm-start container."""
    if backend is None:
        from ..algebra import dense_numpy as backend
    z = np.load(path)
    v = backend.Vectors(np.ascontiguousarray(z['eigenvectors']))
    info = {k: z[k] for k in z.files if k != 'eigenvectors'}
    return z['eigenvalues'], v, info


def save_lra(path, mean, left, right):
    """Persist a PCA/LRA triple for later pca(..., have=) warm updates
    (mirrors the reference examples' numpy.savez persistence,
    compute_eigenimages.py:116-119)."""
    np.savez_compressed(path, mean=mean, left=left, right=right)


def load_lra(path):
    z = np.load(path)
    return z['mean'], z['left'], z['right']
