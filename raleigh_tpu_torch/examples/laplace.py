"""Finite-difference Laplacians in 1/2/3 dimensions and the exact 3D
eigenvalues: pure NumPy/SciPy, shared with the JAX package by import."""

from raleigh_tpu.examples.laplace import (  # noqa: F401
    lap1d, lap2d, lap3d, lap3d_eigenvalues)
