"""User-settable environment knobs.

Parity with reference raleigh/algebra/env.py:3 (`mkl_path`); here the knobs
name the native LDL^T shared library and the complex factorization route.
"""

# If not None, path of the prebuilt native sparse-solver shared library.
native_lib_path = None

# Route complex Hermitian factorizations through the real-symmetric
# embedding (2x size) instead of the native LDL^H engine (debug fallback).
complex_via_embedding = False
