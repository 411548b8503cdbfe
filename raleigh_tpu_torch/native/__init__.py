from .ldlt import SparseLDLT, native_available  # noqa: F401
