from . import verbosity  # noqa: F401
