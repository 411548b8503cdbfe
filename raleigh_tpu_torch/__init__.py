"""raleigh_tpu_torch — the PyTorch/CUDA port of raleigh_tpu.

The first slice: the preconditioned sparse symmetric eigensolve on the
device, ``partial_hevp`` with a Chebyshev preconditioner on the LOBPCG
engine, every DIA SpMM through a CUDA kernel written for Hopper.

  interfaces/   partial_hevp (preconditioned device path)
  core/         device LOBPCG
  algebra/      SparseSymmetricMatrix, Chebyshev, Operator
  ops/          DIA SpMM: CUDA kernel wrapper, plain PyTorch version, build
  csrc/         CUDA C++ sources (built with nvcc at first use)

The package imports torch and never jax.  Jax-free host code is shared
with ``raleigh_tpu`` by import: ``core.solver.Options``,
``algebra.sparse.spectral_bounds`` and ``examples.laplace``.
"""

__version__ = "0.1.0"

_EXPORTS = {
    'Options': 'raleigh_tpu.core.solver',
    'partial_hevp': 'raleigh_tpu_torch.interfaces.partial_hevp',
    'lobpcg': 'raleigh_tpu_torch.core.device_solver',
    'Chebyshev': 'raleigh_tpu_torch.algebra.sparse',
    'spectral_bounds': 'raleigh_tpu_torch.algebra.sparse',
    'SparseSymmetricMatrix': 'raleigh_tpu_torch.algebra.sparse',
}


__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        mod = importlib.import_module(_EXPORTS[name])
        return getattr(mod, name)
    raise AttributeError(name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
