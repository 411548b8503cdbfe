"""raleigh_tpu_torch — the PyTorch/CUDA port of raleigh_tpu.

The preconditioned sparse symmetric eigensolve on the device:
``partial_hevp`` with a Chebyshev preconditioner on the LOBPCG engine, for
stencil matrices (DIA) and finite-element matrices (ELL, BSR), every DIA
and BSR SpMM through a CUDA kernel written for Hopper.

  interfaces/   partial_hevp (preconditioned device path)
  core/         device LOBPCG; solver Options
  algebra/      SparseSymmetricMatrix, spectral_bounds, Chebyshev, Operator
  ops/          DIA, ELL and BSR SpMM, the layout rule, the stream-rate
                probe: CUDA kernel wrappers, plain PyTorch versions, build
  csrc/         CUDA C++ sources (built with nvcc at first use)
  examples/     test matrices: Laplacians, finite-element pencils

The package imports torch and never jax, and nothing of ``raleigh_tpu``:
host code both packages need lives here as a copy of its own.
"""

__version__ = "0.1.0"

_EXPORTS = {
    'Options': 'raleigh_tpu_torch.core.solver',
    'partial_hevp': 'raleigh_tpu_torch.interfaces.partial_hevp',
    'lobpcg': 'raleigh_tpu_torch.core.device_solver',
    'Chebyshev': 'raleigh_tpu_torch.algebra.sparse',
    'spectral_bounds': 'raleigh_tpu_torch.algebra.sparse',
    'SparseSymmetricMatrix': 'raleigh_tpu_torch.algebra.sparse',
    'DiaMatrix': 'raleigh_tpu_torch.ops.spmm',
    'EllMatrix': 'raleigh_tpu_torch.ops.spmm',
    'BsrMatrix': 'raleigh_tpu_torch.ops.spmm',
    'device_sparse': 'raleigh_tpu_torch.ops.spmm',
    'fe_model': 'raleigh_tpu_torch.examples.fe_model',
}


__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        mod = importlib.import_module(_EXPORTS[name])
        # a module export ('fe_model') is the module itself
        return getattr(mod, name, mod)
    raise AttributeError(name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
