"""raleigh_tpu_torch — the PyTorch/CUDA port of raleigh_tpu.

The sparse symmetric eigensolve: ``partial_hevp`` in shift-invert,
generalized, buckling and preconditioned modes, on the core block
Jacobi-CG ``Solver`` over the block-vector algebra on the card
(``dense_torch``) or on the host (``dense_numpy``), on the device LOBPCG
engine or on the chunked per-vector Jacobi engine with a Chebyshev
preconditioner; stencil matrices (DIA) and finite-element matrices (ELL,
BSR), every DIA, ELL and BSR SpMM through a CUDA kernel written for Hopper
(f32, bf16 and f64 operands); the LOBPCG iteration with operator and
blocks split over a mesh of shards; and the dense SVD/PCA stack:
``truncated_svd``, ``PartialSVD``, ``LowerRankApproximation`` and ``pca``
on the Jacobi engines, and the randomized subspace engines (``subspace_pca``,
``subspace_pca_tol``, ``randomized_svd``) — GEMMs, QR, ``eigh`` and SVD,
no kernel of their own.

  interfaces/   partial_hevp (every mode); truncated_svd, partial_svd,
                lra, pca; randomized (the subspace engines)
  core/         the block Jacobi-CG Solver and its small dense numerics;
                device LOBPCG; DeviceJacobi, the chunked per-vector engine
  algebra/      the block-vector contract (dense_torch, dense_numpy, the
                dense.py selector and AMatrix); SparseSymmetricMatrix,
                SparseSymmetricSolver, IncompleteLU, spectral_bounds,
                Chebyshev, Operator
  native/       the host LDL^T, orderings and ILUT in C++ (built with g++
                at first use)
  utils/        the link probe and orchestration choice, knobs,
                checkpoints of eigenpairs and PCA factors
  ops/          DIA, ELL and BSR SpMM, the layout rule, the stream-rate
                probe, the strided copy: CUDA kernel wrappers, plain PyTorch
                versions, build
  parallel/     the mesh (a list of devices, one per shard, walked by one
                process), shardings, sharded row blocks, ShardedEllMatrix
  benches/      the kernel-structure A/B sweeps (three structures of the
                DIA SpMM, four of the streaming copy) and the one timer
  csrc/         CUDA C++ sources (built with nvcc at first use)
  examples/     test matrices (Laplacians, finite-element pencils, the
                synthetic SVD/PCA generator) and the sparse_evp,
                buckling_evp, core_solver, pca_demo and
                truncated_svd_demo CLIs

The package imports torch and never jax, and nothing of ``raleigh_tpu``:
host code both packages need lives here as a copy of its own.
"""

__version__ = "0.1.0"

_EXPORTS = {
    'Options': 'raleigh_tpu_torch.core.solver',
    'Solver': 'raleigh_tpu_torch.core.solver',
    'Problem': 'raleigh_tpu_torch.core.solver',
    'AMatrix': 'raleigh_tpu_torch.algebra.dense',
    'SparseSymmetricSolver': 'raleigh_tpu_torch.algebra.sparse',
    'IncompleteLU': 'raleigh_tpu_torch.algebra.sparse',
    'Operator': 'raleigh_tpu_torch.algebra.sparse',
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
    'make_mesh': 'raleigh_tpu_torch.parallel.mesh',
    'blockvec_sharding': 'raleigh_tpu_torch.parallel.mesh',
    'shard_operator': 'raleigh_tpu_torch.core.device_solver',
    'ShardedEllMatrix': 'raleigh_tpu_torch.parallel.spmm_sharded',
    'pca': 'raleigh_tpu_torch.interfaces.pca',
    'pca_error': 'raleigh_tpu_torch.interfaces.pca',
    'truncated_svd': 'raleigh_tpu_torch.interfaces.truncated_svd',
    'PartialSVD': 'raleigh_tpu_torch.interfaces.partial_svd',
    'LowerRankApproximation': 'raleigh_tpu_torch.interfaces.lra',
    'subspace_pca': 'raleigh_tpu_torch.interfaces.randomized',
    'subspace_pca_tol': 'raleigh_tpu_torch.interfaces.randomized',
    'randomized_svd': 'raleigh_tpu_torch.interfaces.randomized',
    'DeviceJacobi': 'raleigh_tpu_torch.core.device_jacobi',
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
