"""Sharded halo-exchange SpMM on a mesh of shards.

The port of the JAX package's ``benches/bench_spmm_sharded.py``: the
row-partitioned ELL SpMM with neighbour halos
(``parallel/spmm_sharded.py::ShardedEllMatrix``) of a 3-D Laplacian on a
mesh of 8 shards against a mesh of 1, its error against SciPy, and the
bytes the halo exchange moves per product beside the bytes the shards
stream locally.

Usage: python -m raleigh_tpu_torch.benches.bench_spmm_sharded [nx] [m]
           [--shards S] [--reps R] [--device D]
       (default 48 64: n = 110,592 rows, a block of 64 vectors)

The shards all live on one device (the card, or ``--device cpu``), where
they run one after the other: the two times check the code path and say
nothing about scaling over several cards.  The figure that carries over is
the halo volume relative to the local stream.
"""

import argparse

import numpy as np
import torch

from ..examples.laplace import lap3d
from ..ops.spmm import storage_device
from ..parallel.mesh import make_mesh
from ..parallel.spmm_sharded import ShardedEllMatrix
from .timing import time_ms

SEED = 1


def run(mesh, a, xt, reps, device):
    """(product as an ndarray, ms per product, the matrix) on ``mesh``."""
    sm = ShardedEllMatrix(a, mesh)
    ms = time_ms(lambda: sm.matmat_t(xt), reps, device)
    return sm.matmat_t(xt).cpu().numpy(), ms, sm


def main(argv=None):
    """Runs the comparison, prints it, and returns it as a dict (n, nnz, m,
    shards, ms, ms_single, mode, halo, chunk, halo_gb, local_gb, err)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('nx', type=int, nargs='?', default=48)
    ap.add_argument('m', type=int, nargs='?', default=64)
    ap.add_argument('--shards', type=int, default=8)
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--device', default=None)
    args = ap.parse_args(argv)
    device = storage_device(args.device)
    a = lap3d(args.nx, args.nx, args.nx, 1.0, 1.01, 1.02)
    n, m = a.shape[0], args.m
    rng = np.random.default_rng(SEED)
    xt = torch.from_numpy(
        rng.standard_normal((n, m)).astype(np.float32)).to(device)
    where = (torch.cuda.get_device_name(device) if device.type == 'cuda'
             else 'the CPU (plain versions)')
    print('n = %d, nnz = %d, block m = %d, %d shards of %s'
          % (n, a.nnz, m, args.shards, where))
    y, ms, sm = run(make_mesh(args.shards, [device] * args.shards), a, xt,
                    args.reps, device)
    _, ms_single, _ = run(make_mesh(1, [device]), a, xt, args.reps, device)
    ref = a @ xt.cpu().numpy()
    err = float(np.abs(y - ref).max() / np.abs(ref).max())
    # per product: every shard streams its idx and val and reads and writes
    # its (chunk, m) block; the exchange moves both halos of every shard
    entries = sm.n_padded * sm.row_degree
    local_gb = (entries * (4 + 4) + 2 * n * m * 4) / 1e9
    halo_gb = sum(sm.halo) * m * 4 * args.shards / 1e9
    print('sharded(%d): %.2f ms   sharded(1): %.2f ms  [one device: a code '
          'path check, no scaling measurement]'
          % (args.shards, ms, ms_single))
    print('mode %s, halo: %d + %d of %d rows/shard -> %.4f GB exchanged vs '
          '%.3f GB local (%.1f%%)' % (sm.mode, sm.halo[0], sm.halo[1], sm.chunk,
                                 halo_gb, local_gb,
                                 100 * halo_gb / local_gb))
    print('rel err vs scipy: %.2e' % err)
    if not err < 1e-5:
        raise AssertionError('sharded SpMM differs from SciPy by %.2e' % err)
    return dict(n=n, nnz=int(a.nnz), m=m, shards=args.shards, ms=ms,
                ms_single=ms_single, mode=sm.mode, halo=sm.halo,
                chunk=sm.chunk, halo_gb=halo_gb, local_gb=local_gb, err=err)


if __name__ == '__main__':
    main()
