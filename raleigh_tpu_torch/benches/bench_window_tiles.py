"""Tile-size sweep of the three structures of the DIA SpMM.

The port of the JAX package's ``benches/bench_window_tiles.py``, at its
shape: ``lap3d(100, 100, 128) * 0.125`` (n = 1,280,000, 7 diagonals out to
+-10,000) applied to m = 32 f32 operand rows, timed with CUDA events.

  ring    the production kernel ``dia_matmat_rows``, which leaves the
          shifted re-reads of x to L1 and L2 and has no tile parameter
  slide   ``dia_matmat_rows_slide``: one sliding shared-memory window per row
  tiles   ``dia_matmat_rows_tiles``: a ring of four whole tiles per row

Usage: python -m raleigh_tpu_torch.benches.bench_window_tiles
           [ring|slide|tiles] [tile ...] [--m M] [--grid NX NY NZ]
           [--reps R] [--device D]

Each line gives microseconds per apply and effective GB/s, with
bytes = val + operand in + result out per apply, and the last line the
library's product, ``torch.sparse.mm`` on the CSR tensor.  A tile the
kernel cannot take raises; it is never swapped for another kernel.  The
sweep runs on the card and raises without one; ``--device cpu`` runs the
same code through the plain version, and its times say nothing about a
card.
"""

import argparse

import numpy as np
import torch

from ..examples.laplace import lap3d
from ..ops.spmm import DiaMatrix, storage_device
from ..ops.spmm_window import VARIANTS
from .timing import time_ms

M = 32
GRID = (100, 100, 128)
SCALE = 0.125
# lanes per step.  At the default matrix the reach is 20,000 lanes, 80 KB of
# a block's 227 KB per row, and the kernels keep two stages of val beside
# the windows (chunks of up to 2,048 lanes, narrower where less room is
# left): the sliding window takes two rows per block up to 3,616 lanes and
# one up to 18,996; the tile ring needs 10,000 <= tile <= 14,496.
DEFAULT_TILES = {'ring': (None,), 'slide': (2048, 4096, 8192, 16384),
                 'tiles': (10240, 12288, 14336)}
SEED = 1
REPS = 50


def main(argv=None):
    """Runs the sweep, prints one line per tile and the library's line, and
    returns the lines as dicts (variant, tile, ms, gbs)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('variant', nargs='?', default='ring',
                    choices=sorted(VARIANTS))
    ap.add_argument('tiles', type=int, nargs='*', metavar='tile')
    ap.add_argument('--m', type=int, default=M)
    ap.add_argument('--grid', type=int, nargs=3, default=GRID)
    ap.add_argument('--reps', type=int, default=REPS)
    ap.add_argument('--device', default=None)
    args = ap.parse_args(argv)
    device = storage_device(args.device)
    a = (lap3d(*args.grid, 1.0, 1.0, 1.0) * SCALE).tocsr()
    d = DiaMatrix(a, dtype=np.float32, device=device)
    n, m = d.shape[0], args.m
    gen = torch.Generator(device).manual_seed(SEED)
    x = torch.randn((m, n), generator=gen, device=device)
    bytes_per = (len(d.offsets) * n + 2 * n * m) * 4
    print('lap3d%s * %g, n = %d, %d diagonals, m = %d f32 on %s' % (
        tuple(args.grid), SCALE, n, len(d.offsets), m,
        torch.cuda.get_device_name(device) if device.type == 'cuda'
        else 'the CPU (plain version)'))
    fn = VARIANTS[args.variant]
    # the production kernel reads its offsets on the device, the staged
    # ones take them from the host
    offsets = d.offsets_t if args.variant == 'ring' else d.offsets
    out = []
    for tile in args.tiles or DEFAULT_TILES[args.variant]:
        # called directly: a tile the kernel cannot take raises here
        ms = time_ms(lambda: fn(d.val, x, offsets, tile), args.reps,
                     device)
        gbs = bytes_per / ms / 1e6
        label = 'no tile' if tile is None else 'tile %7d' % tile
        print('%-5s %-12s: %8.1f us/apply  %7.1f GB/s effective'
              % (args.variant, label, ms * 1e3, gbs), flush=True)
        out.append(dict(variant=args.variant, tile=tile, ms=ms, gbs=gbs))
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int64)),
        torch.from_numpy(a.indices.astype(np.int64)),
        torch.from_numpy(a.data.astype(np.float32)), size=a.shape,
        device=device)
    xt = x.T.contiguous()
    ms = time_ms(lambda: torch.sparse.mm(csr, xt), max(1, args.reps // 5),
                 device)
    print('torch.sparse.mm (CSR): %8.1f us/apply  %7.1f GB/s effective'
          % (ms * 1e3, bytes_per / ms / 1e6))
    out.append(dict(variant='torch.sparse.mm', tile=None, ms=ms,
                    gbs=bytes_per / ms / 1e6))
    return out


if __name__ == '__main__':
    main()
