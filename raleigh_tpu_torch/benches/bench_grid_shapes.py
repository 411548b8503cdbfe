"""Launch-shape and pipeline A/B of the streaming copy ``y = 0.99999 x``.

The port of the JAX package's ``benches/bench_grid_shapes.py``: the same
copy of an (m, n) f32 array, 32 x 1,277,952 unless told otherwise, through
each structure the port has a kernel for, timed with CUDA events.

  blockspec    one thread block per tile of a row, no grid stride
               (``stream_scale_tiled``), per tile size in ``TILED_TILES``
  blockspec4   the same with four tiles per block; n is trimmed to a
               multiple of 4 * tile, as the reference trims it
  manual2      one persistent grid, each block pipelining chunks through 2
               shared-memory stages filled and drained by bulk copies
               (``stream_scale_pipelined``), per chunk size in
               ``PIPELINED_TILES``
  manual4      the same through 4 stages
  spans        the stream kernel ``stream_scale``, one contiguous span per
               thread block, the rate the SpMM kernels are judged against
  torch        ``torch.mul``, the library's copy
  hbm2hbm      the copy with no on-chip bounce and no arithmetic, y = x in
               column tiles (``hbm2hbm``), per tile size in ``COPY_TILES``

Usage: python -m raleigh_tpu_torch.benches.bench_grid_shapes [variant ...]
           [--tiles T ...] [--m M] [--n N] [--reps R] [--device D]

Each line gives microseconds per copy and GB/s read + write.  The sweep
runs on the card and raises without one; ``--device cpu`` runs the same
code through the plain versions, and its times say nothing about a card.
"""

import argparse

import torch

from ..ops import stream as st
from ..ops.spmm import storage_device
from .timing import time_ms

M, TILE, NSTEPS = 32, 32768, 39
# elements per tile: a block of 256 threads moves 1, 4 or 16 float4 per
# thread and tile
TILED_TILES = (1024, 4096, 16384)
# elements per pipeline stage: 8 and 32 KB
PIPELINED_TILES = (2048, 8192)
# lanes per column tile of the plain copy: the reference's tile
COPY_TILES = (TILE,)
VARIANTS = ('blockspec', 'blockspec4', 'manual2', 'manual4', 'spans',
            'torch', 'hbm2hbm')
SEED = 0


def _copies(name, tiles):
    """[(tile or None, per-block elements n must divide by, function)] of a
    variant."""
    a = st.REFERENCE_SCALE
    if name in ('blockspec', 'blockspec4'):
        per_step = 4 if name == 'blockspec4' else 1
        return [(t, t * per_step,
                 lambda x, t=t: st.stream_scale_tiled(x, a, t, per_step))
                for t in tiles or TILED_TILES]
    if name in ('manual2', 'manual4'):
        depth = int(name[-1])
        return [(t, t,
                 lambda x, t=t: st.stream_scale_pipelined(x, a, t, depth))
                for t in tiles or PIPELINED_TILES]
    if name == 'spans':
        return [(None, 1, lambda x: st.stream_scale(x, a))]
    if name == 'torch':
        return [(None, 1, lambda x: torch.mul(x, a))]
    if name == 'hbm2hbm':
        return [(t, t, lambda x, t=t: st.hbm2hbm(x, t))
                for t in tiles or COPY_TILES]
    raise ValueError('unknown variant %r (one of %s)' % (name, VARIANTS))


def main(argv=None):
    """Runs the sweep, prints one line per variant and tile, and returns
    the lines as dicts (variant, tile, n, ms, gbs)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('variants', nargs='*', metavar='variant')
    ap.add_argument('--tiles', type=int, nargs='+', default=None)
    ap.add_argument('--m', type=int, default=M)
    ap.add_argument('--n', type=int, default=TILE * NSTEPS)
    ap.add_argument('--reps', type=int, default=50)
    ap.add_argument('--device', default=None)
    args = ap.parse_args(argv)
    device = storage_device(args.device)
    names = args.variants or VARIANTS
    gen = torch.Generator(device).manual_seed(SEED)
    x = torch.randn((args.m, args.n), generator=gen, device=device)
    print('copy of (%d, %d) f32 on %s' % (
        args.m, args.n, torch.cuda.get_device_name(device)
        if device.type == 'cuda' else 'the CPU (plain versions)'))
    out = []
    for name in names:
        for tile, chunk, fn in _copies(name, args.tiles):
            # n must divide by what one block takes: trim, as the reference
            # trims for blockspec4
            n = args.n - args.n % chunk
            if n == 0:
                raise ValueError('%s: n = %d is less than one block\'s %d '
                                 'elements' % (name, args.n, chunk))
            xs = x if n == args.n else x[:, :n].contiguous()
            ms = time_ms(lambda: fn(xs), args.reps, device)
            gbs = 2 * args.m * n * 4 / ms / 1e6
            label = name if tile is None else '%s tile %d' % (name, tile)
            print('%-24s n %8d  %8.1f us  %7.1f GB/s'
                  % (label, n, ms * 1e3, gbs), flush=True)
            out.append(dict(variant=name, tile=tile, n=n, ms=ms, gbs=gbs))
    return out


if __name__ == '__main__':
    main()
