"""truncated_svd on the device Jacobi engine: values, iterations, restarts,
wall.

The case is chip_smoke.py's dense 4: ``generate(m, n, rank)`` made after
``np.random.seed(1)`` (3000 x 2000 of rank 1000 by default; with
``--perm p`` its rows permuted by ``np.random.RandomState(p)``) and
``truncated_svd(A, nsv=300)`` at the default iteration limit, in f64 and
f32 on the device Jacobi engine and in f32 on the core Solver with the
blocks on the device.  Each run prints the number of values it returned
and the largest relative difference of the first ``nsv`` from the host
SVD, its wall (after one warm-up solve of a small case), and for the
device engine its iterations and restarts: the chunks whose exit check
found the block's Gram more than sqrt(eps) from the identity or a value
not finite.  The restarts are counted from the chunks' fetched statistics,
so the count reads any version of the engine that fetches them.

With ``--parts`` it times instead, in f32 and f64, the small dense
operations an iteration of the engine makes at its block m = 128: ``eigh``
of the 3m x 3m Rayleigh-Ritz matrix and of an m x m Gram, the Cholesky
factor and a triangular solve at 3m, and the Householder QR and the SVD of
a 2m x m matrix (milliseconds a call on the host clock, the device synced
after each batch of calls, so any wait inside a call is in its time).

With ``--trace`` each device-engine run also prints its chunks (see
``_Recorder``); the wall then includes the tracing.

Usage: python -m raleigh_tpu_torch.benches.bench_jacobi [--m M] [--n N]
       [--rank R] [--nsv K] [--perm P] [--trace] [--parts] [--device cpu]

It runs on the card unless ``--device`` names another device.
"""

import argparse
import math
import time

import numpy as np
import torch

from .. import Options, truncated_svd
from ..core import device_jacobi
from ..examples.generate_matrix import generate
from ..ops.spmm import storage_device

RUNS = ((np.float64, 'auto'), (np.float32, 'host'), (np.float32, 'auto'))
BLOCK, PART_REPS = 128, 20


class _Recorder:
    """Iterations and restarts of the device engine's solves while
    installed: wraps ``device_jacobi.fetch`` and ``DeviceJacobi.solve``.

    With ``trace``, also prints one line per chunk: the largest
    orthonormality error |G - I| of the Rayleigh-Ritz basis S = [X, W, P]
    over the chunk by block (dead rows left out), the largest relative
    drift of X's tracked A-images from A X applied in f64, the chunk-exit
    ``gram_err``, the pairs the sweep locked as converged and as
    stagnated, and the kinematic eigenvector error of the top slot left
    unlocked.  It wraps the module's ``_gram`` (S is the one 3m-row block
    it is given), ``DeviceJacobi._step`` and ``DeviceJacobi._sweep``, which
    every version of the engine has."""

    def __init__(self, trace=False):
        self.iterations, self.restarts = [], 0
        self.trace = trace

    def __enter__(self):
        dj = device_jacobi.DeviceJacobi
        self._saved = [(device_jacobi, 'fetch', device_jacobi.fetch),
                       (dj, 'solve', dj.solve)]
        if self.trace:
            self._saved += [(device_jacobi, '_gram', device_jacobi._gram),
                            (dj, '_step', dj._step), (dj, '_sweep', dj._sweep)]
        real = {name: fn for _, name, fn in self._saved}
        chunk = {}

        def fetch(*stats):
            vals = real['fetch'](*stats)
            lam, gram_err = vals[0], vals[-1]
            eps = np.finfo(lam.dtype).eps
            chunk['gram_err'] = float(gram_err)
            if gram_err > math.sqrt(eps) or not np.all(np.isfinite(lam)):
                self.restarts += 1
                if self.trace:
                    # the engine counts a restarted chunk's iterations
                    # after this; its history's length is the chunk's
                    self._print(chunk, 'restart', vals[2].shape[-2])
            return vals

        def solve(engine, *args, **kw):
            chunk.clear()
            chunk['engine'] = engine
            status = real['solve'](engine, *args, **kw)
            self.iterations.append(engine.iteration)
            return status

        def gram(a, b):
            engine = chunk.get('engine')
            m = engine.block_size if engine is not None else None
            if m and a.shape[0] == 3 * m and b.shape[0] in (3 * m, 6 * m):
                live = torch.linalg.norm(a, dim=1) > 0.5
                err = torch.abs(real['_gram'](a, a) - torch.eye(
                    3 * m, dtype=a.dtype, device=a.device))
                err = err * (live[:, None] & live[None, :])
                for i, bi in enumerate('XWP'):
                    for j, bj in enumerate('XWP'[i:], i):
                        key = bi + bj
                        value = float(err[i * m:(i + 1) * m,
                                          j * m:(j + 1) * m].max())
                        chunk[key] = max(chunk.get(key, 0.0), value)
            return real['_gram'](a, b)

        def step(engine, state, *args):
            x, ax = state[0], state[1]
            ops = tuple(o.to(torch.float64) for o in engine._operands)
            exact = engine.matmat(ops, x.to(torch.float64))
            drift = torch.linalg.norm(ax.to(torch.float64) - exact, dim=1) \
                / torch.linalg.norm(exact, dim=1).clamp(min=1e-300)
            chunk['drift'] = max(chunk.get('drift', 0.0), float(drift.max()))
            return real['_step'](engine, state, *args)

        def sweep(engine, **kw):
            rcon = real['_sweep'](engine, **kw)
            nx = kw['nx']
            cnv = engine.cnv[nx - rcon:]
            top = nx - 1 - rcon
            self._print(chunk, 'locked %d (converged %d, stagnated %d); '
                        'top slot kinematic error %.1e' % (
                            rcon, int((cnv > 0).sum()), int((cnv < 0).sum()),
                            kw['err_X'][0, top] if top >= 0 else -1.0))
            return rcon
        wrappers = {'fetch': fetch, 'solve': solve, '_gram': gram,
                    '_step': step, '_sweep': sweep}
        for owner, name, _ in self._saved:
            setattr(owner, name, wrappers[name])
        return self

    @staticmethod
    def _print(chunk, what, ahead=0):
        engine = chunk['engine']
        blocks = ' '.join('%s %.0e' % (k, chunk.pop(k)) for k in
                          ('XX', 'XW', 'XP', 'WW', 'WP', 'PP') if k in chunk)
        print('  it %d: S error %s; X drift %.0e; gram_err %.1e; %s'
              % (engine.iteration + ahead, blocks, chunk.pop('drift', 0.0),
                 chunk.get('gram_err', 0.0), what))

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def run(a, nsv, engine, device, trace=False):
    """One truncated_svd call: (values, wall s, iterations, restarts)."""
    opt = Options()
    opt.device_engine = engine
    with _Recorder(trace and engine == 'auto') as rec:
        _sync(device)
        t0 = time.perf_counter()
        _, sigma, _ = truncated_svd(a, nsv=nsv, opt=opt, device=device)
        _sync(device)
        wall = time.perf_counter() - t0
    its = rec.iterations[-1] if rec.iterations else None
    return sigma, wall, its, rec.restarts


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def parts(device):
    """Milliseconds a call of each small dense operation, by dtype."""
    m = BLOCK
    out = {}
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator().manual_seed(0)
        h = torch.randn((3 * m, 3 * m), generator=gen, dtype=dtype)
        h = (h + h.T).to(device)
        g = torch.eye(3 * m, dtype=dtype, device=device) + 1e-3 * h
        low = torch.linalg.cholesky(g)
        w = torch.randn((m, m), generator=gen, dtype=dtype).to(device)
        w = w @ w.T
        tall = torch.randn((2 * m, m), generator=gen, dtype=dtype).to(device)
        calls = {'eigh 3m': lambda: torch.linalg.eigh(h),
                 'eigh m': lambda: torch.linalg.eigh(w),
                 'cholesky 3m': lambda: torch.linalg.cholesky_ex(g),
                 'triangular solve 3m': lambda: torch.linalg.solve_triangular(
                     low, h, upper=False),
                 'qr 2m x m': lambda: torch.linalg.qr(tall),
                 'svd 2m x m': lambda: torch.linalg.svd(
                     tall, full_matrices=False)}
        for name, fn in calls.items():
            fn()
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(PART_REPS):
                fn()
            _sync(device)
            ms = (time.perf_counter() - t0) / PART_REPS * 1e3
            out[(str(dtype).split('.')[-1], name)] = ms
            print('%s %s: %.3f ms' % (str(dtype).split('.')[-1], name, ms))
    return out


def main(argv=None):
    """Prints one line per run and returns them as dicts."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--m', type=int, default=3000)
    ap.add_argument('--n', type=int, default=2000)
    ap.add_argument('--rank', type=int, default=1000)
    ap.add_argument('--nsv', type=int, default=300)
    ap.add_argument('--perm', type=int, default=0)
    ap.add_argument('--parts', action='store_true')
    ap.add_argument('--trace', action='store_true')
    ap.add_argument('--device', default=None)
    args = ap.parse_args(argv)
    device = storage_device(args.device)
    if args.parts:
        return parts(device)
    np.random.seed(0)
    warm = generate(200, 150, 60, dtype=np.float32)[0]
    run(warm, 10, 'auto', device)
    out = []
    for dtype, engine in RUNS:
        np.random.seed(1)
        a = generate(args.m, args.n, args.rank, dtype=dtype)[0]
        if args.perm:
            a = a[np.random.RandomState(args.perm).permutation(args.m)]
        exact = np.linalg.svd(a.astype(np.float64), compute_uv=False)
        sigma, wall, its, restarts = run(a, args.nsv, engine, device,
                                         args.trace)
        k = min(sigma.shape[0], args.nsv)
        agree = float(np.max(np.abs(sigma[:k] - exact[:k]) / exact[:k]))
        row = {'dtype': np.dtype(dtype).name, 'engine': engine,
               'values': int(sigma.shape[0]), 'agree': agree, 'wall': wall,
               'iterations': its, 'restarts': restarts}
        out.append(row)
        print('%s on the %s: %d values, within %.2e of the host SVD; wall '
              '%.3f s; iterations %s, restarts %d'
              % (row['dtype'], 'device Jacobi engine' if engine == 'auto'
                 else 'core Solver', row['values'], agree, wall,
                 its if its is not None else '-', restarts))
    return out


if __name__ == '__main__':
    main()
