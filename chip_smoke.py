#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raleigh_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Three phases; any failure exits non-zero.

1. Environment: the card's name and power limit, torch's CUDA version,
   the kernel build from ``raleigh_tpu_torch/csrc`` (time and ``-Xptxas -v``
   lines), and TF32 off.
2. Kernel against its plain PyTorch version on the card, on the same
   inputs, at the main path's shapes: DIA SpMM of lap3d(100,100,128)
   (n = 1,280,000) with m = 16 in f32 and bf16 operands, and lap3d 50^3
   (n = 125,000, not a multiple of 128) with m = 24.  Tolerances: f32,
   1e-6 of the largest |entry| of the plain result (both accumulate in
   f32); bf16, entrywise, one bf16 rounding on either side plus the f32
   summation error bound (``bf16_excess``).  Two controls, the plain version with a bf16
   running sum and with each product rounded to bf16, must fail the bf16
   bound, so that the bound is shown to catch a kernel that does not
   accumulate in f32.  Times from CUDA events over many launches after a
   warm-up.
3. The main path as a user calls it: ``partial_hevp`` with a degree-12
   Chebyshev preconditioner on lap3d(100,100,128), 4 smallest to 5e-5,
   checked against the analytic eigenvalues (1e-3 relative) with both
   kernel launch counters > 0; then lap3d 50^3, 10 smallest, degree 16, to
   1e-6 (1e-5 relative).  The preconditioner's set-up (A's device matrix,
   which ``partial_hevp`` shares) and a second, warm solve are timed.

The last line is {"ok": true, "device": {...}}; the line before it lists
each kernel's launches on the main path, error and times.

    python3 chip_smoke.py --profile

adds, after each main-path field, a profile of one warm solve (device time
by kernel, the device's busy share) and the same solve with f32 Chebyshev
iterates.
"""

import contextlib
import io
import json
import re
import subprocess
import sys
import time

KERNEL_SOURCE = 'raleigh_tpu_torch/csrc/dia_spmm.cu'
REPLACES = 'raleigh_tpu/ops/spmm_window.py:73'
F32_TOL = 1e-6
# two roundings to bf16 (unit roundoff 2^-8) of nearly equal f32 sums
BF16_HALF_ULP_PAIR = 2.0 ** -7


def fail(msg):
    raise SystemExit('chip_smoke: FAILED: %s' % msg)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` launches, CUDA events,
    after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_environment(torch, build):
    card = card_line()
    print(card)
    print('torch %s, CUDA %s, device %s' % (
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0)))
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        fail('TF32 matmuls are on; f32 products must run at full f32')
    t0 = time.perf_counter()
    build.library()
    rep = build.build_report()
    print('kernel build: %.2f s (nvcc %.2f s) -> %s' % (
        time.perf_counter() - t0, rep['seconds'], rep['path']))
    for line in rep['log'].splitlines():
        if 'ptxas' in line:
            print('  ' + line.strip())
    return card


def bf16_excess(torch, sw, val, x, offsets, got, want):
    """Entrywise |got - want| over the bound for two bf16 DIA applies that
    both sum in f32 and round once to bf16: one bf16 rounding on either
    side (2^-7 |want|) plus twice the f32 summation error bound
    (noff 2^-24 sum_k |val_k x|).  At most 1 where ``got`` accumulates in
    f32 in any order; a bf16 sum or bf16 products miss it by orders of
    magnitude.  Returns (largest ratio, share of entries above 1)."""
    terms = sw.dia_matmat_rows_plain(val.abs(), x.float().abs(), offsets)
    bound = (BF16_HALF_ULP_PAIR * want.float().abs()
             + 2 * len(offsets) * 2.0 ** -24 * terms)
    diff = (got.float() - want.float()).abs()
    ratio = torch.where(diff == 0, 0.0, diff / bound)   # 0/0 is agreement
    return ratio.max().item(), (ratio > 1).float().mean().item()


def bf16_controls(torch, val, x, offsets):
    """The DIA apply done wrong in two ways a bf16 kernel could be: a bf16
    running sum, and each product rounded to bf16 before an f32 sum."""
    m, n = x.shape
    run = torch.zeros((m, n), dtype=torch.bfloat16, device=x.device)
    prod = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for k, off in enumerate(offsets.tolist()):
        lo, hi = max(0, -off), min(n, n - off)
        if lo < hi:
            term = val[k, lo:hi] * x[:, lo + off:hi + off]
            run[:, lo:hi] = run[:, lo:hi] + term    # rounds to bf16
            prod[:, lo:hi] += term.to(torch.bfloat16)
    return {'bf16 running sum': run, 'bf16 products': prod.to(torch.bfloat16)}


def phase_kernels(torch, np, lap3d, DiaMatrix, sw):
    """Kernel vs plain at the main path's shapes; returns the f32 and bf16
    rows at the lap3d(100,100,128) shape."""
    rows = {}
    gen = torch.Generator('cuda').manual_seed(0)
    cases = [((100, 100, 128), 16, torch.float32),
             ((100, 100, 128), 16, torch.bfloat16),
             ((50, 50, 50), 24, torch.float32),
             ((50, 50, 50), 24, torch.bfloat16)]
    mats = {}
    for grid, m, dt in cases:
        if grid not in mats:
            mats[grid] = DiaMatrix(lap3d(*grid, 1.0, 1.0, 1.0),
                                   dtype=np.float32, device='cuda')
        dm = mats[grid]
        n = dm.shape[0]
        x = torch.randn((m, n), generator=gen, device='cuda').to(dt)
        yk = sw.dia_matmat_rows(dm.val, x, dm.offsets_t)
        yp = sw.dia_matmat_rows_plain(dm.val, x, dm.offsets_t)
        torch.cuda.synchronize()
        if yk.dtype != dt or yk.shape != (m, n):
            fail('kernel output %s %s' % (yk.dtype, tuple(yk.shape)))
        diff = (yk.float() - yp.float()).abs().max().item()
        rel = diff / yp.float().abs().max().item()
        key = str(dt).replace('torch.', '')
        if not np.isfinite(rel):
            fail('kernel vs plain %s %s m=%d: non-finite' % (grid, key, m))
        if dt == torch.float32 and rel > F32_TOL:
            fail('kernel vs plain %s f32 m=%d: rel err %.3e > %.0e'
                 % (grid, m, rel, F32_TOL))
        if dt == torch.bfloat16:
            worst, share = bf16_excess(torch, sw, dm.val, x, dm.offsets_t,
                                       yk, yp)
            if worst > 1:
                fail('kernel vs plain %s bf16 m=%d: %.3e of the entries '
                     'more than one bf16 rounding apart (worst %.2f times '
                     'the bound)'
                     % (grid, m, share, worst))
            for name, yc in bf16_controls(torch, dm.val, x,
                                          dm.offsets_t).items():
                cworst, cshare = bf16_excess(torch, sw, dm.val, x,
                                             dm.offsets_t, yc, yp)
                crel = ((yc.float() - yp.float()).abs().max().item()
                        / yp.float().abs().max().item())
                print('  control (%s) vs plain, lap3d%s m=%d: %.4f of the '
                      'entries beyond the bound (worst %.1f times it); error '
                      '%.2e of the largest entry' % (name, grid, m, cshare,
                                                     cworst, crel))
                if cworst <= 1:
                    fail('the bf16 bound passes the control (%s)' % name)
        reps = 50

        def kern():
            sw.dia_matmat_rows(dm.val, x, dm.offsets_t)

        def plain():
            sw.dia_matmat_rows_plain(dm.val, x, dm.offsets_t)
        # in turns: plain, kernel, kernel, plain
        tp1 = time_ms(torch, plain, reps)
        tk1 = time_ms(torch, kern, reps)
        tk2 = time_ms(torch, kern, reps)
        tp2 = time_ms(torch, plain, reps)
        tk, tp = min(tk1, tk2), min(tp1, tp2)
        nbytes = len(dm.offsets) * n * 4 + 2 * m * n * x.element_size()
        print('dia_spmm lap3d%s n=%d m=%d %s: rel err %.2e (max abs %.3e), '
              'kernel %.4f ms (%.0f GB/s), plain %.4f ms (%.0f GB/s)'
              % (grid, n, m, key, rel, diff, tk, nbytes / tk / 1e6, tp,
                 nbytes / tp / 1e6))
        if grid == (100, 100, 128):
            rows[key] = {'max_abs_err': diff, 'ms': tk, 'plain_ms': tp}
    return rows


def solve(torch, partial_hevp, a, T, which, tol):
    """One partial_hevp call on the card: (lmd, x, status, iterations,
    wall seconds, LOBPCG seconds).  The difference of the two times is
    partial_hevp's own set-up; A's device matrix is the preconditioner's,
    built before."""
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        lmd, x, status = partial_hevp(a, T=T, which=which, tol=tol, verb=0,
                                      arch='gpu')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    found = re.findall(r'iterations: (\d+), solve time: (\S+)',
                       out.getvalue())
    if not found:
        fail('partial_hevp printed no iteration count')
    return lmd, x, status, int(found[-1][0]), wall, float(found[-1][1])


def profile_solve(torch, partial_hevp, a, T, which, tol, card):
    """One warm solve under torch.profiler: device kernel time by kernel
    and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        *_, wall, _ = solve(torch, partial_hevp, a, T, which, tol)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print('profile (one warm solve, profiler on) [%s]: wall %.3f s, device '
          'busy %.3f s (%.1f%%), %d kernel launches'
          % (card, wall, busy, 100 * busy / wall,
             sum(e.count for e in kernels)))
    for e in kernels[:15]:
        print('  %9.2f ms %6d x  %s' % (e.self_device_time_total / 1e3,
                                        e.count, e.key[:90]))


def check_solution(np, name, lmd, x, status, exact, limit):
    k = len(exact)
    if status != 0 or lmd is None or len(lmd) < k:
        fail('%s: status %s' % (name, status))
    if x.shape[1] < k or not (np.all(np.isfinite(lmd))
                              and np.all(np.isfinite(x))):
        fail('%s: non-finite or short result %s' % (name, x.shape))
    err = float(np.max(np.abs(np.sort(lmd)[:k] - exact) / exact))
    if err > limit:
        fail('%s: eigenvalue error %.2e > %.0e' % (name, err, limit))
    ortho = float(np.abs(x[:, :k].T @ x[:, :k] - np.eye(k)).max())
    if ortho > 1e-3:
        fail('%s: eigenvectors not orthonormal (%.2e)' % (name, ortho))
    return err


def phase_main_path(torch, np, sw, card, profile=False):
    from raleigh_tpu_torch import Chebyshev, partial_hevp, spectral_bounds
    from raleigh_tpu_torch.examples.laplace import lap3d, lap3d_eigenvalues

    fields = [('lap3d(100,100,128) which=4 tol=5e-5', (100, 100, 128), 4,
               12, 5e-5, 1e-3),
              ('lap3d(50,50,50) which=10 tol=1e-6', (50, 50, 50), 10, 16,
               1e-6, 1e-5)]
    launches = None
    for name, grid, which, degree, tol, limit in fields:
        a = lap3d(*grid, 1.0, 1.0, 1.0)
        exact = np.sort(lap3d_eigenvalues(*grid, 1.0, 1.0, 1.0))[:which]
        lo, hi = spectral_bounds(a)
        first = launches is None
        if first:
            sw.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ch = Chebyshev(a, lo, hi, degree=degree, arch='gpu')
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        lmd, x, st, its, cold, _ = solve(torch, partial_hevp, a, ch, which,
                                         tol)
        if first:
            launches = dict(sw.LAUNCHES)
            if min(launches.values()) <= 0:
                fail('main path skipped a kernel: launches %s' % launches)
        err = check_solution(np, name, lmd, x, st, exact, limit)
        lmd, x, st, its2, warm, lob = solve(torch, partial_hevp, a, ch,
                                            which, tol)
        check_solution(np, name, lmd, x, st, exact, limit)
        print('%s: status 0, %d iterations (warm run %d), max rel eigenvalue '
              'error %.2e; Chebyshev set-up %.3f s; partial_hevp wall cold '
              '%.3f s, warm %.3f s (LOBPCG %.3f s, rest %.3f s) [%s]'
              % (name, its, its2, err, setup, cold, warm, lob, warm - lob,
                 card))
        if first:
            print('main path kernel launches: %s' % json.dumps(launches))
        if profile:
            profile_solve(torch, partial_hevp, a, ch, which, tol, card)
            # the same solve with f32 Chebyshev iterates (auto rule off)
            ch.device_matrix().WINDOW_HBM_BYTES = float('inf')
            lmd, x, st, its3, wall, lob = solve(torch, partial_hevp, a, ch,
                                                which, tol)
            del ch.device_matrix().WINDOW_HBM_BYTES
            err = check_solution(np, name, lmd, x, st, exact, limit)
            print('%s with f32 Chebyshev iterates: %d iterations, max rel '
                  'eigenvalue error %.2e, wall %.3f s (LOBPCG %.3f s) [%s]'
                  % (name, its3, err, wall, lob, card))
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    import numpy as np

    from raleigh_tpu_torch.examples.laplace import lap3d
    from raleigh_tpu_torch.ops import _build
    from raleigh_tpu_torch.ops import spmm_window as sw
    from raleigh_tpu_torch.ops.spmm import DiaMatrix

    card = phase_environment(torch, _build)
    rows = phase_kernels(torch, np, lap3d, DiaMatrix, sw)
    launches = phase_main_path(torch, np, sw, card,
                               profile='--profile' in sys.argv[1:])
    if 'jax' in sys.modules:
        fail('jax was imported')
    kernels = [dict(name='dia_spmm_rows_' + ('f32' if key == 'float32'
                                              else 'bf16'),
                    route='cuda', source=KERNEL_SOURCE, replaces=REPLACES,
                    launches=launches[key], **rows[key])
               for key in ('float32', 'bfloat16')]
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
