#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raleigh_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Four phases; any failure exits non-zero.

1. Environment: the card's name and power limit, torch's CUDA version,
   the kernel build from ``raleigh_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel; time and ``-Xptxas -v`` lines), and TF32 off.
2. Every kernel against its plain PyTorch version on the card, on the same
   inputs, at the main path's shapes, with times from CUDA events over many
   launches after a warm-up (plain, kernel, kernel, plain), the time of
   the one PyTorch call that computes the same function
   (``torch.sparse.mm`` on a CSR tensor; for the BSR kernel also the
   product of its tiles as a ``torch.sparse_bsr_tensor``) and the least
   time the card could take (``bound``).
   * DIA SpMM of lap3d(100,100,128) (n = 1,280,000) with m = 16 in f32 and
     bf16 operands, and lap3d 50^3 (n = 125,000) with m = 24.  Tolerances:
     f32, 1e-6 of the largest |entry| of the plain result; bf16, entrywise,
     one bf16 rounding on either side plus the f32 summation error bound
     (``bf16_excess``).  Two controls, the plain version with a bf16
     running sum and with each product rounded to bf16, must fail it.
   * The stream kernel ``y = a x`` on 32 x 1,277,952 f32 against
     ``torch.mul``: exact equality.  Its rate is the card's stream rate as
     the port measures it.
   * BSR SpMM of the finite-element flagship in the mesher's order
     (``shipsec_like(relabel=False)``, n = 139,179, bs = 128, m = 16) in
     the four instantiations (f32 or bf16 tiles, f32 or bf16 operand), and
     of a small girder with n not a multiple of bs = 64, m = 24 and one
     block row emptied.  Tolerance entrywise (``bsr_excess``): twice the
     f32 summation error bound of the entry's L terms, plus one rounding
     on either side for a bf16 result.  Two controls, a bf16 running sum
     over the tiles and bf16 products, must fail it.
   * The ELL apply (plain PyTorch, no kernel) on the same flagship in both
     orderings, timed, for the layout rule's constants.
3. The main paths as a user calls them, each driven with every launch
   counter set to 0 just before it and read just after.
   * ``partial_hevp`` with a degree-12 Chebyshev preconditioner on
     lap3d(100,100,128), 4 smallest to 5e-5, checked against the analytic
     eigenvalues (1e-3 relative) with both DIA launch counters > 0; then
     lap3d 50^3, 10 smallest, degree 16, to 1e-6 (1e-5 relative).
   * FE-ELL: the vibration pencil K x = lambda M x of ``shipsec_like()``
     through ``partial_hevp`` (degree-32 Chebyshev on [hi 1e-4, hi], 6
     smallest to 1e-4); both matrices land in ``EllMatrix``; no BSR launch.
   * FE-BSR: the same mesh in the mesher's order through ``lobpcg`` on
     ``BsrMatrix(bs=128)`` operators, BSR launches > 0; then with bf16
     Chebyshev iterates and with bf16 tiles in the preconditioner, so that
     every instantiation of the kernel is driven.
   Both FE fields must end with status 0, meet
   ``max_j |K x_j - lambda_j M x_j| / (|K|_inf |x_j|)`` <= 1e-5 (2-norms
   of vectors, computed on the host in f64) and agree on the six
   eigenvalues to 1e-3 relative: the two orderings are one mesh.
   * The stream-rate probe ``ops.stream.stream_rate``.
4. No module of jax or of the JAX package was loaded.

The last line is {"ok": true, "device": {...}}; the line before it lists
each kernel's launches on its path, error against plain, times and bound.

    python3 chip_smoke.py --profile

adds, after each main-path field, a profile of one warm solve (device time
by kernel, the device's busy share) and, for the lap3d fields, the same
solve with f32 Chebyshev iterates.
"""

import contextlib
import io
import json
import re
import subprocess
import sys
import time

# source and the TPU kernel each CUDA kernel replaces
DIA = ('raleigh_tpu_torch/csrc/dia_spmm.cu',
       'raleigh_tpu/ops/spmm_window.py:73')
BSR = ('raleigh_tpu_torch/csrc/bsr_spmm.cu',
       'raleigh_tpu/ops/spmm_pallas.py:91')
STREAM = ('raleigh_tpu_torch/csrc/stream_scale.cu', 'bench.py:289')
# data-sheet peaks of one H100 SXM: HBM3 bytes/s, f32 flop/s outside the
# tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
F32_TOL = 1e-6
# FE fields: limit on max_j |K x - lambda M x| / (|K|_inf |x|).  The solves
# read 1.9e-7 (f32 preconditioner) to 1.3e-6 (bf16 iterates) on an H100, so
# 1e-5 fails a solve that stopped an order of magnitude early.
FE_RESIDUAL_LIMIT = 1e-5
FE_AGREE = 1e-3
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


def in_turns(torch, kern, plain, reps):
    """(kernel ms, plain ms): the best of two timings each, taken in
    turns plain, kernel, kernel, plain."""
    tp1 = time_ms(torch, plain, reps)
    tk1 = time_ms(torch, kern, reps)
    tk2 = time_ms(torch, kern, reps)
    tp2 = time_ms(torch, plain, reps)
    return min(tk1, tk2), min(tp1, tp2)


def bound(nbytes, flops):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    to move ``nbytes`` or to do ``flops`` f32 operations, whichever is
    larger, at the data-sheet peaks."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (tb, 'bytes') if tb >= tf else (tf, 'operations')


def library_spmm_ms(torch, csr, x, reps):
    """Milliseconds of ``torch.sparse.mm`` of the f32 CSR tensor of the
    scipy matrix ``csr`` with the (n, m) operand ``x.T``: the one PyTorch
    call that computes an SpMM kernel's function.  None (with a note) if
    this torch cannot do it: a measurement, not a gate."""
    try:
        a = torch.sparse_csr_tensor(
            torch.from_numpy(csr.indptr.astype('int64')),
            torch.from_numpy(csr.indices.astype('int64')),
            torch.from_numpy(csr.data.astype('float32')),
            size=csr.shape, device='cuda')
        xt = x.float().T.contiguous()
        return time_ms(torch, lambda: torch.sparse.mm(a, xt), reps)
    except (RuntimeError, NotImplementedError) as e:
        print('  torch.sparse.mm on a CSR tensor is not available: %s'
              % str(e).splitlines()[0])
        return None


def library_bsr_ms(torch, bm, x, reps):
    """Milliseconds of one PyTorch product of ``bm``'s own tiles as a
    ``torch.sparse_bsr_tensor`` (padded to whole tiles) with the padded
    (n_padded, m) operand, both in ``x``'s dtype: the BSR kernel's function
    on the same tiles.  None (with a note) if this torch cannot do it: a
    measurement, not a gate."""
    try:
        a = torch.sparse_bsr_tensor(
            bm.block_indptr_t.long(), bm.block_cols.long(),
            bm.blocks.to(x.dtype), size=(bm.n_padded, bm.n_padded))
        xt = torch.nn.functional.pad(
            x, (0, bm.n_padded - x.shape[1])).T.contiguous()
        return time_ms(torch, lambda: a @ xt, reps)
    except (RuntimeError, NotImplementedError) as e:
        print('  a torch.sparse_bsr_tensor product in %s is not available: '
              '%s' % (x.dtype, str(e).splitlines()[0]))
        return None


def fmt_ms(t):
    return 'not measured' if t is None else '%.4f ms' % t


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
    """DIA kernel vs plain at the main path's shapes; returns the f32 and
    bf16 rows at the lap3d(100,100,128) shape."""
    rows = {}
    gen = torch.Generator('cuda').manual_seed(0)
    cases = [((100, 100, 128), 16, torch.float32),
             ((100, 100, 128), 16, torch.bfloat16),
             ((50, 50, 50), 24, torch.float32),
             ((50, 50, 50), 24, torch.bfloat16)]
    mats, csrs = {}, {}
    for grid, m, dt in cases:
        if grid not in mats:
            csrs[grid] = lap3d(*grid, 1.0, 1.0, 1.0)
            mats[grid] = DiaMatrix(csrs[grid], dtype=np.float32,
                                   device='cuda')
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
        tk, tp = in_turns(torch, kern, plain, reps)
        noff = len(dm.offsets)
        nbytes = noff * n * 4 + noff * 4 + 2 * m * n * x.element_size()
        flops = 2 * m * sum(n - abs(o) for o in dm.offsets)
        bound_ms, bound_by = bound(nbytes, flops)
        lib = None
        if dt == torch.float32:
            lib = library_spmm_ms(torch, csrs[grid], x, 10)
        print('dia_spmm lap3d%s n=%d m=%d %s: rel err %.2e (max abs %.3e), '
              'kernel %.4f ms (%.0f GB/s), plain %.4f ms (%.0f GB/s), '
              'torch.sparse.mm %s, bound %.4f ms (%s)'
              % (grid, n, m, key, rel, diff, tk, nbytes / tk / 1e6, tp,
                 nbytes / tp / 1e6, fmt_ms(lib), bound_ms, bound_by))
        if grid == (100, 100, 128):
            name = 'dia_spmm_rows_' + ('f32' if key == 'float32' else 'bf16')
            rows[name] = dict(
                name=name, route='cuda', source=DIA[0], replaces=DIA[1],
                launches=0, max_abs_err=diff, ms=tk, plain_ms=tp,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
                bytes=nbytes)
    return rows


def phase_stream(torch, st):
    """The stream kernel against ``torch.mul`` (exact equality) at the
    reference's shape; returns its row, whose rate is the card's stream
    rate as the port measures it."""
    gen = torch.Generator('cuda').manual_seed(1)
    x = torch.randn(st.REFERENCE_SHAPE, generator=gen, device='cuda')
    a = st.REFERENCE_SCALE
    yk = st.stream_scale(x, a)
    yp = st.stream_scale_plain(x, a)
    torch.cuda.synchronize()
    diff = (yk - yp).abs().max().item()
    if not torch.equal(yk, yp):
        fail('stream kernel differs from torch.mul (max abs %.3e)' % diff)
    # an unaligned view takes the 4-byte path and the scalar tail
    odd = x.reshape(-1)[1:1000004]
    if not torch.equal(st.stream_scale(odd.clone(), a),
                       st.stream_scale_plain(odd, a)):
        fail('stream kernel differs from torch.mul on an odd length')
    del yk, yp
    tk, tp = in_turns(torch, lambda: st.stream_scale(x, a),
                      lambda: st.stream_scale_plain(x, a), 50)
    nbytes = 2 * x.numel() * 4
    bound_ms, bound_by = bound(nbytes, x.numel())
    print('stream_scale %s f32: equal to torch.mul, kernel %.4f ms '
          '(%.0f GB/s), torch.mul %.4f ms (%.0f GB/s), bound %.4f ms (%s)'
          % (tuple(x.shape), tk, nbytes / tk / 1e6, tp, nbytes / tp / 1e6,
             bound_ms, bound_by))
    return dict(name='stream_scale_f32', route='cuda', source=STREAM[0],
                replaces=STREAM[1], launches=0, max_abs_err=diff, ms=tk,
                plain_ms=tp, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=tp, bytes=nbytes)


def bsr_excess(torch, sp, bm, x, got, want):
    """Entrywise |got - want| over the bound for two BSR applies that both
    sum in f32: twice the f32 summation error bound of an entry's L terms
    (L = tiles in its block row x bs; 2 L 2^-24 sum |a| |x|, from the plain
    version on |blocks|, |x|), plus one bf16 rounding on either side
    (2^-7 |want|) when the result is bf16.  At most 1 where ``got``
    accumulates in f32 in any order.  Returns (largest ratio, share of
    entries above 1)."""
    n = bm.shape[0]
    terms = sp.bsr_matmat_rows_plain(bm.blocks.float().abs(),
                                     bm.block_indptr_t, bm.block_cols,
                                     x.float().abs(), n)
    per_row = (bm.block_indptr_t[1:] - bm.block_indptr_t[:-1]) * bm.bs
    length = per_row.repeat_interleave(bm.bs)[:n].float()
    limit = 2 * length[None, :] * 2.0 ** -24 * terms
    if want.dtype == torch.bfloat16:
        limit = limit + BF16_HALF_ULP_PAIR * want.float().abs()
    diff = (got.float() - want.float()).abs()
    ratio = torch.where(diff == 0, 0.0, diff / limit)   # 0/0 is agreement
    return ratio.max().item(), (ratio > 1).float().mean().item()


def bsr_controls(torch, bm, x):
    """The BSR apply done wrong in two ways a kernel could be: a bf16
    running sum over the tiles of a block row, and each product rounded to
    bf16 before an f32 sum.  Results in x's dtype."""
    m, n = x.shape
    nb, bs = bm.nb, bm.bs
    xp = torch.nn.functional.pad(x.float(), (0, nb * bs - n))
    xg = xp.reshape(m, nb, bs).index_select(1, bm.block_cols)
    rows = bm.block_rows.long()
    # products a[t, p, q] x[r, t, q], one block row's worth at a time
    run = torch.zeros((nb, bs, m), dtype=torch.bfloat16, device=x.device)
    prod = torch.zeros((nb, bs, m), dtype=torch.float32, device=x.device)
    indptr = bm.block_indptr
    for j in range(int((indptr[1:] - indptr[:-1]).max())):
        # the j-th tile of every block row that has one
        sel = torch.as_tensor(
            [int(indptr[i]) + j for i in range(nb)
             if indptr[i + 1] - indptr[i] > j], device=x.device)
        a = bm.blocks.index_select(0, sel).float()          # (k, bs, bs)
        xs = xg.index_select(1, sel).permute(1, 0, 2)       # (k, m, bs)
        r = rows.index_select(0, sel)
        for q0 in range(0, bs, 8):
            part = torch.einsum('kpq,krq->kpr', a[:, :, q0:q0 + 8],
                                xs[:, :, q0:q0 + 8])
            run[r] = run[r] + part.to(torch.bfloat16)   # rounds to bf16
            terms = (a[:, :, None, q0:q0 + 8]
                     * xs[:, None, :, q0:q0 + 8]).to(torch.bfloat16)
            prod[r] += terms.float().sum(-1)

    def out(t):
        return t.reshape(nb * bs, m)[:n].T.to(x.dtype).contiguous()
    return {'bf16 running sum': out(run), 'bf16 products': out(prod)}


def check_bsr(torch, sp, bm, x, name):
    """One BSR kernel apply against the plain version: dtype, shape,
    finiteness and the entrywise bound; returns (max abs error, worst
    ratio to the bound, the plain version's result)."""
    yk = bm.matmat_rows(x)
    yp = sp.bsr_matmat_rows_plain(bm.blocks, bm.block_indptr_t,
                                  bm.block_cols, x, bm.shape[0])
    torch.cuda.synchronize()
    if yk.dtype != x.dtype or yk.shape != x.shape:
        fail('%s: kernel output %s %s' % (name, yk.dtype, tuple(yk.shape)))
    if not torch.isfinite(yk.float()).all():
        fail('%s: non-finite kernel output' % name)
    worst, share = bsr_excess(torch, sp, bm, x, yk, yp)
    if worst > 1:
        fail('%s: %.3e of the entries beyond the bound (worst %.2f times '
             'it)' % (name, share, worst))
    return (yk.float() - yp.float()).abs().max().item(), worst, yp


def phase_bsr(torch, np, sp, BsrMatrix, EllMatrix, fe, k_nat, k_rel):
    """The BSR kernel against its plain version: the flagship in the
    mesher's order in the four instantiations, with controls and times,
    and an awkward small shape; then the ELL apply's time on the same
    flagship in both orderings.  Returns the kernel rows."""
    rows = {}
    gen = torch.Generator('cuda').manual_seed(2)
    m = 16
    n = k_nat.shape[0]
    x32 = torch.randn((m, n), generator=gen, device='cuda')
    mats = {'f32': BsrMatrix(k_nat, bs=128, device='cuda')}
    mats['bf16'] = BsrMatrix.from_arrays(
        mats['f32'].blocks.to(torch.bfloat16), mats['f32'].block_cols.cpu(),
        mats['f32'].block_indptr, n, nnz=mats['f32'].nnz, device='cuda')
    bm = mats['f32']
    counts = np.diff(bm.block_indptr)
    print('BSR flagship: n=%d nnz=%d bs=%d, %d tiles (fill %.4f), %.1f MB '
          'of f32 tiles, %.1f tiles per block row (most %d), nb=%d'
          % (n, bm.nnz, bm.bs, bm.blocks.shape[0],
             bm.nnz / (bm.blocks.shape[0] * bm.bs ** 2),
             bm.blocks.numel() * 4 / 1e6, counts.mean(), counts.max(),
             bm.nb))
    lib = library_spmm_ms(torch, k_nat, x32, 10)
    for bkey in ('f32', 'bf16'):
        for xkey, x in (('f32', x32), ('bf16', x32.to(torch.bfloat16))):
            bm = mats[bkey]
            name = 'bsr_spmm_rows_%s_%s' % (bkey, xkey)
            diff, worst, yp = check_bsr(torch, sp, bm, x, name)
            if bkey == 'f32':
                for cname, yc in bsr_controls(torch, bm, x).items():
                    cworst, cshare = bsr_excess(torch, sp, bm, x, yc, yp)
                    print('  control (%s) vs plain, %s: %.4f of the entries '
                          'beyond the bound (worst %.1f times it)'
                          % (cname, name, cshare, cworst))
                    if cworst <= 1:
                        fail('the BSR bound passes the control (%s)' % cname)
            del yp

            def kern():
                bm.matmat_rows(x)

            def plain():
                sp.bsr_matmat_rows_plain(bm.blocks, bm.block_indptr_t,
                                         bm.block_cols, x, n)
            tk, tp = in_turns(torch, kern, plain, 20)
            nbytes = (bm.blocks.numel() * bm.blocks.element_size()
                      + 4 * (bm.block_cols.numel() + bm.nb + 1)
                      + 2 * m * n * x.element_size())
            flops = 2 * bm.blocks.numel() * m
            bound_ms, bound_by = bound(nbytes, flops)
            # the library call: the faster of the f32 CSR product and the
            # product of the same tiles as a sparse BSR tensor, which torch
            # takes in one type for tiles and operand, not in a mixed pair
            csr_here = lib if (bkey, xkey) == ('f32', 'f32') else None
            bsr_here = (library_bsr_ms(torch, bm, x, 10) if bkey == xkey
                        else None)
            lib_here = min((t for t in (csr_here, bsr_here)
                            if t is not None), default=None)
            print('%s n=%d m=%d: max abs err %.3e (worst %.3f of the bound), '
                  'kernel %.4f ms (%.0f GB/s, %.2f Gnnz/s), plain %.4f ms, '
                  'torch.sparse.mm on CSR %s, sparse_bsr_tensor product %s, '
                  'bound %.4f ms (%s)'
                  % (name, n, m, diff, worst, tk, nbytes / tk / 1e6,
                     bm.nnz / tk / 1e6, tp, fmt_ms(csr_here),
                     fmt_ms(bsr_here), bound_ms, bound_by))
            rows[name] = dict(
                name=name, route='cuda', source=BSR[0], replaces=BSR[1],
                launches=0, max_abs_err=diff, ms=tk, plain_ms=tp,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_here,
                bytes=nbytes)
    # m = 24 is two groups of 16 operand rows, the second half empty: a
    # kernel limited by the tile bytes would take m = 16's time
    x24 = torch.randn((24, n), generator=gen, device='cuda')
    bm = mats['f32']
    check_bsr(torch, sp, bm, x24, 'bsr_spmm_rows_f32_f32 m=24')
    print('bsr_spmm_rows_f32_f32 n=%d m=24: kernel %.4f ms'
          % (n, time_ms(torch, lambda: bm.matmat_rows(x24), 20)))
    del mats, bm, x24

    # awkward shape: n not a multiple of bs, m past one row group, one
    # block row emptied
    import scipy.sparse as scs
    small = fe.fe_pencil(10, 3, 0.15, seed=5, which='k')
    ns, bs = small.shape[0], 64
    keep = np.ones(ns)
    keep[3 * bs:4 * bs] = 0.0
    small = scs.csr_matrix(scs.diags(keep) @ small @ scs.diags(keep))
    small.eliminate_zeros()
    if ns % bs == 0:
        fail('the awkward BSR shape has n %% bs == 0')
    x = torch.randn((24, ns), generator=gen, device='cuda')
    for dt in (torch.float32, torch.bfloat16):
        bm = BsrMatrix(small, bs=bs, dtype=dt, device='cuda')
        if np.diff(bm.block_indptr).min() != 0:
            fail('the awkward BSR shape has no empty block row')
        for xx in (x, x.to(torch.bfloat16)):
            name = 'bsr_spmm girder n=%d bs=%d m=24 %s tiles %s operand' % (
                ns, bs, dt, xx.dtype)
            diff, worst, _ = check_bsr(torch, sp, bm, xx, name)
            print('%s: max abs err %.3e (worst %.3f of the bound)'
                  % (name, diff, worst))

    # the ELL apply (plain PyTorch) on the flagship, both orderings
    for label, k in (('relabelled', k_rel), ("mesher's order", k_nat)):
        em = EllMatrix(k, device='cuda')
        t = time_ms(torch, lambda: em.matmat_rows(x32), 5)
        ell_bytes = em.idx.numel() * 4 + em.val.numel() * 4
        print('ell apply (plain PyTorch) flagship %s: row degree %d, %.1f MB '
              'of idx + val, m=%d: %.4f ms (%.2f Gnnz/s)'
              % (label, em.row_degree, ell_bytes / 1e6, m, t,
                 em.nnz / t / 1e6))
        del em
    return rows


def solve(torch, partial_hevp, a, T, which, tol, b=None):
    """One partial_hevp call on the card: (lmd, x, status, iterations,
    wall seconds, LOBPCG seconds).  The difference of the two times is
    partial_hevp's own set-up; A's device matrix is the preconditioner's,
    built before."""
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        lmd, x, status = partial_hevp(a, B=b, T=T, which=which, tol=tol,
                                      verb=0, arch='gpu')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    found = re.findall(r'iterations: (\d+), solve time: (\S+)',
                       out.getvalue())
    if not found:
        fail('partial_hevp printed no iteration count')
    return lmd, x, status, int(found[-1][0]), wall, float(found[-1][1])


def profile_run(torch, run, card):
    """``run()`` (one warm solve) under torch.profiler: device kernel time
    by kernel and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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


def reset_counters(mods):
    for mod in mods:
        mod.reset_launches()


def phase_lap3d(torch, np, mods, rows, card, profile=False):
    """The stencil path: partial_hevp on two lap3d fields.  The DIA rows'
    launches are those of the first field."""
    from raleigh_tpu_torch import Chebyshev, partial_hevp, spectral_bounds
    from raleigh_tpu_torch.examples.laplace import lap3d, lap3d_eigenvalues
    sw = mods[0]

    fields = [('lap3d(100,100,128) which=4 tol=5e-5', (100, 100, 128), 4,
               12, 5e-5, 1e-3),
              ('lap3d(50,50,50) which=10 tol=1e-6', (50, 50, 50), 10, 16,
               1e-6, 1e-5)]
    for first, (name, grid, which, degree, tol, limit) in enumerate(fields):
        first = first == 0
        a = lap3d(*grid, 1.0, 1.0, 1.0)
        exact = np.sort(lap3d_eigenvalues(*grid, 1.0, 1.0, 1.0))[:which]
        lo, hi = spectral_bounds(a)
        if first:
            reset_counters(mods)
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
            rows['dia_spmm_rows_f32']['launches'] = launches['float32']
            rows['dia_spmm_rows_bf16']['launches'] = launches['bfloat16']
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
            profile_run(torch, lambda: solve(torch, partial_hevp, a, ch,
                                             which, tol), card)
            # the same solve with f32 Chebyshev iterates (auto rule off)
            ch.device_matrix().WINDOW_HBM_BYTES = float('inf')
            lmd, x, st, its3, wall, lob = solve(torch, partial_hevp, a, ch,
                                                which, tol)
            del ch.device_matrix().WINDOW_HBM_BYTES
            err = check_solution(np, name, lmd, x, st, exact, limit)
            print('%s with f32 Chebyshev iterates: %d iterations, max rel '
                  'eigenvalue error %.2e, wall %.3f s (LOBPCG %.3f s) [%s]'
                  % (name, its3, err, wall, lob, card))


def check_pencil(np, name, k, mass, lmd, x, status, which):
    """Status 0, finite values of the expected shape, and the pencil's
    relative residual, on the host in f64, within FE_RESIDUAL_LIMIT."""
    n = k.shape[0]
    if status != 0 or lmd is None or len(lmd) < which:
        fail('%s: status %s' % (name, status))
    lmd = np.asarray(lmd, dtype=np.float64)[:which]
    x = np.asarray(x, dtype=np.float64)[:, :which]
    if x.shape != (n, which) or not (np.all(np.isfinite(lmd))
                                     and np.all(np.isfinite(x))):
        fail('%s: non-finite or short result %s' % (name, x.shape))
    knorm = abs(k).sum(axis=1).max()
    res = np.linalg.norm(k @ x - (mass @ x) * lmd[None, :], axis=0)
    rel = float((res / (knorm * np.linalg.norm(x, axis=0))).max())
    if rel > FE_RESIDUAL_LIMIT:
        fail('%s: relative residual %.2e > %.0e'
             % (name, rel, FE_RESIDUAL_LIMIT))
    return np.sort(lmd), rel


def phase_fe(torch, np, mods, rows, card, pencils, profile=False):
    """The finite-element paths: FE-ELL through partial_hevp, FE-BSR
    through lobpcg on BsrMatrix operators.  The BSR rows' launches are
    those of the FE-BSR solves."""
    from raleigh_tpu_torch import (BsrMatrix, Chebyshev, lobpcg,
                                   partial_hevp, spectral_bounds)
    from raleigh_tpu_torch.core.device_solver import default_block
    sp = mods[1]
    which, tol, degree = 6, 1e-4, 32
    (k_rel, m_rel), (k_nat, m_nat) = pencils
    n = k_rel.shape[0]

    # ---- FE-ELL -------------------------------------------------------
    name = 'FE-ELL shipsec_like() n=%d which=6 tol=1e-4' % n
    lo, hi = spectral_bounds(k_rel)
    reset_counters(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ch = Chebyshev(k_rel, hi * 1e-4, hi, degree=degree, arch='gpu')
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    layout = type(ch.device_matrix()).__name__
    if layout != 'EllMatrix':
        fail('%s: K landed in %s, not EllMatrix' % (name, layout))
    lmd, x, st, its, cold, _ = solve(torch, partial_hevp, k_rel, ch, which,
                                     tol, b=m_rel)
    if any(sp.LAUNCHES.values()):
        fail('%s launched the BSR kernel: %s' % (name, sp.LAUNCHES))
    ell_lmd, rel = check_pencil(np, name, k_rel, m_rel, lmd, x, st, which)
    lmd, x, st, its2, warm, lob = solve(torch, partial_hevp, k_rel, ch,
                                        which, tol, b=m_rel)
    check_pencil(np, name, k_rel, m_rel, lmd, x, st, which)
    print('%s: K in %s, status 0, %d iterations (warm run %d), relative '
          'residual %.2e, lambda %s; Chebyshev set-up %.3f s; partial_hevp '
          'wall cold %.3f s, warm %.3f s (LOBPCG %.3f s, rest %.3f s) [%s]'
          % (name, layout, its, its2, rel, np.array2string(
              ell_lmd, precision=6), setup, cold, warm, lob, warm - lob,
             card))
    if profile:
        profile_run(torch, lambda: solve(torch, partial_hevp, k_rel, ch,
                                         which, tol, b=m_rel), card)
    del ch
    torch.cuda.empty_cache()

    # ---- FE-BSR -------------------------------------------------------
    name = 'FE-BSR shipsec_like(relabel=False) n=%d bs=128 which=6 ' \
        'tol=1e-4' % n
    lo, hi = spectral_bounds(k_nat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # no device named: the layouts and the solve default to the card
    bsr_k = BsrMatrix(k_nat, bs=128)
    bsr_m = BsrMatrix(m_nat, bs=128)
    if bsr_k.device.type != 'cuda':
        fail('BsrMatrix with no device argument is on %s' % bsr_k.device)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    bsr_k16 = BsrMatrix.from_arrays(
        bsr_k.blocks.to(torch.bfloat16), bsr_k.block_cols.cpu(),
        bsr_k.block_indptr, n, nnz=bsr_k.nnz, device='cuda')
    m = default_block(which, n)
    # (tiles of the preconditioner's matrix, bf16 iterates): the first is
    # the field; the others drive the kernel's other instantiations
    variants = [('f32', False), ('f32', True), ('bf16', False),
                ('bf16', True)]
    for tiles, bf16_iterates in variants:
        ch = Chebyshev(k_nat, hi * 1e-4, hi, degree=degree,
                       device_matrix=bsr_k if tiles == 'f32' else bsr_k16)
        precond = ch.device_rows_operands(m, n, stream_bf16=bf16_iterates)

        def run():
            return lobpcg(bsr_k, which, opB=bsr_m, precond=precond,
                          tol=tol, maxit=600)
        key = (tiles, 'bf16' if bf16_iterates else 'f32')
        label = '%s, %s tiles and %s iterates in the preconditioner' % (
            (name,) + key)
        reset_counters(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lmd, x, _, its, st = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(sp.LAUNCHES)
        if launches[('f32', 'f32')] <= 0 or launches[key] <= 0:
            fail('%s skipped the BSR kernel: launches %s'
                 % (label, launches))
        # each instantiation's count is that of the one solve that is its
        # path: f32 tiles and operands of the field itself, the others of
        # the variant built to drive them
        rows['bsr_spmm_rows_%s_%s' % key]['launches'] = launches[key]
        bsr_lmd, rel = check_pencil(np, label, k_nat, m_nat, lmd, x, st,
                                    which)
        agree = float(np.abs(bsr_lmd / ell_lmd - 1).max())
        if agree > FE_AGREE:
            fail('%s: eigenvalues differ from FE-ELL by %.2e > %.0e'
                 % (label, agree, FE_AGREE))
        if key == ('f32', 'f32'):
            t0 = time.perf_counter()
            lmd, x, _, its2, st = run()
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            check_pencil(np, label, k_nat, m_nat, lmd, x, st, which)
            print('%s: status 0, %d iterations (warm run %d), relative '
                  'residual %.2e, eigenvalues within %.2e of FE-ELL; BSR '
                  'set-up (K and M, build and upload) %.3f s; lobpcg wall '
                  'cold %.3f s, warm %.3f s; BSR launches %s [%s]'
                  % (label, its, its2, rel, agree, setup, wall, warm,
                     {'%s_%s' % k5: c for k5, c in launches.items()}, card))
            if profile:
                profile_run(torch, run, card)
        else:
            print('%s: status 0, %d iterations, relative residual %.2e, '
                  'eigenvalues within %.2e of FE-ELL; lobpcg wall %.3f s; '
                  'BSR launches %s [%s]'
                  % (label, its, rel, agree, wall,
                     {'%s_%s' % k5: c for k5, c in launches.items()}, card))


def phase_stream_rate(mods, rows, card):
    """The stream-rate probe as a user calls it."""
    st = mods[2]
    reset_counters(mods)
    rate = st.stream_rate()
    launches = st.LAUNCHES['float32']
    if launches <= 0:
        fail('stream_rate skipped the stream kernel')
    rows['stream_scale_f32']['launches'] = launches
    print('stream_rate(): %.0f GB/s read + write over %d launches [%s]'
          % (rate / 1e9, launches, card))
    return rate


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    import numpy as np

    from raleigh_tpu_torch.examples import fe_model as fe
    from raleigh_tpu_torch.examples.laplace import lap3d
    from raleigh_tpu_torch.ops import _build
    from raleigh_tpu_torch.ops import spmm_pallas as sp
    from raleigh_tpu_torch.ops import spmm_window as sw
    from raleigh_tpu_torch.ops import stream as st
    from raleigh_tpu_torch.ops.spmm import BsrMatrix, DiaMatrix, EllMatrix

    profile = '--profile' in sys.argv[1:]
    mods = (sw, sp, st)
    card = phase_environment(torch, _build)
    rows = phase_kernels(torch, np, lap3d, DiaMatrix, sw)
    rows['stream_scale_f32'] = phase_stream(torch, st)
    t0 = time.perf_counter()
    pencils = (fe.shipsec_like(), fe.shipsec_like(relabel=False))
    print('shipsec_like() in both orderings: n=%d, nnz=%d, built in %.1f s'
          % (pencils[0][0].shape[0], pencils[0][0].nnz,
             time.perf_counter() - t0))
    rows.update(phase_bsr(torch, np, sp, BsrMatrix, EllMatrix, fe,
                          pencils[1][0], pencils[0][0]))
    phase_lap3d(torch, np, mods, rows, card, profile)
    phase_fe(torch, np, mods, rows, card, pencils, profile)
    rate = phase_stream_rate(mods, rows, card)
    loaded = sorted(m for m in sys.modules
                    if m.split('.')[0] in ('jax', 'jaxlib', 'raleigh_tpu'))
    if loaded:
        fail('modules of jax or of the JAX package were imported: %s'
             % loaded)
    for row in rows.values():
        if row['launches'] <= 0:
            fail('%s was launched no time on its path' % row['name'])
        nbytes = row.pop('bytes')
        print('%s: %.4f ms on %d launches; bound %.4f ms by %s at the data '
              'sheet, %.4f ms at the measured stream rate; plain %.4f ms; '
              'library %s [%s]'
              % (row['name'], row['ms'], row['launches'], row['bound_ms'],
                 row['bound_by'], nbytes / rate * 1e3, row['plain_ms'],
                 fmt_ms(row['library_ms']), card))
    print(card)
    print(json.dumps({'kernels': list(rows.values())}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
