#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raleigh_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Eight phases; any failure exits non-zero.  No phase catches a failure and
carries on, and no wrapper gives way to its plain version on the card.

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
     bf16 operands, and lap3d 50^3 (n = 125,000) with m = 24, through the
     kernel: equal to the plain version bit for bit, and timed in turns
     with it and the library call.  Two controls, the
     plain version with a bf16 running sum and with each product rounded
     to bf16, must fail the entrywise bf16 bound (one bf16 rounding on
     either side plus the f32 summation error bound, ``bf16_excess``).
   * The stream kernel ``y = a x`` on 32 x 1,277,952 f32, on an unaligned
     view and on a tail, against ``torch.mul``: exact equality; timed in
     turns with it.
     The kernel's rate is the card's stream rate as the port measures it.
   * BSR SpMM of the finite-element flagship in the mesher's order
     (``shipsec_like(relabel=False)``, n = 139,179, bs = 128, m = 16 and
     24) in the four instantiations (f32 or bf16 tiles, f32 or bf16
     operand), through the kernel, timed in turns with the plain version
     and the library calls; and of a small girder with n not a multiple of
     bs = 64 (the 16-byte path) or bs = 5 (the general path), m = 24 and
     one block row emptied.  Tolerance entrywise (``bsr_excess``): twice the
     f32 summation error bound of the entry's L terms, plus one rounding
     on either side for a bf16 result.  Two controls, a bf16 running sum
     over the tiles and bf16 products, must fail it.
   * The ELL kernel (``csrc/ell_spmm.cu``, in the JAX package a jitted
     ``lax.scan``) on the same flagship in both orderings (``phase_ell``):
     f32 values with an f32 operand at m = 8, 16, 32, a bf16 operand at
     m = 16, an f64 operand at m = 8 with f32 and with f64 values, and a
     c128 operand at m = 8 (the complex route, one f64 launch over the
     stacked rows).  Tolerance entrywise (``ell_excess``): twice the
     summation error bound of a row's K terms in the sum type, plus one
     bf16 rounding on either side for a bf16 result; the kernel sums in
     the plain version's order, so exact equality is reported as well.
     Two controls, a bf16 running sum and bf16 products, must fail the
     bound.  The kernel timed in turns with the plain version,
     ``torch.sparse.mm`` on the CSR tensor of the same type and the
     row-layout apply (the (n, m) copy of the operand, then the launch),
     with its registers a thread and resident blocks an SM.
   * The Chebyshev step kernel (``ell_step_kernel`` in
     ``csrc/ell_spmm.cu``: a degree step of the recurrence on an ELL
     matrix in one launch, ``phase_ell_step``) on the relabelled flagship
     at the two FE cells' shapes (f32 values with f32 iterates at m = 16,
     with f64 iterates at m = 8): a first, a middle and a last step equal
     to the recurrence's eager step (the ELL kernel and its passes) and to
     the plain step bit for bit; a middle step timed in turns with the
     eager step and the plain step, beside its byte bound.
   * The Gram kernel (``csrc/gram.cu``, ``phase_gram``) at the device
     LOBPCG's Grams, (16, 16), a self-Gram and (48, 48), at n = 1,280,000
     and 139,179: within the summation bound of its rounding chain of an
     f64 product (``gram_chain``), bit-equal across calls, timed in CUDA
     graphs in turns with the plain version and torch.matmul, with its
     registers; kernel and torch.matmul in turns at shorter n, which place
     the dispatch's crossover.  The Laplacian and FE-ELL solves below run
     every non-empty Gram in it.
   * The f64 instantiations of the DIA kernel (f64 operand, f32 or f64
     values) on lap3d(100,100,128), equal to the plain version bit for
     bit, and of the BSR kernel (f64 operand, f32 or f64 tiles) on the FE
     flagship in the mesher's order, within ``F64_SUM_TOL`` of the largest
     |entry| (f64 sums in another order), at the core fields' block size
     and at m = 16, timed in turns with the plain version and
     ``torch.sparse.mm`` on the f64 CSR tensor (the BSR kernel also with
     an f64 ``torch.sparse_bsr_tensor``).
   * The f64 instantiations of the mesh DIA kernel (f64 operand, f32 or
     f64 values) on lap3d(100,100,128) in 8 shards of the card at the core
     block size: one launch for a sharded apply, within ``F64_SUM_TOL`` of
     the largest |entry| of the plain version over the piece table and
     equal bit for bit to the unsharded f64 kernel; timed in turns with the
     plain version, the unsharded f64 kernel and ``torch.sparse.mm`` (f64).
   * The DIA kernel's complex instantiation on the complex field's B
     (c128 values, one launch an apply) and on B's pattern with real f64
     and f32 values, each timed in turns with the stacked route it
     replaced (``ops/complex_rows.py``: two f64 launches over the stacked
     real and imaginary rows for c128 values); the BSR kernel's complex
     route on the FE flagship (f32 tiles, one f64 launch over the stacked
     rows); c128 operands at the core block size, within ``F64_SUM_TOL``
     of the plain version on the complex tensors; timed in turns with it
     and ``torch.sparse.mm`` on the complex CSR.
   * The two staged-window DIA kernels (sliding window, tile ring) at the
     tile sweep's shape, lap3d(100,100,128) * 0.125 with m = 32 and m = 16 f32
     rows, at every tile size the sweep runs.  Tolerance entrywise
     (``window_excess``): twice the f32 summation error bound of the
     entry's terms; the control, a bf16 running sum, must fail it.  Both
     keep the plain version's order of summation, so exact equality is
     reported as well, with the launch plan of each kernel (cluster size,
     clusters that fit the card at once, rows per block, val chunk).  At
     the row tile the kernel, the plain version and K1 are timed in
     turns.
   * The tiled (per_step 1 and 4) and pipelined (depth 2 and 4) stream
     kernels on 32 x 1,277,952 f32 at every tile size the copy sweep runs,
     against ``torch.mul``: exact equality; the pipelined kernel timed in
     turns with ``torch.mul``.
   * The copy kernel: ``hbm2hbm`` on 32 x 1,277,952 f32 at tile 32,768 and
     as one tile, ``copy_lanes`` of a shard's halo (16 x 10,000 lanes out of
     16 x 160,000) and of its body into the slots of an extended operand,
     16-byte aligned and shifted by one element, and ``copy_lanes_many`` of
     all 24 copies that assemble 8 shards' extended operands in one launch
     (against the 24 ``copy_`` calls of its plain version and
     ``torch._foreach_copy_``), f32 and bf16: exact equality.
   * The mesh DIA kernel on lap3d(100,100,128) cut in 8 and in 2 shards,
     m = 16, f32 and bf16: one sharded apply as a user makes it is one
     launch and no copy; every shard, through the mesh entry, against
     the plain version over the piece table (``window_excess`` /
     ``bf16_excess``; the controls must fail), and
     equal to the unsharded kernel's apply, bit for bit.  Times of the
     kernel's wrapper, of the whole sharded apply and of the unsharded
     kernel, in turns.  The shards share the one card: no scaling
     measurement.
3. The main paths as a user calls them, with no device argument, each
   driven with every launch counter set to 0 just before it and read just
   after.
   Each solver field must take the iterations of the records
   (``ITERATIONS``).
   * ``partial_hevp`` with a degree-12 Chebyshev preconditioner on
     lap3d(100,100,128), 4 smallest to 5e-5, checked against the analytic
     eigenvalues (1e-3 relative) with both DIA launch counters > 0; then
     lap3d 50^3, 10 smallest, degree 16, to 1e-6 (1e-5 relative).
   * FE-ELL: the vibration pencil K x = lambda M x of ``shipsec_like()``
     through ``partial_hevp`` (degree-32 Chebyshev on [hi 1e-4, hi], 6
     smallest to 1e-4); both matrices land in ``EllMatrix``; 16
     iterations, ELL kernel and Chebyshev step kernel launches (f32
     only) > 0, no plain version of a kernel run, no BSR launch; then the same pencil through ``lobpcg``
     with bf16 Chebyshev iterates (the ELL kernel's bf16-operand
     instantiation), its eigenvalues within 1e-3 of FE-ELL's.
   * FE-BSR: the same mesh in the mesher's order through ``lobpcg`` on
     ``BsrMatrix(bs=128)`` operators, BSR launches > 0; then with bf16
     Chebyshev iterates and with bf16 tiles in the preconditioner, so that
     every instantiation of the kernel is driven.
   Both FE fields must end with status 0, meet
   ``max_j |K x_j - lambda_j M x_j| / (|K|_inf |x_j|)`` <= 1e-5 (2-norms
   of vectors, computed on the host in f64) and agree on the six
   eigenvalues to 1e-3 relative: the two orderings are one mesh.
   * The stream-rate probe ``ops.stream.stream_rate``.
   * The sharded main path: lap3d(100,100,128) with operator and blocks
     split over ``make_mesh(8)`` (eight shards of the one card), the
     preconditioner on the sharded matrix, through ``lobpcg(sharding=)``:
     status 0, the unsharded field's iterations, eigenvalues within 1e-3
     of the analytic ones and 1e-5 of the unsharded field's, exactly one
     mesh kernel launch per device per sharded apply, no copy launch, none
     of the one-piece entry or of the unsharded DIA kernel.
   * ``ShardedEllMatrix`` of ``shipsec_like()``'s stiffness matrix on the
     same mesh, m = 16: halo mode, one copy launch and one ELL launch a
     shard per product, within 1e-5 of SciPy and of ``EllMatrix``.
4. The two kernel-structure sweeps through their ``main``:
   ``benches.bench_window_tiles`` (ring, slide, tiles; m = 32, and m = 16
   for the staged kernels) and ``benches.bench_grid_shapes`` (blockspec,
   blockspec4, manual2, manual4, spans, torch, hbm2hbm) at full size;
   then ``benches.bench_spmm_sharded`` at its default size,
   ``benches.bench_launch_cost`` and ``graft_entry.dryrun_multichip(8)``
   (its Solver parts on sharded ``dense_torch`` blocks included; one mesh
   kernel launch per device per sharded apply, no copy launch).
5. The core phase: the block Jacobi-CG Solver under ``partial_hevp`` at
   the JAX package's f64 flagship sizes, on the card, with every launch
   counter set to 0 before each field and no plain version of a kernel
   run anywhere in the phase:
   * lap3d 50^3 shift-invert (sigma 0, 10 smallest; ``bench.py:146-182``):
     within 1e-6 of the analytic eigenvalues; set-up, solve, iterations,
     the link probe's orchestration (it must be 'device') and the host
     transfers;
   * the FE flagship ``shipsec_like()`` shift-invert (6 nearest 0, tol
     1e-6; ``bench.py:460-488``): max|K x - x lambda| / 0.25 <= 1e-5;
   * buckling ``buckling_64k()`` (sigma -0.08, 3 load factors, tol 1e-5;
     ``bench.py:498-530``): within 1e-8 of the same call with
     ``arch='cpu'`` (the host algebra) in the same run;
   * ``engine='core'`` on lap3d(100,100,128), 4 smallest, tol 5e-5,
     Chebyshev of degree 12 (``bench.py:581-611``), cold and warm: error
     <= 1e-3, f64 DIA kernel launches (f32 and f64 values) > 0 per solve,
     host transfers per iteration;
   * ``engine='core'`` on the FE flagship in the mesher's order, 6
     smallest, tol 1e-4, with a degree-32 Chebyshev on a ``BsrMatrix``:
     the residual limit of the FE fields, f64 BSR kernel launches > 0
     (with ``--profile``, the f64 BSR kernel's share of device time).
   * Core 5b: the same on the relabelled flagship with its own Chebyshev,
     which lands in ``EllMatrix``: the residual limit, launches > 0 of the
     ELL kernel's f64 x f64 instantiation (the operator's f64 values) and
     of the Chebyshev step kernel's f32 x f64 one (the recurrence's f32
     values), and none of the ELL kernel's f32 x f64 one.
   Every core field prints its ELL launches (core 3's and core 5's
   operator K is ELL).
   * Sharded core 4: core 4's problem on the ``Solver`` with f64
     ``dense_torch`` blocks split over ``make_mesh(8)`` and over
     ``make_mesh2d(2, 4)`` (eight shards of the card), the operator and
     Chebyshev that ``partial_hevp(engine='core')`` builds split by
     ``shard_operator``; cold and warm: status 0, error <= 1e-3, within
     1e-6 of core 4's eigenvalues, the f64 mesh kernel launched for both
     value types once per device per sharded apply, no other kernel, no
     plain version.
   * Complex: generalized shift-invert of the complex Hermitian chain of
     ``tests/test_sparse.py:175`` at n = 125,000 with B = I + 0.25 H, sigma
     0.3, 4 nearest, on the card (B's c128 DIA values through the DIA
     kernel's complex instantiation, no launch of the stacked route)
     against the same call with ``arch='cpu'``: within 1e-8; no plain
     version.
6. The dense phase: the SVD/PCA stack as a user calls it, with no device
   argument.
   * The headline, ``subspace_pca(a, 800, fetch=False)`` on bench.py's
     matrix (``make_data``, bench.py:46-66: 12,000 x 39,375 f32, rank-2048
     factors with k^-0.75 decay, a first column of ones, noise 1e-5) made
     on the card from a seeded generator: a warm-up at full shape with
     another seed, then the timed run; bench.py's checks
     (``_verify_pca``): orthonormality of the leading 64 components
     <= 1e-2 and relative Frobenius error <= 0.30, both failures here.  The
     wall time beside the Gram's f32 bound (2 M^2 N FLOP at 67 TFLOP/s).
   * ``subspace_pca_tol(a, 0.25, max_npc=1200)``, warm then timed: the
     rank, the wall, and the error within its tolerance.
   * ``pca(sub, npc=100, method='jacobi')`` on ``a[:3000, :10000]``
     (bench.py:416-440; warm on ``a[:3000, 10000:20000]``), the device
     Jacobi engine: Frobenius error within 1.02x of the optimal rank-100
     truncation (host SVD in f64); iterations, restarts and wall.
   * ``truncated_svd(generate(3000, 2000, 1000), nsv=300)``: all 300
     singular values within 1e-3 relative of the host SVD, at the default
     iteration limit, in f64 and f32 on the device Jacobi engine and in
     f32 on the core Solver with blocks on the card; iterations, restarts
     and walls.
   * ``partial_hevp(engine='jacobi')`` on lap3d 50^3, 10 smallest, tol 1e-6,
     Chebyshev degree 16, f64: status 0, within 1e-5 of the analytic
     eigenvalues, the DIA kernel launched (counters set to 0 before each
     solve) and no plain version of a kernel called; iterations and
     restarts.
   * Dense 1 again with the matrix split along its features over 8 shards
     of the card (``matrix_sharding``): ``_verify_pca``'s limits, and mean
     within 1e-4 and ``trans @ comps`` within 1e-3 of dense 1's.
   With ``--profile``, each of the first three also one warm run under the
   profiler, its device time split into GEMM, QR, eigh/SVD and the rest,
   and the host's share.
7. ``examples.eigenimages.run()`` at its synthetic default (12,000 x
   39,375 made on the card, npc 800), its factors saved to a temporary
   directory and held to ``_verify_pca``'s checks.
8. No module of jax or of the JAX package was loaded.

The last line is {"ok": true, "device": {...}}; the line before it lists
each kernel's launches on its path, error against plain, times and bound
(the mesh rows also the time of a whole sharded apply and of the
unsharded kernel beside it; a case of a kernel that no path runs keeps 0
launches, with ``off_path`` saying why).

    python3 chip_smoke.py --profile

adds, after each main-path field, a profile of one warm solve (device time
by kernel, the device's busy share) and, for the lap3d fields, the same
solve with f32 Chebyshev iterates.
"""

import contextlib
import ctypes
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
SLIDE = ('raleigh_tpu_torch/csrc/dia_spmm_slide.cu',
         'raleigh_tpu/ops/spmm_window.py:224')
TILES = ('raleigh_tpu_torch/csrc/dia_spmm_tiles.cu',
         'raleigh_tpu/ops/spmm_window.py:354')
TILED = ('raleigh_tpu_torch/csrc/stream_probes.cu',
         'benches/bench_grid_shapes.py:36')
PIPELINED = ('raleigh_tpu_torch/csrc/stream_probes.cu',
             'benches/bench_grid_shapes.py:58')
COPY = ('raleigh_tpu_torch/csrc/copy_lanes.cu',
        'benches/bench_grid_shapes.py:119')
EXT = ('raleigh_tpu_torch/csrc/dia_spmm_ext.cu',
       'raleigh_tpu/ops/spmm_window.py:527')
# not a Pallas kernel: the JAX package's ELL apply, a jitted lax.scan
ELL = ('raleigh_tpu_torch/csrc/ell_spmm.cu', 'raleigh_tpu/ops/spmm.py:463')
# iterations of each solver field as the records have them (whole chunks
# of 16 between host checks)
ITERATIONS = {(100, 100, 128): 32, (50, 50, 50): 16, 'FE-BSR': 16,
              'FE-ELL': 16, 'sharded': 32}
# sources whose kernels were redesigned on the card: phase 1 prints each
# kernel's registers, static shared memory and spills
REDESIGNED = ('dia_spmm', 'bsr_spmm', 'stream_scale', 'stream_probes',
              'dia_spmm_slide', 'dia_spmm_tiles', 'ell_spmm', 'gram')
# the sharded main path: shards of the one card, and its field
SHARDS = 8
SHARDED_AGREE = 1e-5
# the tile each staged-window and stream-probe row of the kernels line is
# timed at (every tile of the sweeps is held against the plain version)
ROW_TILE = {'slide': 4096, 'tiles': 10240, 'tiled': 1024, 'pipelined': 8192}
# data-sheet peaks of one H100 SXM: HBM3 bytes/s, f32 flop/s outside the
# tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# and f64 outside the tensor cores (the f64 DIA kernel's operations), and
# on them (the f64 BSR kernel's: mma.sync m16n8k4 runs at this rate)
PEAK_F64 = 34e12
PEAK_F64_MMA = 67e12
# the core Solver's block size on the core fields (which = 4 and 6: the
# Solver's default block size policy, a multiple of 8)
CORE_BLOCK = 8
# the sharded core field: its eigenvalues against the unsharded core 4's
# in the same run (relative)
MESH_CORE_AGREE = 1e-6
# the complex field: the chain of tests/test_sparse.py:175 at core 1's
# size, its shift, and the agreement with the same call on the host
COMPLEX_N = 125000
COMPLEX_SIGMA = 0.3
COMPLEX_AGREE = 1e-8
# the f64 BSR kernel sums in another order than its plain version: at most
# this share of the largest |entry| apart (f64 sums of ~3,000 terms)
F64_SUM_TOL = 1e-12
# core fields: the FE flagship's residual limit (bench.py:475-478), the
# buckling load factors' agreement with the host run, the shift-invert
# eigenvalue limit (bench.py:146-182)
FE_SHIFT_INVERT_LIMIT = 1e-5
BUCKLING_AGREE = 1e-8
SHIFT_INVERT_LIMIT = 1e-6
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


def time_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` launches on the card: the
    port's one timer (CUDA events after a warm-up)."""
    from raleigh_tpu_torch.benches.timing import time_ms as timer
    return timer(fn, reps)


def in_turns(kern, plain, reps):
    """(kernel ms, plain ms): the best of two timings each, taken in
    turns plain, kernel, kernel, plain."""
    tp1 = time_ms(plain, reps)
    tk1 = time_ms(kern, reps)
    tk2 = time_ms(kern, reps)
    tp2 = time_ms(plain, reps)
    return min(tk1, tk2), min(tp1, tp2)


def bound(nbytes, flops, peak=PEAK_F32):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    to move ``nbytes`` or to do ``flops`` operations (f32 unless ``peak``
    says otherwise), whichever is larger, at the data-sheet peaks."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (tb, 'bytes') if tb >= tf else (tf, 'operations')


def turns(fns, reps):
    """{name: ms} for a dict of callables, each timed twice, in turns: in
    the dict's order, then in the reverse order (plain, kernel, library,
    library, kernel, plain, ...); the best of the two.  An entry that is
    None stays None."""
    names = [k for k, fn in fns.items() if fn is not None]
    best = {k: None for k in fns}
    for k in names + names[::-1]:
        t = time_ms(fns[k], reps)
        best[k] = t if best[k] is None else min(best[k], t)
    return best


def library_spmm_fn(torch, csr, x, dtype='float32'):
    """``torch.sparse.mm`` of the CSR tensor (values in ``dtype``, f32
    unless the kernel's operand is f64) of the scipy matrix ``csr`` with
    the (n, m) operand ``x.T``, as a callable: the one PyTorch call that
    computes an SpMM kernel's function.  None (with a note) if this torch
    cannot do it: a measurement, not a gate."""
    try:
        a = torch.sparse_csr_tensor(
            torch.from_numpy(csr.indptr.astype('int64')),
            torch.from_numpy(csr.indices.astype('int64')),
            torch.from_numpy(csr.data.astype(dtype)),
            size=csr.shape, device='cuda')
        xt = x.to(a.dtype).T.contiguous()
        torch.sparse.mm(a, xt)
        return lambda: torch.sparse.mm(a, xt)
    except (RuntimeError, NotImplementedError) as e:
        print('  torch.sparse.mm on a CSR tensor is not available: %s'
              % str(e).splitlines()[0])
        return None


def library_bsr_fn(torch, bm, x):
    """One PyTorch product of ``bm``'s own tiles as a
    ``torch.sparse_bsr_tensor`` (padded to whole tiles) with the padded
    (n_padded, m) operand, both in ``x``'s dtype, as a callable: the BSR
    kernel's function on the same tiles.  None (with a note) if this torch
    cannot do it: a measurement, not a gate."""
    try:
        a = torch.sparse_bsr_tensor(
            bm.block_indptr_t.long(), bm.block_cols.long(),
            bm.blocks.to(x.dtype), size=(bm.n_padded, bm.n_padded))
        xt = torch.nn.functional.pad(
            x, (0, bm.n_padded - x.shape[1])).T.contiguous()
        a @ xt
        return lambda: a @ xt
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
    for stem in REDESIGNED:
        for fn, res in ptxas_resources(rep['logs'][stem]).items():
            print('  %s %s: %s registers, %s bytes static shared memory, '
                  'spill stores %s / loads %s bytes' % (
                      stem, fn, res.get('registers', '?'),
                      res.get('smem', 0), res.get('spill_stores', '?'),
                      res.get('spill_loads', '?')))
    return card


def ptxas_resources(log):
    """{kernel: {'registers', 'smem', 'spill_stores', 'spill_loads'}} from
    one source's ``-Xptxas -v`` output, kernels by their demangled name
    (``c++filt`` where it exists; the mangled one otherwise)."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m and fn:
            out[fn].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = re.search(r'Used (\d+) registers', line)
        if m and fn:
            out[fn]['registers'] = int(m.group(1))
            sm = re.search(r'(\d+) bytes smem', line)
            out[fn]['smem'] = int(sm.group(1)) if sm else 0
    try:
        names = subprocess.run(['c++filt'], input='\n'.join(out),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.split('\n')
    except (OSError, subprocess.SubprocessError):
        return out
    short = [re.sub(r'^void |\(.*', '',
                    name.replace('(anonymous namespace)::', ''))
             for name in names]
    return dict(zip(short, out.values()))


def bf16_excess(torch, sw, val, x, offsets, got, want, terms=None):
    """Entrywise |got - want| over the bound for two bf16 DIA applies that
    both sum in f32 and round once to bf16: one bf16 rounding on either
    side (2^-7 |want|) plus twice the f32 summation error bound
    (noff 2^-24 sum_k |val_k x|).  At most 1 where ``got`` accumulates in
    f32 in any order; a bf16 sum or bf16 products miss it by orders of
    magnitude.  ``terms``: sum_k |val_k x| where the caller has it (an
    extended operand).  Returns (largest ratio, share of entries above
    1)."""
    if terms is None:
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
    """The DIA kernel and the plain version at the main path's shapes,
    equal bit for bit, timed in turns with the library call; returns the
    kernel's rows at the lap3d(100,100,128) shape, the lap3d 50^3 m = 24
    times as extra keys."""
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
        key = str(dt).replace('torch.', '')
        if yk.dtype != dt or yk.shape != (m, n):
            fail('kernel output %s %s' % (yk.dtype, tuple(yk.shape)))
        if not torch.isfinite(yk.float()).all():
            fail('kernel vs plain %s %s m=%d: non-finite' % (grid, key, m))
        # the kernel keeps the plain version's products and order of sums
        if not torch.equal(yk, yp):
            fail('kernel vs plain %s %s m=%d: not equal bit for bit (max '
                 'abs %.3e)' % (grid, key, m,
                                (yk.float() - yp.float()).abs().max()))
        diff = 0.0
        if dt == torch.bfloat16:
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
        del yk, yp
        fns = {'plain': lambda: sw.dia_matmat_rows_plain(dm.val, x,
                                                         dm.offsets_t),
               'kernel': lambda: sw.dia_matmat_rows(dm.val, x, dm.offsets_t),
               'library': (library_spmm_fn(torch, csrs[grid], x)
                           if dt == torch.float32 else None)}
        t = turns(fns, 50)
        noff = len(dm.offsets)
        nbytes = noff * n * 4 + noff * 4 + 2 * m * n * x.element_size()
        flops = 2 * m * sum(n - abs(o) for o in dm.offsets)
        bound_ms, bound_by = bound(nbytes, flops)
        print('dia_spmm lap3d%s n=%d m=%d %s: equal to plain bit for bit; '
              'kernel %.4f ms (%.0f GB/s); plain %.4f ms, torch.sparse.mm '
              '%s, bound %.4f ms (%s), in turns'
              % (grid, n, m, key, t['kernel'], nbytes / t['kernel'] / 1e6,
                 t['plain'], fmt_ms(t['library']), bound_ms, bound_by))
        name = 'dia_spmm_rows_' + ('f32' if key == 'float32' else 'bf16')
        if grid == (100, 100, 128):
            rows[name] = dict(
                name=name, route='cuda', source=DIA[0], replaces=DIA[1],
                launches=0, max_abs_err=diff, ms=t['kernel'],
                plain_ms=t['plain'], bound_ms=bound_ms, bound_by=bound_by,
                library_ms=t['library'], bytes=nbytes)
        else:
            rows[name]['lap3d50_m24_ms'] = t['kernel']
    return rows


def phase_stream(torch, st):
    """The stream kernel against ``torch.mul`` (exact equality) at the
    reference's shape, on an unaligned view and on a tail, timed in turns
    with ``torch.mul``; returns the kernel's row.  The kernel's rate is
    the card's stream rate as the port measures it."""
    gen = torch.Generator('cuda').manual_seed(1)
    x = torch.randn(st.REFERENCE_SHAPE, generator=gen, device='cuda')
    a = st.REFERENCE_SCALE
    # an unaligned view takes the 4-byte path and the scalar tail
    odd = x.reshape(-1)[1:1000004]
    yp = st.stream_scale_plain(x, a)
    yk = st.stream_scale(x, a)
    torch.cuda.synchronize()
    diff = (yk - yp).abs().max().item()
    if not torch.equal(yk, yp):
        fail('stream kernel differs from torch.mul (max abs %.3e)' % diff)
    if not torch.equal(st.stream_scale(odd.clone(), a),
                       st.stream_scale_plain(odd, a)):
        fail('stream kernel differs from torch.mul on an odd length')
    del yk, yp
    t = turns({'plain': lambda: st.stream_scale_plain(x, a),
               'kernel': lambda: st.stream_scale(x, a)}, 50)
    nbytes = 2 * x.numel() * 4
    bound_ms, bound_by = bound(nbytes, x.numel())
    print('stream_scale %s f32: kernel equal to torch.mul; kernel %.4f ms '
          '(%.0f GB/s); torch.mul %.4f ms (%.0f GB/s), bound %.4f ms (%s), '
          'in turns'
          % (tuple(x.shape), t['kernel'], nbytes / t['kernel'] / 1e6,
             t['plain'], nbytes / t['plain'] / 1e6, bound_ms, bound_by))
    return {'stream_scale_f32': dict(
        name='stream_scale_f32', route='cuda', source=STREAM[0],
        replaces=STREAM[1], launches=0, max_abs_err=diff, ms=t['kernel'],
        plain_ms=t['plain'], bound_ms=bound_ms, bound_by=bound_by,
        library_ms=t['plain'], bytes=nbytes)}


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
    finiteness and the entrywise bound; returns (max abs error, worst ratio
    to the bound, the plain version's result)."""
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


def phase_bsr(torch, np, sp, BsrMatrix, fe, k_nat):
    """The BSR kernel against the plain version: the flagship in the
    mesher's order in the four instantiations at m = 16 and m = 24, with
    controls and times in turns, and awkward small shapes (the 16-byte
    path and the general path).  Returns the kernel's rows."""
    rows = {}
    gen = torch.Generator('cuda').manual_seed(2)
    n = k_nat.shape[0]
    xs = {m: torch.randn((m, n), generator=gen, device='cuda')
          for m in (16, 24)}
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
    for bkey in ('f32', 'bf16'):
        for xkey in ('f32', 'bf16'):
            bm = mats[bkey]
            name = 'bsr_spmm_rows_%s_%s' % (bkey, xkey)
            for m in (16, 24):
                x = xs[m] if xkey == 'f32' else xs[m].to(torch.bfloat16)
                label = '%s m=%d' % (name, m)
                diff, worst, yp = check_bsr(torch, sp, bm, x, label)
                if bkey == 'f32' and m == 16:
                    for cname, yc in bsr_controls(torch, bm, x).items():
                        cworst, cshare = bsr_excess(torch, sp, bm, x, yc, yp)
                        print('  control (%s) vs plain, %s: %.4f of the '
                              'entries beyond the bound (worst %.1f times '
                              'it)' % (cname, label, cshare, cworst))
                        if cworst <= 1:
                            fail('the BSR bound passes the control (%s)'
                                 % cname)
                del yp
                # the library calls: the f32 CSR product, and the product
                # of the same tiles as a sparse BSR tensor, which torch
                # takes in one type for tiles and operand, not a mixed pair
                fns = {
                    'plain': lambda: sp.bsr_matmat_rows_plain(
                        bm.blocks, bm.block_indptr_t, bm.block_cols, x, n),
                    'kernel': lambda: bm.matmat_rows(x),
                    'csr': (library_spmm_fn(torch, k_nat, x)
                            if (bkey, xkey) == ('f32', 'f32') else None),
                    'bsr_tensor': (library_bsr_fn(torch, bm, x)
                                   if bkey == xkey else None)}
                t = turns(fns, 20)
                del fns
                nbytes = (bm.blocks.numel() * bm.blocks.element_size()
                          + 4 * (bm.block_cols.numel() + bm.nb + 1)
                          + 2 * m * n * x.element_size())
                flops = 2 * bm.blocks.numel() * m
                bound_ms, bound_by = bound(nbytes, flops)
                lib = min((v for v in (t['csr'], t['bsr_tensor'])
                           if v is not None), default=None)
                print('%s n=%d: max abs err %.3e (worst %.3f of the bound), '
                      'kernel %.4f ms (%.0f GB/s, %.2f Gnnz/s); plain %.4f '
                      'ms, torch.sparse.mm on CSR %s, sparse_bsr_tensor '
                      'product %s, bound %.4f ms (%s), in turns'
                      % (label, n, diff, worst, t['kernel'],
                         nbytes / t['kernel'] / 1e6, bm.nnz / t['kernel'] / 1e6,
                         t['plain'], fmt_ms(t['csr']),
                         fmt_ms(t['bsr_tensor']), bound_ms, bound_by))
                if m == 16:
                    rows[name] = dict(
                        name=name, route='cuda', source=BSR[0],
                        replaces=BSR[1], launches=0, max_abs_err=diff,
                        ms=t['kernel'], plain_ms=t['plain'],
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=lib, bytes=nbytes)
                else:
                    rows[name]['m24_ms'] = t['kernel']
    del mats, bm, xs

    # awkward shapes: n not a multiple of bs, m past one row group, one
    # block row emptied; bs = 64 takes the 16-byte path, bs = 5 the
    # general one
    import scipy.sparse as scs
    for bs in (64, 5):
        small = fe.fe_pencil(10, 3, 0.15, seed=5, which='k')
        ns = small.shape[0]
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
    return rows


def library_ell_fn(torch, csr, xt, dtype):
    """``torch.sparse.mm`` of ``csr`` as a CSR tensor of ``dtype`` (a torch
    dtype name) with the (n, m) operand ``xt`` in the same dtype, as a
    callable; None (with a note) if this torch cannot do it."""
    try:
        a = torch.sparse_csr_tensor(
            torch.from_numpy(csr.indptr.astype('int64')),
            torch.from_numpy(csr.indices.astype('int64')),
            torch.from_numpy(csr.data.astype(
                'float64' if dtype == 'bfloat16' else dtype)).to(
                    getattr(torch, dtype)),
            size=csr.shape, device='cuda')
        xl = xt.to(a.dtype).contiguous()
        torch.sparse.mm(a, xl)
        return lambda: torch.sparse.mm(a, xl)
    except (RuntimeError, NotImplementedError, TypeError) as e:
        print('  torch.sparse.mm on a %s CSR tensor is not available: %s'
              % (dtype, str(e).splitlines()[0]))
        return None


# the ELL kernel's cases in phase_ell: (row name, value dtype, operand
# dtype, m, the library call's CSR dtype); the first m of a name is the
# main path's shape and gives its row
ELL_CASES = (
    ('ell_spmm_f32_f32', 'float32', 'float32', 16, 'float32'),
    ('ell_spmm_f32_f32', 'float32', 'float32', 8, 'float32'),
    ('ell_spmm_f32_f32', 'float32', 'float32', 32, 'float32'),
    ('ell_spmm_f32_bf16', 'float32', 'bfloat16', 16, 'bfloat16'),
    ('ell_spmm_f32_f64', 'float32', 'float64', CORE_BLOCK, 'float64'),
    ('ell_spmm_f64_f64', 'float64', 'float64', CORE_BLOCK, 'float64'),
    ('ell_spmm_complex_f32_f64', 'float32', 'complex128', CORE_BLOCK,
     'complex128'))


def phase_ell(torch, np, ell, EllMatrix, k_rel, k_nat):
    """The ELL kernel (``csrc/ell_spmm.cu``) against the plain version on
    the FE flagship in both orderings (the FE-ELL field's relabelled order
    first, then the mesher's), every instantiation (``ELL_CASES``), the
    complex route (a c128 operand over f32 values: one launch of the f64
    instantiation over the stacked rows) included.  Tolerance entrywise
    (``ell_excess``): twice the summation error bound of a row's K terms
    in the sum type (plus one bf16 rounding on either side for a bf16
    result); whether the kernel also equals the plain version bit for bit
    (it sums in its order, one FMA a term) is printed.  At f32, m = 16 two
    controls (a bf16 running sum, bf16 products) must fail the bound.  The
    kernel ((n, m) operand and result: the launch alone), the plain
    version and ``torch.sparse.mm`` on the CSR tensor are timed in turns,
    the row-layout apply a solver makes (the (n, m) copy of its operand,
    then the launch) beside them; the kernel's registers a thread and
    resident blocks an SM at the shape are printed.  Returns the kernel's
    rows, those of the relabelled order."""
    rows = {}
    gen = torch.Generator('cuda').manual_seed(21)
    for order, k in (('relabelled', k_rel), ("mesher's order", k_nat)):
        mats = {'float32': EllMatrix(k, device='cuda'),
                'float64': EllMatrix(k, dtype=np.float64, device='cuda',
                                     exact=True)}
        em = mats['float32']
        n, kk = em.idx.shape
        print('ELL flagship, %s: n=%d nnz=%d, row degree %d, %.1f MB of '
              'f32 idx + val' % (order, n, em.nnz, kk,
                                 em.idx.numel() * 8 / 1e6))
        for name, vdt, xdt, m, libdt in ELL_CASES:
            em = mats[vdt]
            idx, val = em.idx, em.val
            x64 = torch.randn((n, m), generator=gen, device='cuda',
                              dtype=torch.float64)
            if xdt == 'complex128':
                xt = torch.complex(x64, torch.randn(
                    (n, m), generator=gen, device='cuda',
                    dtype=torch.float64))
            else:
                xt = x64.to(getattr(torch, xdt))
            del x64
            label = '%s m=%d (%s)' % (name, m, order)
            cplx = xdt == 'complex128'
            key = (('f32', 'f64', 'complex') if cplx else
                   (vdt.replace('float', 'f'),
                    xdt.replace('float', 'f').replace('bfloat16', 'bf16')))
            before = ell.ELL_LAUNCHES[key]
            got = ell._ell_matmat(idx, val, xt)
            torch.cuda.synchronize()
            if ell.ELL_LAUNCHES[key] - before != 1:
                fail('%s: %d launches under %s for one apply, not 1'
                     % (label, ell.ELL_LAUNCHES[key] - before, key))
            want = ell._ell_matmat_plain(idx, val, xt)
            if got.dtype != xt.dtype or got.shape != xt.shape:
                fail('%s: kernel output %s %s' % (label, got.dtype,
                                                  tuple(got.shape)))
            if not torch.isfinite(torch.view_as_real(got) if got.is_complex()
                                  else got.float()).all():
                fail('%s: non-finite kernel output' % label)
            worst, share = ell_excess(torch, ell, idx, val, xt, got, want)
            if worst > 1:
                fail('%s: %.3e of the entries beyond the bound (worst %.2f '
                     'times it)' % (label, share, worst))
            diff = (got - want).abs().max().item()
            equal = torch.equal(got, want)
            if name == 'ell_spmm_f32_f32' and m == 16:
                for cname, yc in ell_controls(torch, idx, val, xt).items():
                    cworst, cshare = ell_excess(torch, ell, idx, val, xt, yc,
                                                want)
                    print('  control (%s) vs plain, %s: %.4f of the entries '
                          'beyond the bound (worst %.1f times it)'
                          % (cname, label, cshare, cworst))
                    if cworst <= 1:
                        fail('the ELL bound passes the control (%s)' % cname)
            del got, want
            x_rows = xt.T.contiguous()
            t = turns({
                'plain': lambda: ell._ell_matmat_plain(idx, val, xt),
                'kernel': lambda: ell._ell_matmat(idx, val, xt),
                'rows': lambda: ell._ell_matmat_rows(idx, val, x_rows),
                'library': library_ell_fn(torch, k, xt, libdt)}, 20)
            del x_rows
            width = 2 * m if xt.is_complex() else m
            nbytes = (idx.numel() * 4 + val.numel() * val.element_size()
                      + 2 * n * m * xt.element_size())
            wide = xdt in ('float64', 'complex128')
            bound_ms, bound_by = bound(nbytes, 2 * n * kk * width,
                                       PEAK_F64 if wide else PEAK_F32)
            # a complex apply launches the f64 instantiation on 2m rows
            pair, mk = (('f32', 'f64'), 2 * m) if cplx else (key, m)
            fit = ell.ell_occupancy(*pair, mk)
            print('%s n=%d: max abs err %.3e (worst %.3f of the bound; %s '
                  'plain bit for bit); kernel %.4f ms (%.0f GB/s, %.2f '
                  'Gnnz/s), row-layout apply (copy and launch) %.4f ms; '
                  'plain %.4f ms (%.1fx), torch.sparse.mm on %s CSR %s, '
                  'bound %.4f ms (%s), in turns; %d registers, %d blocks of '
                  '%d threads an SM, %d bytes local'
                  % (label, n, diff, worst,
                     'equal to' if equal else 'not equal to', t['kernel'],
                     nbytes / t['kernel'] / 1e6, em.nnz / t['kernel'] / 1e6,
                     t['rows'], t['plain'], t['plain'] / t['kernel'], libdt,
                     fmt_ms(t['library']), bound_ms, bound_by,
                     fit['registers'], fit['blocks_per_sm'], fit['threads'],
                     fit['local_bytes']))
            if name in rows and order == 'relabelled':
                rows[name]['m%d_ms' % m] = t['kernel']
            elif name in rows:
                rows[name].setdefault('mesher_order_ms', t['kernel'])
            else:
                rows[name] = dict(
                    name=name, route='cuda', source=ELL[0],
                    replaces=ELL[1], launches=0, max_abs_err=diff,
                    ms=t['kernel'], plain_ms=t['plain'], bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=t['library'], m=m,
                    rows_ms=t['rows'], bytes=nbytes,
                    registers=fit['registers'],
                    blocks_per_sm=fit['blocks_per_sm'])
            del xt
        del mats, em, idx, val
        torch.cuda.empty_cache()
    rows['ell_spmm_f32_f64']['off_path'] = (
        'the f32 x f64 applies are the Chebyshev recurrence\'s, whose '
        'steps run in the step kernel (ell_step_f32_f64); held against '
        'its plain version above')
    rows['ell_spmm_complex_f32_f64']['off_path'] = (
        'no field here has a complex block on an ELL operator (the complex '
        'field\'s B is tridiagonal, so DIA); the route is held against its '
        'plain version above')
    return rows


# the Chebyshev step kernel's cases in phase_ell_step: (row name, value
# dtype, iterate dtype, m), the finite-element cells' shapes
ELL_STEP_CASES = (('ell_step_f32_f32', 'float32', 'float32', 16),
                  ('ell_step_f32_f64', 'float32', 'float64', CORE_BLOCK))


def eager_step(ell, idx, val, d, r, y, c1, c2, first, last):
    """The Chebyshev recurrence's own eager step
    (``algebra/sparse.py::_eager_step``) on (m, n) blocks with the ELL
    apply (the (n, m) copy and the ELL kernel, then the passes): (d', r',
    y'), None where the last step leaves it."""
    from raleigh_tpu_torch.algebra.sparse import _eager_step
    d, r, y = _eager_step(lambda ops, x: ell._ell_matmat_rows(*ops, x),
                          (idx, val), d, r, None if first else y, c1, c2)
    return (None, None, y) if last else (d, r, y)


def phase_ell_step(torch, np, ell, EllMatrix, k_rel):
    """The Chebyshev step kernel (``ell_step_kernel`` in
    ``csrc/ell_spmm.cu``) on the FE flagship in the field's (relabelled)
    order at the two cells' shapes (``ELL_STEP_CASES``): a first, a middle
    and a last step equal to the eager step (``eager_step``) and to the
    plain step bit for bit, one launch each; then a middle step timed in
    turns with the eager step it replaces (the ELL kernel and its passes)
    and the plain step, beside its byte bound: A's nonzeros as values and
    int32 columns, the row pointer, d read, r and y read and written, d'
    written.  Returns the kernel's rows."""
    rows = {}
    em = EllMatrix(k_rel, device='cuda')
    idx, val = em.idx, em.val
    n = em.shape[0]
    gen = torch.Generator('cuda').manual_seed(25)
    c1, c2 = 0.8123456789012345, 1.2345678901234567
    for name, vdt, xdt, m in ELL_STEP_CASES:
        dtype = getattr(torch, xdt)
        key = ('f32', xdt.replace('float', 'f'))
        label = '%s m=%d' % (name, m)
        d, r, y = (torch.randn((m, n), generator=gen, device='cuda',
                               dtype=torch.float64).to(dtype)
                   for _ in range(3))
        for first, last in ((True, False), (False, False), (False, True)):
            want = eager_step(ell, idx, val, d, r, y, c1, c2, first, last)
            outs = []
            for step in (ell._ell_step, ell._ell_step_plain):
                dt, rt, yt = (t.T.contiguous() for t in (d, r, y))
                d_next = torch.full_like(dt, float('nan'))
                before = ell.ELL_STEP_LAUNCHES[key]
                step(idx, val, dt, d_next, rt, yt, c1, c2, first, last)
                launched = ell.ELL_STEP_LAUNCHES[key] - before
                if launched != (step is ell._ell_step):
                    fail('%s: %d launches counted for one step'
                         % (label, launched))
                outs.append((None, None, yt.T) if last
                            else (d_next.T, rt.T, yt.T))
            torch.cuda.synchronize()
            for got, what in zip(outs, ('kernel', 'plain step')):
                for g, w in zip(got, want):
                    if (g is None) != (w is None) or (
                            g is not None and not torch.equal(g, w)):
                        fail('%s (first %s, last %s): the %s is not the '
                             'eager step bit for bit'
                             % (label, first, last, what))
        dt, rt, yt = (t.T.contiguous() for t in (d, r, y))
        d_next = torch.empty_like(dt)
        t = turns({
            'plain': lambda: ell._ell_step_plain(idx, val, dt, d_next, rt,
                                                 yt, c1, c2, False, False),
            'kernel': lambda: ell._ell_step(idx, val, dt, d_next, rt, yt,
                                            c1, c2, False, False),
            'eager': lambda: eager_step(ell, idx, val, d, r, y, c1, c2,
                                        False, False)}, 20)
        size = torch.tensor([], dtype=dtype).element_size()
        nbytes = (em.nnz * (val.element_size() + 4) + (n + 1) * 4
                  + 6 * n * m * size)
        bound_ms, bound_by = bound(nbytes, 2 * em.nnz * m + 6 * n * m,
                                   PEAK_F64 if size == 8 else PEAK_F32)
        print('%s n=%d: equal to the eager step and to the plain step bit '
              'for bit (first, middle, last); kernel %.4f ms (%.0f GB/s, '
              '%.1f%% of the bound), eager step (copy, ELL kernel, passes) '
              '%.4f ms (%.2fx), plain step %.4f ms, bound %.4f ms (%s, '
              '%.1f MB), in turns'
              % (label, n, t['kernel'], nbytes / t['kernel'] / 1e6,
                 100 * bound_ms / t['kernel'], t['eager'],
                 t['eager'] / t['kernel'], t['plain'], bound_ms, bound_by,
                 nbytes / 1e6))
        rows[name] = dict(
            name=name, route='cuda', source=ELL[0],
            replaces='none: the eager Chebyshev step on an ELL matrix',
            launches=0, max_abs_err=0.0, ms=t['kernel'],
            plain_ms=t['plain'], eager_ms=t['eager'], bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None, m=m, bytes=nbytes)
        del d, r, y, dt, rt, yt, d_next
    del em, idx, val
    torch.cuda.empty_cache()
    return rows


GRAM = ('raleigh_tpu_torch/csrc/gram.cu',
        "none: the device LOBPCG's Grams (an XLA dot; torch.matmul before)")
# (row, ma = mb, self-Gram) of the Gram kernel on the LOBPCG cells' path
GRAM_CASES = (('gram_f32_16x16', 16, False),
              ('gram_f32_16x16_self', 16, True),
              ('gram_f32_48x48', 48, False))
# the LOBPCG cells' n (the Laplacian's first: its times go in the rows),
# and the shorter contractions that place the crossover with torch.matmul
GRAM_NS = (1280000, 139179)
GRAM_SHORT_NS = (65536, 32768, 16384, 8192, 6144, 4096, 3072, 2048)


def graph_ms(torch, fn, reps=20):
    """Mean device milliseconds of ``fn`` over ``reps`` calls captured in
    one CUDA graph, as the device LOBPCG's step runs them: the best of
    five replays, after a warm-up on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = None
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        t = start.elapsed_time(end) / reps
        best = t if best is None else min(best, t)
    return best


def graph_turns(torch, fns):
    """``turns`` with each callable timed in a CUDA graph (``graph_ms``)."""
    names = list(fns)
    best = {}
    for k in names + names[::-1]:
        t = graph_ms(torch, fns[k])
        best[k] = min(best.get(k, t), t)
    return best


def gram_chain(n, slots):
    """The longest chain of f32 roundings behind one entry of the Gram
    kernel's result at contraction length n, the launch holding ``slots``
    partial tiles at most: a lane's FMAs over its share of a block's
    chunk, the 4 shuffles of a tile's 16 lanes, a slice of the sum's 32
    and the 31 adds of the slices."""
    chunk = -(-(-(-n // slots)) // 4) * 4
    return -(-chunk // 16) + 4 + -(-(-(-n // chunk)) // 32) + 31


def phase_gram(torch, np):
    """The Gram kernel (``csrc/gram.cu``) at the device LOBPCG's Grams,
    (16, 16), a self-Gram (16, 16) and (48, 48), at the two LOBPCG cells'
    n: against an f64 product within the summation bound of its rounding
    chain (``gram_chain``, entrywise d 2^-24 sum_k |a_k b_k|), bit-equal
    across two calls, timed in CUDA graphs in turns with the plain version
    and torch.matmul (the same call here), beside its byte bound, with its
    registers and resident blocks; then kernel and torch.matmul in turns
    at shorter n, which place the dispatch's crossover
    (``ops/gram.py::GRAM_MIN_N``).  Returns the kernel's rows, at the
    Laplacian's n."""
    from raleigh_tpu_torch.ops import gram
    rows = {}
    gen = torch.Generator('cuda').manual_seed(27)

    def blocks(ma, own, n):
        a = torch.randn((ma, n), generator=gen, device='cuda')
        return a, (a if own else torch.randn((ma, n), generator=gen,
                                             device='cuda'))

    for name, ma, own in GRAM_CASES:
        key = ('f32', ma, ma, own)
        occ = gram.occupancy(ma, ma, own)
        print('%s: %d registers, %d blocks an SM, %d partial tiles, %d '
              'bytes spilled a thread' % (name, occ['registers'],
                                          occ['blocks_per_sm'],
                                          occ['slots'], occ['local_bytes']))
        for n in GRAM_NS:
            a, b = blocks(ma, own, n)
            before = gram.GRAM_LAUNCHES[key]
            got = gram.gram_kernel(a, b)
            again = gram.gram_kernel(a, b)
            torch.cuda.synchronize()
            if gram.GRAM_LAUNCHES[key] - before != 2:
                fail('%s n=%d: %d launches counted for two Grams'
                     % (name, n, gram.GRAM_LAUNCHES[key] - before))
            want = a.double() @ b.double().T
            terms = a.double().abs() @ b.double().abs().T
            excess = ((got.double() - want).abs()
                      / (gram_chain(n, occ['slots']) * 2.0 ** -24
                         * terms)).max().item()
            if excess > 1:
                fail('%s n=%d: %.3g times the summation bound'
                     % (name, n, excess))
            if not torch.equal(got, again):
                fail('%s n=%d: two calls differ' % (name, n))
            t = graph_turns(torch, {
                'plain': lambda: gram.gram_plain(a, b),
                'kernel': lambda: gram.gram_kernel(a, b),
                'library': lambda: torch.matmul(a, b.T)})
            nbytes = ((ma if own else 2 * ma) * n + ma * ma) * 4
            bound_ms, bound_by = bound(nbytes, 2 * ma * ma * n)
            print('%s n=%d: within %.3g of the summation bound, bit-equal '
                  'across calls; kernel %.4f ms (%.1f%% of the bound), '
                  'plain %.4f ms, torch.matmul %.4f ms (%.2fx), bound %.4f '
                  'ms (%s, %.1f MB), in CUDA graphs, in turns'
                  % (name, n, excess, t['kernel'],
                     100 * bound_ms / t['kernel'], t['plain'], t['library'],
                     t['library'] / t['kernel'], bound_ms, bound_by,
                     nbytes / 1e6))
            if n == GRAM_NS[0]:
                rows[name] = dict(
                    name=name, route='cuda', source=GRAM[0],
                    replaces=GRAM[1], launches=0, max_abs_err=excess,
                    ms=t['kernel'], plain_ms=t['plain'], bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=t['library'], m=ma,
                    bytes=nbytes)
            del a, b, want, terms
        torch.cuda.empty_cache()
    wins = {}
    for n in GRAM_SHORT_NS:
        for name, ma, own in GRAM_CASES:
            a, b = blocks(ma, own, n)
            t = graph_turns(torch, {
                'kernel': lambda: gram.gram_kernel(a, b),
                'library': lambda: torch.matmul(a, b.T)})
            wins[n, name] = t['kernel'] < t['library']
            print('%s n=%d: kernel %.4f ms, torch.matmul %.4f ms (%.2fx)'
                  % (name, n, t['kernel'], t['library'],
                     t['library'] / t['kernel']))
    ns = sorted(GRAM_SHORT_NS)
    won = [n for n in ns if all(wins[k] for k in wins if k[0] >= n)]
    print('Gram crossover: the kernel wins every case at every n measured '
          'from %s on; GRAM_MIN_N = %d'
          % (won[0] if won else 'none', gram.GRAM_MIN_N))
    return rows


def ell_excess(torch, spmm, idx, val, xt, got, want):
    """Entrywise |got - want| over the bound for two (n, m) ELL applies
    that each sum a row's K terms in the promoted type of val and xt, in
    any order: twice the summation error bound, 2 K u sum_k |val x| (from
    the plain version on |val|, |x|; u = 2^-24 for f32 sums, 2^-53 for
    f64), with 2K + 1 terms for a complex sum (real and imaginary products
    and the sum of a complex-valued matrix's two launches), compared part
    by part, plus one bf16 rounding on either side (2^-7 |want|) when
    either result is bf16.  Returns (largest ratio, share of entries above
    1)."""
    acc = torch.promote_types(torch.promote_types(val.dtype, xt.dtype),
                              torch.float32)
    wide = acc in (torch.float64, torch.complex128)
    real = torch.float64 if wide else torch.float32
    terms = spmm._ell_matmat_plain(idx, val.abs().to(real),
                                   xt.abs().to(real))
    k = idx.shape[1]
    k = 2 * k + 1 if acc.is_complex else k
    limit = 2 * k * (2.0 ** -53 if wide else 2.0 ** -24) * terms
    if torch.bfloat16 in (got.dtype, want.dtype):
        limit = limit + BF16_HALF_ULP_PAIR * want.to(real).abs()
    d = got.to(acc) - want.to(acc)
    diff = (torch.maximum(d.real.abs(), d.imag.abs()) if acc.is_complex
            else d.abs())
    ratio = torch.where(diff == 0, 0.0, diff / limit)   # 0/0 is agreement
    return ratio.max().item(), (ratio > 1).float().mean().item()


def ell_controls(torch, idx, val, xt):
    """The ELL apply done wrong in two ways a kernel could be: a bf16
    running sum over a row's entries, and each product rounded to bf16
    before an f32 sum.  (n, m) results in xt's dtype."""
    n, k = idx.shape
    run = torch.zeros((n, xt.shape[1]), dtype=torch.bfloat16,
                      device=xt.device)
    prod = torch.zeros((n, xt.shape[1]), dtype=torch.float32,
                       device=xt.device)
    for j in range(k):
        term = val[:, j, None].float() * xt.index_select(0, idx[:, j]).float()
        run = (run.float() + term).to(torch.bfloat16)
        prod += term.to(torch.bfloat16).float()
    return {'bf16 running sum': run.to(xt.dtype),
            'bf16 products': prod.to(xt.dtype)}


def window_excess(torch, sw, val, x, offsets, got, want, terms=None):
    """Entrywise |got - want| over the bound for two f32 DIA applies that
    both sum in f32, in any order: twice the f32 summation error bound of
    the entry's terms, 2 noff 2^-24 sum_k |val_k x| (``terms``, where the
    caller has it).  Returns (largest ratio, share of entries above 1)."""
    if terms is None:
        terms = sw.dia_matmat_rows_plain(val.abs(), x.abs(), offsets)
    limit = 2 * len(offsets) * 2.0 ** -24 * terms
    diff = (got.float() - want.float()).abs()
    ratio = torch.where(diff == 0, 0.0, diff / limit)   # 0/0 is agreement
    return ratio.max().item(), (ratio > 1).float().mean().item()


def phase_variants(torch, np, lap3d, DiaMatrix, sw, st, wt, gs):
    """The staged-window DIA kernels against the plain version at the tile
    sweep's shape, each timed in turns with ``torch.sparse.mm`` at every
    tile the sweep runs, and the tiled and pipelined stream kernels against
    ``torch.mul`` at the copy sweep's, at every tile the sweeps run.
    Returns the kernel rows."""
    rows = {}
    gen = torch.Generator('cuda').manual_seed(3)
    csr = (lap3d(*wt.GRID, 1.0, 1.0, 1.0) * wt.SCALE).tocsr()
    dm = DiaMatrix(csr, dtype=np.float32, device='cuda')
    n, noff = dm.shape[0], len(dm.offsets)
    from raleigh_tpu_torch.benches.timing import WARMUP
    # the sweep's launches of a tile (warm-up and reps of its timer)
    per_tile = wt.REPS + WARMUP
    for m in (wt.M, 16):
        x = torch.randn((m, n), generator=gen, device='cuda')
        yp = sw.dia_matmat_rows_plain(dm.val, x, dm.offsets_t)
        control = bf16_controls(torch, dm.val, x,
                                dm.offsets_t)['bf16 running sum']
        cworst, cshare = window_excess(torch, sw, dm.val, x, dm.offsets_t,
                                       control, yp)
        print('  control (bf16 running sum) vs plain, m=%d: %.4f of the '
              'entries beyond the bound (worst %.1f times it)'
              % (m, cshare, cworst))
        if cworst <= 1:
            fail('the f32 window bound passes the bf16 running sum')
        del control
        library = library_spmm_fn(torch, csr, x)
        nbytes = noff * n * 4 + noff * 4 + 2 * m * n * 4
        flops = 2 * m * sum(n - abs(o) for o in dm.offsets)
        bound_ms, bound_by = bound(nbytes, flops)
        for name, src in (('slide', SLIDE), ('tiles', TILES)):
            kernel = sw.VARIANTS[name]
            sweep = {'kernel': 0.0, 'library': 0.0}
            for tile in wt.DEFAULT_TILES[name]:
                yk = kernel(dm.val, x, dm.offsets, tile)
                torch.cuda.synchronize()
                what = '%s tile %d m=%d' % (name, tile, m)
                if yk.dtype != torch.float32 or yk.shape != (m, n):
                    fail('%s output %s %s' % (what, yk.dtype,
                                              tuple(yk.shape)))
                if not torch.isfinite(yk).all():
                    fail('%s: non-finite output' % what)
                worst, share = window_excess(torch, sw, dm.val, x,
                                             dm.offsets_t, yk, yp)
                if worst > 1:
                    fail('%s: %.3e of the entries beyond the bound (worst '
                         '%.2f times it)' % (what, share, worst))
                diff = (yk - yp).abs().max().item()
                equal = torch.equal(yk, yp)
                del yk
                plan = sw.window_launch_plan(name, dm.val, x, dm.offsets,
                                             tile)
                row_tile = tile == ROW_TILE[name]
                t = turns({
                    'plain': (lambda: sw.dia_matmat_rows_plain(
                        dm.val, x, dm.offsets_t)) if row_tile else None,
                    'kernel': lambda: kernel(dm.val, x, dm.offsets, tile),
                    'k1': (lambda: sw.dia_matmat_rows(
                        dm.val, x, dm.offsets_t)) if row_tile else None,
                    'library': library}, 50)
                for k in sweep:
                    sweep[k] += per_tile * (t[k] or float('nan'))
                print('dia_spmm %s tile %d n=%d m=%d: kernel %.4f ms, '
                      'torch.sparse.mm %s, in turns; max abs err %.3e%s; '
                      'launch: clusters of %d blocks (%d fit the card at '
                      'once), %d per segment, %d segments, %d blocks of %d '
                      'rows, %s, %s' % (
                          name, tile, n, m, t['kernel'],
                          fmt_ms(t['library']), diff,
                          ' (equal to plain bit for bit)' if equal else '',
                          plan['cluster'], plan['active_clusters'],
                          plan['clusters_per_segment'], plan['segments'],
                          plan['blocks'], plan['rows'],
                          'val chunks of %d lanes multicast' % plan['chunk']
                          if plan['chunk'] else 'val from device memory',
                          'bulk copies' if plan['bulk'] else
                          'per-thread copies'))
                if not row_tile:
                    continue
                key = 'dia_spmm_rows_%s_f32' % name + (
                    '' if m == wt.M else '_m%d' % m)
                print('%s tile %d n=%d m=%d: kernel %.4f ms (%.0f GB/s); K1 '
                      '%.4f ms; plain %.4f ms, torch.sparse.mm %s, bound '
                      '%.4f ms (%s), in turns'
                      % (key, tile, n, m, t['kernel'],
                         nbytes / t['kernel'] / 1e6, t['k1'], t['plain'],
                         fmt_ms(t['library']), bound_ms, bound_by))
                rows[key] = dict(
                    name=key, route='cuda', source=src[0], replaces=src[1],
                    launches=0, max_abs_err=diff, ms=t['kernel'],
                    plain_ms=t['plain'], bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=t['library'],
                    bytes=nbytes, k1_ms=t['k1'])
                rows[key].update({k: plan[k] for k in (
                    'cluster', 'active_clusters', 'rows', 'chunk')})
            tiles = wt.DEFAULT_TILES[name]
            print('%s sweep at m=%d (tiles %s, %d launches each): kernel '
                  '%.2f ms, torch.sparse.mm %.2f ms; the kernel loses %.2f '
                  'ms to its bound'
                  % (name, m, ', '.join(map(str, tiles)), per_tile,
                     sweep['kernel'], sweep['library'],
                     sweep['kernel'] - per_tile * len(tiles) * bound_ms))
        del x, yp
    del dm

    x = torch.randn(st.REFERENCE_SHAPE, generator=gen, device='cuda')
    a = st.REFERENCE_SCALE
    # (row name, source, tiles, row tile, per_step, kernel)
    probes = [('stream_scale_tiled_per_step%d' % ps, TILED, gs.TILED_TILES,
               ROW_TILE['tiled'], ps,
               lambda xs, t, ps=ps: st.stream_scale_tiled(xs, a, t, ps))
              for ps in (1, 4)]
    probes += [('stream_scale_pipelined_depth%d' % d, PIPELINED,
                gs.PIPELINED_TILES, ROW_TILE['pipelined'], 1,
                lambda xs, t, d=d: st.stream_scale_pipelined(xs, a, t, d))
               for d in st.PIPELINE_DEPTHS]
    for key, src, tiles, row_tile, per_step, fn in probes:
        for tile in tiles:
            # whole blocks only: the copy sweep trims n the same way
            cut = x.shape[1] - x.shape[1] % (tile * per_step)
            xs = x if cut == x.shape[1] else x[:, :cut].contiguous()
            yp = st.stream_scale_plain(xs, a)
            yk = fn(xs, tile)
            torch.cuda.synchronize()
            diff = (yk - yp).abs().max().item()
            if not torch.equal(yk, yp):
                fail('%s tile %d differs from torch.mul (max abs %.3e)'
                     % (key, tile, diff))
            del yk, yp
            if tile != row_tile:
                continue
            t = turns({'plain': lambda: st.stream_scale_plain(xs, a),
                       'kernel': lambda: fn(xs, tile)}, 50)
            nbytes = 2 * xs.numel() * 4
            bound_ms, bound_by = bound(nbytes, xs.numel())
            print('%s tile %d %s f32: equal to torch.mul at every tile of '
                  '%s, kernel %.4f ms (%.0f GB/s), torch.mul %.4f ms (%.0f '
                  'GB/s), bound %.4f ms (%s), in turns'
                  % (key, tile, tuple(xs.shape), tiles, t['kernel'],
                     nbytes / t['kernel'] / 1e6, t['plain'],
                     nbytes / t['plain'] / 1e6, bound_ms, bound_by))
            rows[key] = dict(
                name=key, route='cuda', source=src[0], replaces=src[1],
                launches=0, max_abs_err=diff, ms=t['kernel'],
                plain_ms=t['plain'], bound_ms=bound_ms, bound_by=bound_by,
                library_ms=t['plain'], bytes=nbytes)
    return rows


def phase_copy(torch, st):
    """The copy kernel against ``Tensor.copy_`` (exact equality): the
    sweep's whole-array copy in column tiles, and a shard's halo and body
    into the slots of an extended operand, on the 16-byte path and on the
    element path.  Returns its rows."""
    rows = {}
    gen = torch.Generator('cuda').manual_seed(4)
    x = torch.randn(st.REFERENCE_SHAPE, generator=gen, device='cuda')
    nbytes = 2 * x.numel() * 4
    bound_ms, bound_by = bound(nbytes, 0)
    for tile in (32768, x.shape[1]):
        yk = st.hbm2hbm(x, tile)
        torch.cuda.synchronize()
        if yk.data_ptr() == x.data_ptr() or not torch.equal(yk, x):
            fail('hbm2hbm tile %d differs from its input' % tile)
        del yk
        tk, tp = in_turns(lambda: st.hbm2hbm(x, tile),
                          lambda: torch.empty_like(x).copy_(x), 50)
        print('hbm2hbm %s f32 tile %d: equal to copy_, kernel %.4f ms '
              '(%.0f GB/s), copy_ %.4f ms (%.0f GB/s), bound %.4f ms (%s)'
              % (tuple(x.shape), tile, tk, nbytes / tk / 1e6, tp,
                 nbytes / tp / 1e6, bound_ms, bound_by))
        if tile == 32768:
            rows['copy_lanes_hbm2hbm'] = dict(
                name='copy_lanes_hbm2hbm', route='cuda', source=COPY[0],
                replaces=COPY[1], launches=0, max_abs_err=0.0, ms=tk,
                plain_ms=tp, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=tp, bytes=nbytes)
    del x

    # a shard of lap3d(100,100,128) cut in 8: 160,000 lanes, halos of 10,000
    m, n_local, halo = 16, 160000, 10000
    for dt in (torch.float32, torch.bfloat16):
        key = str(dt).replace('torch.', '')
        src = torch.randn((m, n_local + 16), generator=gen,
                          device='cuda').to(dt)
        got = torch.zeros((m, n_local + 2 * halo + 16), dtype=dt,
                          device='cuda')
        want = torch.zeros_like(got)
        # (name, source lane, slot lane, lanes): the left halo aligned, the
        # same shifted by one element at either end, and the body
        cases = [('halo', n_local - halo, 0, halo),
                 ('halo, source shifted', n_local - halo + 1, 0, halo),
                 ('halo, slot shifted', n_local - halo, 1, halo),
                 ('body', 0, halo, n_local),
                 ('body, slot shifted', 0, halo + 1, n_local)]
        for name, s0, d0, w in cases:
            sv = src[:, s0:s0 + w]
            dk, dp = got[:, d0:d0 + w], want[:, d0:d0 + w]
            got.zero_()
            want.zero_()
            st.copy_lanes(dk, sv)
            st.copy_lanes_plain(dp, sv)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail('copy_lanes %s %s differs from copy_' % (name, key))
            tk, tp = in_turns(lambda: st.copy_lanes(dk, sv),
                              lambda: st.copy_lanes_plain(dp, sv), 200)
            cbytes = 2 * m * w * src.element_size()
            b_ms, b_by = bound(cbytes, 0)
            print('copy_lanes %s (%d, %d) %s: equal to copy_, kernel %.4f ms '
                  '(%.0f GB/s), copy_ %.4f ms, bound %.5f ms (%s)'
                  % (name, m, w, key, tk, cbytes / tk / 1e6, tp, b_ms, b_by))
            if name == 'halo':
                row = 'copy_lanes_halo_' + ('f32' if key == 'float32'
                                            else 'bf16')
                rows[row] = dict(
                    name=row, route='cuda', source=COPY[0],
                    replaces=COPY[1], launches=0, max_abs_err=0.0, ms=tk,
                    plain_ms=tp, bound_ms=b_ms, bound_by=b_by,
                    library_ms=tp, bytes=cbytes,
                    off_path='no solver path makes a single halo copy: '
                             'ShardedEll batches its copies')
        del src, got, want
        rows.update(assembly_copies(torch, st, gen, dt))
    return rows


def assembly_copies(torch, st, gen, dt):
    """The extended operands of all 8 shards of a lap3d(100,100,128) block
    (m = 16, halos of 10,000 lanes): 24 copies through one
    ``copy_lanes_many`` launch against the plain version's 24 ``copy_``
    calls (exact equality) and ``torch._foreach_copy_``.  Returns its row."""
    from raleigh_tpu_torch.parallel.mesh import ring_runs
    m, n_local, halo = 16, 160000, 10000
    key = 'f32' if dt == torch.float32 else 'bf16'
    parts = [torch.randn((m, n_local), generator=gen, device='cuda').to(dt)
             for _ in range(SHARDS)]
    got, want, pairs, plain = [], [], [], []
    for runs in ring_runs([n_local] * SHARDS, halo, halo):
        got.append(torch.zeros((m, n_local + 2 * halo), dtype=dt,
                               device='cuda'))
        want.append(torch.zeros_like(got[-1]))
        for pos, take, j, at in runs:
            src = parts[j][:, at:at + take]
            pairs.append((got[-1][:, pos:pos + take], src))
            plain.append((want[-1][:, pos:pos + take], src))
    before = st.LAUNCHES['copy_lanes']
    st.copy_lanes_many(pairs)
    st.copy_lanes_many_plain(plain)
    torch.cuda.synchronize()
    if st.LAUNCHES['copy_lanes'] - before != 1:
        fail('the %d copies of an 8-shard assembly took %d launches'
             % (len(pairs), st.LAUNCHES['copy_lanes'] - before))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail('copy_lanes_many of an 8-shard assembly %s differs from copy_'
             % key)
    # all three as a caller makes them, one Python call each: the wrapper
    # (its checks of 24 pairs included), 24 copy_, one _foreach_copy_; and
    # the kernel alone, its parameter block built once and launched directly
    from raleigh_tpu_torch.ops import _build
    block = st._COPY_BLOCK()
    block[0] = len(pairs)
    block[2:2 + len(pairs) * st._COPY_SLOTS] = [
        v for d, c in pairs for v in st._copy_slots(d, c)]
    lib, index = _build.library(), torch.cuda.current_device()

    def launch():
        if lib.copy_lanes_many(ctypes.addressof(block), ctypes.sizeof(block),
                               index, _build.current_stream(index)):
            fail('copy_lanes_many launch failed')
    tk, tp = in_turns(lambda: st.copy_lanes_many(pairs),
                      lambda: st.copy_lanes_many_plain(plain), 100)
    t_launch = time_ms(launch, 100)
    dsts, srcs = [d for d, _ in plain], [s for _, s in plain]
    try:
        lib_ms = time_ms(lambda: torch._foreach_copy_(dsts, srcs), 100)
    except (AttributeError, RuntimeError, NotImplementedError) as e:
        print('  torch._foreach_copy_ is not available: %s'
              % str(e).splitlines()[0])
        lib_ms = None
    nbytes = 2 * sum(g.numel() for g in got) * got[0].element_size()
    b_ms, b_by = bound(nbytes, 0)
    name = 'copy_lanes_many_' + key
    print('%s: the %d copies of an 8-shard assembly (%d x (%d, %d) %s) in '
          'one launch, equal to copy_; through the wrapper %.4f ms (%.0f '
          'GB/s), %d copy_ calls %.4f ms, torch._foreach_copy_ %s, the '
          'kernel launched directly %.4f ms (%.0f GB/s), bound %.4f ms (%s)'
          % (name, len(pairs), SHARDS, m, n_local + 2 * halo, key, tk,
             nbytes / tk / 1e6, len(pairs), tp, fmt_ms(lib_ms), t_launch,
             nbytes / t_launch / 1e6, b_ms, b_by))
    row = dict(name=name, route='cuda', source=COPY[0], replaces=COPY[1],
               launches=0, max_abs_err=0.0, ms=tk, plain_ms=tp,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, bytes=nbytes,
               launch_ms=t_launch)
    if dt != torch.float32:
        row['off_path'] = 'no solver path copies bf16 lanes'
    return {name: row}


def phase_ext(torch, np, lap3d, DiaMatrix, sw, st, k1_rows):
    """The mesh DIA kernel at the sharded main path's shapes:
    lap3d(100,100,128) cut in 8 and in 2 shards of the one card, through
    the mesh entry (one launch for all shards).  Returns its rows (the cut
    in 8)."""
    from raleigh_tpu_torch.core.device_solver import shard_operator
    from raleigh_tpu_torch.parallel.mesh import (ShardedRows,
                                                 blockvec_sharding, make_mesh)
    rows = {}
    gen = torch.Generator('cuda').manual_seed(5)
    a = lap3d(100, 100, 128, 1.0, 1.0, 1.0)
    whole = DiaMatrix(a, dtype=np.float32)
    n, noff, m = whole.shape[0], len(whole.offsets), 16
    for shards in (SHARDS, 2):
        mesh = make_mesh(shards)
        dm = shard_operator(DiaMatrix(a, dtype=np.float32), mesh)
        plan = dm._mesh_plan(dm.val.sharding)
        offs = plan.offsets_on(dm.val.parts[0].device)
        vals = dm.val.parts
        for dt in (torch.float32, torch.bfloat16):
            key = 'f32' if dt == torch.float32 else 'bf16'
            excess = window_excess if dt == torch.float32 else bf16_excess
            x = torch.randn((m, n), generator=gen, device='cuda').to(dt)
            xs = ShardedRows.split(x, blockvec_sharding(mesh))
            y1 = whole.matmat_rows(x)
            # one apply as a user makes it: one launch, nothing copied
            before = dict(sw.LAUNCHES), dict(st.LAUNCHES)
            ym = dm.matmat_rows(xs)
            torch.cuda.synchronize()
            moved = {k: v - before[0][k] for k, v in sw.LAUNCHES.items()
                     if v != before[0][k]}
            moved.update({k: v - before[1][k] for k, v in st.LAUNCHES.items()
                          if v != before[1][k]})
            if moved != {'mesh_' + str(dt)[6:]: 1}:
                fail('%d shards, %s: one sharded apply launched %s, not one '
                     'mesh kernel' % (shards, key, moved))
            if not torch.equal(ym.gather(), y1):
                fail('%d shards, %s: the mesh apply differs from the '
                     'unsharded kernel\'s' % (shards, key))
            # the mesh kernel against its plain version, shard by shard; a
            # shard's terms sum_k |val_k x| are the whole matrix's at its
            # lanes
            yp = sw.dia_matmat_rows_mesh_plain(vals, xs.parts, plan)
            terms_all = sw.dia_matmat_rows_plain(
                whole.val.abs(), x.float().abs(), whole.offsets_t)
            worst_all, diff_all = 0.0, 0.0
            start = 0
            for i, v in enumerate(vals):
                n_i = v.shape[1]
                terms = terms_all[:, start:start + n_i]
                got = ym.parts[i]
                if got.dtype != dt or got.shape != (m, n_i):
                    fail('mesh entry output %s %s'
                         % (got.dtype, tuple(got.shape)))
                if not torch.isfinite(got.float()).all():
                    fail('mesh entry: non-finite output on shard %d' % i)
                worst, share = excess(torch, sw, v, None, offs, got, yp[i],
                                      terms=terms)
                if worst > 1:
                    fail('mesh entry vs plain, %d shards, shard %d, %s: '
                         '%.3e of the entries beyond the bound (worst %.2f '
                         'times it)' % (shards, i, key, share, worst))
                worst_all = max(worst_all, worst)
                diff_all = max(diff_all, (got.float() - yp[i].float())
                               .abs().max().item())
                if i == 0 and shards == SHARDS:
                    for name, yc in bf16_controls(torch, whole.val, x,
                                                  whole.offsets_t).items():
                        yc = yc[:, :n_i]
                        if dt == torch.float32 and name != 'bf16 running sum':
                            continue
                        cworst, cshare = excess(torch, sw, v, None, offs, yc,
                                                yp[i], terms=terms)
                        print('  control (%s) vs plain, shard 0 of %d, %s: '
                              '%.4f of the entries beyond the bound (worst '
                              '%.1f times it)' % (name, shards, key, cshare,
                                                  cworst))
                        if cworst <= 1:
                            fail('the %s bound passes the control (%s)'
                                 % (key, name))
                start += n_i
            del ym, yp, terms_all, y1

            # in turns: the mesh kernel's wrapper against its plain
            # version; the whole sharded apply against K1
            tk, tp = in_turns(
                lambda: sw.dia_matmat_rows_mesh(vals, xs.parts, plan),
                lambda: sw.dia_matmat_rows_mesh_plain(vals, xs.parts, plan),
                20)
            t_apply, t_k1 = in_turns(lambda: dm.matmat_rows(xs),
                                     lambda: whole.matmat_rows(x), 100)
            # K1's work: a shard's halo lanes are its neighbours' own lanes,
            # read once as a whole-matrix apply reads them
            nbytes = noff * n * 4 + noff * 4 + 2 * m * n * x.element_size()
            bound_ms, bound_by = bound(
                nbytes, 2 * m * sum(n - abs(o) for o in whole.offsets))
            name = 'dia_spmm_rows_mesh_' + key
            lib = k1_rows['dia_spmm_rows_f32']['library_ms'] \
                if dt == torch.float32 else None
            print('%s lap3d(100,100,128) in %d shards, m=%d: one launch, '
                  'max abs err %.3e (worst %.3f of the bound), equal to the '
                  'unsharded kernel bit for bit; kernel %.4f ms (%.0f GB/s), '
                  'plain %.4f ms, bound %.4f ms (%s); whole sharded apply '
                  '%.4f ms, unsharded kernel %.4f ms; torch.sparse.mm of the '
                  'whole matrix %s [one card: no scaling measurement]'
                  % (name, shards, m, diff_all, worst_all, tk,
                     nbytes / tk / 1e6, tp, bound_ms, bound_by, t_apply,
                     t_k1, fmt_ms(lib)))
            if shards == SHARDS:
                rows[name] = dict(
                    name=name, route='cuda', source=EXT[0], replaces=EXT[1],
                    launches=0, max_abs_err=diff_all, ms=tk, plain_ms=tp,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
                    bytes=nbytes, shards=shards, apply_ms=t_apply,
                    k1_ms=t_k1)
            del xs, x
        del dm, plan, vals
    return rows


def phase_sweeps(mods, rows, card, wt, gs):
    """The two kernel-structure sweeps as a user runs them: ``main`` with
    no device argument, at full size.  Each call is one path: the launch
    counters are set to 0 just before it and read just after."""
    sw, _, st = mods[:3]

    def drive(main, argv, counter, key, row):
        reset_counters(mods)
        lines = main(argv)
        launches = counter[key]
        if launches <= 0:
            fail('the sweep %s launched %s no time' % (argv, key))
        if not all(line['ms'] > 0 for line in lines):
            fail('the sweep %s printed a time that is not positive' % argv)
        if row is not None:
            rows[row]['launches'] = launches
        print('sweep %s: %d launches of %s [%s]'
              % (' '.join(argv), launches, key, card))

    drive(wt.main, ['ring'], sw.LAUNCHES, 'float32', None)
    for name in ('slide', 'tiles'):
        for argv, row in (([name], 'dia_spmm_rows_%s_f32' % name),
                          ([name, '--m', '16'],
                           'dia_spmm_rows_%s_f32_m16' % name)):
            drive(wt.main, argv, sw.LAUNCHES, name, row)
    drive(gs.main, ['blockspec'], st.LAUNCHES, 'tiled',
          'stream_scale_tiled_per_step1')
    drive(gs.main, ['blockspec4'], st.LAUNCHES, 'tiled',
          'stream_scale_tiled_per_step4')
    for depth in st.PIPELINE_DEPTHS:
        drive(gs.main, ['manual%d' % depth], st.LAUNCHES,
              'pipelined_depth%d' % depth,
              'stream_scale_pipelined_depth%d' % depth)
    drive(gs.main, ['spans', 'torch'], st.LAUNCHES, 'float32', None)
    drive(gs.main, ['hbm2hbm'], st.LAUNCHES, 'copy_lanes',
          'copy_lanes_hbm2hbm')
    if 'hbm2hbm' not in gs.VARIANTS:
        fail('the copy sweep\'s default list lacks hbm2hbm')

    # the sharded SpMM bench at its default size, the host cost of a
    # launch and the dry run of the mesh path, with no device argument
    from raleigh_tpu_torch import graft_entry
    from raleigh_tpu_torch.benches import (bench_launch_cost,
                                           bench_spmm_sharded)
    bench_launch_cost.main(['--reps', '3000'])
    reset_counters(mods)
    out = bench_spmm_sharded.main([])
    if out['mode'] == 'halo' and st.LAUNCHES['copy_lanes'] <= 0:
        fail('bench_spmm_sharded moved its halos without the copy kernel')
    print('bench_spmm_sharded: n=%d m=%d, %s, %d copy launches [%s]'
          % (out['n'], out['m'], out['mode'], st.LAUNCHES['copy_lanes'],
             card))
    reset_counters(mods)
    with counting_sharded_applies() as applies:
        graft_entry.dryrun_multichip(SHARDS)
    if sw.LAUNCHES['mesh_float32'] <= 0:
        fail('dryrun_multichip skipped the mesh kernel: %s' % sw.LAUNCHES)
    check_one_launch_per_device(sw, st, 'dryrun_multichip', applies)
    print('dryrun_multichip(%d): %d mesh kernel launches for %d sharded '
          'applies, no copy launch [%s]'
          % (SHARDS, sw.LAUNCHES['mesh_float32'], len(applies), card))


def hevp_call(torch, partial_hevp, *args, **kw):
    """One partial_hevp call (verb=0, output captured; with no device
    argument, so on the card): (lmd, x, status, iterations, wall s, solve
    s, set-up s or None).  The wall less the solve is partial_hevp's own
    set-up: the factorization and its probe for shift-invert, the
    matrices not built before otherwise."""
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        lmd, x, status = partial_hevp(*args, verb=0, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = out.getvalue()
    found = re.findall(r'iterations: (\d+), solve time: (\S+)', text)
    if not found:
        fail('partial_hevp printed no iteration count: %s' % text[-400:])
    setup = re.findall(r'setup time: (\S+)', text)
    return (lmd, x, status, int(found[-1][0]), wall, float(found[-1][1]),
            float(setup[-1]) if setup else None)


def profile_run(torch, run, card):
    """``run()`` (one warm solve) under torch.profiler: device kernel time
    by kernel and the device's busy share of the wall time.  Returns the
    device time in seconds and the kernels' profiler events."""
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
    return busy, kernels


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


@contextlib.contextmanager
def counting_sharded_applies():
    """Counts the mesh-partitioned DIA applies made inside the block (the
    calls of ``ops.spmm._dia_sharded_apply``) and the devices each one
    spans: yields a list of the device counts."""
    from raleigh_tpu_torch.ops import spmm
    applies, inner = [], spmm._dia_sharded_apply

    def counted(val, plan, x):
        applies.append(len({launch.device for launch in plan.launches}))
        return inner(val, plan, x)
    spmm._dia_sharded_apply = counted
    try:
        yield applies
    finally:
        spmm._dia_sharded_apply = inner


def check_one_launch_per_device(sw, st, what, applies):
    """Fails unless the mesh kernel (any instantiation) ran once per device
    per sharded apply, and neither the copy kernel nor the one-piece entry
    ran."""
    launches = sum(v for k, v in sw.LAUNCHES.items()
                   if k.startswith('mesh_'))
    if not applies or launches != sum(applies):
        fail('%s: %d mesh kernel launches for %d sharded applies over %d '
             'device launches' % (what, launches, len(applies),
                                  sum(applies)))
    stray = (st.LAUNCHES['copy_lanes'],) + tuple(
        v for k, v in sw.LAUNCHES.items() if k.startswith('ext_'))
    if any(stray):
        fail('%s: copy and one-piece launches %s on the mesh DIA path'
             % (what, stray))


def check_grams(name, cases):
    """The Gram launches of the solve just run, by row of ``cases``
    (``GRAM_CASES``' entries), each > 0, with no non-empty device Gram left
    to torch.matmul."""
    from raleigh_tpu_torch.ops import gram
    if gram.MATMUL_GRAMS['device']:
        fail('%s left %d Grams to torch.matmul'
             % (name, gram.MATMUL_GRAMS['device']))
    launches = {row: gram.GRAM_LAUNCHES[('f32', ma, ma, own)]
                for row, ma, own in cases}
    if min(launches.values()) <= 0:
        fail('%s skipped the Gram kernel: %s' % (name, launches))
    return launches


def check_iterations(name, field, counts):
    """Fails unless every solve of ``field`` took the iterations of the
    records (``ITERATIONS``)."""
    if set(counts) != {ITERATIONS[field]}:
        fail('%s: %s iterations, not %d' % (name, counts,
                                            ITERATIONS[field]))


def reset_counters(mods):
    from raleigh_tpu_torch.core import device_solver
    from raleigh_tpu_torch.ops import gram
    for mod in mods + (gram,):
        mod.reset_launches()
    device_solver.reset_counts()


def ell_launches(ell):
    """The ELL kernel's launches since the counters were set to 0, by
    instantiation ('f32_f64': f32 values, f64 operand), as JSON."""
    return json.dumps({'_'.join(k): v for k, v in ell.ELL_LAUNCHES.items()
                       if v})


def phase_lap3d(torch, np, mods, rows, card, profile=False):
    """The stencil path: partial_hevp on two lap3d fields.  The DIA rows'
    launches are those of the first field."""
    from raleigh_tpu_torch import Chebyshev, partial_hevp, spectral_bounds
    from raleigh_tpu_torch.examples.laplace import lap3d, lap3d_eigenvalues
    sw = mods[0]
    main_field = None

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
        ch = Chebyshev(a, lo, hi, degree=degree)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        lmd, x, st, its, cold, _, _ = hevp_call(
            torch, partial_hevp, a, T=ch, which=which, tol=tol)
        if first:
            launches = {key: sw.LAUNCHES[key]
                        for key in ('float32', 'bfloat16')}
            if min(launches.values()) <= 0:
                fail('main path skipped a kernel: launches %s' % launches)
            rows['dia_spmm_rows_f32']['launches'] = launches['float32']
            rows['dia_spmm_rows_bf16']['launches'] = launches['bfloat16']
            grams = check_grams(name, GRAM_CASES)
            for row, count in grams.items():
                rows[row]['launches'] = count
            launches.update(grams)
        err = check_solution(np, name, lmd, x, st, exact, limit)
        lmd, x, st, its2, warm, lob, _ = hevp_call(
            torch, partial_hevp, a, T=ch, which=which, tol=tol)
        check_solution(np, name, lmd, x, st, exact, limit)
        check_iterations(name, grid, (its, its2))
        print('%s: status 0, %d iterations (warm run %d), max rel eigenvalue '
              'error %.2e; Chebyshev set-up %.3f s; partial_hevp wall cold '
              '%.3f s, warm %.3f s (LOBPCG %.3f s, rest %.3f s) [%s]'
              % (name, its, its2, err, setup, cold, warm, lob, warm - lob,
                 card))
        if first:
            print('main path kernel launches: %s' % json.dumps(launches))
            main_field = dict(lmd=np.sort(lmd)[:which], iterations=its2,
                              warm=warm, launches=launches)
        if profile:
            profile_run(torch, lambda: hevp_call(
                torch, partial_hevp, a, T=ch, which=which, tol=tol), card)
            # the same solve with f32 Chebyshev iterates (auto rule off)
            ch.device_matrix().WINDOW_HBM_BYTES = float('inf')
            lmd, x, st, its3, wall, lob, _ = hevp_call(
                torch, partial_hevp, a, T=ch, which=which, tol=tol)
            del ch.device_matrix().WINDOW_HBM_BYTES
            err = check_solution(np, name, lmd, x, st, exact, limit)
            print('%s with f32 Chebyshev iterates: %d iterations, max rel '
                  'eigenvalue error %.2e, wall %.3f s (LOBPCG %.3f s) [%s]'
                  % (name, its3, err, wall, lob, card))
    return main_field


def phase_sharded(torch, np, mods, rows, card, main_field, k_rel,
                  profile=False):
    """The sharded main path as a user writes it, no device argument: the
    lap3d(100,100,128) field with operator and blocks split over a mesh of
    eight shards of the one card; then ``ShardedEllMatrix`` on the same
    mesh.  The extended-operand and copy rows' launches are this solve's."""
    from raleigh_tpu_torch import (Chebyshev, DiaMatrix, EllMatrix,
                                   ShardedEllMatrix, blockvec_sharding,
                                   lobpcg, make_mesh, shard_operator,
                                   spectral_bounds)
    from raleigh_tpu_torch.core.device_solver import default_block
    from raleigh_tpu_torch.examples.laplace import lap3d, lap3d_eigenvalues
    sw, _, st, ell = mods
    grid, which, degree, tol = (100, 100, 128), 4, 12, 5e-5
    name = 'sharded lap3d(100,100,128) which=4 tol=5e-5 on %d shards' % SHARDS
    a = lap3d(*grid, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(*grid, 1.0, 1.0, 1.0))[:which]
    lo, hi = spectral_bounds(a)
    reset_counters(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh = make_mesh(SHARDS)
    dm = shard_operator(DiaMatrix(a), mesh)
    ch = Chebyshev(a, lo, hi, degree=degree, device_matrix=dm)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    if not all(p.device.type == 'cuda' for p in dm.val.parts):
        fail('%s: the mesh with no device argument is not on the card' % name)
    m = default_block(which, a.shape[0])

    def run():
        t0 = time.perf_counter()
        out = lobpcg(dm, which, precond=ch.device_rows_operands(m),
                     tol=tol, maxit=600, sharding=blockvec_sharding(mesh))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with counting_sharded_applies() as applies:
        (lmd, x, _, its, status), cold = run()
    launches = {key: sw.LAUNCHES[key] for key in ('mesh_float32',
                                                  'mesh_bfloat16')}
    if min(launches.values()) <= 0:
        fail('%s skipped a kernel: launches %s' % (name, launches))
    check_one_launch_per_device(sw, st, name, applies)
    if sw.LAUNCHES['float32'] or sw.LAUNCHES['bfloat16']:
        fail('%s launched the unsharded DIA kernel: %s' % (name, sw.LAUNCHES))
    rows['dia_spmm_rows_mesh_f32']['launches'] = launches['mesh_float32']
    rows['dia_spmm_rows_mesh_bf16']['launches'] = launches['mesh_bfloat16']
    err = check_solution(np, name, lmd, x, status, exact, 1e-3)
    agree = float(np.abs(np.sort(lmd)[:which] / main_field['lmd'] - 1).max())
    if agree > SHARDED_AGREE:
        fail('%s: eigenvalues differ from the unsharded field\'s by %.2e > '
             '%.0e' % (name, agree, SHARDED_AGREE))
    if its != main_field['iterations']:
        fail('%s: %d iterations, the unsharded field %d'
             % (name, its, main_field['iterations']))
    (lmd, x, _, its2, status), warm = run()
    check_solution(np, name, lmd, x, status, exact, 1e-3)
    check_iterations(name, 'sharded', (its, its2))
    print('%s: status 0, %d iterations (warm run %d; unsharded %d), max rel '
          'eigenvalue error %.2e, within %.2e of the unsharded field; set-up '
          '(DIA, split, Chebyshev) %.3f s; lobpcg wall cold %.3f s, warm '
          '%.3f s (unsharded partial_hevp warm %.3f s); launches %s for %d '
          'sharded applies (unsharded K1: %s), no copy launch [%s; the shards '
          'share the card: no scaling measurement]'
          % (name, its, its2, main_field['iterations'], err, agree, setup,
             cold, warm, main_field['warm'], json.dumps(launches),
             len(applies), json.dumps(main_field['launches']), card))
    if profile:
        profile_run(torch, run, card)
    del dm, ch
    torch.cuda.empty_cache()

    # ---- ShardedEll ---------------------------------------------------
    reset_counters(mods)
    t0 = time.perf_counter()
    sm = ShardedEllMatrix(k_rel, mesh)
    setup = time.perf_counter() - t0
    n = k_rel.shape[0]
    xt = np.random.default_rng(6).standard_normal((n, 16)).astype(np.float32)
    y = sm.matmat_t(xt)
    torch.cuda.synchronize()
    copies = st.LAUNCHES['copy_lanes']
    if y.device.type != 'cuda' or y.shape != (n, 16):
        fail('ShardedEllMatrix product on %s, shape %s' % (y.device,
                                                           tuple(y.shape)))
    if sm.mode != 'halo' or copies != 1:
        fail('ShardedEllMatrix in mode %s made %d copy launches in one '
             'product, not one' % (sm.mode, copies))
    ell_launches = {k: v for k, v in ell.ELL_LAUNCHES.items() if v}
    if ell_launches != {('f32', 'f32'): SHARDS}:
        fail('ShardedEllMatrix: ELL launches %s in one product, not one a '
             'shard' % ell_launches)
    # the f32 batch is the copy kernel's case on this path; its halo and
    # bf16 rows are on none and keep 0
    rows['copy_lanes_many_f32']['launches'] = copies
    ref = k_rel @ xt.astype(np.float64)
    err = float(np.abs(y.cpu().numpy() - ref).max() / np.abs(ref).max())
    y_ell = EllMatrix(k_rel).matmat_t(torch.from_numpy(xt).cuda())
    err_ell = float((y - y_ell).abs().max() / y_ell.abs().max())
    if not (err < 1e-5 and err_ell < 1e-5):
        fail('ShardedEllMatrix: %.2e from SciPy, %.2e from EllMatrix'
             % (err, err_ell))
    xd = torch.from_numpy(xt).cuda()
    t = time_ms(lambda: sm.matmat_t(xd), 5)
    print('ShardedEllMatrix shipsec_like() n=%d on %d shards: mode %s, halo '
          '%s of %d rows per shard, row degree %d; m=16 product within %.2e '
          'of SciPy and %.2e of EllMatrix, %d copy launches and %d ELL '
          'launches, %.3f ms; set-up (RCM, ELL, upload) %.2f s [%s; one '
          'card: no scaling measurement]'
          % (n, SHARDS, sm.mode, sm.halo, sm.chunk, sm.row_degree, err,
             err_ell, copies, ell_launches[('f32', 'f32')], t, setup, card))


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
    from raleigh_tpu_torch import (BsrMatrix, Chebyshev, EllMatrix, lobpcg,
                                   partial_hevp, spectral_bounds)
    from raleigh_tpu_torch.core.device_solver import default_block
    sw, sp, _, ell = mods
    which, tol, degree = 6, 1e-4, 32
    (k_rel, m_rel), (k_nat, m_nat) = pencils
    n = k_rel.shape[0]

    # ---- FE-ELL -------------------------------------------------------
    name = 'FE-ELL shipsec_like() n=%d which=6 tol=1e-4' % n
    lo, hi = spectral_bounds(k_rel)
    reset_counters(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ch = Chebyshev(k_rel, hi * 1e-4, hi, degree=degree)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    layout = type(ch.device_matrix()).__name__
    if layout != 'EllMatrix':
        fail('%s: K landed in %s, not EllMatrix' % (name, layout))

    def ell_solve():
        """One FE-ELL solve with every counter set to 0: its result, and
        the ELL launches it made."""
        reset_counters(mods)
        with counting_plain_calls(sw, sp, ell) as plain:
            out = hevp_call(torch, partial_hevp, k_rel, B=m_rel, T=ch,
                            which=which, tol=tol)
        launches = {k: v for k, v in ell.ELL_LAUNCHES.items() if v}
        if any(sp.LAUNCHES.values()):
            fail('%s launched the BSR kernel: %s' % (name, sp.LAUNCHES))
        if any(plain.values()):
            fail('%s ran plain versions of the kernels: %s' % (name, plain))
        if set(launches) != {('f32', 'f32')}:
            fail('%s: ELL launches %s, not the f32 kernel alone'
                 % (name, launches))
        steps = {k: v for k, v in ell.ELL_STEP_LAUNCHES.items() if v}
        if set(steps) != {('f32', 'f32')}:
            fail('%s: Chebyshev step launches %s, not the f32 kernel alone'
                 % (name, steps))
        check_grams(name, [c for c in GRAM_CASES if not c[2]])
        return out, launches[('f32', 'f32')], steps[('f32', 'f32')]

    (lmd, x, st, its, cold, _, _), launches, _ = ell_solve()
    ell_lmd, rel = check_pencil(np, name, k_rel, m_rel, lmd, x, st, which)
    (lmd, x, st, its2, warm, lob, _), launches2, steps = ell_solve()
    check_pencil(np, name, k_rel, m_rel, lmd, x, st, which)
    check_iterations(name, 'FE-ELL', (its, its2))
    rows['ell_spmm_f32_f32']['launches'] = launches2
    rows['ell_step_f32_f32']['launches'] = steps
    print('%s: K in %s, status 0, %d iterations (warm run %d), relative '
          'residual %.2e, lambda %s; Chebyshev set-up %.3f s; partial_hevp '
          'wall cold %.3f s, warm %.3f s (LOBPCG %.3f s, rest %.3f s); ELL '
          'kernel launches %d (cold %d), Chebyshev step launches %d, no '
          'plain version [%s]'
          % (name, layout, its, its2, rel, np.array2string(
              ell_lmd, precision=6), setup, cold, warm, lob, warm - lob,
             launches2, launches, steps, card))
    if profile:
        profile_run(torch, lambda: hevp_call(
            torch, partial_hevp, k_rel, B=m_rel, T=ch, which=which, tol=tol),
            card)
    # the same pencil through lobpcg with bf16 Chebyshev iterates: the
    # kernel's f32-values, bf16-operand instantiation on its path
    label = name + ', bf16 iterates in the preconditioner'
    ell_m = EllMatrix(m_rel)
    m = default_block(which, n)
    precond = ch.device_rows_operands(m, n, stream_bf16=True)
    reset_counters(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counting_plain_calls(sw, sp, ell) as plain:
        lmd, x, _, its3, st = lobpcg(ch.device_matrix(), which, opB=ell_m,
                                     precond=precond, tol=tol, maxit=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in ell.ELL_LAUNCHES.items() if v}
    if any(plain.values()) or launches.get(('f32', 'bf16'), 0) <= 0:
        fail('%s: ELL launches %s, plain calls %s'
             % (label, launches, plain))
    rows['ell_spmm_f32_bf16']['launches'] = launches[('f32', 'bf16')]
    bf_lmd, rel = check_pencil(np, label, k_rel, m_rel, lmd, x, st, which)
    agree = float(np.abs(bf_lmd / ell_lmd - 1).max())
    if agree > FE_AGREE:
        fail('%s: eigenvalues differ from FE-ELL by %.2e > %.0e'
             % (label, agree, FE_AGREE))
    print('%s: status 0, %d iterations, relative residual %.2e, eigenvalues '
          'within %.2e of FE-ELL; lobpcg wall %.3f s; ELL launches %s [%s]'
          % (label, its3, rel, agree, wall,
             {'_'.join(k): c for k, c in launches.items()}, card))
    del ch, ell_m, precond
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
            check_iterations(label, 'FE-BSR', (its, its2))
            print('%s: status 0, %d iterations (warm run %d), relative '
                  'residual %.2e, eigenvalues within %.2e of FE-ELL; BSR '
                  'set-up (K and M, build and upload) %.3f s; lobpcg wall '
                  'cold %.3f s, warm %.3f s; BSR launches %s [%s]'
                  % (label, its, its2, rel, agree, setup, wall, warm,
                     {'_'.join(k5): c for k5, c in launches.items()}, card))
            if profile:
                profile_run(torch, run, card)
        else:
            print('%s: status 0, %d iterations, relative residual %.2e, '
                  'eigenvalues within %.2e of FE-ELL; lobpcg wall %.3f s; '
                  'BSR launches %s [%s]'
                  % (label, its, rel, agree, wall,
                     {'_'.join(k5): c for k5, c in launches.items()}, card))


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


def phase_wide(torch, np, lap3d, DiaMatrix, BsrMatrix, sw, sp, k_nat):
    """The f64 instantiations of the DIA and BSR kernels (f64 operand; f32
    or f64 values or tiles) against their plain versions on the same
    inputs: the DIA kernel on lap3d(100,100,128) equal bit for bit, the
    BSR kernel on the FE flagship in the mesher's order within
    ``F64_SUM_TOL`` of the largest |entry|; timed in turns with the plain
    version and ``torch.sparse.mm`` on the f64 CSR tensor (for the BSR
    kernel also an f64 ``torch.sparse_bsr_tensor``) at the core fields'
    block size ``CORE_BLOCK`` and at m = 16.  Returns their rows."""
    rows = {}
    gen = torch.Generator('cuda').manual_seed(9)
    csr = lap3d(100, 100, 128, 1.0, 1.0, 1.0)
    dm = DiaMatrix(csr, dtype=np.float64, device='cuda', exact=True)
    n = dm.shape[0]
    noff = len(dm.offsets)
    for vkey, val in (('val32', dm.val.float()), ('val64', dm.val)):
        name = 'dia_spmm_rows_f64_' + vkey
        for m in (CORE_BLOCK, 16):
            x = torch.randn((m, n), generator=gen, device='cuda',
                            dtype=torch.float64)
            yk = sw.dia_matmat_rows(val, x, dm.offsets_t)
            yp = sw.dia_matmat_rows_plain(val, x, dm.offsets_t)
            torch.cuda.synchronize()
            if yk.dtype != torch.float64 or not torch.isfinite(yk).all():
                fail('%s m=%d: output %s, or not finite' % (name, m,
                                                            yk.dtype))
            if not torch.equal(yk, yp):
                fail('%s vs plain m=%d: not equal bit for bit (max abs '
                     '%.3e)' % (name, m, (yk - yp).abs().max()))
            del yk, yp
            t = turns({'plain': lambda: sw.dia_matmat_rows_plain(
                           val, x, dm.offsets_t),
                       'kernel': lambda: sw.dia_matmat_rows(
                           val, x, dm.offsets_t),
                       'library': library_spmm_fn(torch, csr, x,
                                                  'float64')}, 50)
            nbytes = (noff * n * val.element_size() + noff * 4
                      + 2 * m * n * 8)
            flops = 2 * m * sum(n - abs(o) for o in dm.offsets)
            bound_ms, bound_by = bound(nbytes, flops, PEAK_F64)
            print('%s lap3d(100,100,128) n=%d m=%d: equal to plain bit for '
                  'bit; kernel %.4f ms (%.0f GB/s), plain %.4f ms, '
                  'torch.sparse.mm (f64) %s, bound %.4f ms (%s), in turns'
                  % (name, n, m, t['kernel'], nbytes / t['kernel'] / 1e6,
                     t['plain'], fmt_ms(t['library']), bound_ms, bound_by))
            if m == CORE_BLOCK:
                rows[name] = dict(
                    name=name, route='cuda', source=DIA[0], replaces=DIA[1],
                    launches=0, max_abs_err=0.0, ms=t['kernel'],
                    plain_ms=t['plain'], bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=t['library'], m=m,
                    bytes=nbytes)
            else:
                rows[name].update(m16_ms=t['kernel'], m16_bound_ms=bound_ms,
                                  m16_plain_ms=t['plain'],
                                  m16_library_ms=t['library'])

    n = k_nat.shape[0]
    mats = {'f32': BsrMatrix(k_nat, bs=128, device='cuda'),
            'f64': BsrMatrix(k_nat, dtype=np.float64, bs=128, device='cuda',
                             exact=True)}
    for tkey, bm in mats.items():
        name = 'bsr_spmm_rows_%s_f64' % tkey
        args = (bm.blocks, bm.block_indptr_t, bm.block_cols)
        for m in (CORE_BLOCK, 16):
            x = torch.randn((m, n), generator=gen, device='cuda',
                            dtype=torch.float64)
            yp = sp.bsr_matmat_rows_plain(*args, x, n)
            yk = sp.bsr_matmat_rows(*args, x, n)
            torch.cuda.synchronize()
            if yk.dtype != torch.float64 or not torch.isfinite(yk).all():
                fail('%s m=%d: output %s, or not finite'
                     % (name, m, yk.dtype))
            diff = (yk - yp).abs().max().item()
            rel = diff / yp.abs().max().item()
            if rel > F64_SUM_TOL:
                fail('%s vs plain m=%d: %.2e of the largest entry > %.0e'
                     % (name, m, rel, F64_SUM_TOL))
            del yk, yp
            t = turns({'plain': lambda: sp.bsr_matmat_rows_plain(*args, x,
                                                                 n),
                       'kernel': lambda: sp.bsr_matmat_rows(*args, x, n),
                       'csr': library_spmm_fn(torch, k_nat, x, 'float64'),
                       'bsr': library_bsr_fn(torch, bm, x)}, 20)
            nbytes = (bm.blocks.numel() * bm.blocks.element_size()
                      + 2 * m * n * 8 + bm.block_indptr_t.numel() * 4
                      + bm.block_cols.numel() * 4)
            flops = 2 * bm.blocks.numel() * m
            bound_ms, bound_by = bound(nbytes, flops, PEAK_F64_MMA)
            print('%s flagship n=%d m=%d: %.2e of the largest entry from '
                  'plain; kernel %.4f ms (%.0f GB/s), plain %.4f ms, '
                  'torch.sparse.mm (f64 CSR) %s, f64 BSR tensor %s, bound '
                  '%.4f ms (%s), in turns'
                  % (name, n, m, rel, t['kernel'],
                     nbytes / t['kernel'] / 1e6, t['plain'], fmt_ms(t['csr']),
                     fmt_ms(t['bsr']), bound_ms, bound_by))
            if m == CORE_BLOCK:
                rows[name] = dict(
                    name=name, route='cuda', source=BSR[0], replaces=BSR[1],
                    launches=0, max_abs_err=diff, ms=t['kernel'],
                    plain_ms=t['plain'], bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=t['csr'],
                    library_bsr_ms=t['bsr'], m=m, bytes=nbytes)
            else:
                rows[name].update(m16_ms=t['kernel'], m16_bound_ms=bound_ms,
                                  m16_plain_ms=t['plain'],
                                  m16_library_ms=t['csr'])
    rows['bsr_spmm_rows_f64_f64']['off_path'] = (
        'f64 tiles come with a BSR operator built with exact f64 values, '
        'which partial_hevp builds only for a matrix that device_sparse '
        'lays out as BSR; no field here has one (the FE-BSR core field '
        'drives the f32-tile instantiation)')
    return rows


def phase_mesh_wide(torch, np, lap3d, DiaMatrix, sw):
    """The f64 instantiations of the mesh DIA kernel (K4: an f64 operand,
    f32 or f64 values) at the sharded core field's shapes:
    lap3d(100,100,128) in ``SHARDS`` shards of the card, m = ``CORE_BLOCK``.
    One sharded apply is one launch; it equals the plain version over the
    piece table (within ``F64_SUM_TOL`` of the largest |entry|; the kernel
    keeps its products and order of sums, so it is exact in practice) and
    the unsharded f64 kernel bit for bit.  Timed in turns with the plain
    version, the unsharded f64 kernel and ``torch.sparse.mm`` on the f64
    CSR tensor.  Returns their rows."""
    from raleigh_tpu_torch.core.device_solver import shard_operator
    from raleigh_tpu_torch.parallel.mesh import (ShardedRows,
                                                 blockvec_sharding, make_mesh)
    rows = {}
    gen = torch.Generator('cuda').manual_seed(13)
    csr = lap3d(100, 100, 128, 1.0, 1.0, 1.0)
    mesh = make_mesh(SHARDS)
    m = CORE_BLOCK
    for vkey, values in (('val32', np.float32), ('val64', np.float64)):
        whole = DiaMatrix(csr, dtype=values, device='cuda', exact=True)
        dm = shard_operator(DiaMatrix(csr, dtype=values, device='cuda',
                                      exact=True), mesh)
        n, noff = whole.shape[0], len(whole.offsets)
        plan = dm._mesh_plan(dm.val.sharding)
        vals = dm.val.parts
        x = torch.randn((m, n), generator=gen, device='cuda',
                        dtype=torch.float64)
        xs = ShardedRows.split(x, blockvec_sharding(mesh))
        name = 'dia_spmm_mesh_f64_' + vkey
        before = dict(sw.LAUNCHES)
        ym = dm.matmat_rows(xs)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in sw.LAUNCHES.items()
                 if v != before[k]}
        if moved != {'mesh_float64_' + vkey: 1}:
            fail('%s: one sharded apply launched %s, not one mesh kernel'
                 % (name, moved))
        got = ym.gather()
        want = torch.cat(sw.dia_matmat_rows_mesh_plain(vals, xs.parts, plan),
                         dim=1)
        if got.dtype != torch.float64 or not torch.isfinite(got).all():
            fail('%s: output %s, or not finite' % (name, got.dtype))
        diff = (got - want).abs().max().item()
        rel = diff / want.abs().max().item()
        if rel > F64_SUM_TOL:
            fail('%s vs plain: %.2e of the largest entry > %.0e'
                 % (name, rel, F64_SUM_TOL))
        if not torch.equal(got, whole.matmat_rows(x)):
            fail('%s: the sharded apply differs from the unsharded f64 '
                 'kernel\'s' % name)
        exact = torch.equal(got, want)
        del ym, got, want
        t = turns({'plain': lambda: sw.dia_matmat_rows_mesh_plain(
                       vals, xs.parts, plan),
                   'kernel': lambda: sw.dia_matmat_rows_mesh(
                       vals, xs.parts, plan),
                   'k1': lambda: whole.matmat_rows(x),
                   'library': library_spmm_fn(torch, csr, x, 'float64')},
                  50)
        # K1's work: a shard's halo lanes are its neighbours' own, read
        # once as a whole-matrix apply reads them
        nbytes = noff * n * np.dtype(values).itemsize + noff * 4 \
            + 2 * m * n * 8
        flops = 2 * m * sum(n - abs(o) for o in whole.offsets)
        bound_ms, bound_by = bound(nbytes, flops, PEAK_F64)
        print('%s lap3d(100,100,128) in %d shards, m=%d: one launch; %.2e '
              'of the largest entry from plain (%s), equal to the unsharded '
              'f64 kernel bit for bit; kernel %.4f ms (%.0f GB/s), plain '
              '%.4f ms, unsharded f64 kernel %.4f ms, torch.sparse.mm (f64) '
              '%s, bound %.4f ms (%s), in turns [one card: no scaling '
              'measurement]'
              % (name, SHARDS, m, rel, 'bit for bit' if exact else
                 'not bit for bit', t['kernel'], nbytes / t['kernel'] / 1e6,
                 t['plain'], t['k1'], fmt_ms(t['library']), bound_ms,
                 bound_by))
        rows[name] = dict(
            name=name, route='cuda', source=EXT[0], replaces=EXT[1],
            launches=0, max_abs_err=diff, ms=t['kernel'],
            plain_ms=t['plain'], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=t['library'], m=m, shards=SHARDS, k1_ms=t['k1'],
            bytes=nbytes)
        del dm, whole, plan, vals, xs, x
    torch.cuda.empty_cache()
    return rows


def complex_chain(np, n):
    """The complex Hermitian chain of tests/test_sparse.py:175 (hopping i
    and -i next to the diagonal linspace(0, 1, n)) and B = I + 0.25 H, H
    its hopping part: B's spectrum lies in [0.5, 1.5], so it is positive
    definite."""
    import scipy.sparse as scs
    d = 1j * np.ones(n - 1)
    hop = scs.csr_matrix(scs.diags(d, 1) - scs.diags(d, -1))
    a = scs.csr_matrix(hop + scs.diags(np.linspace(0, 1, n)))
    b = scs.csr_matrix(scs.eye(n) + 0.25 * hop)
    return a, b


# the stacked route of a complex block (ops/complex_rows.py), which c128
# blocks on a DIA matrix took before the complex instantiation
OFF_PATH_STACKED = (
    'the stacked route (ops/complex_rows.py over the f64 instantiation), '
    'timed in turns with the complex instantiation; only c64 blocks and '
    'real operands with complex values take it, on no field\'s path')


def phase_complex_kernels(torch, np, sw, sp, DiaMatrix, BsrMatrix, k_nat):
    """The DIA kernel's complex instantiation and the BSR kernel's complex
    route against their plain versions on complex tensors, at m =
    ``CORE_BLOCK`` c128 rows, within ``F64_SUM_TOL`` of the largest
    |entry|: K1 on the complex field's B (the chain's c128 values, n =
    ``COMPLEX_N``: one launch of ``dia_spmm_rows_c128_val128``), and on
    B's pattern with real f64 and f32 values (|B|: ``_val64``,
    ``_val32``), each timed in turns with the stacked route it replaced
    (``dia_matmat_rows_complex_stacked``: two f64 launches over the stacked
    real and imaginary rows for c128 values, one for real values); K5 on
    the FE flagship in the mesher's order with f32 tiles (one f64 launch
    over the stacked rows).  Timed in turns with the plain version and
    ``torch.sparse.mm`` on the complex CSR tensor.  Returns their rows."""
    rows = {}
    gen = torch.Generator('cuda').manual_seed(17)
    m = CORE_BLOCK
    _, b = complex_chain(np, COMPLEX_N)
    dm = DiaMatrix(b, dtype=np.complex128, device='cuda', exact=True)
    nb = dm.shape[0]
    terms = sum(nb - abs(o) for o in dm.offsets)
    babs = abs(b).astype(np.complex128)
    bm = BsrMatrix(k_nat, bs=128, device='cuda')
    bargs = (bm.blocks, bm.block_indptr_t, bm.block_cols)

    def dia_case(name, val, csr, flops_per_term, stacked_launches):
        stacked_key = ('complex_float64_val32' if val.dtype == torch.float32
                       else 'complex_float64_val64')
        return (name, DIA, name.replace('dia_spmm_rows_c128',
                                        'complex128'),
                csr, nb, lambda x: sw.dia_matmat_rows(val, x, dm.offsets_t),
                lambda x: sw.dia_matmat_rows_plain(val, x, dm.offsets_t),
                sw.LAUNCHES, 1,
                lambda x: sw.dia_matmat_rows_complex_stacked(val, x,
                                                             dm.offsets_t),
                (stacked_key, stacked_launches),
                len(dm.offsets) * nb * val.element_size()
                + len(dm.offsets) * 4, flops_per_term * terms)
    cases = (
        dia_case('dia_spmm_rows_c128_val128', dm.val, b, 8, 2),
        dia_case('dia_spmm_rows_c128_val64', dm.val.abs(), babs, 4, 1),
        dia_case('dia_spmm_rows_c128_val32', dm.val.abs().float(), babs, 4,
                 1),
        ('bsr_spmm_rows_complex_f32_f64', BSR, ('f32', 'f64', 'complex'),
         k_nat, k_nat.shape[0],
         lambda x: sp.bsr_matmat_rows(*bargs, x, k_nat.shape[0]),
         lambda x: sp.bsr_matmat_rows_plain(*bargs, x, k_nat.shape[0]),
         sp.LAUNCHES, 1, None, None,
         bm.blocks.numel() * 4 + bm.block_indptr_t.numel() * 4
         + bm.block_cols.numel() * 4, 4 * bm.blocks.numel()))
    for (name, src, key, csr, n, kern, plain, counts, launches, stacked,
         stacked_count, matrix_bytes, flops_per_row) in cases:
        x = torch.complex(
            torch.randn((m, n), generator=gen, device='cuda',
                        dtype=torch.float64),
            torch.randn((m, n), generator=gen, device='cuda',
                        dtype=torch.float64))
        before = dict(counts)
        got = kern(x)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in counts.items()
                 if v != before[k]}
        if moved != {key: launches}:
            fail('%s: launches %s for one complex apply, not %d under %s'
                 % (name, moved, launches, key))
        want = plain(x)
        outs = {'kernel': got}
        if stacked is not None:
            before = dict(counts)
            outs['stacked route'] = stacked(x)
            torch.cuda.synchronize()
            moved = {k: v - before[k] for k, v in counts.items()
                     if v != before[k]}
            if moved != {stacked_count[0]: stacked_count[1]}:
                fail('%s: the stacked route launched %s, not %d under %s'
                     % (name, moved, stacked_count[1], stacked_count[0]))
        errs = {}
        for what, y in outs.items():
            if y.dtype != torch.complex128 or not torch.isfinite(
                    torch.view_as_real(y)).all():
                fail('%s: %s output %s, or not finite' % (name, what,
                                                           y.dtype))
            diff = (y - want).abs().max().item()
            rel = diff / want.abs().max().item()
            if rel > F64_SUM_TOL:
                fail('%s (%s) vs plain: %.2e of the largest entry > %.0e'
                     % (name, what, rel, F64_SUM_TOL))
            errs[what] = (diff, rel)
        del got, want, outs
        t = turns({'plain': lambda: plain(x), 'kernel': lambda: kern(x),
                   'stacked': None if stacked is None
                   else lambda: stacked(x),
                   'library': library_spmm_fn(torch, csr, x, 'complex128')},
                  20)
        nbytes = matrix_bytes + 2 * m * n * 16
        bound_ms, bound_by = bound(nbytes, m * flops_per_row,
                                   PEAK_F64 if src is DIA else PEAK_F64_MMA)
        print('%s n=%d m=%d (c128 operand, %d launch%s an apply): %s; '
              'kernel %.4f ms (%.0f GB/s), stacked route %s, plain %.4f ms, '
              'torch.sparse.mm (c128 CSR) %s, bound %.4f ms (%s), in turns'
              % (name, n, m, launches, 'es' if launches > 1 else '',
                 '; '.join('%s %.2e of the largest entry from plain'
                           % (what, rel) for what, (_, rel) in errs.items()),
                 t['kernel'], nbytes / t['kernel'] / 1e6,
                 fmt_ms(t['stacked']),
                 t['plain'], fmt_ms(t['library']), bound_ms, bound_by))
        rows[name] = dict(
            name=name, route='cuda', source=src[0], replaces=src[1],
            launches=0, max_abs_err=errs['kernel'][0], ms=t['kernel'],
            plain_ms=t['plain'], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=t['library'], m=m, bytes=nbytes)
        if stacked is not None:
            rows[name]['stacked_ms'] = t['stacked']
        if name == 'dia_spmm_rows_c128_val128':
            # the stacked route on the complex field's B, as it ran there
            # before the complex instantiation
            rows['dia_spmm_rows_complex_f64_val64'] = dict(
                rows[name], name='dia_spmm_rows_complex_f64_val64',
                max_abs_err=errs['stacked route'][0], ms=t['stacked'],
                off_path=OFF_PATH_STACKED)
            del rows['dia_spmm_rows_complex_f64_val64']['stacked_ms']
        del x
    for name in ('dia_spmm_rows_c128_val64', 'dia_spmm_rows_c128_val32'):
        rows[name]['off_path'] = (
            'no field here applies a real DIA matrix to a c128 block (the '
            'complex field\'s B has c128 values); held against its plain '
            'version above')
    rows['bsr_spmm_rows_complex_f32_f64']['off_path'] = (
        'no field here has a complex block on a BSR operator (the complex '
        'field\'s B is tridiagonal, so DIA); the route is held against its '
        'plain version above')
    return rows


@contextlib.contextmanager
def counting_plain_calls(sw, sp, ell):
    """Counts the calls of the DIA, mesh DIA, BSR and ELL kernels' plain
    versions made inside the block: none may come from a path on the
    card."""
    names = {'dia': (sw, 'dia_matmat_rows_plain'),
             'mesh': (sw, '_mesh_shard_plain'),
             'bsr': (sp, 'bsr_matmat_rows_plain'),
             'ell': (ell, '_ell_matmat_plain'),
             'ell_step': (ell, '_ell_step_plain')}
    calls = dict.fromkeys(names, 0)
    inner = {key: getattr(mod, attr) for key, (mod, attr) in names.items()}

    def counter(key):
        def counted(*a):
            calls[key] += 1
            return inner[key](*a)
        return counted
    for key, (mod, attr) in names.items():
        setattr(mod, attr, counter(key))
    try:
        yield calls
    finally:
        for key, (mod, attr) in names.items():
            setattr(mod, attr, inner[key])


def phase_core(torch, np, mods, rows, card, pencils, profile=False):
    """The core block Jacobi-CG Solver under partial_hevp, on the card with
    no device argument, at the JAX package's f64 flagship sizes:
    shift-invert on lap3d 50^3 and on the FE flagship, buckling (against
    the same call on the host, arch='cpu'), engine='core' with a Chebyshev
    on lap3d(100,100,128) (the f64 DIA kernel's path) and with a BSR
    Chebyshev on the FE flagship in the mesher's order (the f64 BSR
    kernel's path).  No plain version of a kernel may run."""
    from raleigh_tpu_torch import (BsrMatrix, Chebyshev, partial_hevp,
                                   SparseSymmetricSolver, spectral_bounds)
    from raleigh_tpu_torch.algebra import dense_torch
    from raleigh_tpu_torch.native import ldlt
    from raleigh_tpu_torch.examples import fe_model as fe
    from raleigh_tpu_torch.examples.laplace import lap3d, lap3d_eigenvalues
    from raleigh_tpu_torch.utils.link import choose_orchestration, probe_link
    sw, sp, _, ell = mods

    t0 = time.perf_counter()
    ldlt._load()      # the host LDL^T library: built with g++ at first use
    print('native LDL^T library loaded in %.2f s (built at first use)'
          % (time.perf_counter() - t0))
    with counting_plain_calls(sw, sp, ell) as plain:
        # 1. lap3d 50^3 shift-invert, 10 smallest (bench.py:146-182)
        a = lap3d(50, 50, 50, 1.0, 1.0, 1.0)
        exact = np.sort(lap3d_eigenvalues(50, 50, 50, 1.0, 1.0, 1.0))[:10]
        link = probe_link()
        choice = choose_orchestration(a.shape[0], 32)
        print('link probe: up %.1f GB/s, down %.1f GB/s, round trip %.1f us;'
              ' orchestration for n=%d: %s [%s]'
              % (link['up_bytes_per_s'] / 1e9, link['down_bytes_per_s'] / 1e9,
                 link['rtt_s'] * 1e6, a.shape[0], choice, card))
        if choice != 'device':
            fail('the link probe chose %s orchestration on a co-located '
                 'card' % choice)
        reset_counters(mods)
        dense_torch.reset_counts()
        lmd, x, st, its, wall, solve_s, setup = hevp_call(
            torch, partial_hevp, a, sigma=0.0, which=10)
        if st != 0 or lmd is None or len(lmd) < 10:
            fail('lap3d 50^3 shift-invert: status %s' % st)
        err = float(np.max(np.abs(np.sort(lmd)[:10] - exact) / exact))
        if err > SHIFT_INVERT_LIMIT or not np.all(np.isfinite(x)):
            fail('lap3d 50^3 shift-invert: eigenvalue error %.2e' % err)
        print('core 1, lap3d 50^3 shift-invert sigma=0 which=10: status 0, '
              '%d iterations, max rel eigenvalue error %.2e (limit %.0e); '
              'set-up %.2f s (analyse, factorize, probe), solve %.2f s, '
              'wall %.2f s; %s orchestration; %d transfers to the host, %d '
              'uploads; ELL launches %s [%s]'
              % (its, err, SHIFT_INVERT_LIMIT, setup, solve_s, wall, choice,
                 dense_torch.COUNTS['to_host'],
                 dense_torch.COUNTS['to_device'], ell_launches(ell), card))
        # where the set-up and an iteration go: the factorization and one
        # host solve of a block of the Solver's default size (32)
        t0 = time.perf_counter()
        fact = SparseSymmetricSolver()
        fact.analyse(a, 0.0)
        t1 = time.perf_counter()
        fact.factorize()
        t2 = time.perf_counter()
        rhs = np.random.RandomState(0).standard_normal((32, a.shape[0]))
        out = np.empty_like(rhs)
        fact.solve(rhs, out)
        t3 = time.perf_counter()
        print('  lap3d 50^3 LDL^T on the host: analyse %.2f s, factorize '
              '%.2f s, one solve of 32 right-hand sides %.3f s [%s]'
              % (t1 - t0, t2 - t1, t3 - t2, card))
        del fact

        # 2. the FE flagship, shift-invert, 6 nearest 0 (bench.py:460-488)
        k = pencils[0][0]
        reset_counters(mods)
        lmd, x, st, its, wall, solve_s, setup = hevp_call(
            torch, partial_hevp, k, sigma=0, which=6, tol=1e-6)
        if st != 0 or lmd is None or len(lmd) < 6:
            fail('FE flagship shift-invert: status %s' % st)
        r = k @ x[:, :6] - x[:, :6] * lmd[None, :6]
        rel = float(np.abs(r).max() / 0.25)     # ||K||_inf ~ 0.25
        if not rel <= FE_SHIFT_INVERT_LIMIT:
            fail('FE flagship shift-invert: residual %.1e' % rel)
        print('core 2, FE flagship shift-invert n=%d sigma=0 which=6 '
              'tol=1e-6: status 0, %d iterations, residual %.1e (limit '
              '%.0e); set-up %.2f s, solve %.2f s, wall %.2f s; ELL '
              'launches %s [%s]'
              % (k.shape[0], its, rel, FE_SHIFT_INVERT_LIMIT, setup,
                 solve_s, wall, ell_launches(ell), card))

        # 3. buckling, 3 load factors in (-0.08, 0) (bench.py:498-530)
        kb, gb = fe.buckling_64k()
        reset_counters(mods)
        lmd, x, st, its, wall, solve_s, setup = hevp_call(
            torch, partial_hevp, kb, B=gb, buckling=True, sigma=-0.08,
            which=3, tol=1e-5)
        core3_ell = ell_launches(ell)
        hl, hx, hst, hits, hwall, _, _ = hevp_call(
            torch, partial_hevp, kb, B=gb, buckling=True, sigma=-0.08,
            which=3, tol=1e-5, arch='cpu')
        if st < 0 or hst < 0 or lmd is None or len(lmd) < 3:
            fail('buckling: status %s (host %s)' % (st, hst))
        agree = float(np.max(np.abs(lmd[:3] - hl[:3]) / np.abs(hl[:3])))
        if not agree <= BUCKLING_AGREE:
            fail('buckling: load factors %s against the host\'s %s (%.1e)'
                 % (lmd[:3], hl[:3], agree))
        print('core 3, buckling n=%d sigma=-0.08 which=3: status %d, %d '
              'iterations, load factors %s, within %.1e of the host run '
              '(arch=\'cpu\': %d iterations, wall %.2f s); set-up %.2f s, '
              'solve %.2f s, wall %.2f s; ELL launches %s [%s]'
              % (kb.shape[0], st, its, np.array2string(lmd[:3]), agree,
                 hits, hwall, setup, solve_s, wall, core3_ell, card))

        # 4. engine='core' with a Chebyshev (bench.py:581-611 parameters)
        a = lap3d(100, 100, 128, 1.0, 1.0, 1.0)
        exact = np.sort(lap3d_eigenvalues(100, 100, 128, 1.0, 1.0, 1.0))[:4]
        lo, hi = spectral_bounds(a)
        ch = Chebyshev(a, lo, hi, degree=12)
        walls, launches = [], None
        for run in range(2):
            reset_counters(mods)
            dense_torch.reset_counts()
            lmd, x, st, its, wall, solve_s, _ = hevp_call(
                torch, partial_hevp, a, T=ch, which=4, tol=5e-5,
                engine='core')
            err = check_solution(np, 'core engine lap3d(100,100,128)', lmd,
                                 x, st, exact, 1e-3)
            walls.append(wall)
            launches = {key: sw.LAUNCHES[key]
                        for key in ('float64_val32', 'float64_val64')}
            if min(launches.values()) <= 0:
                fail('core engine: the f64 DIA kernel was skipped: %s'
                     % launches)
            other = {key: v for key, v in sw.LAUNCHES.items()
                     if v and key not in launches}
            if other:
                fail('core engine launched other DIA kernels: %s' % other)
        syncs = dense_torch.COUNTS['to_host'] / its
        core4 = dict(lmd=np.sort(lmd)[:4], iterations=its, warm=walls[1])
        if profile:
            profile_run(torch, lambda: hevp_call(
                torch, partial_hevp, a, T=ch, which=4, tol=5e-5,
                engine='core'), card)
        rows['dia_spmm_rows_f64_val32']['launches'] = \
            launches['float64_val32']
        rows['dia_spmm_rows_f64_val64']['launches'] = \
            launches['float64_val64']
        print('core 4, engine=\'core\' lap3d(100,100,128) which=4 tol=5e-5 '
              'Chebyshev degree 12: status 0, %d iterations, max rel '
              'eigenvalue error %.2e; wall cold %.2f s, warm %.2f s (solve '
              '%.2f s); f64 DIA kernel launches per solve %s; %.2f host '
              'transfers per iteration (%d in all), %d uploads; ELL launches '
              '%s [%s]'
              % (its, err, walls[0], walls[1], solve_s,
                 json.dumps(launches), syncs, dense_torch.COUNTS['to_host'],
                 dense_torch.COUNTS['to_device'], ell_launches(ell), card))

        # 5. engine='core' with a BSR Chebyshev: the f64 BSR kernel's path
        k_nat = pencils[1][0]
        lo, hi = spectral_bounds(k_nat)
        tb = Chebyshev(k_nat, hi * 1e-4, hi, degree=32,
                       device_matrix=BsrMatrix(k_nat, bs=128))
        reset_counters(mods)
        dense_torch.reset_counts()
        lmd, x, st, its, wall, solve_s, _ = hevp_call(
            torch, partial_hevp, k_nat, T=tb, which=6, tol=1e-4,
            engine='core')
        if st != 0 or lmd is None or len(lmd) < 6:
            fail('FE-BSR core: status %s' % st)
        kinf = float(abs(k_nat).sum(axis=1).max())
        r = k_nat @ x[:, :6] - x[:, :6] * lmd[None, :6]
        res = float(np.max(np.linalg.norm(r, axis=0)
                           / (kinf * np.linalg.norm(x[:, :6], axis=0))))
        if not res <= FE_RESIDUAL_LIMIT:
            fail('FE-BSR core: residual %.2e' % res)
        bl = sp.LAUNCHES[('f32', 'f64')]
        if bl <= 0:
            fail('FE-BSR core: the f64 BSR kernel was skipped')
        for key in (('f32', 'f64'), ('f64', 'f64')):
            rows['bsr_spmm_rows_%s_%s' % key]['launches'] = sp.LAUNCHES[key]
        print('core 5, engine=\'core\' FE flagship (mesher order) which=6 '
              'tol=1e-4, BSR Chebyshev degree 32: status 0, %d iterations, '
              'residual %.2e (limit %.0e); wall %.2f s (solve %.2f s); f64 '
              'BSR kernel launches %d; ELL launches %s (the operator K); '
              '%.2f host transfers per iteration [%s]'
              % (its, res, FE_RESIDUAL_LIMIT, wall, solve_s, bl,
                 ell_launches(ell), dense_torch.COUNTS['to_host'] / its,
                 card))
        if profile:
            busy, kernels = profile_run(torch, lambda: hevp_call(
                torch, partial_hevp, k_nat, T=tb, which=6, tol=1e-4,
                engine='core'), card)
            k5 = [e for e in kernels if 'wide::bsr_rows_kernel' in e.key]
            k5_s = sum(e.self_device_time_total for e in k5) / 1e6
            print('  core 5: the f64 BSR kernel %.1f ms over %d launches, '
                  '%.1f%% of device time [%s]'
                  % (k5_s * 1e3, sum(e.count for e in k5),
                     100 * k5_s / busy, card))

        # 5b. engine='core' on the relabelled FE flagship with its own
        # Chebyshev, which lands in EllMatrix: the ELL kernel's f64
        # instantiations (f32 values in the recurrence, the operator's
        # f64 values) on their path
        k_rel = pencils[0][0]
        lo, hi = spectral_bounds(k_rel)
        te = Chebyshev(k_rel, hi * 1e-4, hi, degree=32)
        if type(te.device_matrix()).__name__ != 'EllMatrix':
            fail('FE-ELL core: the Chebyshev landed in %s, not EllMatrix'
                 % type(te.device_matrix()).__name__)
        reset_counters(mods)
        dense_torch.reset_counts()
        lmd, x, st, its, wall, solve_s, _ = hevp_call(
            torch, partial_hevp, k_rel, T=te, which=6, tol=1e-4,
            engine='core')
        if st != 0 or lmd is None or len(lmd) < 6:
            fail('FE-ELL core: status %s' % st)
        kinf = float(abs(k_rel).sum(axis=1).max())
        r = k_rel @ x[:, :6] - x[:, :6] * lmd[None, :6]
        res = float(np.max(np.linalg.norm(r, axis=0)
                           / (kinf * np.linalg.norm(x[:, :6], axis=0))))
        if not res <= FE_RESIDUAL_LIMIT:
            fail('FE-ELL core: residual %.2e' % res)
        launches = dict(ell.ELL_LAUNCHES)
        steps = ell.ELL_STEP_LAUNCHES[('f32', 'f64')]
        if launches[('f64', 'f64')] <= 0 or steps <= 0:
            fail('FE-ELL core: the f64 ELL kernel or the f32 x f64 '
                 'Chebyshev step was skipped: %s, steps %s'
                 % (ell_launches(ell), ell.ELL_STEP_LAUNCHES))
        if launches[('f32', 'f64')]:
            fail('FE-ELL core: the recurrence launched the ELL kernel: %s'
                 % ell_launches(ell))
        rows['ell_spmm_f64_f64']['launches'] = launches[('f64', 'f64')]
        rows['ell_step_f32_f64']['launches'] = steps
        print('core 5b, engine=\'core\' FE flagship (relabelled) which=6 '
              'tol=1e-4, its own Chebyshev degree 32 (EllMatrix): status 0, '
              '%d iterations, residual %.2e (limit %.0e); wall %.2f s (solve '
              '%.2f s); ELL launches %s, Chebyshev step launches %d; %.2f '
              'host transfers per iteration [%s]'
              % (its, res, FE_RESIDUAL_LIMIT, wall, solve_s,
                 ell_launches(ell), steps,
                 dense_torch.COUNTS['to_host'] / its, card))
        del te
    if any(plain.values()):
        fail('the core phase ran plain versions of the kernels: %s' % plain)
    return core4


def phase_mesh_core(torch, np, mods, rows, card, core4, profile=False):
    """Core 4's problem (lap3d(100,100,128), 4 smallest, tol 5e-5,
    Chebyshev degree 12) on the port's ``Solver`` with f64 ``dense_torch``
    blocks split over ``make_mesh(8)`` and over ``make_mesh2d(2, 4)``, eight
    shards of the card, with the operator and preconditioner that
    ``partial_hevp(engine='core')`` builds (``SparseSymmetricMatrix`` with
    exact f64 values, the Chebyshev's own f32 values), both split by
    ``shard_operator``.  Cold and warm on each mesh: status 0, error <=
    1e-3, within ``MESH_CORE_AGREE`` of core 4's eigenvalues, the f64 mesh
    kernel launched for both value types, once per device per sharded
    apply; no other DIA or BSR kernel, no copy, no plain version."""
    from raleigh_tpu_torch import Chebyshev, spectral_bounds
    from raleigh_tpu_torch.algebra import dense_torch
    from raleigh_tpu_torch.algebra.sparse import SparseSymmetricMatrix
    from raleigh_tpu_torch.core.device_solver import shard_operator
    from raleigh_tpu_torch.core.solver import (DefaultConvergenceCriteria,
                                               Options, Problem, Solver)
    from raleigh_tpu_torch.examples.laplace import lap3d, lap3d_eigenvalues
    from raleigh_tpu_torch.parallel.mesh import (blockvec_sharding,
                                                 make_mesh, make_mesh2d)
    sw, sp, st, ell = mods
    a = lap3d(100, 100, 128, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(100, 100, 128, 1.0, 1.0, 1.0))[:4]
    lo, hi = spectral_bounds(a)
    keys = ('mesh_float64_val32', 'mesh_float64_val64')
    for label, mesh in (('make_mesh(%d)' % SHARDS, make_mesh(SHARDS)),
                        ('make_mesh2d(2, %d)' % (SHARDS // 2),
                         make_mesh2d(2, SHARDS // 2))):
        name = 'sharded core 4 on %s' % label
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        op = SparseSymmetricMatrix(a, exact=True)
        ch = Chebyshev(a, lo, hi, degree=12)
        shard_operator(op.device_matrix(), mesh, axis=mesh.axis_names)
        shard_operator(ch.device_matrix(), mesh, axis=mesh.axis_names)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        sh = blockvec_sharding(mesh)

        def run():
            v = dense_torch.Vectors(a.shape[0], 0, np.float64, sharding=sh)
            solver = Solver(Problem(v, op))
            solver.set_preconditioner(ch)
            opt = Options()
            opt.convergence_criteria = DefaultConvergenceCriteria()
            opt.convergence_criteria.set_error_tolerance(
                'k eigenvector error', 5e-5)
            opt.sigma = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            status = solver.solve(v, opt, which=(4, 0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            lmd = solver.eigenvalues
            order = np.argsort(lmd)
            x = v.data().T[:, order] if v.nvec() else None
            return lmd[order], x, status, solver.iteration, wall

        walls = []
        for _ in range(2):
            reset_counters(mods)
            dense_torch.reset_counts()
            with counting_plain_calls(sw, sp, ell) as plain, \
                    counting_sharded_applies() as applies:
                lmd, x, status, its, wall = run()
            walls.append(wall)
            err = check_solution(np, name, lmd, x, status, exact, 1e-3)
            agree = float(np.abs(lmd[:4] / core4['lmd'] - 1).max())
            if agree > MESH_CORE_AGREE:
                fail('%s: eigenvalues %.2e from core 4\'s (limit %.0e)'
                     % (name, agree, MESH_CORE_AGREE))
            launches = {key: sw.LAUNCHES[key] for key in keys}
            if min(launches.values()) <= 0:
                fail('%s: the f64 mesh kernel was skipped: %s'
                     % (name, launches))
            other = {key: v for key, v in sw.LAUNCHES.items()
                     if v and key not in keys}
            if other or any(sp.LAUNCHES.values()):
                fail('%s launched other kernels: %s %s'
                     % (name, other, {k: v for k, v in sp.LAUNCHES.items()
                                      if v}))
            check_one_launch_per_device(sw, st, name, applies)
            if any(plain.values()):
                fail('%s ran plain versions of the kernels: %s'
                     % (name, plain))
        if mesh.devices.ndim == 1:
            for key in keys:
                rows['dia_spmm_mesh_f64_' + key[-5:]]['launches'] = \
                    launches[key]
        print('%s: status 0, %d iterations (core 4, unsharded: %d), max rel '
              'eigenvalue error %.2e, within %.2e of core 4; wall cold %.2f '
              's, warm %.2f s (core 4 warm %.2f s); set-up (operator, '
              'Chebyshev, split) %.2f s; f64 mesh kernel launches per solve '
              '%s for %d sharded applies (one per device each), no K1, no '
              'plain version; %.2f host transfers per iteration [%s; the '
              'shards share the card: no scaling measurement]'
              % (name, its, core4['iterations'], err, agree, walls[0],
                 walls[1], core4['warm'], setup, json.dumps(launches),
                 len(applies), dense_torch.COUNTS['to_host'] / its, card))
        if profile:
            profile_run(torch, run, card)
        del op, ch
    torch.cuda.empty_cache()


def phase_complex(torch, np, mods, rows, card):
    """Generalized shift-invert of the complex Hermitian chain (``COMPLEX_N``
    = core 1's size, sigma ``COMPLEX_SIGMA``, 4 nearest, tol 1e-6) with B =
    I + 0.25 H on the card (device orchestration: the Solver's c128 blocks
    and B's DIA apply on the card, the LDL^H solve on the host) against the
    same call with ``arch='cpu'``: within ``COMPLEX_AGREE``; B's applies go
    through the DIA kernel's complex route and no plain version runs."""
    from raleigh_tpu_torch import Options, partial_hevp
    sw, sp, _, ell = mods
    a, b = complex_chain(np, COMPLEX_N)
    name = ('complex chain n=%d B=I+0.25H sigma=%g which=4'
            % (COMPLEX_N, COMPLEX_SIGMA))
    opt = Options()
    opt.orchestration = 'device'
    reset_counters(mods)
    with counting_plain_calls(sw, sp, ell) as plain:
        lmd, x, st, its, wall, solve_s, setup = hevp_call(
            torch, partial_hevp, a, B=b, sigma=COMPLEX_SIGMA, which=4,
            tol=1e-6, opt=opt)
    launches = {k: v for k, v in sw.LAUNCHES.items() if v}
    if any(plain.values()):
        fail('%s ran plain versions of the kernels: %s' % (name, plain))
    if launches.get('complex128_val128', 0) <= 0 or set(launches) != {
            'complex128_val128'}:
        fail('%s: DIA launches %s, not the complex instantiation alone'
             % (name, launches))
    hl, hx, hst, hits, hwall, _, _ = hevp_call(
        torch, partial_hevp, a, B=b, sigma=COMPLEX_SIGMA, which=4, tol=1e-6,
        arch='cpu')
    if st != 0 or hst != 0 or lmd is None or len(lmd) < 4:
        fail('%s: status %s (host %s)' % (name, st, hst))

    def nearest(v):
        v = np.asarray(v)
        return np.sort(v[np.argsort(np.abs(v - COMPLEX_SIGMA))[:4]])
    agree = float(np.max(np.abs(nearest(lmd) - nearest(hl))
                         / np.abs(nearest(hl))))
    if not agree <= COMPLEX_AGREE:
        fail('%s: eigenvalues %s against the host\'s %s (%.1e)'
             % (name, nearest(lmd), nearest(hl), agree))
    ind = np.argsort(np.abs(lmd - COMPLEX_SIGMA))[:4]
    xs = x[:, ind]
    res = float(np.max(np.linalg.norm(a @ xs - (b @ xs) * lmd[ind][None, :],
                                      axis=0)
                       / np.linalg.norm(b @ xs, axis=0)))
    if x.dtype != np.complex128 or not res <= 1e-6:
        fail('%s: eigenvectors %s, residual %.1e' % (name, x.dtype, res))
    rows['dia_spmm_rows_c128_val128']['launches'] = \
        launches['complex128_val128']
    print('%s tol=1e-6: status 0, %d iterations, eigenvalues %s within %.1e '
          'of the host run (arch=\'cpu\': %d iterations, wall %.2f s), '
          'relative residual %.1e; set-up %.2f s, solve %.2f s, wall %.2f s; '
          'DIA launches %s (one launch of the complex instantiation an '
          'apply of B\'s c128 values), '
          'no plain version [%s]'
          % (name, its, np.array2string(nearest(lmd), precision=10), agree,
             hits, hwall, res, setup or 0.0, solve_s, wall,
             json.dumps(launches), card))


# the dense phase: bench.py's headline matrix (bench.py:37-66) and its
# checks (bench.py:113-143), the tolerance and Jacobi fields
# (bench.py:388-440), truncated_svd against the host SVD, and
# partial_hevp(engine='jacobi') on bench.py's lap3d 50^3 field
DENSE_M, DENSE_N, GEN_RANK, NPC = 12000, 39375, 2048, 800
ORTHO_LIMIT = 1e-2
ERR_FRO_LIMIT = 0.30
JACOBI_OPTIMAL = 1.02
TSVD_AGREE = 1e-3
JACOBI_HEVP_LIMIT = 1e-5
# feature-split subspace_pca against dense 1: the leading components f32
# determines (sharded_pca), and the rank-800 errors' agreement
PCA_DETERMINED = 100
PCA_ERR_AGREE = 1e-4


def make_dense(torch, seed=1):
    """bench.py's ``make_data`` on the card from a seeded torch.Generator:
    rank-2048 factors with k^-0.75 singular decay, the first column of u
    ones (a PCA-invariant leading direction), plus noise 1e-5, f32."""
    dev = torch.device('cuda')
    gen = torch.Generator(dev).manual_seed(seed)
    u = torch.randn((DENSE_M, GEN_RANK), generator=gen, device=dev)
    u[:, 0] = 1.0
    v = torch.randn((GEN_RANK, DENSE_N), generator=gen, device=dev)
    k = torch.arange(1, GEN_RANK + 1, dtype=torch.float32, device=dev)
    s = k ** -0.75
    a = torch.matmul(u * (s / DENSE_M ** 0.5), v / DENSE_N ** 0.5)
    a.add_(torch.randn((DENSE_M, DENSE_N), generator=gen, device=dev),
           alpha=1e-5)
    return a


def verify_pca(torch, a, mean, trans, comps):
    """bench.py's ``_verify_pca`` on the card: (orthonormality error of
    the leading 64 components, relative Frobenius error of the
    approximation), the squares summed in f64."""
    g = torch.matmul(comps[:64], comps[:64].T)
    ortho = float((g - torch.eye(64, device=g.device)).abs().max())
    centred = a - mean
    as2 = torch.sum(centred * centred, dtype=torch.float64)
    lr2 = torch.sum(torch.matmul(trans.T, trans)
                    * torch.matmul(comps, comps.T), dtype=torch.float64)
    cross = torch.sum(torch.matmul(trans.T, centred) * comps,
                      dtype=torch.float64)
    del centred
    err2 = torch.clamp(as2 - 2 * cross + lr2, min=0.0)
    return ortho, float(torch.sqrt(err2 / as2))


def timed(torch, run):
    """(result, wall s) of ``run()`` between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def dense_breakdown(torch, run, card):
    """One warm run under the profiler, its device time split into
    GEMM, QR, eigh/SVD and the rest, and the host's share of the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(torch, run)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    groups = {'GEMM': ('gemm', 'cutlass', 'xmma', 'sm90_'),
              'QR': ('geqr', 'orgqr', 'ormqr', 'larf', 'householder'),
              'eigh/SVD': ('syev', 'sytrd', 'stedc', 'steqr', 'gesvd',
                           'bdsqr', 'jacobi', 'orgtr', 'ormtr')}
    share = dict.fromkeys(list(groups) + ['other'], 0.0)
    for e in kernels:
        name = e.key.lower()
        group = next((g for g, keys in groups.items()
                      if any(k in name for k in keys)), 'other')
        share[group] += e.self_device_time_total / 1e6
    busy = sum(share.values())
    print('  profile [%s]: wall %.3f s, device busy %.3f s (%.1f%%), %d '
          'launches; %s; host and idle %.3f s'
          % (card, wall, busy, 100 * busy / wall,
             sum(e.count for e in kernels),
             ', '.join('%s %.3f s' % kv for kv in share.items()),
             wall - busy))
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:8]:
        print('    %9.2f ms %6d x  %s' % (e.self_device_time_total / 1e3,
                                          e.count, e.key[:90]))


@contextlib.contextmanager
def jacobi_iterations():
    """Records (iterations, restarts) of every DeviceJacobi solve in the
    block."""
    from raleigh_tpu_torch.core.device_jacobi import DeviceJacobi
    counts, solve = [], DeviceJacobi.solve

    def counted(self, *args, **kw):
        status = solve(self, *args, **kw)
        counts.append((self.iteration, self.restarts))
        return status
    DeviceJacobi.solve = counted
    try:
        yield counts
    finally:
        DeviceJacobi.solve = solve


def sharded_pca(torch, a, mean, trans, comps, card):
    """Dense 1 with the data split along its features over ``SHARDS``
    shards of the card (``matrix_sharding``, as a JAX caller passes a
    feature-sharded array): a warm call, then the timed one.  Held to
    ``_verify_pca``'s limits, and to tests/test_sharded.py:288's against
    dense 1's factors: mean within 1e-4, and ``trans @ comps`` within 1e-3
    of its largest |entry| over the leading ``PCA_DETERMINED`` components.
    Past those, f32 does not determine the factors: the Gram's rounding,
    about eps lambda_1 (eps = 6e-8), meets the gap lambda_k - lambda_k+1
    of about 1.5 lambda_k / k (lambda_k ~ k^-1.5 here), so another order of
    the Gram's sums (eight shards' partial sums instead of one GEMM) mixes
    component k with k + 1 by about eps k^2.5 / 1.5: 0.4% at k = 100, O(1)
    at k = 800.  The rank-800 reconstruction's difference is printed, and
    its error held equal to dense 1's within ``PCA_ERR_AGREE``."""
    from raleigh_tpu_torch import subspace_pca
    from raleigh_tpu_torch.parallel.mesh import (ShardedRows, make_mesh,
                                                 matrix_sharding)
    a_sh, split_s = timed(torch, lambda: ShardedRows.split(
        a, matrix_sharding(make_mesh(SHARDS))))
    _, warm = timed(torch, lambda: subspace_pca(a_sh, NPC, fetch=False,
                                                seed=2))
    (mean_s, trans_s, comps_s), wall = timed(
        torch, lambda: subspace_pca(a_sh, NPC, fetch=False))
    if not (isinstance(mean_s, ShardedRows)
            and isinstance(comps_s, ShardedRows)):
        fail('sharded subspace_pca gathered its mean or comps')
    mean_g, comps_g = mean_s.gather(), comps_s.gather()
    del a_sh, mean_s, comps_s
    if comps_g.shape != comps.shape or trans_s.shape != trans.shape:
        fail('sharded subspace_pca: shapes %s, %s'
             % (tuple(trans_s.shape), tuple(comps_g.shape)))
    ortho, err_fro = verify_pca(torch, a, mean_g, trans_s, comps_g)
    _, err_1 = verify_pca(torch, a, mean, trans, comps)
    mean_diff = float((mean_g - mean).abs().max())
    rec = {}
    for k in (64, PCA_DETERMINED, 200, 400, NPC):
        r1 = torch.matmul(trans[:, :k], comps[:k])
        r2 = torch.matmul(trans_s[:, :k], comps_g[:k])
        rec[k] = float((r1 - r2).abs().max() / r1.abs().max())
        del r1, r2
    if not (ortho <= ORTHO_LIMIT and err_fro <= ERR_FRO_LIMIT
            and mean_diff < 1e-4 and rec[PCA_DETERMINED] < 1e-3
            and abs(err_fro - err_1) <= PCA_ERR_AGREE):
        fail('sharded subspace_pca: orthonormality %.2e, err_fro %.6f '
             '(dense 1 %.6f), mean %.2e and reconstructions %s from dense '
             '1\'s' % (ortho, err_fro, err_1, mean_diff, rec))
    print('dense 1 on %d feature shards of the card, subspace_pca npc=%d: '
          'wall %.3f s (warm-up %.3f s; split %.3f s); err_fro %.6f (dense '
          '1: %.6f, limit %.0e apart), orthonormality %.2e; mean within '
          '%.2e (limit 1e-4); trans @ comps over the leading k components '
          'within %s of dense 1\'s (k = %d held to 1e-3) [%s; the shards '
          'share the card: no scaling measurement]'
          % (SHARDS, NPC, wall, warm, split_s, err_fro, err_1,
             PCA_ERR_AGREE, ortho, mean_diff,
             ', '.join('%.2e (k=%d)' % (v, k) for k, v in rec.items()),
             PCA_DETERMINED, card))


def optimal_error(torch, a, k):
    """The relative Frobenius error of the best rank-k approximation of the
    centred ``a`` (Eckart-Young): from the eigenvalues of its centred Gram,
    taken in f64 on the card."""
    c = (a - a.mean(dim=0)).double()
    lmd = torch.linalg.eigvalsh(torch.matmul(c, c.T)).flip(0).clamp(min=0)
    del c
    return float(torch.sqrt(lmd[k:].sum() / lmd.sum()))


def phase_examples(torch, np, card):
    """The face-image example as a user runs it: ``eigenimages.run()`` at
    its synthetic default (12,000 x 39,375, rank 2048, npc 800, made on the
    card), its factors saved to a temporary directory, then read back and
    held to ``_verify_pca``'s checks against the same synthetic set: the
    orthonormality limit, and the error within ``JACOBI_OPTIMAL`` of the
    optimal rank-800 truncation's.  (``_verify_pca``'s err_fro <= 0.30 is
    bench.py's data's, noise 1e-5; the example's set, as the JAX package
    makes it, has noise 1e-4, about 2.2 in Frobenius norm against 1.6 for
    the rank-2048 part, so its optimum is near 0.8.)"""
    import tempfile
    from raleigh_tpu_torch.examples import eigenimages
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        t0 = time.perf_counter()
        elapsed = eigenimages.run()
        total = time.perf_counter() - t0
        with np.load('eigenimages.npz') as f:
            mean, trans, comps = (torch.from_numpy(f[k]).cuda()
                                  for k in ('mean', 'trans', 'comps'))
    a = eigenimages.synthetic()
    if comps.shape != (NPC, a.shape[1]) or trans.shape != (a.shape[0], NPC):
        fail('eigenimages.run: shapes %s, %s' % (tuple(trans.shape),
                                                 tuple(comps.shape)))
    ortho, err_fro = verify_pca(torch, a, mean, trans, comps)
    best = optimal_error(torch, a, NPC)
    if not (ortho <= ORTHO_LIMIT and err_fro <= JACOBI_OPTIMAL * best):
        fail('eigenimages.run: orthonormality %.2e, err_fro %.4f against '
             'the optimal %.4f' % (ortho, err_fro, best))
    print('eigenimages.run() synthetic %d x %d npc=%d: pca %.2f s, run '
          '(data made on the card, pca, factors saved) %.2f s; err_fro '
          '%.4f, %.5f x the optimal rank-%d truncation (limit %.2f), '
          'orthonormality %.2e (limit %.0e) [%s]'
          % (a.shape[0], a.shape[1], NPC, elapsed, total, err_fro,
             err_fro / best, NPC, JACOBI_OPTIMAL, ortho, ORTHO_LIMIT, card))
    del a, mean, trans, comps
    torch.cuda.empty_cache()


def phase_dense(torch, np, mods, card, profile=False):
    """The dense SVD/PCA stack on the card, as a user calls it (no device
    argument): the headline subspace_pca at bench.py's full shape, the
    tolerance-driven subspace_pca_tol, pca(method='jacobi') on the device
    Jacobi engine, truncated_svd, and partial_hevp(engine='jacobi'), whose
    applies must run K1 and no plain version."""
    from raleigh_tpu_torch import (Chebyshev, Options, partial_hevp, pca,
                                   pca_error, spectral_bounds, subspace_pca,
                                   subspace_pca_tol, truncated_svd)
    from raleigh_tpu_torch.examples.generate_matrix import generate
    from raleigh_tpu_torch.examples.laplace import lap3d, lap3d_eigenvalues
    sw, sp, _, ell = mods
    t_phase = time.perf_counter()

    # 1. the headline: 800 components of the 12,000 x 39,375 matrix
    a, gen_s = timed(torch, lambda: make_dense(torch))
    _, warm = timed(torch, lambda: subspace_pca(a, NPC, fetch=False,
                                                seed=2))
    (mean, trans, comps), wall = timed(
        torch, lambda: subspace_pca(a, NPC, fetch=False))
    if comps.shape != (NPC, DENSE_N) or trans.shape != (DENSE_M, NPC):
        fail('subspace_pca: shapes %s, %s' % (tuple(trans.shape),
                                              tuple(comps.shape)))
    ortho, err_fro = verify_pca(torch, a, mean, trans, comps)
    if not (ortho <= ORTHO_LIMIT and err_fro <= ERR_FRO_LIMIT):
        fail('subspace_pca: orthonormality %.2e (limit %.0e), err_fro '
             '%.4f (limit %.2f)' % (ortho, ORTHO_LIMIT, err_fro,
                                    ERR_FRO_LIMIT))
    gram_flop = 2.0 * DENSE_M ** 2 * DENSE_N
    print('dense 1, subspace_pca %d x %d npc=%d f32: wall %.3f s (warm-up '
          'at full shape %.3f s; data made on the card in %.3f s); err_fro '
          '%.4f (limit %.2f), orthonormality %.2e (limit %.0e); the Gram '
          'alone is %.3g f32 FLOP, %.3f s at %.0f TFLOP/s [%s]'
          % (DENSE_M, DENSE_N, NPC, wall, warm, gen_s, err_fro,
             ERR_FRO_LIMIT, ortho, ORTHO_LIMIT, gram_flop,
             gram_flop / PEAK_F32, PEAK_F32 / 1e12, card))
    sharded_pca(torch, a, mean, trans, comps, card)
    del mean, trans, comps
    if profile:
        dense_breakdown(torch, lambda: subspace_pca(a, NPC, fetch=False),
                        card)

    # 2. the tolerance-driven engine (bench.py:388-413)
    def tol_run():
        return subspace_pca_tol(a, 0.25, max_npc=1200, fetch=False)
    _, warm = timed(torch, tol_run)
    (mean, trans, comps), wall = timed(torch, tol_run)
    ortho, err_fro = verify_pca(torch, a, mean, trans, comps)
    if not (err_fro <= 0.25 and ortho <= ORTHO_LIMIT):
        fail('subspace_pca_tol: err_fro %.4f above its tolerance 0.25, '
             'orthonormality %.2e' % (err_fro, ortho))
    print('dense 2, subspace_pca_tol tol=0.25 max_npc=1200: rank %d, wall '
          '%.3f s (warm-up %.3f s), err_fro %.4f, orthonormality %.2e [%s]'
          % (comps.shape[0], wall, warm, err_fro, ortho, card))
    del mean, trans, comps
    if profile:
        dense_breakdown(torch, tol_run, card)

    # 3. pca(method='jacobi') on a quarter slice (bench.py:416-440)
    sub = a[:3000, :10000].cpu().numpy()
    warm_sub = a[:3000, 10000:20000].cpu().numpy()
    del a
    torch.cuda.empty_cache()
    with jacobi_iterations() as its:
        _, warm = timed(torch, lambda: pca(warm_sub, npc=100,
                                           method='jacobi'))
        (mean, trans, comps), wall = timed(
            torch, lambda: pca(sub, npc=100, method='jacobi'))
    em, ef = pca_error(sub, mean, trans, comps)
    centred = sub.astype(np.float64) - sub.mean(axis=0, dtype=np.float64)
    s = np.linalg.svd(centred, compute_uv=False)
    ef_opt = float(np.sqrt(np.sum(s[100:] ** 2) / np.sum(s ** 2)))
    if comps.shape != (100, 10000) or not ef <= JACOBI_OPTIMAL * ef_opt:
        fail('pca jacobi: %s components, err_fro %.5f against the optimal '
             '%.5f' % (comps.shape, ef, ef_opt))
    print('dense 3, pca(method=\'jacobi\') 3000 x 10000 npc=100: %d '
          'iterations, %d restarts (warm-up on another slice: %d '
          'iterations, %d restarts, %.3f s), wall %.3f s; err_fro %.5f, '
          '%.4f x the optimal rank-100 truncation (limit %.2f), err_max '
          '%.4f [%s]'
          % (its[-1] + its[0] + (warm, wall, ef, ef / ef_opt,
                                 JACOBI_OPTIMAL, em, card)))
    if profile:
        dense_breakdown(torch, lambda: pca(sub, npc=100, method='jacobi'),
                        card)

    # 4. truncated_svd on the card, nsv=300, against the host SVD, every
    # run at the default iteration limit: f64 and f32 on the device Jacobi
    # engine, and f32 on the core Solver with the blocks on the card
    sv = {}
    for dtype, engine in ((np.float64, 'auto'), (np.float32, 'host'),
                          (np.float32, 'auto')):
        np.random.seed(1)
        A, _, _, _ = generate(3000, 2000, 1000, dtype=dtype)
        if dtype not in sv:
            sv[dtype] = np.linalg.svd(A.astype(np.float64),
                                      compute_uv=False)
        opt = Options()
        opt.device_engine = engine
        with jacobi_iterations() as its:
            (u, sigma, vt), wall = timed(
                torch, lambda: truncated_svd(A, nsv=300, opt=opt))
        k = min(sigma.shape[0], 300)
        agree = float(np.max(np.abs(sigma[:k] - sv[dtype][:k])
                             / sv[dtype][:k]))
        if not (k == 300 and agree <= TSVD_AGREE):
            fail('truncated_svd %s (%s): %d singular values, %.2e from the '
                 'host SVD' % (np.dtype(dtype).name, engine, k, agree))
        print('dense 4, truncated_svd 3000 x 2000 nsv=300 %s on the %s: %d '
              'singular values%s, wall %.3f s; sigma within %.2e of the '
              'host SVD (limit %.0e) [%s]'
              % (np.dtype(dtype).name, 'device Jacobi engine'
                 if engine == 'auto' else 'core Solver', sigma.shape[0],
                 ', %d iterations, %d restarts' % its[-1] if its else '',
                 wall, agree, TSVD_AGREE, card))

    # 5. partial_hevp(engine='jacobi'): lap3d 50^3, 10 smallest, f64
    lap = lap3d(50, 50, 50, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(50, 50, 50, 1.0, 1.0, 1.0))[:10]
    ch = Chebyshev(lap, *spectral_bounds(lap), degree=16)
    with counting_plain_calls(sw, sp, ell) as plain, \
            jacobi_iterations() as restarts:
        for run in range(2):
            reset_counters(mods)
            lmd, x, st, its, wall, solve_s, _ = hevp_call(
                torch, partial_hevp, lap, T=ch, which=10, tol=1e-6,
                engine='jacobi')
            k1 = {key: sw.LAUNCHES[key] for key in sw.LAUNCHES
                  if sw.LAUNCHES[key]}
    if any(plain.values()):
        fail('engine=jacobi ran plain versions of the kernels: %s' % plain)
    if sum(k1.values()) <= 0:
        fail('engine=jacobi: the DIA kernel was launched no time')
    err = check_solution(np, 'engine=jacobi lap3d 50^3', lmd, x, st, exact,
                         JACOBI_HEVP_LIMIT)
    print('dense 5, partial_hevp(engine=\'jacobi\') lap3d 50^3 which=10 '
          'tol=1e-6 Chebyshev degree 16, f64: status 0, %d iterations, %d '
          'restarts, max rel eigenvalue error %.2e (limit %.0e); wall %.3f s '
          'warm (solve %.3f s); K1 launches per solve %s, no plain version '
          '[%s]' % (its, restarts[-1][1], err, JACOBI_HEVP_LIMIT, wall,
                    solve_s, json.dumps(k1), card))
    if profile:
        profile_run(torch, lambda: hevp_call(
            torch, partial_hevp, lap, T=ch, which=10, tol=1e-6,
            engine='jacobi'), card)
    print('dense phase: %.1f s [%s]' % (time.perf_counter() - t_phase, card))


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    import numpy as np

    from raleigh_tpu_torch.benches import bench_grid_shapes as gs
    from raleigh_tpu_torch.benches import bench_window_tiles as wt
    from raleigh_tpu_torch.examples import fe_model as fe
    from raleigh_tpu_torch.examples.laplace import lap3d
    from raleigh_tpu_torch.ops import _build
    from raleigh_tpu_torch.ops import spmm as ell
    from raleigh_tpu_torch.ops import spmm_pallas as sp
    from raleigh_tpu_torch.ops import spmm_window as sw
    from raleigh_tpu_torch.ops import stream as st
    from raleigh_tpu_torch.ops.spmm import BsrMatrix, DiaMatrix, EllMatrix

    profile = '--profile' in sys.argv[1:]
    mods = (sw, sp, st, ell)
    card = phase_environment(torch, _build)
    rows = phase_kernels(torch, np, lap3d, DiaMatrix, sw)
    rows.update(phase_stream(torch, st))
    rows.update(phase_copy(torch, st))
    rows.update(phase_ext(torch, np, lap3d, DiaMatrix, sw, st, rows))
    rows.update(phase_variants(torch, np, lap3d, DiaMatrix, sw, st, wt, gs))
    t0 = time.perf_counter()
    pencils = (fe.shipsec_like(), fe.shipsec_like(relabel=False))
    print('shipsec_like() in both orderings: n=%d, nnz=%d, built in %.1f s'
          % (pencils[0][0].shape[0], pencils[0][0].nnz,
             time.perf_counter() - t0))
    rows.update(phase_bsr(torch, np, sp, BsrMatrix, fe, pencils[1][0]))
    rows.update(phase_ell(torch, np, ell, EllMatrix, pencils[0][0],
                          pencils[1][0]))
    rows.update(phase_ell_step(torch, np, ell, EllMatrix, pencils[0][0]))
    rows.update(phase_gram(torch, np))
    rows.update(phase_wide(torch, np, lap3d, DiaMatrix, BsrMatrix, sw, sp,
                           pencils[1][0]))
    rows.update(phase_mesh_wide(torch, np, lap3d, DiaMatrix, sw))
    rows.update(phase_complex_kernels(torch, np, sw, sp, DiaMatrix,
                                      BsrMatrix, pencils[1][0]))
    main_field = phase_lap3d(torch, np, mods, rows, card, profile)
    phase_fe(torch, np, mods, rows, card, pencils, profile)
    rate = phase_stream_rate(mods, rows, card)
    phase_sharded(torch, np, mods, rows, card, main_field, pencils[0][0],
                  profile)
    phase_sweeps(mods, rows, card, wt, gs)
    core4 = phase_core(torch, np, mods, rows, card, pencils, profile)
    phase_mesh_core(torch, np, mods, rows, card, core4, profile)
    phase_complex(torch, np, mods, rows, card)
    phase_dense(torch, np, mods, card, profile)
    phase_examples(torch, np, card)
    loaded = sorted(m for m in sys.modules
                    if m.split('.')[0] in ('jax', 'jaxlib', 'raleigh_tpu'))
    if loaded:
        fail('modules of jax or of the JAX package were imported: %s'
             % loaded)
    for row in rows.values():
        if row['launches'] <= 0 and 'off_path' not in row:
            fail('%s was launched no time on its path' % row['name'])
        if row['launches'] and 'off_path' in row:
            fail('%s is on no path but was launched %d times there'
                 % (row['name'], row['launches']))
        nbytes = row.pop('bytes')
        print('%s: %.4f ms (%.0f GB/s effective) on %d launches; bound '
              '%.4f ms by %s at the data sheet, %.4f ms at the measured '
              'stream rate; plain %.4f ms; library %s [%s]'
              % (row['name'], row['ms'], nbytes / row['ms'] / 1e6,
                 row['launches'], row['bound_ms'],
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
