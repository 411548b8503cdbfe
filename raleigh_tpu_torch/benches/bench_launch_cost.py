"""Host cost of one kernel launch through the port's wrappers, by part.

A sharded apply is small launches, and at that size the host, not the
card, sets the pace.  This probe times, on the host clock over many calls
with the device kept busy but never waited for:

  * one halo copy through ``ops.stream.copy_lanes`` (16 x 10,000 f32 lanes
    out of 16 x 160,000), the same copy through ``Tensor.copy_``, and the
    wrapper's parts on their own: its checks with the copy's slots, the
    look-up of the current stream (``torch.cuda.current_stream`` and the
    raw helper every wrapper uses, ``ops._build.current_stream``), the
    reading of pointers and strides, and the bare call into the kernel
    library;
  * the 24 copies that assemble the extended operands of 8 such shards,
    through one ``copy_lanes_many`` call and through 24 ``Tensor.copy_``;
  * one mesh DIA apply over the same 8 shards (lap3d(100,100,128)'s
    offsets, m = 16): the kernel's wrapper ``dia_matmat_rows_mesh`` alone,
    the whole apply as the solver makes it (``DiaMatrix.matmat_rows`` on a
    ``ShardedRows`` block), and the wrapper's parts: its checks of the 8
    operand parts, the allocation of the 8 outputs, and the bare call into
    the kernel library with the filled parameter block.

The calls whose device time is larger than their host time are timed over
few enough calls that the launch queue never fills.

Usage: python -m raleigh_tpu_torch.benches.bench_launch_cost [--reps R]

It needs the card (the parts are those of a CUDA launch) and raises
without one.
"""

import argparse
import ctypes
import time

import numpy as np
import torch

from ..core.device_solver import shard_operator
from ..ops import _build
from ..ops import spmm_window as sw
from ..ops import stream as st
from ..ops.spmm import DiaMatrix, storage_device
from ..parallel.mesh import ShardedRows, make_mesh, ring_runs

M, N_LOCAL, HALO, SHARDS = 16, 160000, 10000, 8
# lap3d(100,100,128)'s diagonals, in the row convention
OFFSETS = (-10000, -100, -1, 0, 1, 100, 10000)
# calls of a part whose device time exceeds its host time
DEVICE_BOUND_REPS = 300


def _host_us(fn, reps):
    """Microseconds of host time per call of ``fn`` over ``reps`` calls."""
    for _ in range(min(reps, 200)):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def main(argv=None):
    """Prints one line per part and returns {part: microseconds}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--reps', type=int, default=20000)
    args = ap.parse_args(argv)
    device = storage_device(None)
    index = torch.cuda.current_device()
    src = torch.randn((M, N_LOCAL), device=device)
    ext = torch.zeros((M, N_LOCAL + 2 * HALO), device=device)
    sv, dk = src[:, N_LOCAL - HALO:], ext[:, :HALO]
    lib = _build.library()
    one = st._COPY_BLOCK()
    one[0] = 1
    one[2:2 + st._COPY_SLOTS] = list(st._copy_slots(dk, sv))
    one_at, one_bytes = ctypes.addressof(one), ctypes.sizeof(one)

    # 8 shards: their operand parts, the 24 copies of their extended
    # operands, and a DIA matrix split over them (zero values: the cost of
    # a launch does not depend on them)
    parts = [torch.randn((M, N_LOCAL), device=device) for _ in range(SHARDS)]
    exts = [torch.empty((M, N_LOCAL + 2 * HALO), device=device)
            for _ in range(SHARDS)]
    pairs = [(e[:, pos:pos + take], parts[j][:, at:at + take])
             for e, runs in zip(exts, ring_runs([N_LOCAL] * SHARDS, HALO,
                                                HALO))
             for pos, take, j, at in runs]
    mesh = make_mesh(SHARDS, [device] * SHARDS)
    dm = shard_operator(DiaMatrix.from_arrays(
        OFFSETS, np.zeros((len(OFFSETS), SHARDS * N_LOCAL), np.float32),
        device=device), mesh)
    xs = ShardedRows(parts, dm.val.sharding)
    plan = dm._mesh_plan(dm.val.sharding)
    launch = plan.launches[0]
    # one apply fills the parameter block; its outputs stay alive, so the
    # bare calls below, timed before any other apply, write where it wrote
    held = sw.dia_matmat_rows_mesh(dm.val.parts, parts, plan)

    parts_us = {
        'copy_lanes, the whole wrapper': (lambda: st.copy_lanes(dk, sv),
                                          args.reps),
        'Tensor.copy_': (lambda: dk.copy_(sv), args.reps),
        'the wrapper\'s checks and slots': (lambda: st._copy_slots(dk, sv),
                                            args.reps),
        'current stream look-up': (
            lambda: torch.cuda.current_stream(dk.device).cuda_stream,
            args.reps),
        'current stream, raw helper': (lambda: _build.current_stream(index),
                                       args.reps),
        'pointers, strides, sizes': (lambda: (
            dk.data_ptr(), sv.data_ptr(), dk.stride(0), sv.stride(0),
            dk.element_size(), dk.shape), args.reps),
        'call into the kernel library': (lambda: lib.copy_lanes_many(
            one_at, one_bytes, index, _build.current_stream(index)),
            args.reps),
        'copy_lanes_many, 24 copies of 8 shards': (
            lambda: st.copy_lanes_many(pairs),
            min(args.reps, DEVICE_BOUND_REPS)),
        '24 x Tensor.copy_, the same copies': (
            lambda: st.copy_lanes_many_plain(pairs),
            min(args.reps, DEVICE_BOUND_REPS)),
        'mesh apply: the checks of 8 parts': (
            lambda: sw._check_mesh(dm.val.parts, parts, plan), args.reps),
        'mesh apply: 8 outputs in one allocation': (
            lambda: launch.outputs(M, torch.float32),
            min(args.reps, DEVICE_BOUND_REPS)),
        'mesh apply: the call into the kernel library': (
            lambda: lib.dia_spmm_mesh_f32(
                launch.address, launch.nbytes, index,
                _build.current_stream(index)),
            min(args.reps, DEVICE_BOUND_REPS)),
        'mesh DIA apply of 8 shards, the wrapper': (
            lambda: sw.dia_matmat_rows_mesh(dm.val.parts, parts, plan),
            min(args.reps, DEVICE_BOUND_REPS)),
        'mesh DIA apply of 8 shards, matmat_rows': (
            lambda: dm.matmat_rows(xs), min(args.reps, DEVICE_BOUND_REPS)),
    }
    print('host time per call, halo copy of (%d, %d) f32, %d shards of (%d, '
          '%d) on %s' % (M, HALO, SHARDS, M, N_LOCAL,
                         torch.cuda.get_device_name(device)))
    out = {}
    for name, (fn, reps) in parts_us.items():
        out[name] = _host_us(fn, reps)
        print('%-46s %8.2f us' % (name, out[name]), flush=True)
    del held
    return out


if __name__ == '__main__':
    main()
