"""The readings that the limits of ``correct`` are set from, on the card:
for each seed, one run of the harness whose window is a single solve
(the cell's inputs, the program's set-up, one warm-up solve, one solve
judged against the plain reference), one process for all the seeds.

    python3 -m portbench.calibrate --workload <name> --seeds 1 2 3 \\
        [--control | --fault NAME] [--shapes]

``--control`` runs the workload's control instead of the program as the
configuration states it (``control`` in the workload file: 'tf32' lets
the float32 matrix products run in TF32, 'f32' hands the core Solver
float32 matrices); ``--fault`` plants one of ``faults.py``'s faults
under the run.  ``--shapes`` counts the block width of every sparse
apply of the two solves.  One JSON line a seed.  It reads a
``partial_hevp`` solve (``which``, ``lmd``) and refuses a cell of any
other task.
"""

import argparse
import collections
import contextlib
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ''):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import faults, harness, judge  # noqa: E402


@contextlib.contextmanager
def counting_shapes():
    """Counts (layout, value dtype, operand dtype, block width) of every
    sparse apply inside the block, by wrapping the program's two layout
    entries; yields the Counter."""
    from raleigh_tpu_torch.ops import spmm
    seen = collections.Counter()
    ell, dia = spmm._ell_matmat, spmm.dia_matmat_rows

    def ell_counted(idx, val, xt, rows=False, tag=()):
        seen['ell %s %s m=%d' % (val.dtype, xt.dtype, xt.shape[1])] += 1
        return ell(idx, val, xt, rows, tag)

    def dia_counted(val, x, offsets):
        seen['dia %s %s m=%d' % (val.dtype, x.dtype, x.shape[0])] += 1
        return dia(val, x, offsets)
    spmm._ell_matmat, spmm.dia_matmat_rows = ell_counted, dia_counted
    try:
        yield seen
    finally:
        spmm._ell_matmat, spmm.dia_matmat_rows = ell, dia


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--control', action='store_true')
    ap.add_argument('--fault', choices=sorted(faults.FAULTS))
    ap.add_argument('--shapes', action='store_true')
    args = ap.parse_args(argv)
    import torch
    cell = harness.Cell(args.workload)
    if cell.task_name != 'partial_hevp':
        raise SystemExit('calibrate reads which and lmd: a partial_hevp '
                         'tool, and %s runs task %s'
                         % (args.workload, cell.task_name))
    control = cell.workload['control'] if args.control else None
    for seed in args.seeds:
        with (faults.FAULTS[args.fault]() if args.fault
              else contextlib.nullcontext()), \
                (counting_shapes() if args.shapes
                 else contextlib.nullcontext(None)) as shapes:
            out = harness.run(cell, seed, 0.0, 0, time.time(),
                              control=control)
        solve = out.solves[-1]
        line = {'workload': args.workload, 'seed': seed,
                'mode': ('control %s' % control if control else
                         'fault %s' % args.fault if args.fault else 'program'),
                'status': solve.status, 'iterations': solve.iterations,
                'numbers': out.numbers, 'failed': out.reasons,
                'solve_s': out.record.walls[-1], 'phases': out.record.phases,
                'lmd': None if solve.lmd is None else
                [float(v) for v in solve.lmd[:cell.workload['which']]],
                'card': torch.cuda.get_device_name(0)}
        if shapes is not None:
            line['shapes'] = dict(shapes)
        print(json.dumps(line), flush=True)
    found = judge.forbidden_modules()
    if found:
        raise SystemExit('JAX or the JAX package was loaded: %s' % found)


if __name__ == '__main__':
    main()
