"""The readings that the dense PCA cell's limits are set from, on the
card: for each seed, one run of the harness whose window is a single
solve (the cell's inputs, the program's set-up, one warm-up solve, one
solve judged against the plain reference), one process for all seeds;
``calibrate.py`` does the same for the eigensolver's cells.

    python3 -m portbench.calibrate_pca --workload lfw_pca.npc800 \\
        --seeds 1 2 3 [--control | --fault NAME] [--kernels]

``--control`` runs the workload's control ('tf32': the products in
TF32); ``--fault`` plants one of ``pca_faults.py``'s faults under the
run.  ``--kernels`` adds a traced run of the first seed and prints every
kernel of its window with its device time a solve.  One JSON line a
seed.
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

from portbench import harness, judge, pca_faults  # noqa: E402


def kernels(cell, seed):
    """(name, ms a solve, launches a solve) of every kernel in a traced
    run's window, the longest first."""
    out = harness.run(cell, seed, 0.0, 1, time.time())
    t = out.record.trace
    took, count = collections.Counter(), collections.Counter()
    for name, seconds in t.kernels():
        took[name] += seconds
        count[name] += 1
    return [(name, 1e3 * s / t.solves, count[name] / t.solves)
            for name, s in took.most_common()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--control', action='store_true')
    ap.add_argument('--fault', choices=sorted(pca_faults.FAULTS))
    ap.add_argument('--kernels', action='store_true')
    args = ap.parse_args(argv)
    import torch
    cell = harness.Cell(args.workload)
    if cell.task_name != 'pca':
        raise SystemExit('calibrate_pca reads a pca task, and %s runs task '
                         '%s' % (args.workload, cell.task_name))
    control = cell.workload['control'] if args.control else None
    card = torch.cuda.get_device_name(0)
    for seed in args.seeds:
        with (pca_faults.FAULTS[args.fault]() if args.fault
              else contextlib.nullcontext()):
            out = harness.run(cell, seed, 0.0, 0, time.time(),
                              control=control)
        line = {'workload': args.workload, 'seed': seed,
                'mode': ('control %s' % control if control else
                         'fault %s' % args.fault if args.fault else 'program'),
                'numbers': out.numbers, 'failed': out.reasons,
                'correct': out.correct, 'solve_s': out.record.walls[-1],
                'phases': out.record.phases, 'memory_peak_bytes': out.memory,
                'card': card}
        print(json.dumps(line), flush=True)
    if args.kernels:
        for name, ms, n in kernels(cell, args.seeds[0]):
            print('kernel %9.3f ms %7.1f x  %s' % (ms, n, name[:200]),
                  flush=True)
    found = judge.forbidden_modules()
    if found:
        raise SystemExit('JAX or the JAX package was loaded: %s' % found)


if __name__ == '__main__':
    main()
