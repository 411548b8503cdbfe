"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

(``python3 -m portbench.run`` takes the same arguments.)  The last line of
standard output is the result's JSON object; the last lines of standard
error are the compared numbers, each beside its limit.  It exits with
another code than 0, and prints no result, when there is no card or too
few, when the program cannot be imported, or when JAX or the JAX package
was loaded.
"""

import time

T_PROCESS = time.time()

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import subprocess  # noqa: E402
import sys        # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
if __package__ in (None, ''):
    sys.path.insert(0, str(CHECKOUT))

# caches of anything the program builds stay at fixed paths inside the
# checkout; the program's own kernels build under raleigh_tpu_torch/_build
for _var, _sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('TRITON_CACHE_DIR', 'triton')):
    os.environ[_var] = str(CHECKOUT / 'portbench' / '_cache' / _sub)

# one process with few threads: the host paces every cell's solve, and
# spinning BLAS and OpenMP pools and a main thread that moves from core to
# core spread its times; one pool thread, and the process (with every
# thread it starts) kept on two cores.  Set before numpy or torch loads.
for _var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
    os.environ[_var] = '1'
HOST_CORES = sorted(os.sched_getaffinity(0))
HOST_CORES = HOST_CORES[2:4] if len(HOST_CORES) >= 4 else HOST_CORES
os.sched_setaffinity(0, HOST_CORES)


def _card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        done = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
        return done.stdout.strip() or done.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return 'nvidia-smi: %s' % exc


def _fail(msg):
    print('portbench: %s' % msg, file=sys.stderr)
    sys.exit(2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness, judge, registry
    bench = registry.benchmark()
    cells = {w['name']: w for w in bench['workloads']}
    if args.workload not in cells:
        _fail('no workload %r in BENCHMARK.json' % args.workload)
    chips = cells[args.workload]['chips']

    phases = {}
    t = time.time()
    import torch
    phases['torch'] = time.time() - t
    t = time.time()
    if not torch.cuda.is_available():
        _fail('no CUDA device: the benchmark runs on the card only')
    if torch.cuda.device_count() < chips:
        _fail('the cell needs %d cards, %d found'
              % (chips, torch.cuda.device_count()))
    kind = torch.cuda.get_device_name(0)
    torch.cuda.reset_peak_memory_stats()
    phases['cuda'] = time.time() - t
    t = time.time()
    import raleigh_tpu_torch  # noqa: F401  (fails here without the program)
    phases['import'] = time.time() - t

    cell = harness.Cell(args.workload)
    peaks = json.loads((registry.ROOT / 'peaks.json').read_text())
    out = harness.run(cell, args.seed, args.seconds, args.trace, T_PROCESS,
                      peaks=peaks.get(kind))
    card = _card_line()
    print('card: %s; host cores %s' % (card, HOST_CORES), file=sys.stderr)
    phases.update(out.record.phases)
    print('set-up: %s' % ', '.join('%s %.3f s' % kv for kv in phases.items()),
          file=sys.stderr)
    device = {'platform': 'gpu', 'kind': kind, 'count': chips,
              'memory_peak_bytes': out.memory}
    metrics = harness.metrics(out, bench, args.workload, args.trace)
    line = harness.result(out, metrics, device, args.trace)
    rec = out.record
    walls = ('first %.4f s, median %.4f s, last %.4f s' % (
        rec.walls[0], sorted(rec.walls)[len(rec.walls) // 2], rec.walls[-1])
        if rec.walls else 'traced')
    print('portbench %s seed %d trace %d: %d solves (%s), iterations %s, '
          'peak device memory %d bytes [%s]'
          % (args.workload, args.seed, args.trace, out.attempted, walls,
             sorted(set(rec.iterations)), out.memory, card),
          file=sys.stderr)
    for i, why in sorted(out.reasons.items()):
        print('solve %d failed: %s' % (i, why), file=sys.stderr)
    found = judge.forbidden_modules()
    if found:
        _fail('modules of JAX or the JAX package were loaded: %s'
              % ', '.join(found))
    for text in out.lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))


if __name__ == '__main__':
    main()
