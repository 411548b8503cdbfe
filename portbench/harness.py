"""One run of one cell: inputs from the seed, the program's set-up, a
measured window of whole solves (or a traced run of a few), the
comparison with the plain reference, and the result's line.

What a cell runs is its task (``tasks/<name>.py``): the program's set-up
and its solve, reached through the program's public entry points alone,
the inputs' statistics, and the checks against the reference.  Every
solve of a window is the same call on the same inputs; its wall ends in
the host arrays that call returns.
"""

import gc
import time
from types import SimpleNamespace

import numpy as np

from . import judge, registry, tracing

# the task of a workload that names none
DEFAULT_TASK = 'partial_hevp'
# solves whose large answers (``x``) a window keeps for the checks that
# need them (the eigenvectors' residuals), drawn from the seed
SAMPLED_SOLVES = 3


class Cell:
    """A workload and its configuration, found by the workload's name."""

    def __init__(self, name, root=registry.ROOT, params=None):
        self.name = name
        self.root = root
        self.workload = registry.load('workloads', name, root)
        self.config = registry.load('configs', self.workload['config'], root)
        self.params = dict(self.config['params'], **(params or {}))
        self.task_name = self.workload.get('task', DEFAULT_TASK)
        self.task = registry.module('tasks', self.task_name, root)

    def make(self, seed):
        """The inputs of run seed ``seed``."""
        maker = registry.module('makers', self.config['maker'], self.root)
        return maker.make(self.params, seed)


def _free():
    import torch
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _memory_peak():
    import torch
    return (int(torch.cuda.max_memory_allocated())
            if torch.cuda.is_initialized() else 0)


def window(program, seconds, seed):
    """Whole solves until ``seconds`` have passed, the last one finished:
    (walls, window seconds, solves), every solve kept and the large
    answers (``x``) of ``SAMPLED_SOLVES`` solves drawn from the seed
    (reservoir sampling)."""
    rng = np.random.default_rng([seed, 1])
    walls, solves = [], []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        s = program.solve()
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        i = len(solves)
        keep = i < SAMPLED_SOLVES or rng.integers(0, i + 1) < SAMPLED_SOLVES
        if keep and i >= SAMPLED_SOLVES:
            drop = [j for j, old in enumerate(solves) if old.x is not None]
            solves[drop[rng.integers(0, len(drop))]].x = None
        if not keep:
            s.x = None
        solves.append(s)
        if t1 - t_start >= seconds:
            return walls, t1 - t_start, solves


def traced(program, count):
    """``count`` whole solves under ``torch.profiler``, each inside a
    span, after one solve that settles the profiler (judged, outside the
    window): (Trace, solves)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    solves = []
    with profile(activities=acts) as prof:
        solves.append(program.solve())
        for _ in range(count):
            with record_function(tracing.SPAN):
                solves.append(program.solve())
    return tracing.collect(prof), solves


def run(cell, seed, seconds, trace, t_process, device=None, peaks=None,
        control=None):
    """One run of ``cell``: a dict with the result's keys (``metrics`` of
    the cell's end-to-end metrics, or with ``trace`` its per-layer ones)
    and the check lines.  ``t_process`` is the process's start on
    ``time.time()``'s clock; ``device`` None is the card; ``control``
    puts the program on its lower-precision path (the task's
    ``Program``).  The record's ``phases`` holds the seconds of each part
    of the set-up."""
    import torch
    task = cell.task
    phases = {'to inputs': time.time() - t_process}
    # the core Solver draws its start block from NumPy's global generator
    np.random.seed(seed % 2 ** 32)
    torch.manual_seed(seed)
    t = time.time()
    problem = cell.make(seed)
    phases['inputs'] = time.time() - t
    t = time.time()
    program = task.Program(cell, problem, device, control)
    phases['program'] = time.time() - t
    t = time.time()
    program.solve()                              # warm-up: builds, loads
    phases['warm-up'] = time.time() - t
    record = SimpleNamespace(cell=cell.workload, stats=task.stats(problem),
                             problem=problem, peaks=peaks, walls=[],
                             window_s=None, setup_s=None, trace=None,
                             phases=phases)
    if trace:
        record.trace, solves = traced(program,
                                      cell.workload['trace_solves'])
    else:
        record.setup_s = time.time() - t_process
        record.walls, record.window_s, solves = window(program, seconds,
                                                       seed)
    memory = _memory_peak()
    del program
    _free()
    numbers, failed, reasons = task.judge(cell, problem, solves,
                                          device or 'cuda')
    correct, lines = judge.verdict(numbers, failed, cell.workload['limits'],
                                   task.NUMBERS)
    record.iterations = [s.iterations for s in solves[1:]] if trace \
        else [s.iterations for s in solves]
    return SimpleNamespace(record=record, numbers=numbers, failed=failed,
                           reasons=reasons, attempted=len(solves),
                           solves=solves, names=task.NUMBERS,
                           correct=correct, lines=lines, memory=memory)


def metrics(out, bench, cell_name, trace, root=registry.ROOT):
    """{name: {'value', 'unit'}} of the metrics the cell reports in this
    kind of run, each read by its reader; a reader that finds nothing
    returns None and its metric is left out."""
    kind = 'per_layer' if trace else 'end_to_end'
    got = {}
    for entry in registry.metrics_for(bench, cell_name, kind):
        value = registry.module('metrics', entry['name'], root).read(
            out.record)
        if value is not None:
            got[entry['name']] = {'value': float(value),
                                  'unit': entry['unit']}
    return got


def _number(value):
    """A reading as JSON can hold it: a number that is not finite (a
    residual over an eigenvalue of 0) as its name."""
    if value is None or np.isfinite(value):
        return value
    return repr(float(value))


def result(out, metrics_, device, trace):
    """The result's line as a dict, its keys in the order the line
    prints them; the compared numbers with their limits come last, in
    the order of the task's ``NUMBERS``."""
    line = {'correct': bool(out.correct), 'attempted': out.attempted,
            'failed': out.failed, 'metrics': metrics_, 'device': device}
    if trace:
        t = out.record.trace
        line['device'] = dict(device, busy_s=t.busy_s, window_s=t.window_s)
        line['breakdown'] = t.breakdown()
    line['checks'] = {name: {'value': _number(out.numbers.get(name)),
                             'limit': out.record.cell['limits'].get(name)}
                      for name in out.names}
    line['checks']['failed_solves'] = {'value': out.failed, 'limit': 0}
    return line
