"""The no-JAX check, the result's line, and the reference refusing an
altered eigenpair."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np

from portbench import harness, judge, registry
from portbench.tasks import partial_hevp


def test_the_forbidden_names_are_compared_whole():
    assert judge.forbidden_modules(['raleigh_tpu.ops.spmm']) == \
        ['raleigh_tpu']
    assert judge.forbidden_modules(['raleigh_tpu_torch.ops.spmm',
                                    'raleigh_tpu_torchx', 'jaxtyping',
                                    'portbench.bench']) == []
    assert judge.forbidden_modules(['jax.numpy', 'jaxlib', 'flax.linen',
                                    'bench', 'benches.timing']) == \
        ['bench', 'benches', 'flax', 'jax', 'jaxlib']


def test_a_run_loads_no_jax():
    """A whole run in a fresh interpreter (the harness, the program, the
    reference) leaves no module of JAX or the JAX package loaded."""
    code = ('import sys, time\n'
            'sys.path.insert(0, %r)\n'
            'from portbench import harness, judge\n'
            "cell = harness.Cell('lap3d_1p28m.core4', "
            "params={'grid': [8, 9, 10]})\n"
            "harness.run(cell, 5, 0.0, 0, time.time(), device='cpu')\n"
            'print(judge.forbidden_modules())\n' % str(registry.ROOT.parent))
    done = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().splitlines()[-1] == '[]'


def test_the_result_line(run_tiny):
    out, line = run_tiny('shipsec1_fe.lobpcg6')
    assert list(line) == ['correct', 'attempted', 'failed', 'metrics',
                          'device', 'checks']
    assert line['correct'] is True and line['failed'] == 0
    assert line['attempted'] == len(out.record.walls) >= 1
    assert set(line['metrics']) == {'solve_ms', 'solve_ms_p90', 'setup_s'}
    assert all(set(v) == {'value', 'unit'} for v in line['metrics'].values())
    assert set(line['device']) == {'platform', 'kind', 'count',
                                   'memory_peak_bytes'}
    assert list(line['checks']) == ['eig_err', 'resid', 'ortho',
                                    'failed_solves']
    text = json.dumps(line)
    assert '\n' not in text and json.loads(text) == line
    assert out.lines[-1].startswith('check failed_solves 0 limit 0 ok')


def test_the_traced_line(run_tiny):
    """A traced run's line, on a cell that no per-layer metric of the
    benchmark lists (the Laplacian on the core Solver, fast on the host):
    its readers still read what the record holds."""
    out, line = run_tiny('lap3d_1p28m.core4', trace=1)
    assert list(line) == ['correct', 'attempted', 'failed', 'metrics',
                          'device', 'breakdown', 'checks']
    assert line['correct'] is True and line['metrics'] == {}
    assert line['device']['window_s'] > 0 and line['device']['busy_s'] == 0
    assert set(line['breakdown']) == {'device_ops', 'idle_gaps'}
    read = {name: registry.module('metrics', name).read(out.record)
            for name in ('core_solver.iterations', 'lobpcg.iterations',
                         'device.idle_pct', 'e1.roofline_pct',
                         'k1.roofline_pct')}
    assert read.pop('core_solver.iterations') > 0
    # no device in a host run: no device metric, and no number under one
    assert set(read.values()) == {None}


def _sound(cell, seed=3):
    problem = cell.make(seed)
    program = partial_hevp.Program(cell, problem, 'cpu')
    solve = program.solve()
    return cell, problem, solve, partial_hevp.reference(cell, problem, 'cpu')


def _correct(numbers, failed, limits):
    return judge.verdict(numbers, failed, limits, partial_hevp.NUMBERS)[0]


def test_the_reference_refuses_an_altered_pair(tiny_cell):
    cell, problem, s, ref = _sound(tiny_cell('shipsec1_fe.lobpcg6'))
    k, limits = cell.workload['which'], cell.workload['limits']
    numbers, failed, _ = partial_hevp.compare(problem, k, [s], ref, 'cpu')
    assert _correct(numbers, failed, limits) is True
    lmd = s.lmd.copy()
    lmd[2] *= 1 + 10 * limits['eig_err']
    bent = SimpleNamespace(lmd=lmd, x=s.x, status=0, iterations=16)
    numbers, failed, _ = partial_hevp.compare(problem, k, [bent], ref, 'cpu')
    assert numbers['eig_err'] > limits['eig_err']
    assert _correct(numbers, failed, limits) is False
    x = s.x.copy()
    x[:, 1] = np.roll(x[:, 1], 1)
    bent = SimpleNamespace(lmd=s.lmd, x=x, status=0, iterations=16)
    numbers, failed, _ = partial_hevp.compare(problem, k, [bent], ref, 'cpu')
    assert numbers['resid'] > limits['resid']
    assert _correct(numbers, failed, limits) is False
    short = SimpleNamespace(lmd=s.lmd[:k - 1], x=s.x, status=0,
                            iterations=16)
    numbers, failed, _ = partial_hevp.compare(problem, k, [short], ref, 'cpu')
    assert failed == 1 and _correct(numbers, failed, limits) is False


def test_the_reference_agrees_with_a_dense_solve(tiny_cell):
    """lobpcg64 and the closed form against LAPACK on the small sizes."""
    import scipy.linalg
    for name in ('shipsec1_fe.lobpcg6', 'lap3d_1p28m.lobpcg4'):
        cell, problem, _, ref = _sound(tiny_cell(name))
        b = None if problem['B'] is None else problem['B'].toarray()
        dense = scipy.linalg.eigh(problem['A'].toarray(), b,
                                  eigvals_only=True,
                                  subset_by_index=[0, len(ref) - 1])
        assert np.max(np.abs(ref / dense - 1)) < 1e-10
