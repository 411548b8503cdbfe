"""Finding the benchmark's pieces by name, and adding a cell, a
configuration and a metric with new files alone."""

import hashlib
import json
import re
import shutil

import pytest

from portbench import registry
from portbench.harness import DEFAULT_TASK

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_every_entry_of_the_benchmark_has_its_files():
    bench = registry.benchmark()
    configs = {c['name'] for c in bench['configs']}
    for c in bench['configs']:
        data = registry.load('configs', c['name'])
        assert data['name'] == c['name']
        assert c['file'] == 'portbench/configs/%s.json' % c['name']
        assert c['reduced'] == data['reduced']
        registry.module('makers', data['maker'])
        registry.module('references', data['reference']['name'])
    for w in bench['workloads']:
        data = registry.load('workloads', w['name'])
        assert data['config'] == w['config'] in configs
        assert data['why'] == w['why']
        assert w['chips'] == 1
    for m in bench['end_to_end'] + bench['per_layer']:
        assert callable(registry.module('metrics', m['name']).read)


def test_the_benchmark_keeps_to_its_shape():
    bench = registry.benchmark()
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    names = [x['name'] for k in ('configs', 'workloads', 'end_to_end',
                                 'per_layer') for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(n for n in names)) == len(names)
    cells = [w['name'] for w in bench['workloads']]
    e2e = {m['name'] for m in bench['end_to_end']}
    assert 'setup_s' in e2e
    for m in bench['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in bench['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in e2e and UNIT.match(m['unit'])
        assert set(m.get('workloads', cells)) <= set(cells)
    for cell in cells:
        assert len(registry.metrics_for(bench, cell, 'end_to_end')) >= 2
        assert registry.metrics_for(bench, cell, 'per_layer')
    assert 1 <= bench['run_seconds'] <= 51
    assert len(json.dumps(bench)) < 64 * 1024
    # each workload is held to its task: the task has its module, and the
    # limits are exactly the task's checks (a mis-named limit would fail a
    # cell, or leave a check unheld, unseen)
    for path in sorted((registry.ROOT / 'workloads').glob('*.json')):
        data = registry.load('workloads', path.stem)
        task = registry.module('tasks', data.get('task', DEFAULT_TASK))
        assert set(data['limits']) == set(task.NUMBERS), path.name


def test_a_missing_name_is_refused():
    with pytest.raises(KeyError):
        registry.load('workloads', 'no_such.cell')
    with pytest.raises(KeyError):
        registry.module('metrics', 'no_such.metric')


def test_a_new_cell_configuration_and_metric_need_new_files_only(
        tmp_path, run_tiny):
    """A copy of the benchmark gains a configuration, a cell and a
    per-layer metric by new files and new entries alone, and a run of the
    new cell reports the new metric."""
    root = tmp_path / 'portbench'
    shutil.copytree(registry.ROOT, root,
                    ignore=shutil.ignore_patterns('__pycache__', '_cache'))
    bench = registry.benchmark()
    config = registry.load('configs', 'lap3d_1p28m')
    config.update(name='lap3d_cube', params=dict(config['params'],
                                                 grid=[14, 15, 16]))
    (root / 'configs' / 'lap3d_cube.json').write_text(json.dumps(config))
    cell = registry.load('workloads', 'lap3d_1p28m.lobpcg4')
    cell.update(name='lap3d_cube.lobpcg3', config='lap3d_cube', which=3,
                trace_solves=1)
    (root / 'workloads' / 'lap3d_cube.lobpcg3.json').write_text(
        json.dumps(cell))
    (root / 'metrics' / 'trace.solves.py').write_text(
        'def read(record):\n'
        '    return None if record.trace is None else record.trace.solves\n')
    bench['configs'].append({'name': 'lap3d_cube', 'source': config['source'],
                             'file': 'portbench/configs/lap3d_cube.json',
                             'reduced': [], 'why': 'a smaller box'})
    bench['workloads'].append({'name': 'lap3d_cube.lobpcg3',
                               'config': 'lap3d_cube', 'traffic': 'lobpcg3',
                               'chips': 1, 'why': cell['why']})
    bench['per_layer'].append({'name': 'trace.solves', 'unit': 'count',
                               'better': 'higher', 'source': 'device_trace',
                               'layer': 'device', 'moves': 'solve_ms',
                               'workloads': ['lap3d_cube.lobpcg3']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    out, line = run_tiny('lap3d_cube.lobpcg3', trace=1, root=root)
    # the per-layer metrics of the benchmark list their cells, so the new
    # cell reports its own metric alone
    assert line['metrics'] == {'trace.solves': {'value': 1.0,
                                                'unit': 'count'}}
    assert len(out.numbers) == 3 and out.failed == 0


# a kind of solve that is not an eigensolve, as a later cell would bring
# it: a truncated SVD on the port's host algebra, judged against LAPACK's
# singular values; its maker, reference, configuration and workload
TOY = {
    'tasks/truncated_svd.py': '''"""The leading singular values of a dense
matrix by ``truncated_svd``, against the reference's."""

from types import SimpleNamespace

import numpy as np

from .. import registry

NUMBERS = ('sv_err',)


def stats(problem):
    m, n = problem['A'].shape
    return {'m': m, 'n': n}


class Program:
    def __init__(self, cell, problem, device=None, control=None):
        self.a = problem['A'].copy()
        self.nsv = cell.workload['nsv']

    def solve(self):
        from raleigh_tpu_torch import truncated_svd
        u, sigma, vt = truncated_svd(self.a, nsv=self.nsv, arch='cpu')
        return SimpleNamespace(status=0, iterations=None, sigma=sigma,
                               x=(u, vt))


def judge(cell, problem, solves, device):
    spec = cell.config['reference']
    ref = registry.module('references', spec['name'], cell.root
                          ).singular_values(problem, cell.workload['nsv'])
    reasons = {i: 'fewer singular values' for i, s in enumerate(solves)
               if len(s.sigma) < len(ref)}
    errs = [float(np.max(np.abs(s.sigma[:len(ref)] - ref) / ref))
            for i, s in enumerate(solves) if i not in reasons]
    return ({'sv_err': max(errs) if errs else None}, len(reasons),
            reasons)
''',
    'makers/low_rank.py': '''import numpy as np


def make(params, seed):
    rng = np.random.default_rng(seed)
    m, n, r = params['m'], params['n'], params['rank']
    u, _ = np.linalg.qr(rng.standard_normal((m, r)))
    v, _ = np.linalg.qr(rng.standard_normal((n, r)))
    s = np.arange(1, r + 1) ** -params['alpha']
    return {'A': ((u * s) @ v.T).astype(np.float32)}
''',
    'references/lapack_svd.py': '''import numpy as np


def singular_values(problem, k):
    a = problem['A'].astype(np.float64)
    return np.linalg.svd(a, compute_uv=False)[:k]
''',
}


def _hashes(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob('*')) if p.is_file()}


def test_a_cell_of_another_task_needs_new_files_only(tmp_path, run_tiny):
    """A copy of the benchmark gains a cell whose task is not an eigensolve
    by new files and new entries alone; it runs through the harness,
    judged by its own check and limit, and a limit under its reading
    fails it; every file the copy had stays as it was."""
    root = tmp_path / 'portbench'
    shutil.copytree(registry.ROOT, root,
                    ignore=shutil.ignore_patterns('__pycache__', '_cache'))
    before = _hashes(root)
    assert before == {k: v for k, v in _hashes(registry.ROOT).items()
                      if k in before}
    config = {'name': 'low_rank', 'maker': 'low_rank',
              'params': {'m': 300, 'n': 200, 'rank': 100, 'alpha': 0.75},
              'reference': {'name': 'lapack_svd'}, 'reduced': []}
    cell = {'name': 'low_rank.svd20', 'config': 'low_rank',
            'task': 'truncated_svd', 'nsv': 20, 'trace_solves': 1,
            'limits': {'sv_err': 1e-5},
            'why': 'a dense 300 x 200 matrix of rank 100: 20 singular values'}
    files = dict(TOY, **{'configs/low_rank.json': json.dumps(config),
                         'workloads/low_rank.svd20.json': json.dumps(cell)})
    for rel, text in files.items():
        assert not (root / rel).exists()
        (root / rel).write_text(text)
    bench = registry.benchmark()
    bench['configs'].append({'name': 'low_rank',
                             'source': 'https://example.org/low_rank',
                             'file': 'portbench/configs/low_rank.json',
                             'reduced': [], 'why': 'a dense matrix'})
    bench['workloads'].append({'name': 'low_rank.svd20', 'config': 'low_rank',
                               'traffic': 'svd20', 'chips': 1,
                               'why': cell['why']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))

    out, line = run_tiny('low_rank.svd20', root=root)
    assert line['correct'] is True and line['failed'] == 0, out.lines
    assert list(line['checks']) == ['sv_err', 'failed_solves']
    value = line['checks']['sv_err']['value']
    assert 0 < value <= 1e-5 and line['checks']['sv_err']['limit'] == 1e-5
    assert set(line['metrics']) == {'solve_ms', 'setup_s'}
    assert out.lines[0].startswith('check sv_err ')

    cell['limits']['sv_err'] = value / 2
    (root / 'workloads' / 'low_rank.svd20.json').write_text(json.dumps(cell))
    out, line = run_tiny('low_rank.svd20', root=root)
    assert line['correct'] is False
    assert line['checks']['sv_err']['limit'] == value / 2
    assert out.lines[0].endswith('FAIL')

    after = _hashes(root)
    assert {k: after[k] for k in before} == before
