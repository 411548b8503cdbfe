"""Finding the benchmark's pieces by name, and adding a cell, a
configuration and a metric with new files alone."""

import json
import re
import shutil

import pytest

from portbench import registry

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
        assert set(data['limits']) == {'eig_err', 'resid', 'ortho'}
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
