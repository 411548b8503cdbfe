"""The frozen input makers make what the program's examples make, and
every sparse apply of a cell's solve has the block width its rooflines
count with."""

import numpy as np
import pytest

from portbench import calibrate, registry
from portbench.makers import fe_girder, lap3d


def test_the_fe_maker_is_the_programs_example_frozen():
    """The assembly is the program's; each seed renumbers the same mesh
    and draws another jitter, so n, the nonzeros and the rows' lengths
    are the same on every seed and the matrices are not."""
    from raleigh_tpu_torch.examples import fe_model
    for ours, theirs in zip(fe_girder.fe_pencil(10, 6, 0.1, 7),
                            fe_model.fe_pencil(10, 6, 0.1, 7)):
        assert (ours != theirs).nnz == 0
    params = dict(registry.load('configs', 'shipsec1_fe')['params'], nc=10)
    seed = 2 ** 31 + 3
    one, two = fe_girder.make(params, seed), fe_girder.make(params, 9)
    k, m = fe_model.fe_pencil(10, 6, 0.1, 7, relabel=False)
    for p in (one, two):
        assert p['A'].shape == k.shape and p['A'].nnz == k.nnz
        assert np.array_equal(np.sort(np.diff(p['A'].indptr)),
                              np.sort(np.diff(k.indptr)))
    # M has no jitter: the seed's M is the mesher's M renumbered
    perm = np.random.default_rng(seed).permutation(k.shape[0] // 3)
    old = np.empty(k.shape[0], dtype=np.int64)
    old[(3 * perm[:, None] + np.arange(3)).ravel()] = np.arange(k.shape[0])
    assert (one['B'] != m[old][:, old]).nnz == 0
    assert (one['A'] != two['A']).nnz > 0
    again = fe_girder.make(params, seed)
    assert (again['A'] != one['A']).nnz == 0


def test_the_laplacian_maker_is_the_programs_example_frozen():
    from raleigh_tpu_torch.examples import laplace
    assert (lap3d.lap3d(5, 6, 7, 1.0, 1.01, 1.02)
            != laplace.lap3d(5, 6, 7, 1.0, 1.01, 1.02)).nnz == 0
    assert np.array_equal(lap3d.lap3d_eigenvalues(5, 6, 7, 1, 1.01, 1.02),
                          laplace.lap3d_eigenvalues(5, 6, 7, 1, 1.01, 1.02))
    params = registry.load('configs', 'lap3d_1p28m')['params']
    p = lap3d.make(dict(params, grid=[5, 6, 7]), 2 ** 31 + 3)
    scale = p['sides'][0]
    assert 1.0 <= scale <= 1.029 and max(p['sides']) <= 1.05
    assert np.allclose(p['sides'], np.multiply(scale, [1.0, 1.01, 1.02]))


@pytest.mark.parametrize('name', [w['name'] for w in
                                  registry.benchmark()['workloads']])
def test_the_block_width_of_every_apply(tiny_cell, name):
    """The device LOBPCG applies every operator to blocks of ``block``
    vectors; the core Solver to ``block`` and, as pairs converge, fewer
    (the mix is in PERF.md); never more."""
    cell = tiny_cell(name)
    program = cell.task.Program(cell, cell.make(4), 'cpu')
    with calibrate.counting_shapes() as shapes:
        program.solve()
    widths = {int(key.split('m=')[1]) for key in shapes}
    block = cell.workload['block']
    if cell.workload['engine'] == 'core':
        assert max(widths) == block
    else:
        assert widths == {block}
