"""How the subspace engines put their results on the host
(``interfaces/randomized.py::_host``).

Everywhere, the CPU included: a CPU tensor comes back as
``.cpu().numpy()`` gave it and counts in ``COUNTS['to_host_bytes']``
alone; a ``ShardedRows`` on a mesh of the CPU is gathered first;
``reset_counts`` zeroes ``pinned_bytes``.

Marked ``gpu`` (they skip where torch finds no card): a CUDA tensor comes
back through pinned host memory, bit-equal to ``.cpu().numpy()`` in f32
and f64 at the shapes of the benchmark's PCA cell scaled down (mean
(1, n), trans (m, npc), comps (npc, n)) and for a ``ShardedRows`` on two
shards of the card; the arrays are writable and share no memory with one
another or with a later call's; the first call's values survive a second
call; a ``subspace_pca`` call fetches every byte through pinned memory;
once the first result is dropped, a second call of the same shapes pins
no new block.

This file imports nothing of JAX, so it runs on the card with
``--noconftest``."""

import gc
import itertools

import numpy as np
import pytest
import torch

from raleigh_tpu_torch.interfaces import randomized
from raleigh_tpu_torch.parallel.mesh import (ShardedRows, make_mesh,
                                             matrix_sharding)

# One torch thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

# the PCA cell's (mean, trans, comps) at a tenth of m and n and of npc
M, N, NPC = 1200, 3937, 80
SHAPES = ((1, N), (M, NPC), (NPC, N))
DTYPES = (torch.float32, torch.float64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; torch finds none')
    return torch.device('cuda')


@pytest.fixture(autouse=True)
def _counts():
    randomized.reset_counts()
    yield
    randomized.reset_counts()


def _factors(dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen, dtype=dtype).to(device)
            for s in SHAPES]


def _views(dtype, device):
    """Tensors that are not dense in row order, as ``randomized_svd``
    returns (``u[:, :k]``): a column slice and a transpose."""
    gen = torch.Generator().manual_seed(1)
    t = torch.randn((M, NPC + 16), generator=gen, dtype=dtype).to(device)
    return [t[:, :NPC], t.T]


def _sharded(device, dim):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((M // 4, N), generator=gen, dtype=torch.float32)
    mesh = make_mesh(2, [device] * 2)
    return x, ShardedRows.split(x, matrix_sharding(mesh), dim=dim)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


# ---- the CPU ---------------------------------------------------------------

@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_a_cpu_tensor_comes_back_as_cpu_numpy(dtype):
    ts = _factors(dtype, 'cpu') + _views(dtype, 'cpu')
    _same(randomized._host(*ts), [t.cpu().numpy() for t in ts])


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_a_cpu_tensor_counts_no_pinned_bytes(dtype):
    out = randomized._host(*_factors(dtype, 'cpu'))
    size = torch.tensor([], dtype=dtype).element_size()
    assert randomized.COUNTS['to_host_bytes'] == sum(x.nbytes for x in out)
    assert randomized.COUNTS['to_host_bytes'] == size * (N + M * NPC
                                                         + NPC * N)
    assert randomized.COUNTS['pinned_bytes'] == 0


@pytest.mark.parametrize('dim', (0, 1))
def test_cpu_sharded_rows_are_gathered(dim):
    x, sh = _sharded('cpu', dim)
    (got,) = randomized._host(sh)
    _same([got], [sh.gather().cpu().numpy()])
    _same([got], [x.numpy()])
    assert randomized.COUNTS['pinned_bytes'] == 0


def test_reset_counts_zeroes_pinned_bytes():
    randomized.COUNTS['pinned_bytes'] = 7
    randomized.COUNTS['to_host_bytes'] = 7
    randomized.reset_counts()
    assert randomized.COUNTS['pinned_bytes'] == 0
    assert set(randomized.COUNTS.values()) == {0}


# ---- the card --------------------------------------------------------------

def _pinned(x):
    return torch.from_numpy(x).is_pinned()


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_the_pinned_fetch_is_bit_equal(cuda, dtype):
    ts = _factors(dtype, cuda) + _views(dtype, cuda)
    want = [t.cpu().numpy() for t in ts]
    randomized.reset_counts()
    got = randomized._host(*ts)
    _same(got, want)
    assert all(_pinned(x) for x in got)
    nbytes = sum(x.nbytes for x in got)
    assert randomized.COUNTS['pinned_bytes'] == nbytes
    assert randomized.COUNTS['to_host_bytes'] == nbytes


@pytest.mark.gpu
@pytest.mark.parametrize('dim', (0, 1))
def test_sharded_rows_on_the_card_are_gathered(cuda, dim):
    x, sh = _sharded(cuda, dim)
    (got,) = randomized._host(sh)
    _same([got], [x.numpy()])
    assert _pinned(got)
    assert randomized.COUNTS['pinned_bytes'] == got.nbytes


@pytest.mark.gpu
def test_the_arrays_are_writable_and_own_their_memory(cuda):
    first = randomized._host(*_factors(torch.float32, cuda))
    second = randomized._host(*_factors(torch.float32, cuda, seed=5))
    arrays = first + second
    assert all(x.flags.writeable for x in arrays)
    for x, y in itertools.combinations(arrays, 2):
        assert not np.shares_memory(x, y)
    for x in arrays:
        x[...] = 1.0
    assert all(np.all(x == 1.0) for x in arrays)


@pytest.mark.gpu
def test_the_first_values_survive_a_second_call(cuda):
    first = randomized._host(*_factors(torch.float32, cuda))
    kept = [x.copy() for x in first]
    randomized._host(*_factors(torch.float32, cuda, seed=5))
    second = randomized._host(*_factors(torch.float32, cuda, seed=6))
    _same(first, kept)
    assert not any(np.array_equal(x, y) for x, y in zip(first, second))


@pytest.mark.gpu
def test_a_pca_fetches_every_byte_through_pinned_memory(cuda):
    gen = torch.Generator().manual_seed(4)
    a = torch.randn((600, 2000), generator=gen).to(cuda)
    mean, trans, comps = randomized.subspace_pca(a, 40)
    nbytes = 4 * (2000 + 600 * 40 + 40 * 2000)
    assert randomized.COUNTS['to_host_bytes'] == nbytes
    assert randomized.COUNTS['pinned_bytes'] == nbytes
    assert all(_pinned(x) for x in (mean, trans, comps))


# the count of cudaHostAlloc calls in torch.cuda.host_memory_stats()
HOST_ALLOCS = 'num_host_alloc'


@pytest.mark.gpu
def test_a_second_call_reuses_the_freed_blocks(cuda):
    ts = _factors(torch.float32, cuda)
    first = randomized._host(*ts)
    pointers = {x.ctypes.data for x in first}
    del first
    gc.collect()
    before = torch.cuda.host_memory_stats()[HOST_ALLOCS]
    second = randomized._host(*ts)
    assert torch.cuda.host_memory_stats()[HOST_ALLOCS] == before
    assert {x.ctypes.data for x in second} == pointers
