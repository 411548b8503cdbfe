"""The DIA kernel's complex instantiation (``csrc/dia_spmm.cu``,
``dia_spmm_rows_c128_val32`` / ``_val64`` / ``_val128``): a c128 row block
with f32, f64 or c128 values in one launch, reached through
``ops/spmm_window.py::dia_matmat_rows``.

On the CPU: which blocks take the complex instantiation and which the
stacked route of ``ops/complex_rows.py``, the wrapper's checks (on meta
tensors, before any launch and with none counted), and a c128 block on CPU
tensors through the plain version, against the JAX package's
``_dia_matmat_rows``.  Marked ``gpu`` (they skip without a card): the kernel
against the plain version, within 1e-14 of the largest |entry| (f64 sums
of at most a few terms, with fused multiply-adds where the plain version
rounds each product).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as scs
import torch

from raleigh_tpu.ops.spmm import _dia_matmat_rows
from raleigh_tpu_torch.ops import _build
from raleigh_tpu_torch.ops import spmm_window as sw
from raleigh_tpu_torch.ops.spmm import DiaMatrix

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores.
torch.set_num_threads(1)

C128_TOL = 1e-14
VALUES = {'f32': torch.float32, 'f64': torch.float64, 'c128': torch.complex128}
KEYS = {'f32': 'complex128_val32', 'f64': 'complex128_val64',
        'c128': 'complex128_val128'}


def _case(n, offsets, m, values, seed, device='cpu'):
    """DIA values (noff, n) of dtype ``values`` and a c128 (m, n) block,
    from numpy."""
    rng = np.random.default_rng(seed)
    noff = len(offsets)
    val = rng.standard_normal((noff, n))
    if values == 'c128':
        val = val + 1j * rng.standard_normal((noff, n))
    x = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    return (torch.from_numpy(val).to(device, VALUES[values]),
            torch.from_numpy(x).to(device),
            torch.tensor(offsets, dtype=torch.int32, device=device))


@pytest.fixture
def no_library(monkeypatch):
    def refuse():
        raise AssertionError('the library was asked for')
    monkeypatch.setattr(_build, 'library', refuse)


# ---- on the CPU -------------------------------------------------------------

@pytest.mark.parametrize('values', list(VALUES))
def test_c128_block_on_cpu_is_plain_and_matches_jax(no_library, values):
    """A c128 block on CPU tensors takes ``dia_matmat_rows_plain`` (no
    library, no launch counted), which agrees with the JAX package's
    ``_dia_matmat_rows`` on the same arrays."""
    n, offsets = 203, [-203, -17, -1, 0, 1, 17, 250]
    val, x, offs = _case(n, offsets, 7, values, seed=1)
    before = dict(sw.LAUNCHES)
    got = sw.dia_matmat_rows(val, x, offs)
    assert sw.LAUNCHES == before
    assert got.dtype == torch.complex128
    assert torch.equal(got, sw.dia_matmat_rows_plain(val, x, offs))
    want = np.array(_dia_matmat_rows(
        jnp.asarray(val.numpy().astype(
            np.complex128 if values == 'c128' else np.float64)),
        jnp.asarray(x.numpy()), tuple(offsets)))
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= C128_TOL * scale


ROUTES = [
    (torch.complex128, torch.float32, 'native'),
    (torch.complex128, torch.float64, 'native'),
    (torch.complex128, torch.complex128, 'native'),
    (torch.complex64, torch.complex128, 'native'),    # refused there
    (torch.complex64, torch.float32, 'stacked'),
    (torch.complex64, torch.complex64, 'stacked'),
    (torch.float64, torch.complex128, 'stacked'),
    (torch.float32, torch.float32, 'real')]


@pytest.mark.parametrize('xdt,vdt,route', ROUTES,
                         ids=['%s-%s' % (str(x)[6:], str(v)[6:])
                              for x, v, _ in ROUTES])
def test_blocks_take_their_route(monkeypatch, xdt, vdt, route):
    """Off the CPU a c128 operand (and c128 values with any complex
    operand, which the checks then refuse) goes to the complex
    instantiation; c64 blocks and real operands with complex values to the
    stacked route; real blocks to the real kernel."""
    taken = []
    for name in ('_dia_rows_complex', 'dia_matmat_rows_complex_stacked',
                 '_dia_rows'):
        monkeypatch.setattr(sw, name, lambda *a, name=name, **k:
                            taken.append(name))
    val = torch.empty((3, 10), dtype=vdt, device='meta')
    x = torch.empty((2, 10), dtype=xdt, device='meta')
    offs = torch.empty((3,), dtype=torch.int32, device='meta')
    sw.dia_matmat_rows(val, x, offs)
    assert taken == [{'native': '_dia_rows_complex',
                      'stacked': 'dia_matmat_rows_complex_stacked',
                      'real': '_dia_rows'}[route]]


def _meta(val, x, offs):
    return val.to('meta'), x.to('meta'), offs.to('meta')


BAD = {
    'devices differ': (lambda v, x, o: (v, x.to('meta'), o.to('meta')),
                       ValueError, 'share a device'),
    'c128 values, c64 operand': (
        lambda v, x, o: _meta(v.to(torch.complex128), x.to(torch.complex64),
                              o), TypeError, 'c128 operand'),
    'c64 values': (lambda v, x, o: _meta(v.to(torch.complex64), x, o),
                   TypeError, 'c128 operand'),
    'shape mismatch': (lambda v, x, o: _meta(v[:, :-1], x, o), ValueError,
                       'shape mismatch'),
    'offsets shape': (lambda v, x, o: _meta(v, x, o[:-1]), ValueError,
                      'shape mismatch'),
    'strided operand': (lambda v, x, o: _meta(v, x.T.contiguous().T, o),
                        ValueError, 'contiguous'),
    'strided values': (lambda v, x, o: _meta(v.T.contiguous().T, x, o),
                       ValueError, 'contiguous'),
    'int64 offsets': (lambda v, x, o: _meta(v, x, o.long()), TypeError,
                      'int32 offsets'),
    'no kernel for meta': (_meta, ValueError, 'no DIA apply for device'),
}


@pytest.mark.parametrize('case', list(BAD))
def test_wrapper_refuses_before_any_launch(no_library, case):
    """Every input the complex instantiation does not take raises before
    the library is asked for and with no launch counted; a tensor on a
    device that is neither the CPU nor a card is refused, never computed
    elsewhere."""
    val, x, offs = _case(64, [-1, 0, 1], 4, 'c128', seed=2)
    make, err, match = BAD[case]
    v, xx, o = make(val, x, offs)
    before = dict(sw.LAUNCHES)
    with pytest.raises(err, match=match):
        sw.dia_matmat_rows(v, xx, o)
    assert sw.LAUNCHES == before


def test_launch_keys_reset():
    """The complex instantiation counts under a key per value dtype, beside
    the stacked route's ``complex_`` keys; all reset to 0."""
    assert {'complex128_val32', 'complex128_val64', 'complex128_val128',
            'complex_float64_val64', 'complex_float32'} <= set(sw.LAUNCHES)
    sw.LAUNCHES['complex128_val128'] += 1
    sw.reset_launches()
    assert not any(sw.LAUNCHES.values())


def test_stacked_route_on_cpu_is_plain(no_library):
    """The stacked route's entry, the route of c64 blocks, is the plain
    version on CPU tensors."""
    val, x, offs = _case(50, [-3, 0, 3], 5, 'c128', seed=3)
    before = dict(sw.LAUNCHES)
    assert torch.equal(sw.dia_matmat_rows_complex_stacked(val, x, offs),
                       sw.dia_matmat_rows_plain(val, x, offs))
    assert sw.LAUNCHES == before


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; torch finds none')
    return torch.device('cuda')


def _near(got, want):
    return (got - want).abs().max().item() <= \
        C128_TOL * want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize('m', [1, 7, 8])
@pytest.mark.parametrize('values', list(VALUES))
def test_kernel_matches_plain(cuda, values, m):
    """Each value type at m = 1, 7, 8, n = 1,001 (not a multiple of 4),
    offsets within, at and beyond +-n: one launch under the value type's
    key and none of the stacked route's, within 1e-14 of the largest
    |entry| of the plain version."""
    n = 1001
    offsets = [-n - 3, -n, -(n - 1), -40, -1, 0, 1, 40, n - 1, n, n + 3]
    val, x, offs = _case(n, offsets, m, values, seed=m, device=cuda)
    before = dict(sw.LAUNCHES)
    got = sw.dia_matmat_rows(val, x, offs)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in sw.LAUNCHES.items()
             if v != before[k]}
    assert moved == {KEYS[values]: 1}
    want = sw.dia_matmat_rows_plain(val, x, offs)
    assert got.dtype == torch.complex128 and got.shape == (m, n)
    assert torch.isfinite(torch.view_as_real(got)).all()
    assert _near(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize('values', list(VALUES))
def test_kernel_matches_the_stacked_route(cuda, values):
    """The complex instantiation and the stacked route it replaced agree
    within the tolerance on a lap3d-shaped operator; the stacked route
    counts under its ``complex_`` keys (two launches for c128 values)."""
    n = 12 * 11 * 10
    offsets = [-132, -12, -1, 0, 1, 12, 132]
    val, x, offs = _case(n, offsets, 8, values, seed=5, device=cuda)
    before = dict(sw.LAUNCHES)
    stacked = sw.dia_matmat_rows_complex_stacked(val, x, offs)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in sw.LAUNCHES.items()
             if v != before[k]}
    key = 'complex_float64_val32' if values == 'f32' \
        else 'complex_float64_val64'
    assert moved == {key: 2 if values == 'c128' else 1}
    assert _near(sw.dia_matmat_rows(val, x, offs), stacked)


@pytest.mark.gpu
def test_kernel_refuses_on_the_card(cuda):
    """On the card the wrapper raises instead of computing elsewhere."""
    val, x, offs = _case(64, [-1, 0, 1], 4, 'c128', seed=6, device=cuda)
    with pytest.raises(TypeError, match='c128 operand'):
        sw.dia_matmat_rows(val, x.to(torch.complex64), offs)
    with pytest.raises(ValueError, match='contiguous'):
        sw.dia_matmat_rows(val, x.T.contiguous().T, offs)
    with pytest.raises(ValueError, match='share a device'):
        sw.dia_matmat_rows(val.cpu(), x, offs)
