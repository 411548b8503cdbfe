"""DIA SpMM on row-layout operand blocks: the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (``csrc/dia_spmm.cu``) replaces the sliding-window Pallas
kernel ``raleigh_tpu/ops/spmm_window.py::build_dia_window_ring``.  Its
TPU-only machinery does not carry over: the DMA ring through VMEM (L1/L2
give a coalesced kernel the same halo reuse), and the Mosaic limits
``n % 128 == 0``, ``m % 8 == 0`` and two or more lane tiles — the kernel
takes any shape.

    y[r, i] = sum_k val[k, i] * x[r, i + offsets[k]],  zero outside [0, n)

``val`` (noff, n), ``x`` (m, n), ``offsets`` an int32 (noff,) tensor on
the same device.  On a CUDA tensor the wrapper launches the kernel (x f32
or bf16 with val f32; or x f64, the core Solver's blocks, with val f32 or
f64, the f64 instantiation) or raises; only a CPU tensor takes the plain
version.  The kernel keeps the plain version's products and order of
sums, so the two are equal bit for bit.  A c128 operand with f32, f64 or
c128 values goes through the kernel's complex instantiation, one launch
that reads the interleaved complex storage directly (the products and
sums in f64 by fused multiply-adds, within a few units of the last place
of the plain version's); c64 blocks and real operands with complex values
take the stacked route of ``ops/complex_rows.py``
(``dia_matmat_rows_complex_stacked``).

Two more kernels compute the same function for f32 operands, each through
an explicitly staged shared-memory window that reads x from device memory
once.  They are the A/B partners of the production kernel in
``benches/bench_window_tiles.py`` and serve no solver:

  * ``dia_matmat_rows_slide`` (``csrc/dia_spmm_slide.cu``) replaces
    ``build_dia_window_slide``: one circular window of tile + reach lanes
    per row, the next tile's lanes in flight while a tile is computed;
  * ``dia_matmat_rows_tiles`` (``csrc/dia_spmm_tiles.cu``) replaces
    ``build_dia_window_tiles``: a ring of four whole tiles per row and no
    halo, for max|offset| <= tile.

Their ``offsets`` are host ints (``DiaMatrix.offsets``): the launch sizes
its shared memory from them, and the kernel takes them as an argument.
Both launch as thread-block clusters: the blocks of one run of lanes share
each chunk of val through one multicast bulk copy, and x arrives by bulk
copies; where a stage of val of ``MIN_CHUNK_LANES`` does not fit beside the
windows, or a bulk copy cannot take the shape, val comes from device
memory instead.  ``window_launch_plan`` says which branch and plan a call
takes (cluster size, clusters that fit the card at once, rows per block,
val chunk).

``dia_matmat_rows_mesh`` (``csrc/dia_spmm_ext.cu``) replaces
``build_dia_window_ring_ext``, the per-shard kernel of the mesh-partitioned
apply (``DiaMatrix.sharded_rows_fn``): the same sum, for every shard of a
device in one launch, over each shard's lanes and its neighbours' edge
lanes read where they lie through a piece table (``DiaMeshPlan``), with the
shards' own values and no range check.  ``dia_matmat_rows_ext`` is the
kernel's one-piece case, one shard over an operand that the caller has
extended by its neighbours' edge lanes: the counterpart of the reference's
kernel as it is called.  Mosaic's limits (``n % 128``, ``m % 8``, two or
more tiles, halos rounded up to 128) do not carry over, and bf16 operands
go through the kernel too.
"""

import ctypes

import torch

from ..utils.profiling import spanned
from . import _build
from .complex_rows import complex_parts, complex_rows, result_dtype

# kernel launches, counted where the kernel is launched: the production
# kernel per operand dtype, the two staged-window kernels, the mesh
# kernel per operand dtype through its one-piece entry and its mesh entry.
# The launches that apply a complex
# operand or complex values (``ops/complex_rows.py``) count under keys of
# their own, ``complex_`` and ``mesh_complex_`` before the real route's,
# and those of the complex instantiation under ``complex128_val32``,
# ``_val64`` and ``_val128``, by the values' dtype.
_ROUTES = ('float32', 'float64_val32', 'float64_val64')
LAUNCHES = dict(
    {'float32': 0, 'bfloat16': 0, 'float64_val32': 0,
     'float64_val64': 0, 'complex128_val32': 0, 'complex128_val64': 0,
     'complex128_val128': 0, 'slide': 0, 'tiles': 0,
     'ext_float32': 0, 'ext_bfloat16': 0, 'ext_float64_val32': 0,
     'ext_float64_val64': 0, 'mesh_float32': 0, 'mesh_bfloat16': 0,
     'mesh_float64_val32': 0, 'mesh_float64_val64': 0},
    **{pre + key: 0 for pre in ('complex_', 'mesh_complex_')
       for key in _ROUTES})

# operand rows a block of a staged-window kernel can own, and the most
# diagonals it takes (they travel as a kernel argument)
ROWS_PER_BLOCK = (8, 4, 2, 1)
MAX_WINDOW_OFFSETS = 128
# the clustered staged-window kernels: bytes of barriers before the
# windows, the widest chunk of val lanes a stage holds, and the narrowest
# worth a stage (below it the kernels read val from device memory; on the
# H100 at the tile sweep's shape a stage of 816 lanes beat that and one of
# 780 lost, and two rows a block with chunks of 704 lost to one row with
# 2,048)
WINDOW_BARRIER_BYTES = 256
CHUNK_LANES = 2048
MIN_CHUNK_LANES = 800
# the slots of a clustered kernel's launch plan (``window_launch_plan``)
PLAN_KEYS = ('cluster', 'active_clusters', 'clusters_per_segment',
             'segments', 'blocks')

_ENTRY = {torch.float32: ('float32', 'dia_spmm_rows_f32'),
          torch.bfloat16: ('bfloat16', 'dia_spmm_rows_bf16'),
          # the f64 instantiation, by the values' dtype
          (torch.float64, torch.float32): ('float64_val32',
                                           'dia_spmm_rows_f64_val32'),
          (torch.float64, torch.float64): ('float64_val64',
                                           'dia_spmm_rows_f64_val64')}
# the complex instantiation (c128 operand), by the values' dtype
_COMPLEX_ENTRY = {
    torch.float32: ('complex128_val32', 'dia_spmm_rows_c128_val32'),
    torch.float64: ('complex128_val64', 'dia_spmm_rows_c128_val64'),
    torch.complex128: ('complex128_val128', 'dia_spmm_rows_c128_val128')}
_EXT_ENTRY = {torch.float32: ('ext_float32', 'dia_spmm_rows_ext_f32'),
              torch.bfloat16: ('ext_bfloat16', 'dia_spmm_rows_ext_bf16'),
              (torch.float64, torch.float32): (
                  'ext_float64_val32', 'dia_spmm_rows_ext_f64_val32'),
              (torch.float64, torch.float64): (
                  'ext_float64_val64', 'dia_spmm_rows_ext_f64_val64')}
_MESH_ENTRY = {torch.float32: ('mesh_float32', 'dia_spmm_mesh_f32'),
               torch.bfloat16: ('mesh_bfloat16', 'dia_spmm_mesh_bf16'),
               (torch.float64, torch.float32): ('mesh_float64_val32',
                                                'dia_spmm_mesh_f64_val32'),
               (torch.float64, torch.float64): ('mesh_float64_val64',
                                                'dia_spmm_mesh_f64_val64')}


def _entry_key(x_dtype, val_dtype):
    """The key of an entry table for an operand and values: the operand's
    dtype, or (f64, the values' dtype) for the f64 instantiations."""
    return (x_dtype, val_dtype) if x_dtype == torch.float64 else x_dtype


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def dia_matmat_rows_plain(val, x, offsets):
    """Plain PyTorch DIA row apply, any device and dtype (complex too);
    ``offsets`` a tensor or a sequence of ints.  Accumulates in the
    promoted type of val and x (f32 for bf16 operands with f32 values),
    adding the diagonals in order, and returns x's dtype (made complex for
    complex values)."""
    m, n = x.shape
    y = torch.zeros((m, n), dtype=torch.promote_types(val.dtype, x.dtype),
                    device=x.device)
    if isinstance(offsets, torch.Tensor):
        offsets = offsets.tolist()
    for k, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        if lo < hi:
            y[:, lo:hi] += val[k, lo:hi] * x[:, lo + off:hi + off]
    return y.to(result_dtype(val.dtype, x.dtype))


def _check(val, x, offsets):
    """Raise on what the kernel does not take: an f32 or bf16 operand takes
    f32 values, an f64 operand f32 or f64 values."""
    if not (val.device == x.device == offsets.device):
        raise ValueError('val, x and offsets must share a device (got %s, '
                         '%s, %s)' % (val.device, x.device, offsets.device))
    if x.dtype == torch.float64:
        if val.dtype not in (torch.float32, torch.float64):
            raise TypeError('the f64 DIA kernel takes f32 or f64 values, '
                            'not %s' % val.dtype)
    elif x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError('the DIA kernel takes f32, bf16 or f64 operands, '
                        'not %s' % x.dtype)
    elif val.dtype != torch.float32:
        raise TypeError('the DIA kernel takes f32 values with an f32 or '
                        'bf16 operand (got %s)' % val.dtype)
    if offsets.dtype != torch.int32:
        raise TypeError('the DIA kernel takes int32 offsets (got %s)'
                        % offsets.dtype)
    if (val.dim() != 2 or x.dim() != 2 or offsets.dim() != 1
            or val.shape[1] != x.shape[1]
            or offsets.shape[0] != val.shape[0]):
        raise ValueError('shape mismatch: val %s, x %s, offsets %s'
                         % (tuple(val.shape), tuple(x.shape),
                            tuple(offsets.shape)))
    if not (val.is_contiguous() and x.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError('the DIA kernel takes contiguous tensors')


def dia_matmat_rows(val, x, offsets):
    """(m, n) = DIA matrix applied to the (m, n) row block ``x``, in x's
    dtype.  CUDA tensors go through the kernel, CPU tensors through
    ``dia_matmat_rows_plain``.  A c128 operand goes through the kernel's
    complex instantiation (f32, f64 or c128 values; one launch, counted
    under ``complex128_val32`` / ``_val64`` / ``_val128``), other complex
    blocks through ``dia_matmat_rows_complex_stacked``."""
    if x.device.type != 'cpu' and (
            x.dtype == torch.complex128
            or (val.dtype == torch.complex128 and x.is_complex())):
        return _dia_rows_complex(val, x, offsets)
    if x.device.type != 'cpu' and (x.is_complex() or val.is_complex()):
        return dia_matmat_rows_complex_stacked(val, x, offsets)
    return _dia_rows(val, x, offsets)


def dia_matmat_rows_complex_stacked(val, x, offsets):
    """The stacked route of a complex block (``ops/complex_rows.py``): a
    complex operand as one real block of its real and imaginary rows
    through the real kernel, complex values as two launches, one with their
    real and one with their imaginary parts, counted under the ``complex_``
    keys.  The route of c64 blocks and of real operands with complex
    values; it takes c128 blocks too."""
    if x.device.type == 'cpu':
        return dia_matmat_rows_plain(val, x, offsets)
    return complex_rows(
        lambda v, s: _dia_rows(v, s, offsets, 'complex_'), val, x)


def _check_complex(val, x, offsets):
    """Raise on what the complex instantiation does not take, and on a
    device that is not a card."""
    if not (val.device == x.device == offsets.device):
        raise ValueError('val, x and offsets must share a device (got %s, '
                         '%s, %s)' % (val.device, x.device, offsets.device))
    if x.dtype != torch.complex128 or val.dtype not in _COMPLEX_ENTRY:
        raise TypeError('the complex DIA kernel takes a c128 operand with '
                        'f32, f64 or c128 values, not %s values with a %s '
                        'operand' % (val.dtype, x.dtype))
    if offsets.dtype != torch.int32:
        raise TypeError('the DIA kernel takes int32 offsets (got %s)'
                        % offsets.dtype)
    if (val.dim() != 2 or x.dim() != 2 or offsets.dim() != 1
            or val.shape[1] != x.shape[1]
            or offsets.shape[0] != val.shape[0]):
        raise ValueError('shape mismatch: val %s, x %s, offsets %s'
                         % (tuple(val.shape), tuple(x.shape),
                            tuple(offsets.shape)))
    if not (val.is_contiguous() and x.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError('the DIA kernel takes contiguous tensors')
    if x.device.type != 'cuda':
        raise ValueError('no DIA apply for device %s' % x.device)


@spanned('raleigh.spmm')
def _dia_rows_complex(val, x, offsets):
    _check_complex(val, x, offsets)
    return _launch(*_COMPLEX_ENTRY[val.dtype], val, x, offsets)


@spanned('raleigh.spmm')
def _dia_rows(val, x, offsets, tag=''):
    if x.device.type == 'cpu':
        return dia_matmat_rows_plain(val, x, offsets)
    if x.device.type != 'cuda':
        raise ValueError('no DIA apply for device %s' % x.device)
    _check(val, x, offsets)
    key, entry = _ENTRY[_entry_key(x.dtype, val.dtype)]
    return _launch(tag + key, entry, val, x, offsets)


def _launch(key, entry, val, x, offsets):
    """One launch of the C entry ``entry`` on checked CUDA tensors, counted
    under ``LAUNCHES[key]``."""
    y = torch.empty_like(x)
    m, n = x.shape
    if m == 0 or n == 0:
        return y
    index = x.get_device()
    err = getattr(_build.library(), entry)(
        val.data_ptr(), x.data_ptr(), y.data_ptr(), offsets.data_ptr(),
        val.shape[0], m, n, index, _build.current_stream(index))
    if err != 0:
        raise RuntimeError('DIA kernel launch failed (%s): CUDA error %d'
                           % (entry, err))
    LAUNCHES[key] += 1
    return y


def dia_matmat_rows_ext_plain(val, x_ext, offsets, halo_lo, n):
    """Plain PyTorch DIA row apply over a pre-extended operand, any device
    and dtype: ``x_ext`` carries ``halo_lo`` lanes before the ``n`` local
    ones and at least ``max(offsets)`` after, so every diagonal is one
    static slice.  Accumulates in the promoted type of val and x_ext,
    adding the diagonals in order, and returns x_ext's dtype."""
    m = x_ext.shape[0]
    y = torch.zeros((m, n), dtype=torch.promote_types(val.dtype, x_ext.dtype),
                    device=x_ext.device)
    if isinstance(offsets, torch.Tensor):
        offsets = offsets.tolist()
    for k, off in enumerate(offsets):
        y += val[k, :n] * x_ext[:, halo_lo + off:halo_lo + off + n]
    return y.to(result_dtype(val.dtype, x_ext.dtype))


def dia_matmat_rows_ext(val, x_ext, offsets, halo_lo, n, reach=None):
    """(m, n) = the shard's DIA values ``val`` (noff, n) applied to the
    extended row block ``x_ext`` (m, halo_lo + n + halo_hi) =
    [left halo | local lanes | right halo], in x_ext's dtype:

        y[r, i] = sum_k val[k, i] * x_ext[r, halo_lo + i + offsets[k]]

    with no range check, so ``halo_lo >= -min(offsets)`` and
    ``x_ext.shape[1] >= halo_lo + n + max(offsets)`` must hold; raises
    otherwise.  ``reach`` = (-min(offsets, 0), max(offsets, 0)) as host
    ints saves reading the offsets back from the device.  ``x_ext`` needs
    unit stride along the lanes and may have any row stride.  CUDA tensors
    go through the mesh kernel as one shard with one piece (x_ext f32 or
    bf16 with f32 values, or f64 with f32 or f64 values), CPU tensors
    through ``dia_matmat_rows_ext_plain``."""
    halo_lo, n = int(halo_lo), int(n)
    if not (val.device == x_ext.device == offsets.device):
        raise ValueError('val, x_ext and offsets must share a device (got '
                         '%s, %s, %s)'
                         % (val.device, x_ext.device, offsets.device))
    if x_ext.device.type not in ('cpu', 'cuda'):
        raise ValueError('no DIA apply for device %s' % x_ext.device)
    if (val.dim() != 2 or x_ext.dim() != 2 or offsets.dim() != 1
            or val.shape[1] != n or offsets.shape[0] != val.shape[0]):
        raise ValueError('shape mismatch: val %s, x_ext %s, offsets %s, '
                         'n = %d' % (tuple(val.shape), tuple(x_ext.shape),
                                     tuple(offsets.shape), n))
    if reach is None:
        host = offsets.tolist()
        reach = (max(0, -min(host, default=0)), max(0, max(host, default=0)))
    if halo_lo < reach[0] or x_ext.shape[1] < halo_lo + n + reach[1]:
        raise ValueError('x_ext has %d lanes before and %d after the %d '
                         'local ones; the offsets reach %d before and %d '
                         'after' % (halo_lo, x_ext.shape[1] - halo_lo - n,
                                    n, reach[0], reach[1]))
    if x_ext.device.type == 'cpu':
        return dia_matmat_rows_ext_plain(val, x_ext, offsets, halo_lo, n)
    if _entry_key(x_ext.dtype, val.dtype) not in _EXT_ENTRY or (
            x_ext.dtype != torch.float64 and val.dtype != torch.float32):
        raise TypeError('the DIA kernel takes f32 values with an f32 or bf16 '
                        'operand, or f32 or f64 values with an f64 operand '
                        '(got %s values, a %s operand)'
                        % (val.dtype, x_ext.dtype))
    if offsets.dtype != torch.int32:
        raise TypeError('the DIA kernel takes int32 offsets (got %s)'
                        % offsets.dtype)
    m = x_ext.shape[0]
    if not (val.is_contiguous() and offsets.is_contiguous()
            and (x_ext.shape[1] <= 1 or x_ext.stride(1) == 1)):
        raise ValueError('the DIA kernel takes contiguous values and '
                         'offsets and an operand with unit stride along '
                         'the lanes')
    y = torch.empty((m, n), dtype=x_ext.dtype, device=x_ext.device)
    if m == 0 or n == 0:
        return y
    key, entry = _EXT_ENTRY[_entry_key(x_ext.dtype, val.dtype)]
    index = x_ext.get_device()
    err = getattr(_build.library(), entry)(
        val.data_ptr(), x_ext.data_ptr(), y.data_ptr(), offsets.data_ptr(),
        val.shape[0], m, n, x_ext.stride(0), halo_lo, index,
        _build.current_stream(index))
    if err != 0:
        raise RuntimeError('one-piece mesh DIA kernel launch failed: CUDA '
                           'error %d' % err)
    LAUNCHES[key] += 1
    return y


# layout of the mesh kernel's parameter block (csrc/dia_spmm_ext.cu::Params)
# in int64 slots: a header, then MESH_MAX_SHARDS shards, MESH_MAX_SOURCES
# sources and MESH_MAX_PIECES pieces
MESH_MAX_SHARDS, MESH_MAX_SOURCES, MESH_MAX_PIECES = 16, 32, 96
_M, _NOFF, _OFFSETS, _Y, _NSHARDS = range(5)    # header slots; 8 in all
_SHARD = 7      # val, n, col0, a slot the entry point fills, first piece,
#                 end of its pieces, lane of its own lane 0 in its source
_SOURCE = 2     # base, row stride
_PIECE = 3      # first relative lane, shift to the source lane, source
_SHARDS_AT = 8
_SOURCES_AT = _SHARDS_AT + MESH_MAX_SHARDS * _SHARD
_PIECES_AT = _SOURCES_AT + MESH_MAX_SOURCES * _SOURCE
_MESH_PARAMS = _PIECES_AT + MESH_MAX_PIECES * _PIECE


class _MeshLaunch:
    """One launch of the mesh kernel: shards of one device and their
    parameter block, whose static part is filled here.  ``sources``: what
    each source slot reads, ('part', j) for shard j's operand part on this
    device, or ('stage', j, lane, lanes) for lanes of a part on another
    device, copied here per apply.  Source i is the operand part of the
    launch's shard i: the kernel reads a shard's own lanes from it without
    a look-up."""

    def __init__(self, plan, device, shards):
        self.device = device
        self.shards = shards
        self.widths = [plan.widths[s] for s in shards]
        self.lanes = sum(self.widths)
        self.sources = [('part', s) for s in shards]
        slot = {key: i for i, key in enumerate(self.sources)}
        params = (ctypes.c_int64 * _MESH_PARAMS)()
        params[_NOFF] = len(plan.offsets)
        if device.type == 'cuda':
            params[_OFFSETS] = plan.offsets_on(device).data_ptr()
        params[_NSHARDS] = len(shards)
        col0, piece = 0, 0
        for i, s in enumerate(shards):
            at = _SHARDS_AT + i * _SHARD
            params[at + 1], params[at + 2] = plan.widths[s], col0
            params[at + 4] = piece
            for start, length, j, lane in plan.pieces[s]:
                if plan.devices[j] == device:
                    key, shift = ('part', j), lane - start
                else:
                    key, shift = ('stage', j, lane, length), -start
                if key not in slot:
                    slot[key] = len(self.sources)
                    self.sources.append(key)
                at_piece = _PIECES_AT + piece * _PIECE
                params[at_piece:at_piece + _PIECE] = [start, shift, slot[key]]
                piece += 1
            params[at + 5] = piece
            col0 += plan.widths[s]
        self.params = params
        self.address = ctypes.addressof(params)
        self.nbytes = ctypes.sizeof(params)
        # (slot, shard) of the sources that are operand parts on this device
        self.part_slots = [(_SOURCES_AT + i * _SOURCE, key[1])
                           for i, key in enumerate(self.sources)
                           if key[0] == 'part']
        self.stage_slots = [(_SOURCES_AT + i * _SOURCE, key[1:])
                            for i, key in enumerate(self.sources)
                            if key[0] == 'stage']
        self.vals = ()      # the value parts whose pointers the block holds

    @staticmethod
    def fits(plan, shards):
        sources = {('part', j) if plan.devices[j] == plan.devices[s]
                   else ('stage', j, lane, length)
                   for s in shards for _, length, j, lane in plan.pieces[s]}
        return (len(shards) <= MESH_MAX_SHARDS
                and sum(len(plan.pieces[s]) for s in shards)
                <= MESH_MAX_PIECES
                and len(sources) <= MESH_MAX_SOURCES)

    def outputs(self, m, dtype):
        """The shards' (m, n_s) results, contiguous, side by side in one
        allocation; and its address."""
        flat = torch.empty(m * self.lanes, dtype=dtype, device=self.device)
        return ([y.view(m, w) for y, w in
                 zip(flat.split([m * w for w in self.widths]), self.widths)],
                flat.data_ptr())


class DiaMeshPlan:
    """The piece table of a mesh-partitioned DIA apply, for shards of
    ``widths`` lanes on ``devices`` (one per shard, repeats allowed) and the
    diagonals ``offsets`` (host ints): built once per partition, filled with
    the parts' pointers per apply by ``dia_matmat_rows_mesh``.

    Shard s reads the shard-relative lanes [-lo, n_s + hi) of the ring of
    shards (lo, hi: the offsets' reach), cut into pieces by
    ``parallel.mesh.ring_runs``: ``pieces[s]`` lists (first relative lane,
    lanes, shard they lie in, their first lane there); None for an empty
    shard.  ``launches``: the non-empty shards grouped by device, one
    launch per device unless a device holds more shards, pieces or sources
    than one parameter block takes."""

    def __init__(self, widths, devices, offsets):
        from ..parallel.mesh import _indexed, ring_runs
        self.widths = [int(w) for w in widths]
        self.devices = [_indexed(torch.device(d)) for d in devices]
        self.indices = [d.index if d.type == 'cuda' else -1
                        for d in self.devices]
        self.offsets = tuple(int(o) for o in offsets)
        self.lo = max(0, -min(self.offsets, default=0))
        self.hi = max(0, max(self.offsets, default=0))
        self.pieces = [
            None if runs is None else [(pos - self.lo, take, j, at)
                                       for pos, take, j, at in runs]
            for runs in ring_runs(self.widths, self.lo, self.hi)]
        self._offsets_on = {}
        self._vals_checked = ()
        by_device = {}
        for s, dev in enumerate(self.devices):
            if self.pieces[s] is not None:
                by_device.setdefault(dev, []).append(s)
        self.launches = []
        for dev, shards in by_device.items():
            batch = []
            for s in shards:
                if not _MeshLaunch.fits(self, [s]):
                    raise ValueError(
                        'shard %d reads %d pieces of the ring; one launch '
                        'takes %d' % (s, len(self.pieces[s]),
                                      MESH_MAX_PIECES))
                if not _MeshLaunch.fits(self, batch + [s]):
                    self.launches.append(_MeshLaunch(self, dev, batch))
                    batch = []
                batch.append(s)
            self.launches.append(_MeshLaunch(self, dev, batch))

    def offsets_on(self, device):
        """The offsets as an int32 tensor on ``device``, for the kernel."""
        if device not in self._offsets_on:
            self._offsets_on[device] = torch.tensor(
                self.offsets, dtype=torch.int32, device=device)
        return self._offsets_on[device]


def _mesh_lanes(xs, pieces, first, count, device):
    """The relative lanes [first, first + count) of a shard's operand,
    assembled from its pieces, on ``device``."""
    segments = []
    for start, length, j, lane in pieces:
        a, b = max(first, start), min(first + count, start + length)
        if a < b:
            segments.append(
                xs[j][:, lane + a - start:lane + b - start].to(device))
    return segments[0] if len(segments) == 1 else torch.cat(segments, dim=1)


def _mesh_shard_plain(val, xs, plan, s):
    """Shard s of ``dia_matmat_rows_mesh_plain``."""
    m, dtype, width, dev = xs[0].shape[0], xs[0].dtype, plan.widths[s], \
        plan.devices[s]
    if width == 0:
        return torch.empty((m, 0), dtype=result_dtype(val.dtype, dtype),
                           device=dev)
    y = torch.zeros((m, width), dtype=torch.promote_types(val.dtype, dtype),
                    device=dev)
    for k, off in enumerate(plan.offsets):
        y += val[k] * _mesh_lanes(xs, plan.pieces[s], off, width, dev)
    return y.to(result_dtype(val.dtype, dtype))


def dia_matmat_rows_mesh_plain(vals, xs, plan):
    """Plain PyTorch version of ``dia_matmat_rows_mesh`` over the same piece
    table, any device and dtype: per shard, each diagonal's source lanes
    gathered from the pieces as one slice, the diagonals added in order in
    the promoted type of val and x, the result in x's dtype (made complex
    for complex values)."""
    return [_mesh_shard_plain(v, xs, plan, s) for s, v in enumerate(vals)]


def _check_mesh(vals, xs, plan):
    """What the mesh kernel asks of the shards' values and operand parts;
    raises.  Returns the parts' row strides.  The values are checked when
    they change."""
    if not (len(vals) == len(xs) == len(plan.widths)):
        raise ValueError('%d value parts and %d operand parts for %d shards'
                         % (len(vals), len(xs), len(plan.widths)))
    m, dtype = xs[0].shape[0], xs[0].dtype
    strides = []
    for p, width, index in zip(xs, plan.widths, plan.indices):
        if p.dtype is not dtype or p.shape != (m, width):
            raise ValueError('operand parts of %s %s lanes (%d rows of %s) '
                             'for shards of %s lanes'
                             % ([q.dtype for q in xs],
                                [tuple(q.shape) for q in xs], m, dtype,
                                plan.widths))
        if p.get_device() != index:
            raise ValueError('an operand part on %s for a shard on %s'
                             % (p.device, plan.devices[len(strides)]))
        if p.is_contiguous():
            strides.append(width)
            continue
        stride = p.stride()
        if width > 1 and stride[1] != 1:
            raise ValueError('the mesh kernel takes operand parts with unit '
                             'stride along the lanes')
        strides.append(stride[0])
    if len(vals) == len(plan._vals_checked) and all(
            v is w for v, w in zip(vals, plan._vals_checked)):
        return strides
    noff = len(plan.offsets)
    for v, width, dev in zip(vals, plan.widths, plan.devices):
        if v.shape != (noff, width) or v.device != dev:
            raise ValueError('a value part %s on %s for a shard of %d lanes '
                             'and %d diagonals on %s'
                             % (tuple(v.shape), v.device, width, noff, dev))
        wide = dtype == torch.float64 and v.dtype == torch.float64
        if dev.type == 'cuda' and not ((v.dtype == torch.float32 or wide)
                                       and v.is_contiguous()):
            raise TypeError('the mesh kernel takes contiguous f32 values '
                            '(or f64 with an f64 operand), not %s'
                            % v.dtype)
    plan._vals_checked = tuple(vals)
    return strides


def dia_matmat_rows_mesh(vals, xs, plan):
    """The mesh-partitioned DIA apply: per shard s, its values ``vals[s]``
    (noff, n_s) applied to its operand part ``xs[s]`` (m, n_s) extended by
    the ring's halo lanes, which are read where they lie (``plan``, a
    ``DiaMeshPlan`` of the partition), in x's dtype:

        y_s[r, i] = sum_k vals[s][k, i] * X_s[r, i + offsets[k]]

    Returns the (m, n_s) results, one per shard.  On the card one kernel
    launch per device covers all of its shards (x f32 or bf16 with f32
    values, or f64 with f32 or f64 values); lanes that lie on another
    device are first copied to a staging tensor there by
    ``Tensor.copy_``.  A complex operand or complex values take the real
    launches of ``ops/complex_rows.py`` (one per device for a real-valued
    matrix, two for a complex-valued one), counted under the
    ``mesh_complex_`` keys.  CPU tensors go through
    ``dia_matmat_rows_mesh_plain``.  Values outside the global matrix must
    be zero (``shard_operator`` zeroes them): the wrapped lanes meet them."""
    if (xs[0].is_complex() or vals[0].is_complex()) and any(
            d.type == 'cuda' for d in plan.devices):
        return complex_parts(
            lambda vs, ss: _mesh_apply(vs, ss, plan, 'mesh_complex_'),
            vals, xs)
    return _mesh_apply(vals, xs, plan, '')


@spanned('raleigh.spmm')
def _mesh_apply(vals, xs, plan, tag):
    """``dia_matmat_rows_mesh`` for real values and operand parts; the
    launches count under ``tag`` + the route's key (``mesh_float32``, say,
    for no tag)."""
    strides = _check_mesh(vals, xs, plan)
    m, dtype = xs[0].shape[0], xs[0].dtype
    out = [None] * len(xs)
    for s, width in enumerate(plan.widths):
        if width == 0:
            out[s] = torch.empty((m, 0), dtype=dtype, device=plan.devices[s])
    for launch in plan.launches:
        dev = launch.device
        if dev.type == 'cpu':
            for s in launch.shards:
                out[s] = _mesh_shard_plain(vals[s], xs, plan, s)
            continue
        if dev.type != 'cuda':
            raise ValueError('no DIA apply for device %s' % dev)
        if _entry_key(dtype, vals[launch.shards[0]].dtype) not in \
                _MESH_ENTRY:
            raise TypeError('the mesh kernel takes f32 or bf16 operands '
                            '(or f64), not %s' % dtype)
        ys, y = launch.outputs(m, dtype)
        for s, ys_s in zip(launch.shards, ys):
            out[s] = ys_s
        if m == 0:
            continue
        params = launch.params
        params[_M] = m
        params[_Y] = y
        if not (len(launch.vals) == len(launch.shards) and all(
                vals[s] is v for s, v in zip(launch.shards, launch.vals))):
            launch.vals = tuple(vals[s] for s in launch.shards)
            for i, v in enumerate(launch.vals):
                params[_SHARDS_AT + i * _SHARD] = v.data_ptr()
        for at, j in launch.part_slots:
            params[at] = xs[j].data_ptr()
            params[at + 1] = strides[j]
        staged = []
        for at, (j, lane, lanes) in launch.stage_slots:
            src = xs[j][:, lane:lane + lanes].to(dev)
            staged.append(src)
            params[at] = src.data_ptr()
            params[at + 1] = src.stride(0)
        key, entry = _MESH_ENTRY[_entry_key(dtype,
                                            vals[launch.shards[0]].dtype)]
        key = tag + key[len('mesh_'):] if tag else key
        err = getattr(_build.library(), entry)(
            launch.address, launch.nbytes, dev.index,
            _build.current_stream(dev.index))
        if err != 0:
            raise RuntimeError('mesh DIA kernel launch failed: CUDA error %d'
                               % err)
        LAUNCHES[key] += 1
    return out


def _bulk(val, x, tile):
    """Whether a clustered staged-window kernel takes its bulk-copy branch
    for these operands (the C entry decides the same): n and ``tile``
    multiples of 4, val and x on 16 bytes (the result, a fresh tensor, is)."""
    return (x.shape[1] % 4 == 0 and tile % 4 == 0
            and val.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0)


def _window_plan(m, lanes, noff, bulk, what):
    """(rows per block, val chunk lanes) of a clustered staged-window
    kernel.  On the bulk-copy branch: the most rows (of
    ``ROWS_PER_BLOCK``, no more than m needs) whose windows of ``lanes``
    f32 lanes each, the barriers and two stages of ``noff`` val rows of at
    least ``MIN_CHUNK_LANES`` lanes fit one block's shared memory, the
    chunk as wide as the rest allows up to ``CHUNK_LANES``.  Where no such
    stage fits, and on the per-thread branch, no stage (chunk 0: val from
    device memory) and the most rows whose windows and barriers fit.
    Raises when one row's do not."""
    def fit(rows, stage_bytes):
        return (_build.SMEM_PER_BLOCK - WINDOW_BARRIER_BYTES
                - rows * lanes * 4 - stage_bytes)

    wanted = [rows for rows in ROWS_PER_BLOCK if rows == 1 or rows < 2 * m]
    if bulk:
        for rows in wanted:
            w = min(CHUNK_LANES,
                    max(fit(rows, 0), 0) // (8 * max(noff, 1))) // 4 * 4
            if w >= MIN_CHUNK_LANES:
                return rows, w
    for rows in wanted:
        if fit(rows, 0) >= 0:
            return rows, 0
    raise ValueError('%s: one row\'s window of %d lanes and %d bytes of '
                     'barriers take %d bytes of shared memory; a block has '
                     '%d' % (what, lanes, WINDOW_BARRIER_BYTES,
                             WINDOW_BARRIER_BYTES + lanes * 4,
                             _build.SMEM_PER_BLOCK))


def _check_staged(val, x, offsets):
    """The staged-window kernels' checks on their operands."""
    if not val.device == x.device:
        raise ValueError('val and x must share a device (got %s, %s)'
                         % (val.device, x.device))
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError('no DIA apply for device %s' % x.device)
    if x.dtype != torch.float32 or val.dtype != torch.float32:
        raise TypeError('the staged-window DIA kernels take f32 values and '
                        'operands (got %s, %s)' % (val.dtype, x.dtype))
    if (val.dim() != 2 or x.dim() != 2 or val.shape[1] != x.shape[1]
            or len(offsets) != val.shape[0]):
        raise ValueError('shape mismatch: val %s, x %s, %d offsets'
                         % (tuple(val.shape), tuple(x.shape), len(offsets)))
    if not (val.is_contiguous() and x.is_contiguous()):
        raise ValueError('the DIA kernels take contiguous tensors')
    if len(offsets) > MAX_WINDOW_OFFSETS:
        raise ValueError('the staged-window DIA kernels take at most %d '
                         'diagonals, got %d'
                         % (MAX_WINDOW_OFFSETS, len(offsets)))


def _staged(entry, key, val, x, offsets, tile, lanes):
    """Checks, then the staged-window kernel ``entry`` with as many rows
    per block and val lanes a stage as ``lanes`` window lanes per row allow
    (``_window_plan``), or the plain version for CPU tensors."""
    _check_staged(val, x, offsets)
    m, n = x.shape
    rows, chunk = _window_plan(m, lanes, len(offsets), _bulk(val, x, tile),
                               key)
    if x.device.type == 'cpu':
        return dia_matmat_rows_plain(val, x, offsets)
    y = torch.empty_like(x)
    if m == 0 or n == 0:
        return y
    host_offsets = (ctypes.c_int * len(offsets))(*offsets)
    index = x.get_device()
    err = getattr(_build.library(), entry)(
        val.data_ptr(), x.data_ptr(), y.data_ptr(), host_offsets,
        len(offsets), m, n, tile, chunk, rows, index,
        _build.current_stream(index))
    if err != 0:
        raise RuntimeError('%s DIA kernel launch failed: CUDA error %d'
                           % (key, err))
    LAUNCHES[key] += 1
    return y


def _host_offsets(offsets, tile):
    """(offsets as a tuple of ints, tile as an int)."""
    tile = int(tile)
    if tile < 1:
        raise ValueError('tile must be at least 1 lane, got %d' % tile)
    return tuple(int(o) for o in offsets), tile


def _reach(offsets):
    """The offsets' extent to the left plus to the right, each rounded up
    to a multiple of 4 lanes, as the sliding-window kernel rounds them."""
    lo = max(0, -min(offsets, default=0))
    hi = max(0, max(offsets, default=0))
    return -(-lo // 4) * 4 + -(-hi // 4) * 4


def dia_matmat_rows_slide(val, x, offsets, tile):
    """(m, n) = DIA matrix applied to the f32 (m, n) row block ``x`` through
    one sliding shared-memory window per row, ``tile`` lanes per step.
    ``offsets``: the diagonals as host ints.  A row's window holds
    reach + 2 * tile lanes (reach = the offsets' extent to the left plus to
    the right, each rounded up to 4 lanes); if that and two stages of val
    do not fit a block's shared memory, raises ``ValueError``."""
    offsets, tile = _host_offsets(offsets, tile)
    return _staged('dia_spmm_rows_slide_f32', 'slide', val, x, offsets, tile,
                   _reach(offsets) + 2 * tile)


def _tile_ring_offsets(offsets, tile):
    offsets, tile = _host_offsets(offsets, tile)
    if max((abs(o) for o in offsets), default=0) > tile:
        raise ValueError('tile-ring kernel needs max|offset| <= tile (got '
                         '%d > %d)' % (max(abs(o) for o in offsets), tile))
    return offsets, tile


def dia_matmat_rows_tiles(val, x, offsets, tile):
    """(m, n) = DIA matrix applied to the f32 (m, n) row block ``x`` through
    a shared-memory ring of four whole tiles of ``tile`` lanes per row, with
    no halo.  ``offsets``: the diagonals as host ints, none larger than
    ``tile`` in size.  If four tiles and two stages of val do not fit a
    block's shared memory, raises ``ValueError``."""
    offsets, tile = _tile_ring_offsets(offsets, tile)
    return _staged('dia_spmm_rows_tiles_f32', 'tiles', val, x, offsets, tile,
                   4 * tile)


def window_launch_plan(variant, val, x, offsets, tile):
    """The launch ``VARIANTS[variant]`` ('slide' or 'tiles') takes for these
    operands on the card, asked of its C entry without a launch: a dict of
    ``PLAN_KEYS`` (cluster size, clusters that fit the card at once,
    clusters per segment, segments, blocks) and ``rows`` per block, val
    ``chunk`` lanes (0: val from device memory) and ``bulk`` (the
    bulk-copy branch)."""
    offsets, tile = (_tile_ring_offsets(offsets, tile) if variant == 'tiles'
                     else _host_offsets(offsets, tile))
    _check_staged(val, x, offsets)
    if x.device.type != 'cuda':
        raise ValueError('a launch plan is a card\'s, not %s' % x.device)
    lanes = 4 * tile if variant == 'tiles' else _reach(offsets) + 2 * tile
    bulk = _bulk(val, x, tile)
    rows, chunk = _window_plan(x.shape[0], lanes, len(offsets), bulk,
                               variant)
    plan = (ctypes.c_int64 * len(PLAN_KEYS))()
    err = getattr(_build.library(), 'dia_spmm_rows_%s_plan' % variant)(
        (ctypes.c_int * len(offsets))(*offsets), len(offsets), x.shape[0],
        x.shape[1], tile, chunk, rows, int(bulk), x.get_device(), plan)
    if err != 0:
        raise RuntimeError('%s launch plan failed: CUDA error %d'
                           % (variant, err))
    return dict(zip(PLAN_KEYS, plan), rows=rows, chunk=chunk, bulk=bulk)


def _ring(val, x, offsets, tile=None):
    """The production kernel in the variants' signature: it has no tile
    parameter, and takes its offsets as a tensor on x's device."""
    if not isinstance(offsets, torch.Tensor):
        offsets = torch.tensor(offsets, dtype=torch.int32, device=x.device)
    return dia_matmat_rows(val, x, offsets)


# the three structures of one function, by the names the JAX package's
# tile sweep gives them
VARIANTS = {'ring': _ring, 'slide': dia_matmat_rows_slide,
            'tiles': dia_matmat_rows_tiles}
