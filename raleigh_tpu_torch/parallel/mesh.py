"""Device mesh, shardings and sharded row blocks for the block-vector
algebra.

PyTorch port of ``raleigh_tpu/parallel/mesh.py``.  The single scaling axis
is the vector dimension ``n``: block vectors are (m, n) arrays split over
the mesh along ``n``.

The JAX package is single-controller: one process, a mesh over a list of
devices, global arrays that XLA's SPMD partitioner splits.  The port keeps
that shape.  A mesh is a grid of ``torch.device``s, one per shard, and **a
device may appear more than once**: ``make_mesh(8)`` on a machine with one
card is eight shards of that card, ``make_mesh(8, devices=['cpu'] * 8)``
the CPU twin of eight virtual devices.  One process walks the shards in
order; shards on one device run one after the other on the current stream,
shards on distinct devices exchange data with ``Tensor.copy_``.

What the partitioner did silently PyTorch has to be told: ``ShardedRows``
holds one contiguous (m, n_p) tensor per shard and carries exactly the
operations the device LOBPCG and the Chebyshev recurrence apply to a
block, and the in-place updates of a sharded ``dense_torch`` block.
Every reduction over the vector dimension (Gram matrices, row dots, row
norms) sums per-shard partial results on the first shard's device, along
the innermost mesh axis first.
"""

import bisect

import numpy as np
import torch

from ..ops.stream import copy_lanes_many

AXIS = 'shards'
HOST_AXIS = 'hosts'


def _indexed(device):
    """``device`` as a tensor on it reports it: 'cuda' is the current card,
    by number."""
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


class Mesh:
    """A grid of ``torch.device``s with named axes; ``devices`` is an object
    ndarray of the grid's shape, ``shape`` maps axis name to size."""

    def __init__(self, devices, axis_names):
        self.devices = np.empty(np.shape(devices), dtype=object)
        self.devices.ravel()[:] = [_indexed(torch.device(d))
                                   for d in np.ravel(devices)]
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError('%d axis names for a %d-D grid'
                             % (len(self.axis_names), self.devices.ndim))
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return self.devices.size

    def __repr__(self):
        return 'Mesh(%s, %s)' % (self.shape, sorted(
            {str(d) for d in self.devices.ravel()}))


def _device_list(count, devices):
    """``count`` devices: the first of ``devices``, or the card as often as
    asked for (``count`` None: every visible card once)."""
    from ..ops.spmm import storage_device
    if devices is not None:
        devices = [storage_device(d) for d in devices]
        if count is not None:
            if len(devices) < count:
                raise ValueError('%d devices asked for, %d given'
                                 % (count, len(devices)))
            devices = devices[:count]
        return devices
    card = storage_device(None)
    if count is None:
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    return [card] * count


def make_mesh(n_devices=None, devices=None):
    """A 1-D mesh of ``n_devices`` shards.  ``devices``: the devices to
    take them from, first come first (names or ``torch.device``s, repeats
    allowed).  Without it the shards live on the card: ``n_devices`` shards
    of the current CUDA device, or one per visible card when ``n_devices``
    is None.  CUDA with no card raises; the CPU is used only when named."""
    return Mesh(_device_list(n_devices, devices), (AXIS,))


def make_mesh2d(hosts, chips_per_host, devices=None):
    """A 2-D ('hosts', 'shards') mesh of the same kind of list.  The vector
    dimension splits over both axes (``blockvec_sharding`` names every
    axis), host by host; reductions sum within a host first and across
    hosts second."""
    grid = _device_list(hosts * chips_per_host, devices)
    return Mesh(np.array(grid, dtype=object).reshape(hosts, chips_per_host),
                (HOST_AXIS, AXIS))


class Sharding:
    """How one dimension of an array is split over a mesh: over the mesh
    axes ``axes`` (outermost first), or not at all (``axes = ()``).  The
    axes not named are not split over: the shards live on the devices at
    index 0 of those axes."""

    def __init__(self, mesh, axes):
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(axes)
        unknown = [a for a in axes if a not in mesh.axis_names]
        if unknown:
            raise ValueError('mesh has axes %s, not %s'
                             % (mesh.axis_names, unknown))
        self.mesh = mesh
        self.axes = tuple(a for a in mesh.axis_names if a in axes)
        index = tuple(slice(None) if a in self.axes else 0
                      for a in mesh.axis_names)
        grid = np.asarray(mesh.devices[index], dtype=object)
        self.devices = list(np.ravel(grid))
        # shard numbers by innermost-axis group, for the two-stage sums
        inner = grid.shape[-1] if grid.ndim else 1
        self.groups = [list(range(g, g + inner))
                       for g in range(0, len(self.devices), inner)]

    @property
    def nshards(self):
        return len(self.devices)

    def bounds(self, n):
        """[(start, end)] of each shard's share of ``n`` entries: equal
        chunks of ceil(n / nshards), the last ones shorter or empty."""
        chunk = -(-n // self.nshards) if n else 0
        return [(min(n, i * chunk), min(n, (i + 1) * chunk))
                for i in range(self.nshards)]

    def same_layout(self, other):
        return self.devices == other.devices and self.groups == other.groups

    def __repr__(self):
        return 'Sharding(%r, axes=%s)' % (self.mesh, self.axes)


def blockvec_sharding(mesh):
    """Sharding of (m, n) block vectors: the vector dimension split over
    every mesh axis."""
    return Sharding(mesh, mesh.axis_names)


def matrix_sharding(mesh):
    """Sharding of a dense (rows, features) data matrix: the features
    split, so that operator applications contract over the split axis."""
    return Sharding(mesh, mesh.axis_names)


def replicated(mesh):
    return Sharding(mesh, ())


def _to(t, device):
    return t if t.device == device else t.to(device)


class ShardedRows:
    """An array split along one dimension (``dim``, by default the vector
    dimension of an (m, n) row block) into one contiguous tensor per shard,
    each on its shard's device.

    Elementwise arithmetic acts shard by shard; a (m, 1) column or a small
    matrix that meets a block lives on one device and is sent to each
    shard's device where they differ.  Reductions over the split dimension
    return a small tensor on the first shard's device."""

    def __init__(self, parts, sharding, dim=1):
        self.parts = list(parts)
        self.sharding = sharding
        self.dim = dim

    # ---- construction ----------------------------------------------------
    @classmethod
    def split(cls, x, sharding, dim=1):
        """Shards of the global tensor or ndarray ``x``."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.require(x, requirements='W'))
        parts = [_to(x.narrow(dim, s, e - s), dev).contiguous()
                 for (s, e), dev in zip(sharding.bounds(x.shape[dim]),
                                        sharding.devices)]
        return cls(parts, sharding, dim)

    def gather(self):
        """The global tensor, on the first shard's device."""
        dev = self.device
        return torch.cat([_to(p, dev) for p in self.parts], dim=self.dim)

    def resplit(self, sharding):
        """The same array under another sharding."""
        if sharding is self.sharding:
            return self
        if sharding.same_layout(self.sharding):
            return ShardedRows(self.parts, sharding, self.dim)
        return ShardedRows.split(self.gather(), sharding, self.dim)

    def _like(self, parts):
        return ShardedRows(parts, self.sharding, self.dim)

    # ---- what a tensor would answer --------------------------------------
    @property
    def device(self):
        return self.sharding.devices[0]

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def shape(self):
        shape = list(self.parts[0].shape)
        shape[self.dim] = sum(p.shape[self.dim] for p in self.parts)
        return torch.Size(shape)

    @property
    def real(self):
        return self._like([p.real for p in self.parts])

    def bounds(self):
        ends = np.cumsum([p.shape[self.dim] for p in self.parts]).tolist()
        return list(zip([0] + ends[:-1], ends))

    # ---- elementwise -----------------------------------------------------
    def _map(self, fn):
        return self._like([fn(p) for p in self.parts])

    def _zip(self, other, fn):
        if isinstance(other, ShardedRows):
            return self._like([fn(p, q)
                               for p, q in zip(self.parts, other.parts)])
        if isinstance(other, torch.Tensor) and other.dim():
            return self._like([fn(p, _to(other, p.device))
                               for p in self.parts])
        return self._like([fn(p, other) for p in self.parts])

    def __add__(self, other):
        return self._zip(other, lambda p, q: p + q)

    def __sub__(self, other):
        return self._zip(other, lambda p, q: p - q)

    def __mul__(self, other):
        return self._zip(other, lambda p, q: p * q)

    def __rmul__(self, other):
        return self._zip(other, lambda p, q: q * p)

    def __truediv__(self, other):
        return self._zip(other, lambda p, q: p / q)

    def conj(self):
        return self._map(lambda p: p.conj())

    def to(self, dtype):
        if dtype == self.dtype:
            return self
        return self._map(lambda p: p.to(dtype))

    def contiguous(self):
        return self

    def zeros_like(self):
        return self._map(torch.zeros_like)

    def clone(self):
        return self._map(torch.clone)

    def is_complex(self):
        return self.parts[0].is_complex()

    # ---- in place, shard by shard (the block storage of dense_torch) -----
    def _parts_of(self, src):
        """``src`` cut as this array is: a ``ShardedRows`` under this
        sharding, or a tensor broadcast to the global shape and narrowed to
        each shard's range, each piece on its shard's device."""
        if isinstance(src, ShardedRows):
            return src.resplit(self.sharding).parts
        src = src.broadcast_to(self.shape)
        return [_to(src.narrow(self.dim, s, e - s), p.device)
                for (s, e), p in zip(self.bounds(), self.parts)]

    def copy_(self, src):
        for p, q in zip(self.parts, self._parts_of(src)):
            p.copy_(q)
        return self

    def zero_(self):
        for p in self.parts:
            p.zero_()
        return self

    def fill_(self, value):
        for p in self.parts:
            p.fill_(value)
        return self

    def _inplace(self, name, other, *args, **kw):
        """``part.name(other, ...)`` on every shard; ``other`` a scalar, a
        small tensor that broadcasts against a part (sent to the part's
        device) or a ``ShardedRows`` of this sharding."""
        if isinstance(other, ShardedRows):
            others = other.resplit(self.sharding).parts
        elif isinstance(other, torch.Tensor) and other.dim():
            others = [_to(other, p.device) for p in self.parts]
        else:
            others = [other] * len(self.parts)
        for p, q in zip(self.parts, others):
            getattr(p, name)(q, *args, **kw)
        return self

    def mul_(self, other):
        return self._inplace('mul_', other)

    def div_(self, other):
        return self._inplace('div_', other)

    def add_(self, other, alpha=1):
        return self._inplace('add_', other, alpha=alpha)

    def addcmul_(self, coef, other):
        """self += coef * other for a small ``coef`` that broadcasts."""
        for p, q in zip(self.parts, other.resplit(self.sharding).parts):
            p.addcmul_(_to(coef, p.device), q)
        return self

    def zero_rows(self, dead):
        """The block with the rows flagged in the (m,) mask set to 0."""
        return self._map(lambda p: torch.where(
            _to(dead, p.device)[:, None], 0.0, p))

    def __getitem__(self, rows):
        """Row selection (a slice, an index tensor or a mask), the same on
        every shard."""
        if isinstance(rows, torch.Tensor):
            return self._map(lambda p: p[_to(rows, p.device)])
        return self._map(lambda p: p[rows])

    @staticmethod
    def cat(blocks):
        """Blocks of one sharding stacked along the rows."""
        first = blocks[0]
        return first._like([torch.cat(ps, dim=0) for ps in
                            zip(*(b.parts for b in blocks))])

    # ---- reductions over the split dimension -----------------------------
    def _reduce(self, partials):
        """Sum of per-shard partial results on the first shard's device:
        within each innermost-axis group first, then across the groups."""
        sums = []
        for group in self.sharding.groups:
            dev = self.sharding.devices[group[0]]
            total = partials[group[0]]
            for i in group[1:]:
                total = total + _to(partials[i], dev)
            sums.append(total)
        total = sums[0]
        for s in sums[1:]:
            total = total + _to(s, total.device)
        return total

    def gram(self, other):
        """Xᴴ Y of two row blocks: (m, j) on the first shard's device."""
        return self._reduce([torch.matmul(p.conj(), q.transpose(0, 1))
                             for p, q in zip(self.parts, other.parts)])

    def row_dots(self, other):
        """Real parts of the row-wise inner products (m,)."""
        return self._reduce([(p.conj() * q).sum(1).real
                             for p, q in zip(self.parts, other.parts)])

    def row_norms(self):
        """2-norms of the rows (m,)."""
        return torch.sqrt(self._reduce(
            [torch.linalg.vector_norm(p, dim=1) ** 2 for p in self.parts]))

    def mixed(self, c):
        """c @ block for a small (j, m) matrix ``c``: the rows combined from
        the left, shard by shard."""
        return self._map(lambda p: torch.matmul(_to(c, p.device), p))


def ring_runs(widths, before, after):
    """The halo walk round the ring of shards whose lane counts are
    ``widths``: per shard, the runs that make up its lanes with the
    ``before`` lanes that precede them and the ``after`` that follow, taken
    from as many neighbouring shards as they span and wrapped around the
    ring at the global ends (None for an empty shard).  A run is
    (position in [before | own | after], lanes, shard it lies in, its first
    lane there)."""
    ends = np.cumsum(widths).tolist()
    starts = [0] + ends[:-1]
    n = ends[-1] if ends else 0
    out = []
    for start, end in zip(starts, ends):
        if end == start:
            out.append(None)
            continue
        length = before + end - start + after
        runs, pos, g = [], 0, start - before
        while pos < length:
            at = g % n
            # the last shard that starts at or before ``at`` is not empty
            j = bisect.bisect_right(starts, at) - 1
            take = min(length - pos, ends[j] - at)
            runs.append((pos, take, j, at - starts[j]))
            pos += take
            g += take
        out.append(runs)
    return out


def ring_extended(x, before, after):
    """Per shard, its own entries along ``x.dim`` with the ``before``
    entries that precede them and the ``after`` that follow
    (``ring_runs``): [before | own | after], one new tensor per shard on
    the shard's device (None for an empty shard).  Returns (tensors, number
    of runs copied).  The runs within one device move in one
    ``copy_lanes_many`` launch, runs between devices by ``Tensor.copy_``."""
    dim = x.dim
    widths = [p.shape[dim] for p in x.parts]
    out, copies, local = [], 0, {}
    for part, width, runs in zip(x.parts, widths,
                                 ring_runs(widths, before, after)):
        if runs is None:
            out.append(None)
            continue
        shape = list(part.shape)
        shape[dim] = before + width + after
        ext = torch.empty(shape, dtype=part.dtype, device=part.device)
        for pos, take, j, at in runs:
            src = x.parts[j].narrow(dim, at, take)
            dst = ext.narrow(dim, pos, take)
            if src.device == dst.device:
                local.setdefault(dst.device, []).append((dst, src))
            else:
                dst.copy_(src)
            copies += 1
        out.append(ext)
    for pairs in local.values():
        copy_lanes_many(pairs)
    return out, copies
