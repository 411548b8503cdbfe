"""The block-vector algebra contract on torch tensors.

The port's twin of ``raleigh_tpu/algebra/dense_jax.py``: one implementation
of the ``Vectors`` / ``Matrix`` duck type that ``core/solver.py`` is written
against (reference raleigh/core/solver.py:22-96), on the card unless a
``device`` names another.

Design:

  * A block of ``m`` vectors of dimension ``n`` is a ``(capacity, n)``
    tensor on an explicit device plus a host-side selection window
    ``(first, nvec)`` — the contract documented at dense_jax.py:10-14.
    Window updates are in-place operations on tensor views; the JAX
    package's functional ``dynamic_update_slice`` kernels, its shape
    buckets (``bucket``, ``capacity_for``) and its padded, blended writes
    exist to keep XLA from compiling one program per window size, and
    have nothing to do here: torch runs eagerly, every window at its own
    size.

  * The caller's data type stays: s/d/c/z blocks are f32/f64/c64/c128 on
    the card (the H100 computes f64 natively), as dense_jax keeps them
    under ``jax_enable_x64``.  f32 products run at full f32: TF32 stays off
    (``torch.backends.cuda.matmul.allow_tf32`` is False by default, and
    nothing here turns it on).  Complex Grams take the conjugate of the
    other block, as dense_jax's ``_k_gram`` does.

  * All O(m*n) work (Gram matrices, linear combinations, dense operator
    applications) is device GEMMs; the small O(m^2) results come back to
    the host as NumPy arrays, or stay on the device when the caller asks
    (``keep=True``) and hands them on to another contract op.

  * ``compensated=True`` (the JAX package's exact-product Ozaki scheme for
    d/z accuracy on f32-only hardware) is a Gram taken in f64 from f32
    data and returned in f64: the card has f64 arithmetic.

  * Host round trips.  Each transfer of device data to the host waits for
    the card; ``COUNTS['to_host']`` counts them, ``COUNTS['to_device']``
    the uploads.  ``fetch`` brings several small results back in one
    transfer.  Uploads go through pinned memory without blocking, so they
    do not wait for the card.  Nothing here calls
    ``torch.cuda.synchronize``.

  * Spans (``utils/profiling.py``).  Under a profiler each contract
    operation that issues device work is a ``raleigh.dense.<name>`` span,
    and each transfer to the host a ``raleigh.sync`` span inside it.

Randomness: ``fill_random`` draws on the host with NumPy's global generator
(uniform in [-1, 1)) and uploads — bit-identical to dense_numpy and
dense_jax after ``numpy.random.seed``.

Sharded storage (``sharding=``, a ``parallel.mesh.Sharding``: the
vector dimension split over a mesh, ``blockvec_sharding`` or
``matrix_sharding``).  The block is then a ``ShardedRows`` of one
(capacity, n_p) tensor per shard, each on its shard's device, and the
window selects the same rows of every shard.  What XLA's partitioner does
for dense_jax is written out: Gram matrices and row dots are per-shard
GEMMs and products whose partial sums ``ShardedRows._reduce`` adds on the
first shard's device, in the mesh's order (within a host first); linear
combinations, scalings, copies and fills act shard by shard; fetched and
kept small results live on the first shard's device.  A sharded
``Matrix`` splits its features (its columns): ``apply`` contracts over
them by per-shard GEMMs, the reduce, and a split into the output's shards;
the adjoint apply takes the whole operand to each shard's device.
"""

import numbers

import numpy as np
import torch

from ..ops.spmm import storage_device
from ..parallel.mesh import ShardedRows, _to
from ..utils.profiling import span, spanned
from .dense_numpy import _hadamard_like_fill

# device->host transfers and host->device uploads since the last reset
COUNTS = {'to_host': 0, 'to_device': 0}

_NUMPY = {torch.float32: np.float32, torch.float64: np.float64,
          torch.complex64: np.complex64, torch.complex128: np.complex128}
_TORCH = {np.dtype(v): k for k, v in _NUMPY.items()}
_WIDE = {torch.float32: torch.float64, torch.complex64: torch.complex128}


def reset_counts():
    for key in COUNTS:
        COUNTS[key] = 0


def _torch_dtype(dt):
    if isinstance(dt, torch.dtype):
        return dt
    try:
        return _TORCH[np.dtype(dt)]
    except KeyError:
        raise TypeError('Vectors take f32, f64, c64 or c128 data, not %s'
                        % np.dtype(dt)) from None


def _real_dtype(dt):
    return torch.empty((), dtype=dt).real.dtype


def _cj(a):
    return a.conj() if a.is_complex() else a


def _host(t):
    """A host copy of the tensor ``t`` (one transfer); a ``ShardedRows`` is
    gathered on its first shard's device first."""
    if isinstance(t, ShardedRows):
        t = t.gather()
    COUNTS['to_host'] += 1
    with span('raleigh.sync'):
        return t.detach().to('cpu', copy=True).numpy()


def _upload(a, dtype, device):
    """The host array ``a`` as a new tensor of ``dtype`` on ``device``.
    To the card it goes from pinned memory without blocking: the upload
    waits for nothing on the card."""
    t = torch.from_numpy(np.require(a, _NUMPY.get(dtype), 'CW'))
    if device.type == 'cpu':
        return t.clone()
    COUNTS['to_device'] += 1
    return t.pin_memory().to(device, non_blocking=True)


def _parts(t):
    """The per-shard tensors of a block (a tensor is one)."""
    return t.parts if isinstance(t, ShardedRows) else [t]


def _summed(t, partials):
    """The sum of the partial results of ``t``'s shards on the first
    shard's device, in the mesh's order (``ShardedRows._reduce``); a
    tensor's one partial result as it is."""
    return t._reduce(partials) if isinstance(t, ShardedRows) else partials[0]


def _as_layout(t, like):
    """``t`` (a tensor or a ``ShardedRows``) laid out as ``like``: split as
    ``like`` is, or whole on ``like``'s device."""
    if isinstance(like, ShardedRows):
        if isinstance(t, ShardedRows):
            return t.resplit(like.sharding)
        return ShardedRows.split(t, like.sharding, like.dim)
    if isinstance(t, ShardedRows):
        return _to(t.gather(), like.device)
    return t


def _laid_out(t, sharding):
    """The tensor ``t`` split by ``sharding``, or ``t`` where it is None."""
    return t if sharding is None else ShardedRows.split(t, sharding)


def _zeros(rows, n, dtype, device, sharding):
    """A zero block of ``rows`` vectors of dimension ``n``: on ``device``,
    or one part per shard of ``sharding``, each on its shard's device."""
    if sharding is None:
        return torch.zeros((rows, n), dtype=dtype,
                           device=storage_device(device))
    return ShardedRows([torch.zeros((rows, e - s), dtype=dtype, device=d)
                        for (s, e), d in zip(sharding.bounds(n),
                                             sharding.devices)], sharding)


def _upload_block(a, dtype, device, sharding):
    """The host block ``a`` on ``device``, or split by ``sharding``: each
    shard's columns uploaded to its device."""
    if sharding is None:
        return _upload(a, dtype, storage_device(device))
    return ShardedRows([_upload(a[:, s:e], dtype, d)
                        for (s, e), d in zip(sharding.bounds(a.shape[1]),
                                             sharding.devices)], sharding)


def _same_storage(a, b):
    a, b = _parts(a)[0], _parts(b)[0]
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _copy_into(dst, src):
    """dst[...] = src, reading src first where the two share storage; a
    ``ShardedRows`` source meets a tensor destination gathered."""
    if isinstance(src, ShardedRows) and not isinstance(dst, ShardedRows):
        src = src.gather()
    if _same_storage(dst, src):
        src = src.clone()
    dst.copy_(src)


@spanned('raleigh.dense.fetch')
def fetch(*arrays):
    """Several small results (tensors, host arrays or None) on the host in
    one transfer: the tensors of one device are widened to a common type,
    joined, brought back together and cut apart again (the widening is
    exact, and so is the narrowing back)."""
    out = [None] * len(arrays)
    groups = {}
    for i, a in enumerate(arrays):
        if isinstance(a, torch.Tensor):
            groups.setdefault(a.device, []).append(i)
        else:
            out[i] = np.asarray(a)
    for device, idx in groups.items():
        ts = [arrays[i].detach() for i in idx]
        common = ts[0].dtype
        for t in ts[1:]:
            common = torch.promote_types(common, t.dtype)
        flat = _host(torch.cat([t.reshape(-1).to(common) for t in ts]))
        pos = 0
        for i, t in zip(idx, ts):
            size = t.numel()
            part = flat[pos:pos + size].reshape(tuple(t.shape))
            if np.dtype(_NUMPY[t.dtype]).kind != 'c':
                part = part.real
            out[i] = part.astype(_NUMPY[t.dtype])
            pos += size
    return tuple(out)


class _Staged:
    """A host coefficient matrix for repeated ``combine`` use, uploaded
    once to each device it meets."""

    def __init__(self, a):
        self.host = np.asarray(a)
        self._on = {}

    def on(self, device):
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = _upload(
                self.host, _TORCH[self.host.dtype], device)
        return t


def stage_coeff(a, rows=None, cols=None):
    """Prepare a host coefficient matrix for repeated device-side
    ``combine()`` use: it is uploaded once, to the device of the first
    block it meets."""
    return _Staged(a)


@spanned('raleigh.dense.combine')
def combine(a, b):
    """Small-matrix product a @ b on b's device; ``a`` may be a host
    matrix, a staged one or a kept tensor.  b is cast to a's type, as in
    dense_jax."""
    if isinstance(a, _Staged):
        a = a.on(b.device)
    elif not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        a = _upload(a, _TORCH[a.dtype], b.device)
    return torch.matmul(a, b.to(a.dtype))


@spanned('raleigh.dense.rootabs')
def rootabs(a):
    if isinstance(a, torch.Tensor):
        return torch.sqrt(torch.abs(a.real if a.is_complex() else a))
    return np.sqrt(np.abs(np.asarray(a).real))


@spanned('raleigh.dense.diag_ratio')
def diag_ratio(a, b):
    """re(diag(a) / diag(b)), zero where diag(b) is exactly zero, without
    leaving the device: the core solver forms residuals with these
    device-resident Ritz values, so the Ritz-value and residual-norm round
    trips become one."""
    if not isinstance(a, torch.Tensor):
        from .dense_numpy import diag_ratio as host
        return host(a, b)
    da = torch.diagonal(a)
    db = torch.diagonal(torch.as_tensor(b, device=a.device))
    zero = db == 0
    r = da / torch.where(zero, torch.ones_like(db), db)
    r = r.real if r.is_complex() else r
    return torch.where(zero, torch.zeros_like(r), r)


@spanned('raleigh.dense.conjugation_beta')
def conjugation_beta(zay, zby, lmd_y, lmdz, sy, sz, dtype):
    """Jacobi-conjugation coefficients with the overflow guard, on the
    device when the Gram blocks were kept there (reference
    core/solver.py:1331-1347)."""
    if not isinstance(zay, torch.Tensor):
        from .dense_numpy import conjugation_beta as host
        return host(zay, zby, lmd_y, lmdz, sy, sz, dtype)
    nz, ny = zay.shape
    rdt = _real_dtype(zay.dtype)
    lmd_y = _upload(np.asarray(lmd_y)[:ny], rdt, zay.device)
    lmdz = _upload(np.asarray(lmdz)[:nz], rdt, zay.device)
    num = zay - zby * lmd_y[None, :].to(zby.dtype)
    den = lmdz[:, None] - lmd_y[None, :]
    syr = rootabs(sy)[:ny]
    szr = rootabs(sz)[:nz]
    ratio = syr[None, :] / torch.where(szr[:, None] == 0,
                                       torch.ones_like(szr[:, None]),
                                       szr[:, None])
    guard = torch.abs(num) >= 100 * ratio * torch.abs(den)
    beta = torch.where(guard, torch.zeros_like(num), num / den)
    beta = torch.where(torch.isfinite(beta), beta, torch.zeros_like(beta))
    return beta.to(_torch_dtype(dtype))


class Vectors:
    """Selectable window over a block of row-vectors, torch storage."""

    def __init__(self, arg, nvec=0, data_type=None, shallow=False,
                 sharding=None, compensated=False, device=None):
        """A block from another ``Vectors`` (a copy of its window, or a
        view of it when ``shallow``), a ``Matrix`` (the same), a tensor
        (used as storage), a ``ShardedRows`` (the same), a host array
        (uploaded) or a dimension ``n`` with ``nvec`` zero vectors of
        ``data_type`` (default f32, as in dense_jax).  Host arrays and new
        blocks go to ``device``, the card unless it names another; the
        others stay where they are.  ``sharding``: the vector dimension
        split over a mesh (a tensor or a host array is split; a block or a
        matrix keeps its own sharding, as in dense_jax).

        ``compensated=True``: f32 and c64 storage whose fetched Gram
        reductions (``dot``, ``dots``) are taken in f64 / c128 and
        returned so."""
        self._comp = bool(compensated)
        self._sharding = sharding
        if isinstance(arg, Vectors):
            f, k = arg.selected()
            self._comp = arg._comp
            self._sharding = arg._sharding
            block = arg._array[f:f + k]
            self._array = block if shallow else block.clone()
        elif isinstance(arg, Matrix):
            self._sharding = arg._sharding
            self._array = arg._data if shallow else arg._data.clone()
        elif isinstance(arg, ShardedRows):
            self._sharding = arg.sharding
            self._array = arg
        elif isinstance(arg, torch.Tensor):
            if arg.dim() != 2:
                raise ValueError('Vectors storage must be 2-D')
            self._array = _laid_out(arg.contiguous(), sharding)
        elif isinstance(arg, np.ndarray):
            a = np.ascontiguousarray(arg)
            self._array = _upload_block(a, _torch_dtype(a.dtype), device,
                                        sharding)
        elif isinstance(arg, numbers.Number):
            dt = _torch_dtype(np.float32 if data_type is None else data_type)
            self._array = _zeros(nvec, int(arg), dt, device, sharding)
        else:
            raise ValueError('cannot build Vectors from %r' % type(arg))
        self._nvec = self._array.shape[0]
        self._sel = (0, self._nvec)

    def _ensure_capacity(self, need):
        cap = self._array.shape[0]
        if cap < need:
            grown = []
            for p in _parts(self._array):
                g = p.new_zeros((need, p.shape[1]))
                g[:cap] = p
                grown.append(g)
            self._array = (ShardedRows(grown, self._array.sharding)
                           if isinstance(self._array, ShardedRows)
                           else grown[0])

    def _window(self, first, k):
        return self._array[first:first + k]

    # ---- storage / selection -------------------------------------------

    def dimension(self):
        return self._array.shape[1]

    def nvec(self):
        return self._sel[1]

    def select(self, nv, first=0):
        assert first >= 0
        self._nvec = max(self._nvec, first + nv)
        self._ensure_capacity(first + nv)
        self._sel = (first, nv)

    def select_all(self):
        self._sel = (0, self._nvec)

    def selected(self):
        return self._sel

    def data_type(self):
        return _NUMPY[self._array.dtype]

    def is_complex(self):
        return self._array.is_complex()

    @spanned('raleigh.dense.all_data')
    def all_data(self):
        return _host(self._array[:self._nvec])

    @spanned('raleigh.dense.data')
    def data(self, i=None):
        host = _host(self.device_data())
        return host if i is None else host[i]

    def device_data(self):
        """The selected rows: a tensor, or a ``ShardedRows`` of views."""
        f, k = self._sel
        return self._array[f:f + k]

    @spanned('raleigh.dense.new_vectors')
    def new_vectors(self, arg=0, dim=None):
        if isinstance(arg, (np.ndarray, torch.Tensor)):
            if isinstance(arg, np.ndarray):
                dt = _torch_dtype(arg.dtype)
                a = _upload(arg, dt, self._array.device)
            else:
                a = arg.to(self._array.device, copy=True)
            if a.dtype != self._array.dtype and (
                    a.is_complex() == self._array.is_complex()):
                a = a.to(self._array.dtype)
            return Vectors(a, compensated=self._comp,
                           sharding=self._sharding)
        if dim is None:
            dim = self.dimension()
        return Vectors(dim, arg, self.data_type(), compensated=self._comp,
                       device=self._array.device, sharding=self._sharding)

    @spanned('raleigh.dense.clone')
    def clone(self):
        return Vectors(self)

    def reference(self):
        return Vectors(self, shallow=True)

    @spanned('raleigh.dense.append')
    def append(self, other, axis=0):
        if axis == 0:
            mine = self._array[:self._nvec] if self._sel == (0, self._nvec) \
                else self.device_data()
            theirs = _as_layout(other.device_data(), mine)
            if isinstance(mine, ShardedRows):
                self._array = ShardedRows.cat(
                    [mine, theirs.to(self._array.dtype)])
            else:
                self._array = torch.cat((mine, theirs.to(
                    self._array.device, self._array.dtype)))
            self._nvec = mine.shape[0] + other.nvec()
        else:
            whole = self._array.gather() \
                if isinstance(self._array, ShardedRows) else self._array
            cap = whole.shape[0]
            ob = other._array
            if isinstance(ob, ShardedRows):
                ob = ob.gather()
            ob = ob.to(whole.device, whole.dtype)
            if ob.shape[0] >= cap:
                ob = ob[:cap]
            else:
                ob = torch.cat((ob, ob.new_zeros((cap - ob.shape[0],
                                                  ob.shape[1]))))
            self._array = _laid_out(torch.cat((whole, ob), dim=1),
                                    self._sharding)
        self._sel = (0, self._nvec)

    # ---- fills ----------------------------------------------------------

    @spanned('raleigh.dense.zero')
    def zero(self):
        self.device_data().zero_()

    @spanned('raleigh.dense.fill')
    def fill(self, value):
        w = self.device_data()
        if isinstance(value, numbers.Number):
            w.fill_(value)
            return
        if isinstance(value, ShardedRows):
            _copy_into(w, _as_layout(value, w).to(w.dtype))
            return
        if isinstance(value, torch.Tensor):
            v = value.to(w.device)
        else:
            v = _upload(np.asarray(value), w.dtype, w.device)
        k = w.shape[0]
        if v.dim() < 2 or v.shape[0] != k:
            v = v.broadcast_to(w.shape)
        _copy_into(w, v.to(w.dtype))

    @spanned('raleigh.dense.fill_random')
    def fill_random(self):
        k = self.nvec()
        rows = np.zeros((k, self.dimension()), dtype=self.data_type())
        rows[:] = 2 * np.random.rand(k, self.dimension()) - 1
        self.device_data().copy_(_upload(rows, self._array.dtype,
                                         self._array.device))

    @spanned('raleigh.dense.fill_orthogonal')
    def fill_orthogonal(self):
        k = self.nvec()
        a = np.zeros((k, self.dimension()), dtype=self.data_type())
        _hadamard_like_fill(a)
        self.device_data().copy_(_upload(a, self._array.dtype,
                                         self._array.device))

    # ---- contract ops ---------------------------------------------------

    def _coef(self, s, k):
        """Per-vector coefficients as a (k, 1) tensor on the device (the
        first shard's), in the real type of the storage unless they are
        complex."""
        if isinstance(s, torch.Tensor):
            c = s.reshape(-1)[:k]
            dt = self._array.dtype if c.is_complex() \
                else _real_dtype(self._array.dtype)
            return c.to(self._array.device, dt).reshape(k, 1)
        sv = np.asarray(s).reshape(-1)[:k]
        dt = self._array.dtype if np.iscomplexobj(sv) \
            else _real_dtype(self._array.dtype)
        return _upload(sv, dt, self._array.device).reshape(k, 1)

    def _matrix(self, q):
        """A coefficient matrix (host array or kept tensor) as a tensor of
        the storage type on the device (the first shard's)."""
        if isinstance(q, torch.Tensor):
            return q.to(self._array.device, self._array.dtype)
        return _upload(np.asarray(q), self._array.dtype, self._array.device)

    @spanned('raleigh.dense.copy')
    def copy(self, other, ind=None):
        if ind is None:
            assert self.nvec() == other.nvec()
            k = self.nvec()
            other._ensure_capacity(other._sel[0] + k)
            dst = other._window(other._sel[0], k)
            _copy_into(dst, _as_layout(self.device_data(), dst).to(
                other._array.dtype))
        else:
            ind = np.asarray(ind, dtype=np.int64).reshape(-1)
            k = len(ind)
            other._ensure_capacity(other._sel[0] + k)
            idx = _upload(ind, torch.int64, self._array.device)
            rows = self._array[idx] \
                if isinstance(self._array, ShardedRows) \
                else self._array.index_select(0, idx)
            dst = other._window(other._sel[0], k)
            dst.copy_(_as_layout(rows, dst))

    @spanned('raleigh.dense.scale')
    def scale(self, s, multiply=False):
        w = self.device_data()
        c = self._coef(s, w.shape[0])
        if multiply:
            w.mul_(c)
        else:
            w.div_(torch.where(c == 0, torch.ones_like(c), c))

    def _comp_active(self, other, keep):
        """Compensated reductions apply to fetched results of f32/c64
        storage: device-kept consumers stay on the plain path, and f64
        storage needs no help."""
        return ((self._comp or getattr(other, '_comp', False))
                and not keep
                and self._array.dtype in _WIDE)

    def _pair(self, other, k, keep):
        a = self.device_data()
        b = _as_layout(other._window(other._sel[0], k), a)
        if self._comp_active(other, keep):
            a = a.to(_WIDE[a.dtype])
            b = b.to(_WIDE[b.dtype])
        return a, b

    @spanned('raleigh.dense.dots')
    def dots(self, other, transp=False, keep=False):
        k = self.nvec()
        a, b = self._pair(other, k, keep)
        # a product and a sum: the einsum of dense_jax becomes a batched
        # matrix-vector product in torch, which cuBLAS runs at a twentieth
        # of the card's memory rate on these long rows
        partials = [(_cj(q) * p).sum(dim=0 if transp else 1)
                    for p, q in zip(_parts(a), _parts(b))]
        if not transp:
            r = _summed(a, partials)
        elif len(partials) == 1:
            r = partials[0]
        else:
            # one sum per lane: the shards' lanes side by side
            r = torch.cat([_to(p, a.device) for p in partials])
        return r if keep else _host(r)

    @spanned('raleigh.dense.dot')
    def dot(self, other, keep=False):
        a, b = self._pair(other, other.nvec(), keep)
        r = _summed(a, [torch.matmul(_cj(q), p.T)
                        for p, q in zip(_parts(a), _parts(b))])
        return r if keep else _host(r)

    @spanned('raleigh.dense.multiply')
    def multiply(self, q, output):
        assert output.nvec() == q.shape[1]
        qt = self._matrix(q)
        f, k = output.selected()
        output._ensure_capacity(f + k)
        dst = output._window(f, k)
        src = _as_layout(self.device_data(), dst)
        for d, s in zip(_parts(dst), _parts(src)):
            qs = _to(qt, s.device)
            if _same_storage(d, s) or d.dtype != s.dtype:
                d.copy_(torch.matmul(qs.T, s))
            else:
                torch.matmul(qs.T, s, out=d)

    @spanned('raleigh.dense.add')
    def add(self, other, s, q=None):
        w = self.device_data()
        o = _as_layout(other.device_data(), w)
        if _same_storage(w, o):
            o = o.clone()
        if np.isscalar(s):
            if np.iscomplexobj(s) and not w.is_complex():
                s = s.real
            if q is None:
                w.add_(o.to(w.dtype), alpha=s)
            else:
                qm = self._matrix(q)
                for wp, op in zip(_parts(w), _parts(o)):
                    wp.add_(torch.matmul(_to(qm, op.device).T,
                                         op.to(wp.dtype)), alpha=s)
        else:
            w.addcmul_(self._coef(s, w.shape[0]), o.to(w.dtype))

    # ---- backend extras -------------------------------------------------

    @spanned('raleigh.dense.orthogonalize')
    def orthogonalize(self, other):
        ws = self.device_data()
        wo = _as_layout(other.device_data(), ws).to(ws.dtype)
        q = _summed(ws, [torch.matmul(_cj(po), ps.T)
                         for ps, po in zip(_parts(ws), _parts(wo))])
        for ps, po in zip(_parts(ws), _parts(wo)):
            ps.sub_(torch.matmul(_to(q, po.device).T, po))
        return self.new_vectors(_host(q))

    @spanned('raleigh.dense.svd')
    def svd(self):
        """Economy SVD of the selected block: storage rows become the right
        singular vectors V^H, returns (sigma, conj(U)).  Gram matrix on the
        device, small host eigh and a device rotation, refined by one
        Cholesky-QR pass — dense_jax's scheme (the reference's own
        tall-skinny ``_finalize_svd``, raleigh/interfaces/partial_svd.py:
        162-235)."""
        f, k = self._sel
        if k > self.dimension():
            raise ValueError(
                'cannot orthonormalize %d vectors in a %d-dimensional '
                'space; truncate the block first' % (k, self.dimension()))
        dt = self.data_type()
        g = np.conj(self.dot(self))                     # X X^H
        g = 0.5 * (g + g.conj().T)
        lmd, u = np.linalg.eigh(g)                      # ascending
        lmd, u = lmd[::-1].copy(), u[:, ::-1].copy()    # G = U S^2 U^H
        sigma = np.sqrt(np.maximum(lmd, 0.0))
        floor = max(np.sqrt(np.finfo(sigma.dtype).tiny),
                    np.finfo(sigma.dtype).eps * max(sigma[0], 1.0))
        inv = 1.0 / np.maximum(sigma, floor)
        # V^H = S^-1 U^H X:  rows := q^T rows with q = conj(U S^-1)
        self.multiply(np.conj(u * inv[None, :]), self)
        # Cholesky-QR refinement restores the orthonormality lost to the
        # squared conditioning of the Gram route
        g2 = np.conj(self.dot(self))
        g2 = 0.5 * (g2 + g2.conj().T)
        try:
            c = np.linalg.cholesky(g2).conj().T         # g2 = C^H C
            ci = np.linalg.inv(c)
            self.multiply(np.conj(ci), self)            # rows := C^-H rows
            t = (u * sigma[None, :]) @ c.conj().T
            p, sigma, qh = np.linalg.svd(t)
            # rows := qh rows, and multiply applies q^T without conjugation
            self.multiply(qh.T, self)
            u = p
        except np.linalg.LinAlgError:
            pass
        real = np.zeros((), dt).real.dtype
        u = u.astype(dt)
        return sigma.astype(real), (u.conj() if np.iscomplexobj(u) else u)

    @spanned('raleigh.dense.apply')
    def apply(self, A, output, transp=False):
        A.apply(self, output, transp=transp)


class Matrix:
    """Dense operator on a 2-D tensor: ``apply`` is y = x @ A^T, its
    adjoint y = x @ conj(A) — ``torch.matmul``, which the JAX package also
    leaves to XLA.  With ``sharding`` its features (columns) are split over
    a mesh, one part per shard."""

    def __init__(self, arg, sharding=None, device=None):
        """From a ``Vectors`` (a view of its window, with its sharding), a
        ``ShardedRows`` (used as it is), a tensor (used as it is, or split
        by ``sharding``) or a host array (uploaded to ``device``, the card
        unless it names another, or split by ``sharding`` and each part
        uploaded to its shard's device)."""
        self._sharding = sharding
        if isinstance(arg, Vectors):
            self._data = arg.device_data()
            self._sharding = arg._sharding
        elif isinstance(arg, ShardedRows):
            self._data = arg
            self._sharding = arg.sharding
        elif isinstance(arg, torch.Tensor):
            self._data = _laid_out(arg, sharding)
        elif isinstance(arg, np.ndarray):
            a = np.ascontiguousarray(arg)
            self._data = _upload_block(a, _torch_dtype(a.dtype), device,
                                       sharding)
        else:
            raise ValueError('cannot build Matrix from %r' % type(arg))

    @spanned('raleigh.dense.data')
    def data(self):
        return _host(self._data)

    def device_array(self):
        return self._data

    def shape(self):
        return tuple(self._data.shape)

    def data_type(self):
        return _NUMPY[self._data.dtype]

    def is_complex(self):
        return self._data.is_complex()

    def order(self):
        return 'C_CONTIGUOUS'

    @spanned('raleigh.dense.apply')
    def apply(self, x, y, transp=False):
        kx = x.nvec()
        assert y.nvec() == kx
        f = y.selected()[0]
        y._ensure_capacity(f + kx)
        wx = x.device_data()
        dt = torch.promote_types(wx.dtype, self._data.dtype)
        if not isinstance(self._data, ShardedRows):
            wx = _as_layout(wx, self._data)
            a = self._data.to(dt)
            if transp:
                w = torch.matmul(wx.to(dt), _cj(a))
            else:
                w = torch.matmul(wx.to(dt), a.T)
        elif transp:
            # y = x conj(A): the whole operand on every shard's device, the
            # result split as the features are
            whole = _as_layout(wx, self._data.parts[0]).to(dt)
            w = ShardedRows([torch.matmul(_to(whole, p.device),
                                          _cj(p.to(dt)))
                             for p in self._data.parts], self._data.sharding)
        else:
            # y = x A^T contracts over the split features: per-shard GEMMs
            # and the reduce; the copy below splits it into y's shards
            xs = _as_layout(wx, self._data)
            w = self._data._reduce([torch.matmul(q.to(dt), p.to(dt).T)
                                    for p, q in zip(self._data.parts,
                                                    xs.parts)])
        _copy_into(y._window(f, kx), w)

    @spanned('raleigh.dense.dots')
    def dots(self):
        v = Vectors(self, shallow=True)
        return v.dots(v)

    def new_vectors(self, dim=None, nv=0):
        if dim is None:
            dim = self._data.shape[1]
        return Vectors(dim, nv, self.data_type(), device=self._data.device,
                       sharding=self._sharding)
