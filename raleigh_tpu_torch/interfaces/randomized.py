"""Device-resident randomized/subspace PCA and SVD engines.

PyTorch port of ``raleigh_tpu/interfaces/randomized.py``.  The block
Jacobi-CG engine (interfaces/partial_svd.py) is the high-accuracy path with
per-singular-triplet convergence control; this module is the opposite
trade: the implicit Gram operator, subspace iteration with Householder QR
re-orthonormalization and Rayleigh-Ritz all stay on the device, and only
the result (or, in tolerance mode, one error profile per subspace size)
comes back.  Its accuracy target is the truncation error of the
approximation (near-optimal with modest oversampling and a few power
iterations), not per-vector tolerances.

The JAX package compiles each engine into one program; here the same steps
run eagerly as torch calls: ``torch.matmul`` for the products (full f32:
TF32 stays off), ``torch.linalg.qr``, ``eigh`` and ``svd``.  f64 data
computes and returns f64; any other type computes in f32.

Randomness: the public engines draw their starting blocks from a
``torch.Generator`` seeded with ``seed`` on the data's device.  They cannot
reproduce ``jax.random``'s bits, so the private helpers take the starting
block itself, and a caller holding both packages to one start passes it
there.

Entry points run on the card unless ``device`` names another device (or
the data is already a tensor on one); with no card they raise.

Feature-split data.  ``subspace_pca`` also takes the data matrix as a
``parallel.mesh.ShardedRows`` split along its features (columns) by
``matrix_sharding(mesh)``, where the JAX caller passes an array sharded
the same way and GSPMD partitions the products.  The centred Gram is then
per-shard GEMMs whose partial sums ``ShardedRows._reduce`` adds on the
first shard's device; the subspace iteration runs there; the mean and the
right factors (``comps``) stay split, shard by shard, until they are
fetched (``fetch=False`` returns them as ``ShardedRows``).

Spans and counts (``utils/profiling.py``).  Under a profiler each public
engine call is a ``raleigh.subspace`` span, and inside it
``raleigh.subspace.gram`` (the centred Gram), ``raleigh.subspace.iterate``
(each product and QR of the subspace iteration), ``raleigh.subspace.rr``
(the last product, ``eigh`` and the rotation) and
``raleigh.subspace.factors`` (the right factors); each fetch to the host
or wait for the card is a ``raleigh.sync`` span.  ``COUNTS`` counts always:
engine calls (a streaming call counts its stages too), matrix products,
QR factorizations, ``eigh`` calls, the bytes ``_host`` fetches and, of
those, the bytes fetched through pinned memory; ``reset_counts`` sets them
back to 0.

Host results.  The engines that return host arrays copy them from the
card into pinned host memory from PyTorch's caching host allocator, every
copy queued before one wait; each array is a NumPy view of its own pinned
block, which lives as long as the array.  A dropped array's block is kept
for a later fetch of the same size, so a caller that drops its previous
result pins no new pages.  Data on the CPU comes back as ``.cpu().numpy()``.
"""

import functools

import numpy as np
import torch

from ..ops.spmm import storage_device
from ..parallel.mesh import ShardedRows, _to
from ..utils.profiling import span, spanned

# engine calls, matrix products, QRs, eigh calls, bytes fetched to the
# host and, of those, bytes fetched through pinned memory since the last
# reset
COUNTS = {'calls': 0, 'products': 0, 'qr': 0, 'eigh': 0,
          'to_host_bytes': 0, 'pinned_bytes': 0}


def reset_counts():
    for key in COUNTS:
        COUNTS[key] = 0


def _engine(fn):
    """A public engine: each call counted and, under a profiler, the span
    ``raleigh.subspace``."""
    inner = spanned('raleigh.subspace')(fn)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        COUNTS['calls'] += 1
        return inner(*args, **kwargs)
    return call


def _mm(x, y):
    COUNTS['products'] += 1
    return torch.matmul(x, y)


def _qr(x):
    COUNTS['qr'] += 1
    return torch.linalg.qr(x)[0]


def _eigh(x):
    COUNTS['eigh'] += 1
    return torch.linalg.eigh(x)


def _data(a, device):
    """``a`` as a 2-D f32/f64 tensor: a tensor stays on its device, a host
    array goes to ``device`` (the card unless it names another); a
    feature-split ``ShardedRows`` stays split."""
    if isinstance(a, ShardedRows):
        return a if a.dtype == torch.float64 else a.to(torch.float32)
    if isinstance(a, torch.Tensor):
        t = a
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
        t = t.to(storage_device(device))
    if t.dtype != torch.float64:
        t = t.to(torch.float32)
    return t


def _normal(shape, like, seed):
    """A standard normal block of ``like``'s dtype and device, drawn from a
    generator seeded with ``seed``."""
    gen = torch.Generator(like.device).manual_seed(int(seed))
    return torch.randn(shape, generator=gen, dtype=like.dtype,
                       device=like.device)


def _parts(t):
    return t.parts if isinstance(t, ShardedRows) else [t]


def _wait(ts):
    """Wait for the CUDA devices that hold ``ts`` (each shard's device
    for a ``ShardedRows``)."""
    for dev in {p.device for t in ts for p in _parts(t) if p.is_cuda}:
        torch.cuda.synchronize(dev)


def _finished(*ts):
    """Wait for the devices to finish ``ts`` (the JAX engines'
    ``block_until_ready``)."""
    with span('raleigh.sync'):
        _wait(ts)
    return ts


def _host(*ts):
    """``ts`` as NumPy arrays, a ``ShardedRows`` gathered first.  A CUDA
    tensor is copied into a pinned block of PyTorch's caching host
    allocator, all copies queued before one wait; a CPU tensor is
    ``.cpu().numpy()``."""
    with span('raleigh.sync'):
        ts = [t.gather() if isinstance(t, ShardedRows) else t for t in ts]
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                .copy_(t, non_blocking=True) if t.is_cuda else t.cpu()
                for t in ts]
        _wait(ts)
        out = tuple(h.numpy() for h in host)
    COUNTS['to_host_bytes'] += sum(x.nbytes for x in out)
    COUNTS['pinned_bytes'] += sum(x.nbytes for x, t in zip(out, ts)
                                  if t.is_cuda)
    return out


def _gram_about(a, mean):
    """G = As As^T for As = A - e mean (any row vector ``mean``), without
    materializing As: A A^T - r e^T - e r^T + |mean|^2 with r = A mean."""
    r = _mm(a, mean)
    mu2 = torch.dot(mean, mean)
    g = _mm(a, a.T)
    return g.sub_(r[:, None]).sub_(r[None, :]).add_(mu2)


@spanned('raleigh.subspace.factors')
def _right_factors(a, mean, u, sigma):
    """(trans, comps) of the centered data from its left factor u:
    comps = (As^T u / sigma)^T, again without As.  Feature-split data give
    split comps, each shard's columns from its own."""
    if isinstance(a, ShardedRows):
        su = torch.sum(u, dim=0)
        parts = []
        for p, mu in zip(a.parts, mean.parts):
            ud = _to(u, p.device)
            atu = _mm(p.T, ud) - mu[:, None] * _to(su, p.device)
            parts.append(_scaled_factors(atu, ud, _to(sigma, p.device))[1])
        return u * sigma[None, :], ShardedRows(parts, a.sharding, dim=1)
    atu = _mm(a.T, u)
    atu = atu - mean[:, None] * torch.sum(u, dim=0)[None, :]
    return _scaled_factors(atu, u, sigma)


def _scaled_factors(asu, u, sigma):
    tiny = torch.finfo(u.dtype).tiny ** 0.5
    inv = 1.0 / torch.clamp(sigma, min=tiny)
    return u * sigma[None, :], (asu * inv[None, :]).T.contiguous()


def _subspace_pca_gram(a, q, npc, iters):
    """PCA via subspace iteration on the implicit centered Gram matrix
    G = As As^T (As = A - e mean), from the (m, l) starting block ``q``.

    Returns (mean (n,), trans (m, npc), comps (npc, n), sigma (npc,))."""
    G, mean = _centered_gram(a)
    lmd, u = _gram_subspace(G, q, iters)
    return (mean,) + _finalize_from_gram(a, mean, u, lmd, npc)


@_engine
def subspace_pca(a, npc, oversample=64, iters=6, seed=1, fetch=True,
                 device=None):
    """One-call PCA: returns (mean (1, n), trans (m, npc), comps (npc, n))
    like interfaces.pca.pca.

    With ``fetch=False`` the factors are returned as tensors on the
    device, the computation finished, for on-device consumers — no host
    transfer.

    ``a`` may be a ``ShardedRows`` split along the features by
    ``parallel.mesh.matrix_sharding(mesh)``: the Gram is then per-shard
    GEMMs and a reduce, and with ``fetch=False`` mean and comps come back
    split (``ShardedRows``), trans whole on the first shard's device."""
    a = _data(a, device)
    m = a.shape[0]
    l = min(int(npc) + int(oversample), m)
    q = _normal((m, l), a, seed)
    mean, trans, comps, _ = _subspace_pca_gram(a, q, int(npc), int(iters))
    return _deliver(mean, trans, comps, fetch)


def _deliver(mean, trans, comps, fetch):
    if isinstance(mean, ShardedRows):
        mean = ShardedRows([p.reshape(1, -1) for p in mean.parts],
                           mean.sharding, dim=1)
    else:
        mean = mean.reshape(1, -1)
    if not fetch:
        return _finished(mean, trans, comps)
    return _host(mean, trans, comps)


@spanned('raleigh.subspace.gram')
def _centered_gram(a):
    """G = As As^T for As = A - e mean, and the mean, without
    materializing As.  For feature-split data each shard's products are
    summed by ``ShardedRows._reduce`` (the mesh's order) on the first
    shard's device, and the mean stays split."""
    if not isinstance(a, ShardedRows):
        mean = torch.mean(a, dim=0)
        return _gram_about(a, mean), mean
    means = [torch.mean(p, dim=0) for p in a.parts]
    r = a._reduce([_mm(p, mu) for p, mu in zip(a.parts, means)])
    mu2 = a._reduce([torch.dot(mu, mu) for mu in means])
    g = a._reduce([_mm(p, p.T) for p in a.parts])
    g = g.sub_(r[:, None]).sub_(r[None, :]).add_(mu2)
    return g, ShardedRows(means, a.sharding, dim=0)


def _gram_subspace(G, q, iters):
    """Subspace iteration with QR re-orthonormalization on the (PSD) Gram
    matrix from the (m, l) starting block ``q``; returns descending
    (lmd (l,), U (m, l))."""
    for _ in range(int(iters) + 1):
        with span('raleigh.subspace.iterate'):
            q = _qr(_mm(G, q))
    with span('raleigh.subspace.rr'):
        s = _mm(q.T, _mm(G, q))
        s = 0.5 * (s + s.T)
        lmd, w = _eigh(s)                            # ascending
        u = _mm(q, w.flip(1))
    return torch.clamp(lmd.flip(0), min=0.0), u


def _row_error_profile(gdiag, u, sigma):
    """max-row truncation error after keeping k components, for every k:
    err_m(k) = max_i sqrt(diag_i - sum_{j<k} (u_ij sigma_j)^2), k = 0..l."""
    e2 = (u * sigma[None, :]) ** 2
    cum = torch.cumsum(e2, dim=1)
    resid = torch.clamp(gdiag[:, None] - cum, min=0.0)
    full = torch.sqrt(torch.max(torch.clamp(gdiag, min=0.0)))
    prof = torch.sqrt(torch.max(resid, dim=0).values)
    return torch.cat((full[None], prof))


def _rank_for_tol(G, lmd, u, tol, norm):
    """(smallest k meeting the tolerance or None, full error profile
    prof (l+1,) with prof[k] = relative error after keeping k
    components).  Error conventions follow the reference stopping
    criteria (truncated_svd.py:244-257): relative Frobenius ('f'),
    relative max row norm ('m'), relative singular value ('s')."""
    sigma2 = lmd.cpu().numpy()
    if norm == 'f':
        total = max(float(torch.trace(G)), 1e-30)
        resid = np.maximum(total - np.cumsum(sigma2), 0.0)
        prof = np.sqrt(np.concatenate(([total], resid)) / total)
    elif norm == 'm':
        prof = _row_error_profile(torch.diagonal(G), u,
                                  torch.sqrt(torch.clamp(lmd, min=0.0)))
        prof = prof.cpu().numpy()
        prof = prof / max(prof[0], 1e-30)
    else:
        s = np.sqrt(np.maximum(sigma2, 0.0))
        prof = np.concatenate(([1.0], s / max(s[0], 1e-30)))
    ok = np.nonzero(prof <= tol)[0]
    return (int(ok[0]) if ok.size else None), prof


def _next_subspace_size(prof, tol, l, cap, trusted=None):
    """Predict the next subspace size when the rank-l profile did not
    meet ``tol``: extrapolate log(prof) linearly in log(k) over the last
    octave of the TRUSTED profile range and solve for prof(k) = tol.
    Jumping near the predicted rank beats blind doubling; the loop
    re-checks, so an undershoot costs at most one more round.  A flat
    trusted tail (noise floor / slow spectrum: no meaningful decay) jumps
    straight to the cap — no sequence of doublings can help there.

    ``trusted`` bounds the fit to the converged leading part of the
    subspace (the unconverged tail flattens the profile artificially and
    would otherwise fake a noise floor).  tol <= 0 is unreachable by
    definition: go straight to the cap."""
    if not (tol > 0):
        return cap
    k1 = min(int(trusted), l) if trusted else l
    k1 = max(k1, 2)
    k0 = max(1, k1 // 2)
    with np.errstate(divide='ignore'):
        y0 = np.log(max(float(prof[k0]), 1e-300))
        y1 = np.log(max(float(prof[k1]), 1e-300))
    slope = (y1 - y0) / np.log(k1 / k0) if k1 > k0 else 0.0
    if not np.isfinite(slope) or slope >= -1e-3:
        return cap                          # flat: tol is out of reach
    # prof(k) ~ prof(k1) * (k/k1)^slope => k = k1 * (tol/prof(k1))^(1/slope)
    k_pred = k1 * np.exp((np.log(tol) - y1) / slope)
    if not np.isfinite(k_pred):
        return cap
    # 25% margin so the convergence-trust cut (l - l//8) still covers
    # the predicted rank; never shrink the step below 1.5x (progress
    # guarantee), never exceed the cap
    target = int(np.ceil(min(1.25 * k_pred + 16, float(cap))))
    return _bucket(int(min(max(target, (3 * l) // 2), cap)), cap)


def _bucket(l, cap, q=128):
    """Round a subspace size up to a multiple of ``q`` (clamped at the
    cap).  The JAX package buckets to reuse compiled programs; the port
    keeps the rounding because it changes results, not only shapes: a
    larger subspace can meet the tolerance at another rank, and both
    packages must pick the same one."""
    return int(min(-(-l // q) * q, cap))


def _finalize_from_gram(a, mean, u, lmd, npc):
    """Recover (trans, comps, sigma) for the leading npc components of
    the centered data from the Gram eigenpairs."""
    u = u[:, :npc]
    sigma = torch.sqrt(torch.clamp(lmd[:npc], min=0.0))
    trans, comps = _right_factors(a, mean, u, sigma)
    return trans, comps, sigma


def _tol_rank(G, tol, norm, l, cap, iters, seed, verb, what, trusted):
    """The growth loop of the tolerance modes: iterate subspaces of size l
    (from a start drawn with ``seed``) until the error profile meets
    ``tol`` within the trusted leading part or l reaches the cap.
    Returns (k, lmd, u)."""
    m = G.shape[0]
    while True:
        lmd, u = _gram_subspace(G, _normal((m, l), G, seed), iters)
        # only the leading part of the subspace is trusted as converged
        margin = l - max(8, l // 8) if l < m else l
        k, prof = _rank_for_tol(G, lmd, u, tol, norm)
        if verb > 0:
            print('subspace %sl=%d -> needed k=%s' % (what, l, k))
        if k is not None and (k <= margin or l >= cap):
            return k, lmd, u
        if l >= cap:
            return min(cap, l), lmd, u
        l = _next_subspace_size(prof, tol, l, cap,
                                trusted=margin if trusted else None)


def _cap(m, max_npc):
    return m if max_npc is None or max_npc < 1 else min(2 * max_npc, m)


def _clamp_rank(k, max_npc):
    if max_npc and max_npc > 0:
        k = min(k, max_npc)
    return max(k, 1)


@_engine
def subspace_pca_tol(a, tol, norm='f', max_npc=-1, iters=6, seed=1,
                     fetch=True, verb=0, device=None):
    """Tolerance-driven device PCA: grow the iterated subspace until the
    truncation error (in the requested norm, reference conventions)
    meets ``tol``, then cut to the smallest satisfying rank.

    The unconverged tail of the computed spectrum underestimates the
    captured energy, so the error profile used for the decision is an
    overestimate — growth stops late, never early."""
    a = _data(a, device)
    m = a.shape[0]
    G, mean = _centered_gram(a)
    k, lmd, u = _tol_rank(G, tol, norm, min(128, m), _cap(m, max_npc),
                          iters, seed, verb, '', False)
    k = _clamp_rank(k, max_npc)
    trans, comps, _ = _finalize_from_gram(a, mean, u, lmd, k)
    return _deliver(mean, trans, comps, fetch)


@spanned('raleigh.subspace.gram')
def _update_gram(mean0, trans0, comps0, a1):
    """Gram matrix of the pooled centered stack [A0; A1] where
    A0 ~= e mean0 + L0 R0 is known only through its factors (R0 rows
    orthonormal).  Returns (G (m, m), pooled mean, d = mean0 - mean)."""
    m0 = trans0.shape[0]
    m1 = a1.shape[0]
    mtot = m0 + m1
    mean1 = torch.mean(a1, dim=0)
    mean = (m0 / mtot) * mean0 + (m1 / mtot) * mean1
    d = mean0 - mean

    L0 = trans0
    rd = _mm(comps0, d)                                  # (k0,)
    dd = torch.dot(d, d)
    g00 = _mm(L0, L0.T)
    t0 = _mm(L0, rd)                                     # (m0,)
    g00 = g00 + t0[:, None] + t0[None, :] + dd

    w = _mm(comps0, a1.T)                                # (k0, m1)
    rmu = _mm(comps0, mean)                              # (k0,)
    a1d = _mm(a1, d)                                     # (m1,)
    dmu = torch.dot(d, mean)
    g01 = _mm(L0, w) - _mm(L0, rmu)[:, None] \
        + a1d[None, :] - dmu

    g11 = _gram_about(a1, mean)
    G = torch.cat((torch.cat((g00, g01), dim=1),
                   torch.cat((g01.T, g11), dim=1)), dim=0)
    return G, mean, d


@spanned('raleigh.subspace.factors')
def _finalize_update(trans0, comps0, a1, mean, d, u, lmd, npc):
    """comps for the pooled stack: As^T U assembled from the old factors
    and the new rows, never materializing A0."""
    m0 = trans0.shape[0]
    u = u[:, :npc]
    sigma = torch.sqrt(torch.clamp(lmd[:npc], min=0.0))
    u0, u1 = u[:m0], u[m0:]
    ltu = _mm(trans0.T, u0)                              # (k0, npc)
    asu = _mm(comps0.T, ltu)                             # (n, npc)
    asu = asu + d[:, None] * torch.sum(u0, dim=0)[None, :]
    asu = asu + _mm(a1.T, u1)
    asu = asu - mean[:, None] * torch.sum(u1, dim=0)[None, :]
    trans, comps = _scaled_factors(asu, u, sigma)
    return trans, comps, sigma


@_engine
def subspace_pca_update(have, a1, npc=-1, tol=0, norm='f', max_npc=-1,
                        iters=6, seed=1, verb=0, device=None):
    """Device warm-start update: fold the new rows ``a1`` into a previous
    (mean, trans, comps) PCA so the result approximates the stacked
    dataset — the reference ``pca(have=...)`` capability
    (reference lra.py:158-379) on the subspace engine.  The old data
    participates only through its factors (the Gram blocks and the
    right-factor recovery are assembled from L0, R0 and the mean change),
    so the cost scales with the new rows plus the old rank.

    Tolerance-driven updates select the rank against tol/2: the old
    factors already carry a truncation error up to tol of their own
    data, and the two error components add roughly in quadrature, so
    halving the per-stage target keeps the stacked result within tol.

    Returns host arrays (mean (1, n), trans, comps)."""
    mean0, trans0, comps0 = have
    a1 = _data(a1, device)

    def like(t):
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.array(t))
        return t.to(a1.device, a1.dtype)
    mean0, trans0, comps0 = like(mean0).reshape(-1), like(trans0), \
        like(comps0)
    G, mean, d = _update_gram(mean0, trans0, comps0, a1)
    m = G.shape[0]
    if npc and npc > 0:
        l = min(npc + max(16, npc // 8), m)
        lmd, u = _gram_subspace(G, _normal((m, l), G, seed), iters)
        k = npc
    else:
        cap = _cap(m, max_npc)
        l = _bucket(min(max(128, 2 * comps0.shape[0]), cap), cap)
        k, lmd, u = _tol_rank(G, 0.5 * tol, norm, l, cap, iters, seed,
                              verb, 'update ', True)
        k = _clamp_rank(k, max_npc)
    trans, comps, _ = _finalize_update(trans0, comps0, a1, mean, d, u,
                                       lmd, int(k))
    return _host(mean.reshape(1, -1), trans, comps)


@_engine
def subspace_pca_stream(a, batch_size, npc=-1, tol=0, norm='f',
                        max_npc=-1, iters=6, seed=1, verb=0, device=None):
    """Streaming device PCA: compute on the first batch of rows, then
    fold in each subsequent batch with the device update — the reference
    ``pca(batch_size=...)`` capability on the subspace engine."""
    total = a.shape[0]
    step = min(batch_size, total)
    if npc and npc > 0:
        first = subspace_pca(a[:step], npc, iters=iters, seed=seed,
                             device=device)
    else:
        # every stage targets tol/2 (see subspace_pca_update): stage
        # errors compose roughly in quadrature across the stream
        first = subspace_pca_tol(a[:step], 0.5 * tol, norm=norm,
                                 max_npc=max_npc, iters=iters, seed=seed,
                                 verb=verb, device=device)
    mean, trans, comps = first
    for lo in range(step, total, step):
        hi = min(total, lo + step)
        mean, trans, comps = subspace_pca_update(
            (mean, trans, comps), a[lo:hi], npc=npc, tol=tol, norm=norm,
            max_npc=max_npc, iters=iters, seed=seed, verb=verb,
            device=device)
    return mean, trans, comps


@_engine
def randomized_svd(a, k, oversample=16, iters=4, seed=1, device=None):
    """Randomized truncated SVD (Halko-Martinsson-Tropp style): returns
    host arrays (u, sigma, vt)."""
    a = _data(a, device)
    m, n = a.shape
    l = min(int(k) + int(oversample), min(m, n))
    return _host(*_rand_svd(a, _normal((n, l), a, seed), int(k),
                            int(iters)))


def _rand_svd(a, q, k, iters):
    """Range finder from the (n, l) starting block ``q``, ``iters`` power
    iterations with QR in between, then the SVD of the projected block."""
    q = _mm(a, q)
    for _ in range(int(iters)):
        with span('raleigh.subspace.iterate'):
            q = _mm(a, _mm(a.T, _qr(q)))
    q = _qr(q)
    b = _mm(q.T, a)                                      # (l, n)
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = _mm(q, ub)
    return u[:, :k], s[:k], vt[:k]
