"""Device-resident preconditioned block eigensolver (LOBPCG).

PyTorch port of ``raleigh_tpu/core/device_solver.py``.  The whole
iteration — SpMM, polynomial preconditioning, constraint
orthogonalization, Gram matrices, the Rayleigh–Ritz eigenproblem of a
(3m x 3m) matrix, basis update and residual norms — runs on the device.
The JAX package compiles ``chunk`` iterations into one program; here each
iteration is four pieces split at its three ``torch.linalg.eigh`` calls
(whose info check waits for the card), and the host still looks at the
(m,) eigenvalues and residuals only once per chunk to decide termination.
On a card each piece runs as a CUDA graph replay, captured once per
operator and shape (``_StepGraphs``); elsewhere the pieces run eagerly.

Blocks are stored as (m, n) row-vector tensors, vectors as rows; the
public contract stays column-major ((n, k) eigenvectors, (n, nc)
constraints) like the reference's.  Algorithm, masks and thresholds are
the JAX package's: classical LOBPCG with hierarchical block
orthonormalization (X ⊥ W ⊥ P, two-pass Gram–Schmidt, eigh-whitening with
dead-row masking), in the B-inner product for generalized problems, with
optional deflation against ``constraints``.  f32 products run at full f32
(TF32 stays off).

With ``sharding=`` the blocks are ``ShardedRows`` (``parallel/mesh.py``),
one (m, n_p) tensor per shard of a mesh, and the same iteration runs on
them: the few helpers below dispatch on the block's type, a plain tensor
takes exactly the torch calls it took before.  ``shard_operator`` splits a
device matrix's values over the mesh to match.
"""

import copy
import weakref

import numpy as np
import torch

from ..ops import gram, spmm, spmm_pallas, spmm_window
from ..ops.spmm import (BsrMatrix, DiaMatrix, EllMatrix, storage_device,
                        torch_dtype)
from ..parallel.mesh import ShardedRows, Sharding
from ..utils.profiling import span, spanned

# pieces of the step captured as CUDA graphs, replayed, and run eagerly
GRAPH_COUNTS = {'captures': 0, 'replays': 0, 'eager_pieces': 0}
# ``_eigh`` calls by (dtype, width): the whitenings at the block's width m
# in the block's dtype, the Rayleigh-Ritz problem at 3m in float64
EIGH_COUNTS = {}
# the device layouts whose applies (and Chebyshev recurrences) a step
# captures: every launch they make is a kernel on torch's current stream
_GRAPH_LAYOUTS = (DiaMatrix, EllMatrix, BsrMatrix)
# the launch counters of those layouts' kernels and of the Grams (the
# Gram kernel's, and the Grams left to torch.matmul), which count Python
# calls: a replay adds the launches its capture counted
_LAUNCH_COUNTERS = (spmm_window.LAUNCHES, spmm.ELL_LAUNCHES,
                    spmm.ELL_STEP_LAUNCHES, spmm_pallas.LAUNCHES,
                    gram.GRAM_LAUNCHES, gram.MATMUL_GRAMS)
# _StepGraphs by what a capture depends on (``_graph_key``)
_GRAPHS = {}


def _gram(a, b):
    """Xᴴ Y for row-stored blocks: contraction over the vector
    dimension; plain tensors through ``ops/gram.py::gram`` (the Gram
    kernel where it takes them, else torch.matmul)."""
    if isinstance(a, ShardedRows):
        return a.gram(b)
    return gram.gram(a, b)


def _mixed(c, block, out=None):
    """c @ block for a small matrix c: row blocks combine from the left
    (into ``out`` where given, for a plain tensor)."""
    if isinstance(block, ShardedRows):
        return block.mixed(c)
    return torch.matmul(c, block, out=out)


def _row_dots(a, b):
    """Real parts of the row-wise inner products of two blocks."""
    if isinstance(a, ShardedRows):
        return a.row_dots(b)
    return (a.conj() * b).sum(1).real


def _row_norms(a):
    if isinstance(a, ShardedRows):
        return a.row_norms()
    return torch.linalg.vector_norm(a, dim=1)


def _scaled(col, block):
    """Each row of ``block`` times its entry of the (m, 1) column."""
    if isinstance(block, ShardedRows):
        return block * col
    return col * block


def _zero_rows(dead, block):
    """``block`` with the rows flagged in the (m,) mask set to 0."""
    if isinstance(block, ShardedRows):
        return block.zero_rows(dead)
    return torch.where(dead[:, None], 0.0, block)


def _cat(blocks):
    if isinstance(blocks[0], ShardedRows):
        return ShardedRows.cat(blocks)
    return torch.cat(blocks, dim=0)


def _zeros_like(block):
    if isinstance(block, ShardedRows):
        return block.zeros_like()
    return torch.zeros_like(block)


def reset_counts():
    """Set ``GRAPH_COUNTS`` to 0 and empty ``EIGH_COUNTS``."""
    for key in GRAPH_COUNTS:
        GRAPH_COUNTS[key] = 0
    EIGH_COUNTS.clear()


def _eigh(a, out=None):
    """``torch.linalg.eigh`` (into ``out`` where given), a
    ``raleigh.lobpcg.eigh`` span, counted in ``EIGH_COUNTS``: on a card
    its info check waits for the card."""
    key = (gram.dtype_name(a.dtype), a.shape[-1])
    EIGH_COUNTS[key] = EIGH_COUNTS.get(key, 0) + 1
    with span('raleigh.lobpcg.eigh'):
        return torch.linalg.eigh(a, out=out)


def _ritz_wide(h):
    """The (3m x 3m) Rayleigh–Ritz matrix as its eigh takes it, always in
    float64: the reference solves its Ritz problem in float64 whatever the
    vector dtype (core/solver.py:1437-1473), and the H100 has native f64,
    so f32 iterations resolve eigenvalue clusters that an all-f32 Ritz
    step cannot."""
    return h.to(torch.complex128 if h.is_complex() else torch.float64)


def _whiten_gram(block, bblock):
    """The Hermitian part of the B-Gram matrix whose eigh whitens the
    rows of ``block``."""
    g = _gram(block, bblock)
    return 0.5 * (g + g.conj().transpose(0, 1))


def _bnorms(block, bblock):
    """Per-row B-norms given the block and its B-image (2-norms when
    bblock is block itself)."""
    return torch.sqrt(torch.clamp(_row_dots(block, bblock), min=0.0))


def _normalize_drop_pair(block, bblock, sqrt_eps, dead0=None):
    """Normalize rows to unit B-length; a row whose norm collapsed below
    sqrt(eps) relative to the block's largest row is rounding noise —
    zero it and flag it dead.  Row scaling commutes with the operators,
    so the B-image follows exactly."""
    norms = _bnorms(block, bblock)
    ref = torch.clamp(norms.max(), min=1e-30)
    dead = norms <= sqrt_eps * ref
    if dead0 is not None:
        dead = dead | dead0
    safe = torch.where(norms == 0, 1.0, norms).to(block.real.dtype)
    out = _zero_rows(dead, block / safe[:, None])
    bout = out if bblock is block else \
        _zero_rows(dead, bblock / safe[:, None])
    return out, bout, dead


def _whiten_pair(block, bblock, eps_rel, sqrt_eps, dead0=None):
    """B-orthonormalize the rows of ``block`` by eigh-whitening of its
    B-Gram matrix; near-dependent directions are zeroed and flagged.

    Returns (whitened block, whitened B-image, dead mask (m,))."""
    w, v = _eigh(_whiten_gram(block, bblock))
    return _whitened(block, bblock, w, v, eps_rel, sqrt_eps, dead0)


def _whitened(block, bblock, w, v, eps_rel, sqrt_eps, dead0=None):
    """``_whiten_pair`` given the eigenpairs (w ascending, >= 0 up to
    noise; v) of ``_whiten_gram(block, bblock)``."""
    wmax = torch.clamp(w[-1], min=0.0)
    dead_g = w <= wmax * eps_rel
    inv = torch.where(dead_g, 0.0,
                      1.0 / torch.sqrt(torch.where(dead_g, 1.0, w)))
    mix = v * inv[None, :]
    # row blocks combine from the left: X_new = X mix  <=>  R_new = mixᵀ R
    bw = _mixed(mix.transpose(0, 1), block)
    bbw = bw if bblock is block else _mixed(mix.transpose(0, 1), bblock)
    # a correctly whitened row is unit up to rounding; anything that is
    # not was noise-dominated — run the scale test once more
    return _normalize_drop_pair(bw, bbw, sqrt_eps, dead0)


def _ortho_against_pair(block, basis, bbasis, *extra):
    """Two-pass classical Gram–Schmidt of ``block`` against the
    B-orthonormal ``basis`` in the B-inner product.  Any ``extra``
    (image, basis image) pairs receive the same row operation exactly."""
    outs = list(extra)
    for _ in range(2):
        q = _gram(bbasis, block)
        block = block - _mixed(q.transpose(0, 1), basis)
        for i, (img, bas_img) in enumerate(outs):
            outs[i] = (img - _mixed(q.transpose(0, 1), bas_img), bas_img)
    if not extra:
        return block
    return (block,) + tuple(img for img, _ in outs)


def shard_operator(dm, mesh, axis='chips'):
    """Split a device sparse matrix's values over ``mesh`` so that the
    LOBPCG iteration shards over the vector dimension; returns ``dm``,
    changed in place, as the JAX package's function does.

    DIA: ``val`` (noff, n) is split along the lanes, and every sharded
    apply is one launch per device that reads the neighbours' halo lanes
    where they lie (``DiaMatrix.sharded_rows_fn``).  ELL: ``idx`` and
    ``val`` are split by rows and applied against the gathered operand.  Any
    other matrix (a ``BsrMatrix``, which has neither DIA values nor ELL
    indices) is returned unchanged, as the JAX package's function returns
    it: a sharded ``lobpcg`` applies it to the gathered block.

    ``axis`` names the mesh axis (or a tuple of axes) the split follows.
    A 1-D mesh has one axis, whatever it is called, so there the name is
    free; on a 2-D mesh an unknown name raises."""
    if len(mesh.axis_names) == 1:
        axis = mesh.axis_names
    sharding = Sharding(mesh, axis)
    if isinstance(dm, DiaMatrix):
        val = dm.val.gather() if dm._multi_device() else dm.val
        # a value outside the matrix would meet a wrapped lane: the
        # unsharded kernel skips it, so it must be 0 here
        n = val.shape[1]
        lane = torch.arange(n, device=val.device)[None, :] \
            + dm.offsets_t.to(val.device)[:, None]
        val = torch.where((lane >= 0) & (lane < n), val, 0.0)
        dm.val = ShardedRows.split(val, sharding)
    elif isinstance(dm, EllMatrix):
        if dm._multi_device():
            dm.idx, dm.val = dm.idx.gather(), dm.val.gather()
        dm.idx = ShardedRows.split(dm.idx, sharding, dim=0)
        dm.val = ShardedRows.split(dm.val, sharding, dim=0)
    return dm


def _rows_matmat(op, sharding=None):
    """Adapt the operator form the caller gave to the row-layout
    (m, n) -> (m, n) apply the iteration uses: a device sparse matrix
    (``matmat_rows`` or ``matmat_t``) or a bare column-layout callable.

    Under ``sharding`` the blocks are ``ShardedRows``.  A DIA matrix whose
    values sit on one device is split over the mesh on entry (a copy: the
    caller's matrix stays whole), as XLA's partitioner splits it in the JAX
    package; any other operator that knows no shards is applied to the
    gathered block."""
    if op is None:
        return None
    if sharding is not None:
        multi = getattr(op, '_multi_device', None)
        if multi is None or not multi():
            if isinstance(op, DiaMatrix):
                op = shard_operator(copy.copy(op), sharding.mesh,
                                    sharding.axes)
            else:
                whole = _rows_matmat(op)

                def apply_rows(v):
                    return ShardedRows.split(whole(v.gather()), sharding)
                return apply_rows
    if hasattr(op, 'matmat_rows'):
        return op.matmat_rows
    if hasattr(op, 'matmat_t'):
        def apply_rows(v):
            return op.matmat_t(v.transpose(0, 1)).transpose(0, 1)
        return apply_rows

    def apply_rows(v):
        return op(v.transpose(0, 1)).transpose(0, 1)
    return apply_rows


def _host(t):
    """The tensor ``t`` as a host array: one transfer, which waits for the
    card, in a ``raleigh.sync`` span."""
    with span('raleigh.sync'):
        return t.cpu().numpy()


def default_block(k, n):
    """Default iteration block for ``k`` wanted pairs: k plus slack,
    rounded up to a multiple of 8 (kept from the JAX package, so both
    iterate the same block; the CUDA kernel itself takes any m)."""
    m = min(n, k + max(8, k // 4))
    return min(n, -(-m // 8) * 8)


class _Step:
    """One LOBPCG iteration as four pieces, split at its three eigh calls:
    ``gram_w`` (the state to W's B-Gram), ``gram_p`` (W's whitening to P's
    B-Gram), ``ritz_matrix`` (P's whitening to the Rayleigh–Ritz matrix in
    float64) and ``update`` (the Ritz vectors to the next state).  Each
    piece but the first takes what the one before returned and the
    eigenpairs of its matrix; calling the object runs the four eagerly.
    ``matmat``, ``matmat_b`` and ``precond`` apply to (m, n) row blocks;
    ``y``, ``ay``, ``by`` are the constraints and their images."""

    def __init__(self, matmat, matmat_b, precond, y, ay, by, generalized,
                 m, sign, eps_rel, sqrt_eps, device):
        self.matmat, self.matmat_b, self.precond = matmat, matmat_b, precond
        self.y, self.ay, self.by = y, ay, by
        self.generalized = generalized
        self.m, self.sign, self.device = m, sign, device
        self.eps_rel, self.sqrt_eps = eps_rel, sqrt_eps

    def __call__(self, state):
        """The next state, each piece run eagerly in a
        ``raleigh.lobpcg.piece`` span."""
        args = state
        for i, piece in enumerate(self.pieces()):
            with span('raleigh.lobpcg.piece'):
                out = piece(*args)
            GRAPH_COUNTS['eager_pieces'] += 1
            if i < 3:
                args = (out[0],) + tuple(_eigh(out[1]))
        return out

    def pieces(self):
        return self.gram_w, self.gram_p, self.ritz_matrix, self.update

    def gram_w(self, x, ax, bx, p, ap, bp, anorm):
        y, ay, by, sqrt_eps = self.y, self.ay, self.by, self.sqrt_eps
        # re-deflate X against the constraints every iteration with exact
        # image tracking: a leaked constraint direction with a more
        # extreme eigenvalue is amplified by the Rayleigh–Ritz step
        q = _gram(by, x)
        x = x - _mixed(q.transpose(0, 1), y)
        ax = ax - _mixed(q.transpose(0, 1), ay)
        if self.generalized:
            bx = bx - _mixed(q.transpose(0, 1), by)
        else:
            bx = x
        lam = _row_dots(x, ax)
        anorm = torch.maximum(anorm, lam.abs().max())
        w = ax - _scaled(lam[:, None].to(x.dtype), bx)
        w = self.precond(w).to(w.dtype)
        # hierarchical B-orthonormalization: X is B-orthonormal;
        # W ⊥_B Y, X; P ⊥_B Y, X, W.  Dead (noise or rank-deficient) rows
        # are zeroed and masked out of the Rayleigh–Ritz selection.
        w, _, dead_w = _normalize_drop_pair(w, w, sqrt_eps)
        w = _ortho_against_pair(w, y, by)
        w = _ortho_against_pair(w, x, bx)
        bw = self.matmat_b(w)
        w, bw, dead_w = _normalize_drop_pair(w, bw, sqrt_eps, dead_w)
        return (x, ax, bx, p, anorm, w, bw, dead_w), _whiten_gram(w, bw)

    def gram_p(self, carry, ew, vw):
        x, ax, bx, p, anorm, w, bw, dead_w = carry
        y, by, sqrt_eps = self.y, self.by, self.sqrt_eps
        w, bw, dead_w = _whitened(w, bw, ew, vw, self.eps_rel, sqrt_eps,
                                  dead_w)
        aw = self.matmat(w)
        p, _, dead_p = _normalize_drop_pair(p, p, sqrt_eps)
        p = _ortho_against_pair(p, y, by)
        p = _ortho_against_pair(p, x, bx)
        p = _ortho_against_pair(p, w, bw)
        bp = self.matmat_b(p)
        p, bp, dead_p = _normalize_drop_pair(p, bp, sqrt_eps, dead_p)
        return ((x, ax, bx, anorm, w, bw, aw, p, bp, dead_w, dead_p),
                _whiten_gram(p, bp))

    def ritz_matrix(self, carry, ep, vp):
        x, ax, bx, anorm, w, bw, aw, p, bp, dead_w, dead_p = carry
        m = self.m
        p, bp, dead_p = _whitened(p, bp, ep, vp, self.eps_rel,
                                  self.sqrt_eps, dead_p)
        ap = self.matmat(p)
        s = _cat((x, w, p))
        a_s = _cat((ax, aw, ap))
        h = _gram(s, a_s)
        h = 0.5 * (h + h.conj().transpose(0, 1)) * self.sign
        dead = torch.cat((torch.zeros(m, dtype=torch.bool,
                                      device=self.device), dead_w, dead_p))
        # push dead (zeroed) basis rows past the live spectrum, which is
        # bounded by 3m * max|diag| for a B-orthonormal basis, so the Ritz
        # selection never picks them
        big = (torch.diagonal(h).abs().max() + 1.0) * (4.0 * s.shape[0])
        h = h + torch.diag(torch.where(dead, big, 0.0).to(h.dtype))
        return (s, a_s, bx, bw, bp, anorm, h), _ritz_wide(h)

    def update(self, carry, eh, vh, into=None):
        """The next state; with ``into`` (a state of plain tensors) written
        into its tensors, which it returns."""
        s, a_s, bx, bw, bp, anorm, h = carry
        m = self.m
        out = (None,) * 7 if into is None else into
        _, c = eh.to(h.real.dtype), vh.to(h.dtype)
        cm = c[:, :m]
        xn = _mixed(cm.transpose(0, 1), s, out[0])
        axn = _mixed(cm.transpose(0, 1), a_s, out[1])
        # conjugate directions: the W/P components of the update
        cwp = cm.clone()
        cwp[:m] = 0
        pn = _mixed(cwp.transpose(0, 1), s, out[3])
        apn = _mixed(cwp.transpose(0, 1), a_s, out[4])
        if self.generalized:
            b_s = _cat((bx, bw, bp))
            bxn = _mixed(cm.transpose(0, 1), b_s, out[2])
            bpn = _mixed(cwp.transpose(0, 1), b_s, out[5])
        else:
            bxn, bpn = xn, pn
        if into is not None:
            anorm = into[6].copy_(anorm)
        return xn, axn, bxn, pn, apn, bpn, anorm


def _graphable(op, opB, precond, device, sharding, constraints, dtype):
    """True where the step can run as CUDA graph replays: on a card, real
    blocks, no sharding and no constraints, and the operator, ``opB`` and
    a Chebyshev preconditioner's matrix (``precond[0].device_matrix``)
    each a real device matrix of a layout in ``_GRAPH_LAYOUTS`` on one
    device.  Anything else runs the pieces eagerly."""
    if (device.type != 'cuda' or sharding is not None or dtype.is_complex
            or (constraints is not None and np.size(constraints) > 0)):
        return False
    mats = [op] if opB is None else [op, opB]
    if precond is not None:
        mats.append(getattr(precond[0], 'device_matrix', None)
                    if isinstance(precond, tuple) else None)
    return all(isinstance(a, _GRAPH_LAYOUTS) and not a.dtype.is_complex
               and not getattr(a, '_multi_device', bool)() for a in mats)


def _step_graphs(objects, m, n, dtype, device, sign, state):
    """The ``_StepGraphs`` of a step, made for ``state`` at the first call.
    It is found again by the identities of ``objects`` (the operator,
    ``opB`` and the preconditioner's function; None where absent), the
    block's shape and dtype, the device, the Ritz selection's sign and the
    TF32 mode, which captured cuBLAS calls keep; it is dropped with the
    first of ``objects`` to die."""
    key = (tuple(map(id, objects)), m, n, dtype, str(device), sign,
           torch.backends.cuda.matmul.allow_tf32)
    live = [o for o in objects if o is not None]
    hit = _GRAPHS.get(key)
    if hit is not None and all(r() is o for r, o in zip(hit.refs, live)):
        return hit
    made = _StepGraphs(state)
    made.refs = [weakref.ref(o, lambda _r, k=key, kept=_GRAPHS:
                             kept.pop(k, None)) for o in live]
    _GRAPHS[key] = made
    return made


def _capture(pool, fn, *args, **kwargs):
    """(graph, what the call returned) of ``fn(*args, **kwargs)`` captured
    into a CUDA graph whose memory comes from ``pool``."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = fn(*args, **kwargs)
    return graph, out


class _StepGraphs:
    """A ``_Step``'s four pieces as CUDA graphs in one memory pool, with
    the three eigh calls run eagerly between their replays.  The state
    lives in persistent tensors (``state``): ``run`` copies a state that
    is not there into them, the first piece reads them and the last
    writes the next state into them.  Each eigh reads the matrix its
    piece left and writes into static tensors the next piece reads.  The
    first ``run`` is eager, the second captures the pieces
    (``raleigh.lobpcg.capture`` spans), replaying each once; every run
    after replays them (``raleigh.lobpcg.replay`` spans), and each replay
    adds to the kernels' launch counters what its capture counted."""

    def __init__(self, state):
        own = {}            # one tensor for each tensor of the state
        for t in state:     # (bx is x, bp is p, without opB)
            if id(t) not in own:
                own[id(t)] = torch.empty_like(t)
        self.state = tuple(own[id(t)] for t in state)
        self.pool = torch.cuda.graph_pool_handle()
        self.warm = False
        self.graphs = []        # (graph, launches it counted) per piece
        self.mats = []          # the matrix each eigh reads
        self.eigs = []          # the static (w, v) each eigh writes

    def load(self, state):
        """Copy ``state`` into ``self.state``, but for the tensors that
        are already there."""
        done = set()
        for dst, src in zip(self.state, state):
            if id(dst) not in done and dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
            done.add(id(dst))

    def run(self, step, state):
        """One iteration of ``step`` from ``state``.  The first call runs
        it eagerly, so that kernels, cuBLAS and launch shapes are warm
        before the second captures it; from the second on it returns
        ``self.state``."""
        if not self.warm:
            self.warm = True
            return step(state)
        self.load(state)
        if self.graphs:
            for i, (graph, counted) in enumerate(self.graphs):
                self._replay(graph, counted)
                if i < 3:
                    _eigh(self.mats[i], out=self.eigs[i])
            return self.state
        carry = None
        for i, piece in enumerate(step.pieces()):
            args = self.state if i == 0 else (carry, *self.eigs[i - 1])
            kwargs = {'into': self.state} if i == 3 else {}
            before = [dict(c) for c in _LAUNCH_COUNTERS]
            with span('raleigh.lobpcg.capture'):
                graph, out = _capture(self.pool, piece, *args, **kwargs)
            counted = []
            for counts, was in zip(_LAUNCH_COUNTERS, before):
                counted.append({k: counts[k] - was.get(k, 0) for k in counts
                                if counts[k] != was.get(k, 0)})
                for k in counts:    # a key the capture made stays, at 0
                    counts[k] = was.get(k, 0)
            GRAPH_COUNTS['captures'] += 1
            self.graphs.append((graph, counted))
            self._replay(graph, counted)
            if i < 3:
                carry, mat = out
                w = torch.empty(mat.shape[0], dtype=mat.real.dtype,
                                device=mat.device)
                v = torch.empty_like(mat).mT    # eigh's column-major layout
                _eigh(mat, out=(w, v))
                self.mats.append(mat)
                self.eigs.append((w, v))
        return self.state

    @staticmethod
    def _replay(graph, counted):
        with span('raleigh.lobpcg.replay'):
            graph.replay()
        for counts, delta in zip(_LAUNCH_COUNTERS, counted):
            for k, n in delta.items():
                counts[k] += n
        GRAPH_COUNTS['replays'] += 1


@spanned('raleigh.lobpcg')
def lobpcg(op, k, n=None, opB=None, precond=None, block_size=None,
           tol=1e-4, maxit=500, chunk=16, largest=False, x0=None,
           constraints=None, seed=1, dtype=torch.float32, verb=0,
           sharding=None, device=None):
    """Compute the ``k`` algebraically smallest (or largest) eigenpairs of
    a symmetric positive (semi-)definite operator — or of the generalized
    pencil (A, B) when ``opB`` is given — on the device.

    Parameters
    ----------
    op : a device sparse matrix from ops/spmm.py (``matmat_rows``), an
        object with ``matmat_t((n, m)) -> (n, m)``, or a bare column-layout
        callable on tensors.
    k : number of wanted eigenpairs.
    n : problem dimension (required when ``op`` is a bare callable).
    opB : optional right-hand operator of a generalized problem
        A x = λ B x, symmetric positive definite, in the same forms.  The
        returned eigenvectors are B-orthonormal.
    precond : None, a row-layout (m, n) -> (m, n) callable, or an
        ``(fn, operands)`` pair such as
        ``Chebyshev.device_rows_operands(m, n)``.
    block_size : iteration block m >= k (default ``default_block(k, n)``).
    tol : convergence on ||A x - lmd B x|| <= tol * anorm_est per wanted
        pair, anorm_est = running max |lmd| (scipy.lobpcg convention).
    chunk : iterations between host convergence checks.
    x0 : optional (n, >=m) initial block (ndarray or tensor).  Without
        it the start block is ``torch.randn`` from a generator seeded with
        ``seed``; it cannot reproduce the JAX package's random bits, so
        comparisons between the packages pass ``x0``.
    constraints : optional (n, nc) block of prior eigenvectors; the
        iteration is deflated against their B-orthonormalized span, so it
        computes the *next* k pairs.
    dtype : iteration dtype (torch or numpy).
    sharding : optional ``parallel.mesh.blockvec_sharding(mesh)``: the
        iteration blocks are split along the vector dimension over the
        mesh (``ShardedRows``).  The start block, the constraints and the
        random numbers are made whole, as without it, and then split; the
        (3m x 3m) Ritz problem and the host checks are unchanged.  Pair it
        with ``shard_operator`` (and give a Chebyshev preconditioner the
        sharded matrix as its ``device_matrix``).
    device : device of the iteration (default: ``op.device``, else the
        card; CUDA with no card raises).  Under ``sharding`` it is the
        first shard's device, where the small matrices live.

    Returns (lmd (k,), x (n, k), resid (k,), niter, status) as NumPy
    arrays, status 0 = converged, 2 = iteration limit, 3 = no search
    directions (reference core/solver.py:305-331).

    On a card, with real blocks, no sharding and no constraints, and
    operators and a Chebyshev preconditioner in DIA, ELL or BSR
    (``_graphable``), each iteration after the first of the first call
    runs as four CUDA graph replays with the three ``eigh`` calls between
    them (``_StepGraphs``); the graphs are kept for later calls with the
    same operators, shape, dtype and TF32 mode.  ``GRAPH_COUNTS`` counts
    the pieces captured, replayed and run eagerly, ``EIGH_COUNTS`` the
    ``eigh`` calls by dtype and width (``reset_counts`` resets both).

    Under a profiler the call is a ``raleigh.lobpcg`` span, each
    iteration a ``raleigh.lobpcg.step`` span holding a span for each of
    its four pieces (``raleigh.lobpcg.piece`` run eagerly,
    ``raleigh.lobpcg.replay``, ``raleigh.lobpcg.capture``), each ``eigh``
    a ``raleigh.lobpcg.eigh`` span and each transfer to the host a
    ``raleigh.sync`` span (``utils/profiling.py``).  Spans inside a piece
    fire where it runs eagerly or is captured, not at a replay.
    """
    if sharding is not None and not isinstance(sharding, Sharding):
        raise TypeError('lobpcg needs a parallel.mesh.Sharding for its '
                        'blocks (got %s); build one with '
                        'parallel.mesh.blockvec_sharding'
                        % type(sharding).__name__)
    if n is None:
        n = op.shape[0]
    if sharding is not None:
        device = sharding.devices[0]
    elif device is None:
        device = getattr(op, 'device', None)
    device = storage_device(device)
    dtype = torch_dtype(dtype)
    m = block_size or default_block(k, n)
    if m < k:
        raise ValueError('block_size < k')
    matmat_a = _rows_matmat(op, sharding)
    matmat_b_rows = _rows_matmat(opB, sharding)
    real = torch.empty((), dtype=dtype).real.dtype
    eps = torch.finfo(real).eps
    eps_rel = 100 * eps
    sqrt_eps = float(np.sqrt(eps))
    sign = -1.0 if largest else 1.0

    # the operator (and preconditioner) may hold values in a different
    # precision; the iteration dtype is authoritative for the carries
    def matmat(v):
        return matmat_a(v).to(v.dtype)

    if opB is None:
        def matmat_b(v):
            return v
    else:
        def matmat_b(v):
            return matmat_b_rows(v).to(v.dtype)

    if precond is None:
        def apply_precond(w):
            return w
    elif isinstance(precond, tuple):
        precond_fn, ops_p = precond

        def apply_precond(w):
            return precond_fn(ops_p, w)
    else:
        apply_precond = precond

    def as_rows(block):
        """(n, j) column block (ndarray or tensor) -> (j, n) rows."""
        if not isinstance(block, torch.Tensor):
            block = torch.from_numpy(np.array(block))   # writable copy
        t = block.to(dtype=dtype, device=device)
        return t.transpose(0, 1).contiguous()

    def spread(block):
        """A whole (j, n) block as the iteration stores it."""
        if sharding is None:
            return block
        return ShardedRows.split(block, sharding)

    # ---- constraints: B-orthonormalize once, precompute A/B-images -----
    if constraints is not None and np.size(constraints) > 0:
        y = spread(as_rows(constraints))
        by0 = matmat_b(y)
        y, by0, dead_y = _normalize_drop_pair(y, by0, sqrt_eps)
        y, by0, dead_y = _whiten_pair(y, by0, eps_rel, sqrt_eps, dead_y)
        ay = matmat(y)
        by = matmat_b(y)
    else:
        y = spread(torch.zeros((0, n), dtype=dtype, device=device))
        ay = by = y

    step = _Step(matmat, matmat_b, apply_precond, y, ay, by, opB is not None,
                 m, sign, eps_rel, sqrt_eps, device)

    def run_chunk(state, iters):
        for _ in range(iters):
            with span('raleigh.lobpcg.step'):
                state = step(state) if graphs is None \
                    else graphs.run(step, state)
        x, ax, bx, p, ap, bp, anorm = state
        # chunk exit: re-deflate and refresh the images so the host's
        # convergence decision sees trustworthy residuals
        q = _gram(by, x)
        x = x - _mixed(q.transpose(0, 1), y)
        ax = matmat(x)
        bx = matmat_b(x)
        lam = _row_dots(x, ax)
        anorm = torch.maximum(anorm, lam.abs().max())
        resid = _row_norms(ax - _scaled(lam[:, None].to(x.dtype), bx))
        order = torch.argsort(sign * lam)
        return (x[order], ax[order], bx[order], p, ap, bp, anorm), \
            lam[order], resid[order]

    # ---- initial block -----------------------------------------------
    gen = torch.Generator(device).manual_seed(seed)
    if x0 is not None:
        x = as_rows(x0)[:m]
        if x.shape[0] < m:
            extra = torch.randn((m - x.shape[0], n), generator=gen,
                                dtype=dtype, device=device)
            x = torch.cat((x, extra), dim=0)
    else:
        x = torch.randn((m, n), generator=gen, dtype=dtype, device=device)

    x = _ortho_against_pair(spread(x), y, by)
    bx = matmat_b(x)
    x, bx, dead_x = _normalize_drop_pair(x, bx, sqrt_eps)
    x, bx, _ = _whiten_pair(x, bx, eps_rel, sqrt_eps, dead_x)
    ax = matmat(x)
    lam0 = _row_dots(x, ax)
    r0 = _row_norms(ax - _scaled(lam0[:, None].to(x.dtype), bx))
    p = _zeros_like(x)
    ap = _zeros_like(x)
    bp = p if opB is None else _zeros_like(x)
    anorm = torch.zeros((), dtype=real, device=device)
    lam_h, resid_h = _host(lam0), _host(r0)
    anorm_h = float(np.max(np.abs(lam_h)))

    state = (x, ax, bx, p, ap, bp, anorm)
    graphs = None
    if _graphable(op, opB, precond, device, sharding, constraints, dtype):
        graphs = _step_graphs(
            (op, opB, precond[0] if isinstance(precond, tuple) else precond),
            m, n, dtype, device, sign, state)
    niter = 0
    status = 2
    restarts = 0
    stall = 0
    best = np.inf
    while niter < maxit:
        iters = min(chunk, maxit - niter)
        new_state, lam, resid = run_chunk(state, iters)
        niter += iters
        lam_t = _host(lam)
        resid_t = _host(resid)
        anorm_t = float(_host(new_state[-1]))
        if not (np.all(np.isfinite(lam_t)) and np.all(np.isfinite(resid_t))):
            # post-convergence noise blocks can degenerate when the caller
            # over-iterates far past the engine's accuracy floor: roll back
            # to the pre-chunk state, reset the conjugate directions, and
            # retry; give up (status 3) on repeat
            x, ax, bx, _, _, _, anorm = state
            p = _zeros_like(x)
            ap = _zeros_like(x)
            bp = p if opB is None else _zeros_like(x)
            state = (x, ax, bx, p, ap, bp, anorm)
            restarts += 1
            if verb > 0:
                print('iter %4d: non-finite chunk, rolling back (%d)'
                      % (niter, restarts))
            if restarts > 2:
                status = 3
                break
            continue
        state = new_state
        lam_h, resid_h, anorm_h = lam_t, resid_t, anorm_t
        if verb > 0:
            print('iter %4d: lmd[:%d] %s, resid %s' % (
                niter, min(k, 4), np.round(lam_h[:min(k, 4)], 6),
                np.format_float_scientific(resid_h[:k].max(), 2)))
        rmax = float(resid_h[:k].max())
        if np.all(resid_h[:k] <= tol * max(anorm_h, 1e-30)):
            status = 0
            break
        # stall detection: once the residual stops improving the iterate
        # sits at the engine's accuracy floor
        if rmax > 0.99 * best:
            stall += 1
            if stall >= 4:
                break
        else:
            stall = 0
        best = min(best, rmax)
    x = state[0][:k]
    if sharding is not None:
        x = x.gather()
    return (np.asarray(lam_h[:k]), _host(x.transpose(0, 1)),
            np.asarray(resid_h[:k]), niter, status)
