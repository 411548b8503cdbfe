"""Row-partitioned sharded SpMM with neighbour halo exchange.

PyTorch port of ``raleigh_tpu/parallel/spmm_sharded.py``: the symmetric
matrix is bandwidth-reduced (reverse Cuthill-McKee), its ELL structure
row-partitioned over the mesh, and each shard computes its row block
against its own slice of the operand plus a halo of neighbouring rows, so
that the traffic between shards grows with the matrix bandwidth and not
with n.

Three regimes, chosen from the reordered pattern:

  * one-hop halo    the bandwidth fits within one neighbouring chunk per
    side; each shard fetches just the boundary rows;
  * multi-hop halo  the band spans h > 1 chunks; the halo is assembled from
    the intermediate chunks whole and a slice of the outermost one;
  * gathered        scattered patterns where halos would approach n anyway;
    every shard sees the whole operand and indices stay global.  Always
    correct, traffic grows with n.

The mesh is a list of devices walked by one process (``parallel/mesh.py``).
Each shard's product is one launch of the ELL kernel (``csrc/ell_spmm.cu``,
through ``ops.spmm._ell_matmat``) on its (rows, m) extended operand; the
halo and body copies that assemble the shards' extended operands go
through the hand-written copy kernel, one ``ops.stream.copy_lanes_many``
launch for all copies within a device, and through ``Tensor.copy_``
between devices.
"""

import numpy as np
import torch

from ..ops.spmm import (_checked_columns, _ell_matmat, _int32,
                        _to_full_csr, _values)
from .mesh import AXIS, ShardedRows, Sharding, ring_extended


class ShardedEllMatrix:
    """Symmetric sparse matrix in RCM-reordered, row-sharded ELL form.

    ``mesh``: a 1-D mesh (``make_mesh``).  ``mode``: 'auto' (default) picks
    halo exchange when the reordered bandwidth spans less than the whole
    ring, gathered otherwise; 'halo' and 'gather' force the respective
    regime ('halo' raises if the pattern cannot be covered without wrapping
    the ring)."""

    def __init__(self, a, mesh, dtype=np.float32, pad_to=8, mode='auto'):
        import scipy.sparse as scs
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        a = _to_full_csr(a)
        n0 = a.shape[0]
        perm = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True))
        a = a[perm, :][:, perm].tocsr()
        a.sort_indices()

        nshards = mesh.shape[AXIS]
        # pad n to a multiple of the shard count
        chunk = -(-n0 // nshards)
        n = chunk * nshards
        if n > n0:
            a = scs.csr_matrix(
                scs.vstack([scs.hstack([a, scs.csr_matrix((n0, n - n0))]),
                            scs.csr_matrix((n - n0, n))]))
        deg = np.diff(a.indptr)
        k = max(1, int(deg.max()))
        k = ((k + pad_to - 1) // pad_to) * pad_to
        idx = np.zeros((n, k), dtype=np.int32)
        val = np.zeros((n, k), dtype=dtype)
        rows = np.repeat(np.arange(n), deg)
        offs = np.arange(a.nnz) - np.repeat(a.indptr[:-1], deg)
        idx[rows, offs] = a.indices
        val[rows, offs] = a.data.astype(dtype)

        # per-side halo extents: how far any row's columns reach below /
        # above its own chunk, in rows
        lo = (np.arange(n) // chunk) * chunk
        halo_lo = halo_hi = 0
        nz = val != 0
        if nz.any():
            rel_lo = (lo[:, None] - idx)[nz]
            rel_hi = (idx - (lo[:, None] + chunk - 1))[nz]
            halo_lo = int(max(rel_lo.max(), 0))
            halo_hi = int(max(rel_hi.max(), 0))
        hops_lo = -(-halo_lo // chunk)
        hops_hi = -(-halo_hi // chunk)

        # a halo that spans the whole ring would wrap: rows would arrive
        # from both directions at once, so fall back to gathering
        fits = hops_lo + hops_hi < nshards
        if mode == 'auto':
            mode = 'halo' if fits else 'gather'
        elif mode == 'halo' and not fits:
            raise ValueError(
                'matrix bandwidth spans the whole ring even after RCM; '
                "use mode='gather' (or 'auto') for this pattern")
        if mode == 'gather':
            halo = (0, 0)                                 # global indices
        else:
            halo = (halo_lo, halo_hi)
            # local indices into [halo_lo | chunk | halo_hi]
            idx = np.clip(idx - lo[:, None] + halo_lo, 0,
                          chunk + halo_lo + halo_hi - 1).astype(np.int32)
        self._init(idx, val, perm, halo, chunk, mode, mesh, int(a.nnz))

    @classmethod
    def from_arrays(cls, idx, val, perm, halo, chunk, mode, mesh, nnz=None):
        """The port's matrix from another sharded ELL matrix's arrays, e.g.
        the ``np.asarray`` of a ``raleigh_tpu`` ``ShardedEllMatrix``'s
        ``idx`` and ``val`` with its ``perm``, ``halo``, ``chunk`` and
        ``mode``: no second RCM."""
        self = cls.__new__(cls)
        self._init(idx, val, perm, tuple(int(h) for h in halo),
                   int(chunk), mode, mesh, nnz)
        return self

    def _init(self, idx, val, perm, halo, chunk, mode, mesh, nnz):
        if mode not in ('halo', 'gather'):
            raise ValueError("mode must be 'halo' or 'gather', got %r"
                             % (mode,))
        sharding = Sharding(mesh, AXIS)
        n, k = val.shape
        if n != chunk * sharding.nshards:
            raise ValueError('%d rows are not %d shards of %d'
                             % (n, sharding.nshards, chunk))
        perm = np.ascontiguousarray(perm)   # RCM hands out a reversed view
        n0 = len(perm)
        self.mesh = mesh
        self.sharding = sharding
        self.shape = (n0, n0)
        self.n_padded = n
        self.chunk = chunk
        self.mode = mode
        self.halo = halo
        self.perm = perm
        self.iperm = np.empty_like(perm)
        self.iperm[perm] = np.arange(n0)
        self.row_degree = k
        first = sharding.devices[0]
        # halo mode indexes each shard's extended operand, gather mode the
        # whole one
        width = chunk + sum(halo) if mode == 'halo' else n
        self.idx = ShardedRows.split(
            _int32(_checked_columns(idx, width), first), sharding, dim=0)
        self.val = ShardedRows.split(_values(val, None, first), sharding,
                                     dim=0)
        self.nnz = int(np.count_nonzero(val)) if nnz is None else nnz
        self.dtype = self.val.dtype
        self._perm_t = torch.as_tensor(perm, dtype=torch.int64, device=first)
        self._iperm_t = torch.as_tensor(self.iperm, dtype=torch.int64,
                                        device=first)

    def matmat_t(self, xt):
        """(n0, m) = A_original @ (n0, m): operand (a tensor or an ndarray)
        and result in the ORIGINAL ordering; the permutations are applied
        on the first shard's device, where the result lives."""
        first = self.sharding.devices[0]
        if not isinstance(xt, torch.Tensor):
            xt = torch.from_numpy(np.require(xt, requirements='W'))
        n0 = self.shape[0]
        xp = xt.to(first).index_select(0, self._perm_t)
        if self.n_padded > n0:
            xp = torch.nn.functional.pad(xp, (0, 0, 0, self.n_padded - n0))
        x = ShardedRows.split(xp, self.sharding, dim=0)
        if self.mode == 'gather':
            whole = {}
            for dev in set(self.sharding.devices):
                whole[dev] = torch.cat([p.to(dev) for p in x.parts], dim=0)
            operands = [whole[dev] for dev in self.sharding.devices]
        else:
            operands, _ = ring_extended(x, *self.halo)
        y = torch.cat([_ell_matmat(i, v, xe).to(first) for i, v, xe in
                       zip(self.idx.parts, self.val.parts, operands)], dim=0)
        return y[:n0].index_select(0, self._iperm_t)
