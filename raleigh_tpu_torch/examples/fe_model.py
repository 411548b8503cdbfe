"""Seeded synthetic finite-element models: scattered-pattern stiffness /
mass / geometric-stiffness pencils at the scale and structure of the
reference's headline benchmark matrices (shipsec1: n = 140,874 FE shell
dof, ~55 nnz/row, reference README.md:19-25, downloaded by reference
examples/sparse_evp.py:11-12 and buckling_evp.py:29-34 — downloads need
egress, so the matrices are generated here instead).

The flagship geometry is a stiffened box girder — the actual structure
of a ship section: an orthogonal assembly of 1-element-thick plates
(hull plating, decks, transverse bulkheads) on a coarse spacing, with
random lightening holes punched through the plates and a random node
relabeling (destroying any banded numbering, as a production mesher
would).  3 translational dof per node, isotropic hex8 elasticity, a
per-element material jitter so the values are not degenerate.  Element
matrices are the standard 2x2x2 Gauss-quadrature integrals:

  K_e  = int B^T D B dV          (elasticity stiffness)
  M_e  = int rho N^T N dV        (consistent mass)
  G_e  = int sigma_ab dN_i/dx_a dN_j/dx_b dV x I_3
                                 (geometric stiffness, uniaxial
                                  compression sigma_xx = -1 — the
                                  buckling pencil K x = -lmd G x has
                                  positive critical load factors)

Everything is deterministic in ``seed``.
"""

import numpy as np
import scipy.sparse as scs


def _gauss2():
    g = 1.0 / np.sqrt(3.0)
    pts = np.array([[i, j, k] for i in (-g, g) for j in (-g, g)
                    for k in (-g, g)])
    return pts, np.ones(8)


_CORNER_SIGNS = np.array([[i, j, k] for i in (-1, 1) for j in (-1, 1)
                          for k in (-1, 1)], dtype=float)


def _shape_derivs(xi, h):
    """dN/dx (8, 3) of the hex8 shape functions at natural point ``xi``
    for an axis-aligned brick with side lengths ``h`` (hx, hy, hz)."""
    s = _CORNER_SIGNS
    dN = np.empty((8, 3))
    for a in range(8):
        sa = s[a]
        f = 0.125 * np.array([
            sa[0] * (1 + sa[1] * xi[1]) * (1 + sa[2] * xi[2]),
            sa[1] * (1 + sa[0] * xi[0]) * (1 + sa[2] * xi[2]),
            sa[2] * (1 + sa[0] * xi[0]) * (1 + sa[1] * xi[1])])
        dN[a] = f * 2.0 / np.asarray(h)     # d(xi)/dx = 2/h
    return dN


def hex8_matrices(h=(1.0, 1.0, 1.0), E=1.0, nu=0.3, rho=1.0):
    """(K_e, M_e, G_e) 24x24 element matrices of an axis-aligned hex8
    brick with side lengths ``h``."""
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[np.arange(3), np.arange(3)] += 2 * mu
    D[np.arange(3, 6), np.arange(3, 6)] = mu
    detJ = np.prod(h) / 8.0     # d(vol) per unit natural volume
    pts, wts = _gauss2()
    K = np.zeros((24, 24))
    M = np.zeros((24, 24))
    G = np.zeros((8, 8))
    for xi, w in zip(pts, wts):
        dN = _shape_derivs(xi, h)            # (8, 3)
        B = np.zeros((6, 24))
        for a in range(8):
            dx, dy, dz = dN[a]
            c = 3 * a
            B[0, c] = dx
            B[1, c + 1] = dy
            B[2, c + 2] = dz
            B[3, c] = dy
            B[3, c + 1] = dx
            B[4, c + 1] = dz
            B[4, c + 2] = dy
            B[5, c] = dz
            B[5, c + 2] = dx
        K += w * detJ * (B.T @ D @ B)
        N = 0.125 * np.prod(1 + _CORNER_SIGNS * xi, axis=1)
        Nm = np.zeros((3, 24))
        for a in range(8):
            Nm[:, 3 * a:3 * a + 3] = N[a] * np.eye(3)
        M += w * detJ * rho * (Nm.T @ Nm)
        # uniaxial compression sigma_xx = -1: per-component coupling
        # -dNi/dx dNj/dx, replicated over the 3 dof directions
        G += w * detJ * (-np.outer(dN[:, 0], dN[:, 0]))
    G24 = np.kron(G, np.eye(3))
    return K, M, G24


def girder_mesh(nc=40, spacing=6, hole_frac=0.10, seed=7,
                relabel=True):
    """Element connectivity of the stiffened box girder: an ``nc^3``
    cell grid keeping only cells on the orthogonal wall planes
    (``i % spacing == 0`` etc.), a fraction ``hole_frac`` of wall
    elements punched out at random, surviving nodes randomly relabeled.
    Returns (conn, n_nodes) with conn (nel, 8) node indices per hex8
    element, corner order matching ``_shape_derivs``."""
    nx = nc + 1
    rng = np.random.RandomState(seed)

    def node_id(i, j, k):
        return i + nx * (j + nx * k)

    ii, jj, kk = np.meshgrid(np.arange(nc), np.arange(nc), np.arange(nc),
                             indexing='ij')
    ei, ej, ek = ii.ravel(), jj.ravel(), kk.ravel()
    wall = (ei % spacing == 0) | (ej % spacing == 0) | (ek % spacing == 0)
    ei, ej, ek = ei[wall], ej[wall], ek[wall]
    keep = rng.rand(ei.size) >= hole_frac
    e0 = node_id(ei[keep], ej[keep], ek[keep])
    # corner order: x sign fastest, then y, then z (matches _CORNER_SIGNS)
    corner = np.array([node_id(i, j, k) for i in (0, 1) for j in (0, 1)
                       for k in (0, 1)], dtype=np.int64)
    conn = e0[:, None] + corner[None, :]
    used = np.zeros(nx ** 3, dtype=bool)
    used[conn.ravel()] = True
    n_nodes = int(used.sum())
    new_id = np.full(nx ** 3, -1, dtype=np.int64)
    order = (rng.permutation(n_nodes) if relabel
             else np.arange(n_nodes, dtype=np.int64))
    new_id[np.flatnonzero(used)] = order
    return new_id[conn], n_nodes


def assemble(conn, n_nodes, elem, elem_scale=None, bsr=False):
    """Assemble the (3 n_nodes, 3 n_nodes) global matrix from the 24x24
    element matrix ``elem`` over connectivity ``conn`` (nel, 8), with an
    optional per-element scalar ``elem_scale`` (material jitter).

    Block-level scheme — the per-(corner a, corner b) 3x3 blocks of
    ``elem`` are constant across elements up to ``elem_scale``, so the
    whole assembly reduces to one ``np.unique`` over the nel*64 node
    pairs plus 64 weighted bincounts; no 576*nel scalar COO is ever
    materialized.  Returns CSR (or the blocked BSR when ``bsr=True`` —
    the natural feed for the device BSR SpMM)."""
    nel = conn.shape[0]
    if elem_scale is None:
        elem_scale = np.ones(nel)
    # node-pair keys for all 64 (a, b) corner pairs
    keys = (conn[:, :, None] * np.int64(n_nodes)
            + conn[:, None, :]).reshape(nel, 64)
    uniq, inv = np.unique(keys, return_inverse=True)
    inv = inv.reshape(nel, 64)
    nnzb = uniq.size
    # accumulated element weight per (node pair, corner pair): one
    # bincount over all nel*64 contributions, then one matmul spreads
    # the 64 corner-pair weights through the 3x3 blocks of ``elem``
    comb = inv + np.arange(64, dtype=np.int64)[None, :] * nnzb
    w = np.bincount(comb.ravel(),
                    weights=np.repeat(elem_scale, 64),
                    minlength=64 * nnzb).reshape(nel and 64, nnzb).T
    blkvals = elem.reshape(8, 3, 8, 3).transpose(0, 2, 1, 3).reshape(64, 9)
    blocks = (w @ blkvals).reshape(nnzb, 3, 3)
    brow = (uniq // n_nodes).astype(np.int64)
    bcol = (uniq % n_nodes).astype(np.int64)
    indptr = np.searchsorted(brow, np.arange(n_nodes + 1))
    A = scs.bsr_matrix((blocks, bcol, indptr),
                       shape=(3 * n_nodes, 3 * n_nodes))
    return A if bsr else A.tocsr()


def fe_pencil(nc=40, spacing=6, hole_frac=0.10, seed=7, which='km',
              jitter=0.6, bsr=False, relabel=True):
    """Assembled pencil on the box-girder mesh.  ``which``: 'k' stiffness
    only, 'km' (K, M), 'kg' (K, G buckling).  ``jitter`` is the log-range
    of the per-element material scale (0 = uniform).  K is grounded SPD
    (light diagonal shift standing in for Dirichlet constraints)."""
    conn, n_nodes = girder_mesh(nc, spacing, hole_frac, seed,
                                relabel=relabel)
    rng = np.random.RandomState(seed + 1)
    scale = np.exp(rng.uniform(-jitter, jitter, conn.shape[0]))
    h = (1.0 / nc,) * 3
    Ke, Me, Ge = hex8_matrices(h)
    n = 3 * n_nodes
    out = []
    wanted = {'k': ('K',), 'km': ('K', 'M'), 'kg': ('K', 'G')}[which]
    for name in wanted:
        elem = {'K': Ke, 'M': Me, 'G': Ge}[name]
        A = assemble(conn, n_nodes, elem,
                     elem_scale=scale if name != 'M' else None,
                     bsr=bsr and name == 'K')
        if name == 'K':
            shift = 1e-3 * abs(Ke).max() * float(np.mean(scale))
            A = A + scs.identity(n, format=A.format) * shift
        out.append(A)
    return out[0] if which == 'k' else tuple(out)


def shipsec_like(seed=7, which='km', bsr=False, relabel=True):
    """The FE-class flagship: scattered-pattern elasticity pencil at
    shipsec1's scale and density (n ~ 140k dof, ~55 nnz/row).
    ``relabel=False`` keeps the mesher's natural node order (the
    locality a production numbering would have — what a tiled BSR
    layout consumes)."""
    return fe_pencil(39, 6, 0.10, seed, which=which, bsr=bsr,
                     relabel=relabel)


def buckling_64k(seed=11):
    """FE-class buckling pencil (K, G) at ~64k dof for the
    reference-parity buckling benchmark (panel_buckle class,
    reference README.md:22-25)."""
    return fe_pencil(31, 6, 0.10, seed, which='kg')


if __name__ == '__main__':
    import time
    t = time.time()
    K, M = shipsec_like()
    print('K: n=%d nnz=%d (%.2f/row)  %.1f s'
          % (K.shape[0], K.nnz, K.nnz / K.shape[0], time.time() - t))
