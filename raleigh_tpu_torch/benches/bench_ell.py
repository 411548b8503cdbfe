"""The ELL kernel, its plain version and the library call, timed in turns
on the finite-element flagship.

``shipsec_like()``'s stiffness matrix (n = 139,179, K = 80) in the FE-ELL
field's relabelled order and in the mesher's order, at every instantiation
chip_smoke's ``phase_ell`` runs (f32 values with an f32 operand at m = 8,
16, 32, a bf16 operand at m = 16, an f64 operand at the core block m = 8
with f32 and with f64 values): the kernel (``ops.spmm._ell_matmat``) held
equal to its plain version (``_ell_matmat_plain``) bit for bit (both sum
a row's terms in its order, one fused multiply-add a term), then the
kernel, the plain
version and ``torch.sparse.mm`` on the CSR tensor of the operand's type
timed in turns (plain, kernel, library, library, kernel, plain; the best
of two) with CUDA events over ``--reps`` launches, beside the bound (the
padded idx and val read once, x read once, y written once, over 3.35
TB/s) and the kernel's registers a thread and resident blocks an SM as
the card's runtime reports them (``ell_occupancy``).  One JSON line a
case.

Usage: python -m raleigh_tpu_torch.benches.bench_ell [--reps R]
       [--orders relabelled mesher]

It needs the card and raises without one.
"""

import argparse
import json

import numpy as np
import torch

from ..examples import fe_model as fe
from ..ops import spmm
from ..ops.spmm import EllMatrix, storage_device
from .timing import time_ms

PEAK_BYTES = 3.35e12
# (value dtype, operand dtype, m), as chip_smoke's phase_ell runs them
CASES = (('f32', 'f32', 16), ('f32', 'f32', 8), ('f32', 'f32', 32),
         ('f32', 'bf16', 16), ('f32', 'f64', 8), ('f64', 'f64', 8))
DTYPES = {'f32': torch.float32, 'bf16': torch.bfloat16, 'f64': torch.float64}


def library_fn(k_mat, xt):
    """``torch.sparse.mm`` of ``k_mat`` as a CSR tensor of xt's dtype, as
    a callable."""
    a = torch.sparse_csr_tensor(
        torch.from_numpy(k_mat.indptr.astype(np.int64)),
        torch.from_numpy(k_mat.indices.astype(np.int64)),
        torch.from_numpy(k_mat.data.astype(np.float64)).to(xt.dtype),
        size=k_mat.shape, device=xt.device)
    return lambda: torch.sparse.mm(a, xt)


def run_case(em, k_mat, key, m, reps, gen):
    """One case: the kernel held equal to its plain version, then the
    kernel, the plain version and the library call timed in turns; returns
    the case's record."""
    idx, val = em.idx, em.val
    n, k = idx.shape
    xt = torch.randn((n, m), generator=gen, device=idx.device,
                     dtype=torch.float64).to(DTYPES[key[1]])
    want = spmm._ell_matmat_plain(idx, val, xt)
    got = spmm._ell_matmat(idx, val, xt)
    if not torch.equal(got, want):
        raise SystemExit('bench_ell: %s %s m=%d: the kernel differs from '
                         'its plain version by %.3e'
                         % (key + (m, (got.double() - want.double())
                                   .abs().max().item())))
    fns = {'plain': lambda: spmm._ell_matmat_plain(idx, val, xt),
           'kernel': lambda: spmm._ell_matmat(idx, val, xt),
           'library': library_fn(k_mat, xt)}
    best = {}
    for name in ('plain', 'kernel', 'library', 'library', 'kernel',
                 'plain'):
        t = time_ms(fns[name], reps)
        best[name] = min(best.get(name, t), t)
    nbytes = (idx.numel() * 4 + val.numel() * val.element_size()
              + 2 * n * m * xt.element_size())
    return {'values': key[0], 'operand': key[1], 'm': m, 'n': n, 'k': k,
            'bound_ms': nbytes / PEAK_BYTES * 1e3, 'ms': best,
            'occupancy': spmm.ell_occupancy(*key, m)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--orders', nargs='+', default=['relabelled', 'mesher'])
    args = ap.parse_args(argv)
    if storage_device(None).type != 'cuda':
        raise SystemExit('bench_ell needs a CUDA device')
    gen = torch.Generator('cuda').manual_seed(21)
    print(torch.cuda.get_device_name(0))
    for order in args.orders:
        k_mat = fe.shipsec_like(which='k', relabel=order == 'relabelled')
        mats = {'f32': EllMatrix(k_mat),
                'f64': EllMatrix(k_mat, dtype=np.float64, exact=True)}
        for vdt, xdt, m in CASES:
            rec = run_case(mats[vdt], k_mat, (vdt, xdt), m, args.reps, gen)
            rec['order'] = order
            print(json.dumps(rec))
        del mats
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
