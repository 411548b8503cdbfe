"""The least work of one dense PCA by subspace iteration on the centred
Gram (the program's ``interfaces/randomized.py::subspace_pca``), counted
from the shapes alone, whatever implements it: for m rows, n features,
npc components, l = min(npc + oversample, m) and iters power iterations,

* the centred Gram A A^T, symmetric: m (m + 1) n;
* each product at 2 rows inner cols: A mean (2 m n), iters + 2 products
  G q (2 m m l each), q^T (G q) and q w (2 m l l each), A^T u (2 n m npc);
* each of the iters + 1 Householder QRs of (m, l): 4 m l^2 - 4 l^3 / 3;
* ``eigh`` of (l, l) and the elementwise work left out.

12,000 x 39,375, npc 800, oversample 64, iters 6: 8,698,708,220,256 FLOP,
0.130 s at ``F32_PEAK``."""

# FP32 outside the tensor cores on an H100 SXM at its boost clock: 132 SMs
# x 128 FP32 lanes x 2 (fused multiply-add) x 1.98 GHz; NVIDIA's H100 data
# sheet rounds it to 67 TFLOP/s (at the full 700 W power limit)
F32_PEAK = 132 * 128 * 2 * 1.98e9


def flops(m, n, npc, oversample, iters):
    """The least FLOP count of one call (an integer)."""
    l = min(npc + oversample, m)
    products = (2 * m * n + (iters + 2) * 2 * m * m * l + 2 * (2 * l * m * l)
                + 2 * n * m * npc)
    qr = (iters + 1) * (4 * m * l * l - 4 * l ** 3 // 3)
    return m * (m + 1) * n + products + qr
