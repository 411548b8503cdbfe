"""The synthetic eigenimages matrix of the dense PCA cell, made on the
device from the seed: the recipe of upstream RALEIGH's
examples/pca/generate_matrix.py:33-36 as the repository's root bench.py
draws it (``make_data``), with a ``torch.Generator``.

A = (u diag(s) / sqrt(m)) (v / sqrt(n)) + noise e, with u (m, rank) and v
(rank, n) standard normal, u's first column set to ones (a direction that
centring removes), s_k = k^-alpha and e standard normal: f32, rank
``rank`` plus a dense noise floor (noise 1e-5 puts it near 3e-3, below
s_2048)."""

import torch

# rows of noise drawn at a time, so that the noise never needs a second
# copy of A
_CHUNK = 1024


def make(params, seed):
    """{'A': the (m, n) f32 matrix on ``params['device']`` (the card where
    it names none)} for run seed ``seed``."""
    dev = torch.device(params.get('device', 'cuda'))
    m, n, rank = params['m'], params['n'], params['rank']
    gen = torch.Generator(dev).manual_seed(int(seed))
    u = torch.randn((m, rank), generator=gen, device=dev)
    u[:, 0] = 1.0
    v = torch.randn((rank, n), generator=gen, device=dev)
    k = torch.arange(1, rank + 1, dtype=torch.float32, device=dev)
    s = k ** -float(params['alpha'])
    a = torch.matmul(u * (s / m ** 0.5), v / n ** 0.5)
    del u, v
    for lo in range(0, m, _CHUNK):
        rows = a[lo:lo + _CHUNK]
        rows.add_(torch.randn(rows.shape, generator=gen, device=dev),
                  alpha=float(params['noise']))
    return {'A': a}
