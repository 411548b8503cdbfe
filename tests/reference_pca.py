"""The spectrum of a dense PCA problem in float64 by plain PyTorch: the
data centred, its Gram matrix formed and ``torch.linalg.eigvalsh`` taken,
with TF32 off.  From the eigenvalues lambda_1 >= lambda_2 >= ... of the
centred Gram G: the singular values sigma_k = sqrt(lambda_k) of the
centred data and the optimal rank-k Frobenius error
e_opt = sqrt(trace(G) - sum_{j <= k} lambda_j) (Eckart-Young), which no
mean and rank-k factors can beat.  It shares no code with the program; the
benchmark holds a copy of it (``portbench/references/pca64.py``)."""

import numpy as np
import torch


def spectrum(a, npc, device):
    """{'sigma': the npc largest singular values of the centred ``a``
    (float64, descending), 'e_opt': the optimal rank-npc Frobenius error,
    'norm': the Frobenius norm of the centred ``a``}, computed on
    ``device``; ``a`` is a tensor or an array of rows."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = torch.as_tensor(a).to(device=device, dtype=torch.float64)
        x = x - torch.mean(x, dim=0, keepdim=True)
        g = x @ x.T if x.shape[0] <= x.shape[1] else x.T @ x
        del x
        lam = torch.flip(torch.linalg.eigvalsh(g), dims=(0,))
        trace = float(torch.trace(g))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    lam = np.maximum(lam.cpu().numpy(), 0.0)
    rest = max(trace - float(np.sum(lam[:npc])), 0.0)
    return {'sigma': np.sqrt(lam[:npc]), 'e_opt': float(np.sqrt(rest)),
            'norm': float(np.sqrt(trace))}
