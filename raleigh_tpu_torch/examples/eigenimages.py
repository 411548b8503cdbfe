"""Eigenimages (LFW-class) PCA workload — the reference README's headline
dense benchmark (reference examples/eigenimages/compute_eigenimages.py and
icompute_eigenimages.py).  PyTorch port of
``raleigh_tpu/examples/eigenimages.py``.

Usage:
    python -m raleigh_tpu_torch.examples.eigenimages [npc] [data.npy|synthetic]
        [device] [batch]

With 'synthetic' (default — the LFW download needs network access) a matrix
of the LFW eigenimages shape (12000 x 39375) with the reference generator's
k**-0.75 singular decay is made on the card from a seeded
``torch.Generator`` (it cannot reproduce ``jax.random``'s draws: the two
packages' synthetic sets differ, and their results are compared on one
NumPy input instead).  Pass a .npy file of shape (nimages, height*width) —
e.g. the reference's converted lfwdf_wmi_175x225_fa_12K.npy — to run on
real data.  Everything runs on the card unless ``device`` names another
('cpu').  Results are saved to eigenimages.npz (mean, trans, comps) for
reuse, mirroring the reference's numpy.savez persistence
(compute_eigenimages.py:116-119).  matplotlib is optional: without a
display the image pairs are saved as .npy files.
"""

import math
import sys
import time

import numpy as np


if __package__ in (None, ''):     # runnable as a plain script
    import os as _os
    import sys as _sys
    _sys.path.insert(0, _os.path.join(
        _os.path.dirname(_os.path.abspath(__file__)), '..', '..'))


def synthetic(m=12000, n=39375, rank=2048, seed=1, device=None):
    """The (m, n) f32 image set as a tensor on ``device`` (the card unless
    it names another): rank-``rank`` factors with k^-0.75 singular decay,
    the first column of the left factor ones (a PCA-invariant leading
    direction), plus noise 1e-4, drawn from a ``torch.Generator`` seeded
    with ``seed`` on that device."""
    import torch
    from raleigh_tpu_torch.ops.spmm import storage_device

    dev = storage_device(device)
    gen = torch.Generator(dev).manual_seed(int(seed))
    u = torch.randn((m, rank), generator=gen, device=dev)
    u[:, 0] = 1.0
    v = torch.randn((rank, n), generator=gen, device=dev)
    s = torch.arange(1, rank + 1, dtype=torch.float32, device=dev) ** -0.75
    a = torch.matmul(u * (s / math.sqrt(m)), v / math.sqrt(n))
    a.add_(torch.randn((m, n), generator=gen, device=dev), alpha=1e-4)
    if a.is_cuda:
        torch.cuda.synchronize(dev)
    return a


def _centered_row_norms(data2d):
    """Row norms of data - e*mean without materializing the centered
    matrix: ||a_i - c||^2 = ||a_i||^2 - 2 a_i.c + ||c||^2."""
    mean = data2d.mean(axis=0)
    t = np.linalg.norm(data2d, axis=1)
    s = data2d @ mean
    return np.sqrt(np.abs(t * t - 2 * s + mean @ mean))


def _render_image_pair(index, image, approx, shape2d):
    """Show an image next to its PCA approximation.  Uses matplotlib
    when importable; headless environments get the pair saved as .npy
    plus a printed error summary instead."""
    if shape2d is not None:
        image = image.reshape(shape2d)
        approx = approx.reshape(shape2d)
    rel = np.linalg.norm(approx - image) / max(np.linalg.norm(image),
                                               1e-30)
    shown = False
    try:
        import matplotlib
        # a non-GUI backend (Agg & friends) would drop the figures on
        # the floor — treat it as headless and persist instead
        if 'agg' not in matplotlib.get_backend().lower():
            import matplotlib.pyplot as plt
            for title, img in (('image %d' % index, image),
                               ('PCA approximation of image %d' % index,
                                approx)):
                plt.figure()
                plt.title(title)
                plt.imshow(img, cmap='gray')
            plt.show()
            shown = True
    except Exception:
        pass
    if not shown:                                  # headless: persist
        np.save('probe_image_%d.npy' % index, image)
        np.save('probe_approx_%d.npy' % index, approx)
        print('image %d: relative approximation error %.2e '
              '(pair saved as probe_image_%d.npy / probe_approx_%d.npy)'
              % (index, rel, index, index))
    return rel


class ImageProbe:
    """Interactive monitor for the eigenimages computation (capability of
    reference icompute_eigenimages.py:63-186 ``Probe``).

    Plugged into ``UserStoppingCriteria``, ``inspect`` runs after every
    converged batch.  Commands at the prompt:
        q               stop the computation
        s i1 [i2 ...]   show/inspect the listed images vs their current
                        PCA approximations ('s' alone repeats the last
                        selection)
        t tol           hand over to non-interactive mode until the
                        relative Frobenius truncation error drops below
                        tol (then return to the prompt)
        h               help; anything else computes more eigenimages
    """

    def __init__(self, images):
        self.images = np.asarray(images)
        m = self.images.shape[0]
        self.shape2d = (self.images.shape[1:]
                        if self.images.ndim == 3 else None)
        self.data2d = self.images.reshape(m, -1)
        self.nrms = _centered_row_norms(self.data2d)
        self.tol = 0.0
        self.selection = None
        self.greeted = False
        self.errors = []

    def _truncation_error(self, sigma, left):
        captured = np.linalg.norm(left * sigma[None, :], axis=1)
        resid = np.maximum(self.nrms ** 2 - captured ** 2, 0.0)
        return math.sqrt(np.sum(resid) / max(np.sum(self.nrms ** 2),
                                             1e-30))

    def _show(self, tokens, mean, sigma, left, right):
        picks = tokens or self.selection
        if not picks:
            print('usage: s im1 [im2 ...]')
            return
        u = left * sigma[None, :]
        for tok in picks:
            i = int(tok)
            if not 0 <= i < left.shape[0]:
                continue
            approx = u[i] @ right.T + np.reshape(mean, (-1,))
            _render_image_pair(i, self.data2d[i], approx, self.shape2d)
        self.selection = picks

    def inspect(self, mean, sigma, left, right):
        k = sigma.shape[0]
        err = self._truncation_error(sigma, left)
        self.errors.append((k, err))
        msg = 'sigma[%d] = %.1e*sigma[0], truncation error %.1e' \
            % (k - 1, sigma[-1] / sigma[0], err)
        if self.tol > 0:
            print(msg)
            if err >= self.tol:
                return False
            self.tol = 0.0                 # reached: back to interactive
        while True:
            if not self.greeted:
                print('answer h to the prompt below for usage help')
                self.greeted = True
            words = input(msg + ' h|q|s|t> ').split()
            if not words:
                return False
            cmd = words[0]
            if cmd == 'q':
                return True
            if cmd == 'h':
                print(self.__doc__)
                continue
            if cmd == 's':
                self._show(words[1:], mean, sigma, left, right)
                continue
            if cmd == 't' and len(words) > 1:
                self.tol = float(words[1])
            return False


def show_errors(images, eigenimages='eigenimages.npz', plot=True):
    """Compare images with their saved PCA approximation (capability of
    reference examples/eigenimages/show_errors.py): per-image relative
    error statistics, printed (and plotted when matplotlib is around).

    ``images``: array or .npy path; ``eigenimages``: .npz path or dict
    with mean/trans/comps.  Returns the per-image relative errors."""
    if isinstance(images, str):
        images = np.load(images)
    data = np.asarray(images).reshape(np.asarray(images).shape[0], -1)
    ei = np.load(eigenimages) if isinstance(eigenimages, str) \
        else eigenimages
    mean = np.reshape(ei['mean'], (1, -1))
    trans, comps = ei['trans'], ei['comps']
    m = min(data.shape[0], trans.shape[0])
    sigma = np.linalg.norm(trans[:m], axis=0)
    print('%d eigenimages loaded, sigma[0]=%.3e sigma[-1]=%.3e'
          % (comps.shape[0], sigma[0], sigma[-1]))
    approx = trans[:m] @ comps + mean
    errs = np.linalg.norm(approx - data[:m], axis=1) \
        / np.maximum(np.linalg.norm(data[:m] - mean, axis=1), 1e-30)
    order = np.argsort(errs)
    print('per-image relative errors: median %.2e, 90%% %.2e, max %.2e '
          '(image %d)' % (np.median(errs),
                          errs[order[int(0.9 * (m - 1))]],
                          errs[order[-1]], order[-1]))
    if plot:
        try:
            import matplotlib.pyplot as plt
            plt.figure()
            plt.loglog(np.arange(1, sigma.size + 1), sigma)
            plt.grid(); plt.title('singular values')
            plt.figure()
            plt.hist(errs, bins=50)
            plt.title('per-image relative PCA errors')
            plt.show()
        except Exception:
            pass                              # headless: stats only
    return errs


def run(npc=800, source='synthetic', arch=None, batch=None, verb=0,
        interactive=False, device=None):
    """PCA of the image set (``source``: 'synthetic' or a .npy path) on the
    card unless ``device`` names another device or ``arch='cpu'`` asks for
    the host algebra; the factors saved to eigenimages.npz.  Returns the
    seconds the PCA took."""
    from raleigh_tpu_torch.interfaces.pca import pca
    from raleigh_tpu_torch.core.solver import Options
    from raleigh_tpu_torch.interfaces.truncated_svd import (
        UserStoppingCriteria)

    if source == 'synthetic':
        data = synthetic(device='cpu' if arch == 'cpu' and device is None
                         else device)
    else:
        data = np.load(source, mmap_mode='r' if batch else None)
        m = data.shape[0]
        data = np.reshape(data, (m, -1))
    print('images: %s x %s' % (data.shape[0], data.shape[1]))

    start = time.time()
    if interactive:
        # the user decides when enough eigenimages have been computed,
        # inspecting approximations along the way (reference
        # icompute_eigenimages.py workflow)
        data = data.cpu().numpy() if hasattr(data, 'cpu') \
            else np.asarray(data)
        opt = Options()
        opt.stopping_criteria = UserStoppingCriteria(
            data, shift=True, probe=ImageProbe(data))
        mean, trans, comps = pca(data, opt=opt, arch=arch, verb=verb,
                                 method='jacobi', device=device)
    else:
        mean, trans, comps = pca(data, npc=npc, batch_size=batch,
                                 arch=arch, verb=verb, device=device)
    elapsed = time.time() - start
    where = arch if arch == 'cpu' and device is None else (device or 'cuda')
    print('%d eigenimages in %.1f s (%s)' % (comps.shape[0], elapsed, where))
    np.savez('eigenimages', mean=mean, trans=trans, comps=comps)
    print('saved to eigenimages.npz')
    return elapsed


if __name__ == '__main__':
    a = sys.argv[1:]
    if a and a[0] == 'errors':
        show_errors(a[1], a[2] if len(a) > 2 else 'eigenimages.npz')
        sys.exit(0)
    interactive = 'interactive' in a
    a = [x for x in a if x != 'interactive']
    npc = int(a[0]) if a else 800
    source = a[1] if len(a) > 1 else 'synthetic'
    where = a[2] if len(a) > 2 else None
    batch = int(a[3]) if len(a) > 3 else None
    run(npc, source, arch='cpu' if where == 'host' else None, batch=batch,
        interactive=interactive, device=None if where == 'host' else where)
