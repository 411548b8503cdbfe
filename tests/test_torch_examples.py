"""The port's device trace and face-image examples on the CPU, against
the JAX package's.

``utils/profiling.py``: ``device_trace`` writes a ``torch.profiler`` trace
(its spans: ``tests/test_torch_profiling.py``).
``examples/convert_images.py``: the same images, names and selections as
the JAX package's converter on one synthetic folder (exact: NumPy only).
``examples/eigenimages.py``: ``ImageProbe``'s truncation errors and
``show_errors``' per-image errors equal to the JAX package's on the same
inputs (1e-12 relative: the same NumPy code); the interactive workflow of
``tests/test_examples.py:20`` through the port's ``pca(method='jacobi')``;
``run()`` on a saved image file against the JAX package's ``run()`` (the
subspace engine in both, different random starts: mean within 1e-6 and
``trans @ comps`` within 1e-3 of its largest |entry|, the limits of
``tests/test_sharded.py:288`` tightened for the mean); ``synthetic()`` at a
small size.  Images are synthetic and written to ``tmp_path``.
"""

import json
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from raleigh_tpu.examples import convert_images as jci
from raleigh_tpu.examples import eigenimages as jei
from raleigh_tpu_torch.core.solver import Options
from raleigh_tpu_torch.examples import convert_images as tci
from raleigh_tpu_torch.examples import eigenimages as tei
from raleigh_tpu_torch.examples.generate_matrix import generate
from raleigh_tpu_torch.interfaces.pca import pca
from raleigh_tpu_torch.interfaces.truncated_svd import UserStoppingCriteria
from raleigh_tpu_torch.utils import profiling as tprof

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One OpenBLAS thread for NumPy and SciPy inside these tests, for the
    same reason, restored after each test."""
    with threadpool_limits(1):
        yield


def test_device_trace_writes_a_trace(tmp_path):
    """A torch.profiler trace of the block (host activity here, the card's
    kernels too where there is one) in the named directory."""
    logdir = str(tmp_path / 'trace')
    with tprof.device_trace(logdir) as prof:
        torch.matmul(torch.ones(64, 64), torch.ones(64, 64))
    with open(os.path.join(logdir, 'trace.json')) as f:
        events = json.load(f)['traceEvents']
    assert any('matmul' in e.get('name', '') for e in events)
    assert any('matmul' in e.key for e in prof.key_averages())


def _write_synthetic_faces(root, npeople=3, per_person=2, h=25, w=20):
    """Tiny LFW-style tree: per-person folders of RGB images with a
    bright centered 'face' blob on a textured background (the images of
    tests/test_examples.py)."""
    from PIL import Image

    rng = np.random.RandomState(7)
    y, x = np.mgrid[:h, :w]
    for p in range(npeople):
        d = root / ('person_%d' % p)
        d.mkdir()
        for i in range(per_person):
            blob = 200.0 * np.exp(-(((x - w / 2 - p) / (w / 4)) ** 2
                                    + ((y - h / 2) / (h / 3)) ** 2))
            img = blob + 40.0 * rng.rand(h, w)
            rgb = np.stack([img, img, img], axis=-1).astype(np.uint8)
            Image.fromarray(rgb).save(str(d / ('%04d.png' % i)))
    return npeople * per_person


@pytest.mark.parametrize('double,off_face', [(True, 0.0), (False, -1.0),
                                             (False, 0.5)])
def test_convert_images_matches_jax(tmp_path, double, off_face):
    """tests/test_examples.py:138 on both packages: grayscale and passport
    crop, off-face masking, mirror doubling, asymmetry and the symmetric
    selection, equal array for array."""
    n = _write_synthetic_faces(tmp_path)
    got, names = tci.convert_images(str(tmp_path), double=double,
                                    off_face=off_face)
    want, jnames = jci.convert_images(str(tmp_path), double=double,
                                      off_face=off_face)
    assert names == jnames and got.dtype == np.float32
    assert np.array_equal(got, want)
    assert got.shape[0] == (2 if double else 1) * n
    assert got.shape[1:] == (int(25 * 0.9), int(20 * 0.7))
    if double:
        assert np.array_equal(got[1], got[0][:, ::-1])
    assert np.array_equal(tci.asymmetry(got), jci.asymmetry(want))
    for threshold in (4.0, 1.0 - 1e-12, -1.0, 0.5):
        assert np.array_equal(tci.select_symmetric(got, threshold),
                              jci.select_symmetric(want, threshold))
    assert np.array_equal(tci.face_mask(30, 20), jci.face_mask(30, 20))


def test_convert_images_cli(tmp_path, monkeypatch):
    """tests/test_examples.py:166 on the port: the CLI writes images.npy,
    names.txt and, with an asymmetry selection, photos.npy."""
    _write_synthetic_faces(tmp_path, npeople=2, per_person=2)
    out = tmp_path / 'out'
    out.mkdir()
    monkeypatch.chdir(out)
    rc = tci.main([str(tmp_path), '-o', 'images.npy', '-f', '0.5',
                   '-s', '-2.0', '-m', '3'])
    assert rc == 0
    images = np.load('images.npy')
    assert images.shape[0] == 3
    with open('names.txt') as f:
        assert len(f.read().split()) == 3
    photos = np.load('photos.npy')
    assert 1 <= photos.shape[0] <= 3


def test_eigenimages_interactive_probe(monkeypatch, tmp_path):
    """tests/test_examples.py:20 on the port: help, image inspection,
    tolerance handover and quit, via monkeypatched stdin, through the
    port's pca(method='jacobi') on the CPU; the probe's truncation errors
    equal the JAX package's ImageProbe's on the same factors."""
    np.random.seed(1)
    data, *_ = generate(300, 200, 100, pca=True)
    images = data.reshape(300, 20, 10)
    answers = iter(['h', 's 0 3', '', 't 0.25', 'q'])
    monkeypatch.setattr('builtins.input', lambda msg: next(answers, 'q'))
    monkeypatch.chdir(tmp_path)
    probe = tei.ImageProbe(images)
    opt = Options()
    opt.block_size = 16
    opt.stopping_criteria = UserStoppingCriteria(data, shift=True,
                                                 probe=probe)
    mean, trans, comps = pca(data, opt=opt, method='jacobi', device='cpu')
    assert comps.shape[0] >= 16
    assert probe.errors[-1][1] < 0.25
    assert os.path.exists('probe_image_0.npy')
    assert os.path.exists('probe_approx_3.npy')
    jprobe = jei.ImageProbe(images)
    assert np.array_equal(probe.nrms, jprobe.nrms)
    sigma = np.linalg.norm(trans, axis=0)
    left = trans / sigma[None, :]
    got = probe._truncation_error(sigma, left)
    assert abs(got - jprobe._truncation_error(sigma, left)) <= 1e-12 * got


def test_eigenimages_show_errors_matches_jax(tmp_path, capsys):
    """tests/test_examples.py:53: per-image PCA error statistics from a
    saved npz, the same as the JAX package's on the same file."""
    np.random.seed(1)
    data, *_ = generate(300, 200, 100, pca=True)
    mean, trans, comps = pca(data, npc=40, device='cpu')
    npz = tmp_path / 'ei.npz'
    np.savez(npz, mean=mean, trans=trans, comps=comps)
    errs = tei.show_errors(data, str(npz), plot=False)
    assert errs.shape == (300,) and np.median(errs) < 0.5
    assert 'per-image relative errors' in capsys.readouterr().out
    jerrs = jei.show_errors(data, str(npz), plot=False)
    assert np.abs(errs - jerrs).max() <= 1e-12 * np.abs(jerrs).max()


def test_eigenimages_run_matches_jax(tmp_path, monkeypatch):
    """run() on an image file (300 images of 20 x 10) through the subspace
    engine in both packages: the same mean and rank-20 approximation."""
    np.random.seed(1)
    data, *_ = generate(300, 200, 100, pca=True)
    src = tmp_path / 'images.npy'
    np.save(src, data.reshape(300, 20, 10).astype(np.float32))
    monkeypatch.chdir(tmp_path)
    tei.run(20, str(src), device='cpu')
    got = dict(np.load(tmp_path / 'eigenimages.npz'))
    jei.run(20, str(src), arch='tpu')
    want = np.load(tmp_path / 'eigenimages.npz')
    assert got['comps'].shape == want['comps'].shape == (20, 200)
    assert np.abs(got['mean'] - want['mean']).max() < 1e-6
    r, r2 = got['trans'] @ got['comps'], want['trans'] @ want['comps']
    assert np.abs(r - r2).max() / np.abs(r2).max() < 1e-3


def test_synthetic_image_set_small():
    """synthetic(): an f32 set of the asked shape from a seeded generator,
    the same for the same seed, its column mean carrying the constant
    leading direction."""
    a = tei.synthetic(60, 90, rank=16, device='cpu')
    b = tei.synthetic(60, 90, rank=16, device='cpu')
    c = tei.synthetic(60, 90, rank=16, seed=2, device='cpu')
    assert a.shape == (60, 90) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    # rank 16 plus noise 1e-4: the noise's singular values stay below
    # 1e-4 (sqrt(m) + sqrt(n)), twice over
    s = torch.linalg.svdvals(a.double())
    assert s[16] < 2e-4 * (60 ** 0.5 + 90 ** 0.5) < 0.1 * s[15]
