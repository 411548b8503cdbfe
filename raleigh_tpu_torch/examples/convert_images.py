"""Convert an LFW-style image folder into the eigenimages .npy workload.

The port's own copy of ``raleigh_tpu/examples/convert_images.py`` (NumPy
and PIL only; PIL is imported when an image is read).  Capability parity
with the reference's LFW converter
(reference raleigh/examples/eigenimages/convert_lfw.py:4-80): walk a
folder of per-person sub-folders of portrait images, convert to
grayscale, crop toward passport framing, optionally erase the
off-face background with an elliptical mask, optionally double the
dataset with mirror images, and optionally select near-symmetric
("passport-style") faces by how little each image differs from its
mirror.  The result is the ``(nimages, height, width)`` float32 array
``examples/eigenimages.py`` consumes via ``--data``.

Everything is a plain function over numpy arrays (the reference is one
top-to-bottom script), so the pipeline is unit-testable on synthetic
images without the LFW download; the CLI at the bottom reproduces the
reference's file outputs (images.npy / names.txt, photos.npy /
photo_names.txt).
"""

import os

import numpy as np

# ITU-R BT.601 luma weights (what the reference's grayscale conversion
# uses, convert_lfw.py:65-69)
_LUMA = np.array([0.2989, 0.587, 0.114], dtype=np.float32)

# passport-style crop keeps this central fraction of width / height
CROP_X, CROP_Y = 0.7, 0.9


def to_grayscale(image):
    """float32 grayscale of an (h, w[, 3|4]) image array."""
    image = np.asarray(image)
    if image.ndim == 2:
        return image.astype(np.float32)
    return image[:, :, :3].astype(np.float32) @ _LUMA


def load_image(path):
    """Read one image file into a float32 grayscale array."""
    from PIL import Image

    with Image.open(path) as im:
        return to_grayscale(np.asarray(im))


def face_mask(height, width):
    """Boolean (height, width) mask, True OUTSIDE the centered ellipse
    with semi-axes (width/2 - width/5, height/2 - height/6) — the
    off-face region the passport processing erases
    (reference convert_lfw.py:79-89, vectorized)."""
    x0, y0 = width / 2, height / 2
    ax, ay = x0 - width / 5, y0 - height / 6
    y, x = np.ogrid[:height, :width]
    return ((x - x0) / ax) ** 2 + ((y - y0) / ay) ** 2 > 1


def passport_crop(images):
    """Central (CROP_Y * h, CROP_X * w) crop of an (m, h, w) stack."""
    h, w = images.shape[-2:]
    iy = int(h * (1 - CROP_Y) / 2)
    ix = int(w * (1 - CROP_X) / 2)
    return images[..., iy: iy + int(h * CROP_Y), ix: ix + int(w * CROP_X)]


def erase_off_face(images, level):
    """Fill pixels outside the face ellipse with
    ``vmin + level * (vmax - vmin)`` of the stack's value range
    (reference convert_lfw.py:202-219).  In place; returns the stack."""
    vmin, vmax = float(images.min()), float(images.max())
    mask = face_mask(*images.shape[-2:])
    images[..., mask] = vmin + level * (vmax - vmin)
    return images


def asymmetry(images):
    """Per-image relative asymmetry: ||image - mirror|| / ||image||
    (reference convert_lfw.py:221-226), vectorized over the stack."""
    flat = images.reshape(images.shape[0], -1)
    mirr = images[:, :, ::-1].reshape(images.shape[0], -1)
    num = np.linalg.norm(flat - mirr, axis=1)
    den = np.linalg.norm(flat, axis=1)
    return num / np.maximum(den, np.finfo(np.float32).tiny)


def select_symmetric(images, threshold):
    """Indices of near-symmetric images: asymmetry <= threshold * max
    asymmetry when threshold > 0, <= -threshold * mean asymmetry when
    negative, the int(threshold) most symmetric when > 1 (the
    reference's --asymm selection semantics, convert_lfw.py:243-252)."""
    a = asymmetry(images)
    if threshold > 1:
        k = int(threshold)
        order = np.argsort(a)
        return np.sort(order[:k])
    th = a.max() * threshold if threshold > 0 else a.mean() * (-threshold)
    return np.nonzero(a <= th)[0]


def list_images(datapath, how_many=-1, extensions=('.jpg', '.jpeg',
                                                   '.png')):
    """(paths, names): image files under ``datapath``'s sub-folders in
    directory order, each labeled with its sub-folder (= person) name."""
    paths, names = [], []
    for subdir in sorted(os.listdir(datapath)):
        full = os.path.join(datapath, subdir)
        if not os.path.isdir(full):
            continue
        for fname in sorted(os.listdir(full)):
            if os.path.splitext(fname)[1].lower() in extensions:
                paths.append(os.path.join(full, fname))
                names.append(subdir)
                if 0 < how_many <= len(paths):
                    return paths, names
    return paths, names


def convert_images(datapath, how_many=-1, double=False, off_face=-1.0,
                   verb=0):
    """Convert an LFW-style folder into the eigenimages workload.

    Returns (images (ni, ny, nx) float32, names list of ni strings);
    ``double`` interleaves each image with its mirror (reference
    convert_lfw.py:183-232: original at even, mirror at odd indices);
    ``off_face`` >= 0 erases the background at that gray level.
    """
    paths, names = list_images(datapath, how_many)
    if not paths:
        raise ValueError('no images found under %s' % datapath)
    stack = np.stack([load_image(p) for p in paths])
    stack = np.ascontiguousarray(passport_crop(stack))
    if verb > 0:
        print('collected %d images of shape %s from %s'
              % (stack.shape[0], stack.shape[1:], datapath))
    if off_face >= 0:
        stack = erase_off_face(stack, off_face)
    if double:
        mirrored = np.empty((2 * stack.shape[0],) + stack.shape[1:],
                            dtype=stack.dtype)
        mirrored[0::2] = stack
        mirrored[1::2] = stack[:, :, ::-1]
        stack = mirrored
        names = [n for n in names for _ in range(2)]
    return stack, names


def _write_names(path, names):
    with open(path, 'w') as f:
        for n in names:
            f.write('%s\n' % n)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description='LFW-style folder -> eigenimages .npy workload')
    ap.add_argument('datapath', help='folder of per-person image folders')
    ap.add_argument('-m', '--how-many', type=int, default=-1,
                    help='number of images to process (<0: all)')
    ap.add_argument('-o', '--output', default='images.npy')
    ap.add_argument('-f', '--off-face', type=float, default=-1.0,
                    help='erase background at this gray level (>= 0)')
    ap.add_argument('-s', '--asymm', type=float, default=1.0,
                    help='also save near-symmetric photos.npy: keep '
                         'images with asymmetry <= s * max (s in (0, 1]), '
                         '<= -s * mean (s < 0), or the int(s) most '
                         'symmetric (s > 1)')
    ap.add_argument('-d', '--double', action='store_true',
                    help='double the dataset with mirror images')
    args = ap.parse_args(argv)

    images, names = convert_images(args.datapath, how_many=args.how_many,
                                   double=args.double,
                                   off_face=args.off_face, verb=1)
    print('pixel values range: %f to %f' % (images.min(), images.max()))
    np.save(args.output, images)
    _write_names('names.txt', names)
    print('saved %d images to %s' % (images.shape[0], args.output))
    if args.asymm != 1.0:
        keep = select_symmetric(images, args.asymm)
        np.save('photos.npy', images[keep])
        _write_names('photo_names.txt', [names[i] for i in keep])
        print('saved %d passport-style photos to photos.npy' % len(keep))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
