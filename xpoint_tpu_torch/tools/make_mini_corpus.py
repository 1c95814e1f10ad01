"""Generate the deterministic multispectral mini-corpus (port of
``tools/make_mini_corpus.py``).

    python -m xpoint_tpu_torch.tools.make_mini_corpus [--out data/mini_corpus]
        [--n-train 64] [--n-test 64] [--size 512] [--splits both]
        [--gap v1|v2]

Synthetic optical images (the drawing primitives over a blob background,
8-12 primitives an image) and pseudo-thermal partners with a photometric
gap: a per-image gamma remap, a 3 x 3 blur and speckle (``v1``), plus
dead-leaves backgrounds and region-level partial contrast inversion
(``v2``). The splits draw from ``np.random.default_rng(0)`` (train) and
``(1)`` (test), so either can be rewritten alone.

Each split is written as ``training.npz`` / ``test.npz``: one group
``sample_%04d`` a pair with float32 ``optical`` / ``thermal`` images in
[0, 1], the layout ``ImagePairDataset`` reads (``data/group_file.py``). The
arrays equal those of the JAX tool's HDF5 files bit for bit: where the JAX
tool seeds the global ``random`` / ``np.random`` streams per image, the
primitives here draw from a ``random.Random`` and a
``np.random.RandomState`` seeded alike.
"""
import argparse
import os
import random

import cv2
import numpy as np

from ..data import draw_primitives as dp
from ..data.group_file import write_npz_groups

GENERATORS = [dp.draw_lines, dp.draw_polygon, dp.draw_multiple_polygons,
              dp.draw_ellipses, dp.draw_star, dp.draw_checkerboard,
              dp.draw_stripes, dp.draw_cube]


def _primitive_streams(rng):
    """The generators of one image's primitives, seeded from ``rng``."""
    seed = int(rng.integers(2 ** 31))
    return np.random.RandomState(seed), random.Random(seed)


def _draw_primitives(img, rng, np_rng, py_rng):
    # 8-12 overlapping primitives an image (density calibrated in the JAX
    # tool with a SIFT + MAGSAC oracle under the committed eval warps)
    for _ in range(8 + int(rng.integers(5))):
        gen = GENERATORS[rng.integers(len(GENERATORS))]
        gen(img, np_rng, py_rng)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def optical_image(rng, shape=(512, 512)):
    np_rng, py_rng = _primitive_streams(rng)
    img = dp.generate_background(np_rng, py_rng, shape)
    return _draw_primitives(img, rng, np_rng, py_rng)


def pseudo_thermal(opt, rng):
    """Nonlinear spectral gap: per-image gamma remap + 3 x 3 blur + speckle
    (a VIS-NIR-like gap), normalised to [0, 1]."""
    g = 0.5 + 1.1 * rng.uniform()
    t = np.power(opt, g)
    t = cv2.GaussianBlur(t, (3, 3), 0)
    t = np.clip(t + rng.normal(0, 0.03, t.shape), 0, 1)
    lo, hi = t.min(), t.max()
    return ((t - lo) / max(hi - lo, 1e-6)).astype(np.float32)


def dead_leaves(rng, shape, n_disks=220):
    """Occluding disks with a power-law radius distribution (the
    dead-leaves model of natural image statistics)."""
    img = np.full(shape, 0.5, np.float32)
    H, W = shape
    rmin, rmax = 6.0, H / 3.0
    for _ in range(n_disks):
        # p(r) ~ r^-3 on [rmin, rmax] via inverse-CDF sampling
        u = rng.uniform()
        r = (rmin ** -2 + u * (rmax ** -2 - rmin ** -2)) ** -0.5
        c = (int(rng.integers(W)), int(rng.integers(H)))
        col = float(rng.uniform(0.1, 0.9))
        cv2.circle(img, c, int(r), col, -1)
    img = cv2.GaussianBlur(img, (3, 3), 0)
    return img


def optical_image_v2(rng, shape=(512, 512)):
    """v2 optical: dead-leaves base + the primitive overlay."""
    np_rng, py_rng = _primitive_streams(rng)
    base = dead_leaves(rng, shape)
    img = dp.generate_background(np_rng, py_rng, shape)
    img = 0.5 * img + 0.5 * base
    return _draw_primitives(img, rng, np_rng, py_rng)


def partial_inversion_mask(rng, shape, blur_frac=0.12):
    """Smooth random field in [0, 1] with ~half the area above 0.5: the
    regions whose intensity polarity flips."""
    H, W = shape
    small = rng.normal(size=(8, 8)).astype(np.float32)
    field = cv2.resize(small, (W, H), interpolation=cv2.INTER_CUBIC)
    k = int(blur_frac * H) | 1
    field = cv2.GaussianBlur(field, (k, k), 0)
    med = float(np.median(field))
    scale = max(float(field.std()), 1e-6) * 0.35
    return 1.0 / (1.0 + np.exp(-(field - med) / scale))


def pseudo_thermal_v2(opt, rng):
    """v2 gap: region-level partial contrast inversion on top of the v1
    gamma / blur / speckle gap."""
    g = 0.5 + 1.1 * rng.uniform()
    t = np.power(opt, g)
    m = partial_inversion_mask(rng, t.shape)
    t = m * (1.0 - t) + (1.0 - m) * t
    t = cv2.GaussianBlur(t, (3, 3), 0)
    t = np.clip(t + rng.normal(0, 0.03, t.shape), 0, 1)
    lo, hi = t.min(), t.max()
    return ((t - lo) / max(hi - lo, 1e-6)).astype(np.float32)


def split_groups(n, rng, shape=(512, 512), gap='v1'):
    """The pairs of one split, one (name, {optical, thermal}) at a time."""
    make_opt = optical_image_v2 if gap == 'v2' else optical_image
    make_th = pseudo_thermal_v2 if gap == 'v2' else pseudo_thermal
    for i in range(n):
        opt = make_opt(rng, shape)
        th = make_th(opt, rng)
        yield f"sample_{i:04d}", {'optical': opt, 'thermal': th}


def write_split(path, n, rng, shape=(512, 512), gap='v1'):
    write_npz_groups(path, split_groups(n, rng, shape, gap))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', default='data/mini_corpus')
    ap.add_argument('--n-train', type=int, default=64)
    ap.add_argument('--n-test', type=int, default=64)
    ap.add_argument('--size', type=int, default=512)
    ap.add_argument('--gap', choices=('v1', 'v2'), default='v1',
                    help="spectral gap: 'v1' = gamma+blur+speckle "
                         "(VIS-NIR-like, the committed benchmark), 'v2' = "
                         "v1 + dead-leaves backgrounds + region-level "
                         "partial contrast INVERSION (optical<->thermal-"
                         "like)")
    ap.add_argument('--splits', choices=('both', 'train', 'test'),
                    default='both',
                    help='which split(s) to (re)write; the splits use '
                         'independent rng seeds (train 0, test 1), so the '
                         'test set can be regenerated or enlarged without '
                         'invalidating training.npz or its HA labels')
    return ap.parse_args(argv)


def main(argv=None):
    from ..cli._common import report_at_exit
    args = parse_args(argv)
    report_at_exit('make_mini_corpus')
    os.makedirs(args.out, exist_ok=True)
    shape = (args.size, args.size)
    if args.splits in ('both', 'train'):
        write_split(os.path.join(args.out, 'training.npz'), args.n_train,
                    np.random.default_rng(0), shape, args.gap)
    if args.splits in ('both', 'test'):
        write_split(os.path.join(args.out, 'test.npz'), args.n_test,
                    np.random.default_rng(1), shape, args.gap)
    print(f"mini corpus written to {args.out} "
          f"({args.n_train} train / {args.n_test} test pairs @{args.size}, "
          f"splits={args.splits}, gap={args.gap})")


if __name__ == '__main__':
    main()
