"""Generate SyntheticShapes samples and save them with their keypoints
(port of ``cli/show_synthetic_images.py``).

    python -m xpoint_tpu_torch.cli.show_synthetic_images [-n 1] [-r 1]
        [-y CONFIG] [-m] [-o outputs]

The dataset section of ``-y`` (default: SyntheticShapes' defaults) draws
``-n`` samples; writes ``synthetic_<i>.png`` with a green circle at each
keypoint. ``-m`` raises TypeError, as in the JAX CLI (its tint is a tuple
times a float; the port keeps the defect). Sample i draws from its own
seeded generators (``data/seeding.py``), where the JAX CLI draws from the
global streams.
"""
import argparse
import os

import cv2
import numpy as np

from ..config import load_yaml
from ..data import SyntheticShapes


def main(argv=None):
    parser = argparse.ArgumentParser(description='Show synthetic samples')
    parser.add_argument('-n', dest='sample_number', type=int, default=1)
    parser.add_argument('-r', dest='radius', type=int, default=1)
    parser.add_argument('-y', dest='yaml', default=None)
    parser.add_argument('-m', dest='show_mask', action='store_true')
    parser.add_argument('-o', '--output-dir', default='outputs')
    args = parser.parse_args(argv)

    cfg = load_yaml(args.yaml).get('dataset', {}) if args.yaml else {}
    ds = SyntheticShapes(cfg)
    os.makedirs(args.output_dir, exist_ok=True)
    for i in range(args.sample_number):
        s = ds[i]
        im = cv2.cvtColor((np.clip(s['image'][..., 0], 0, 1) * 255)
                          .astype(np.uint8), cv2.COLOR_GRAY2BGR)
        for r, c in np.argwhere(s['keypoints']):
            cv2.circle(im, (int(c), int(r)), args.radius, (0, 255, 0), 1)
        if args.show_mask:
            invalid = ~s['valid_mask'].astype(bool)
            # as in the JAX CLI: (0, 0, 150) * 0.6 raises TypeError
            im[invalid] = im[invalid] * 0.4 + (0, 0, 150) * 0.6
        path = os.path.join(args.output_dir, f'synthetic_{i}.png')
        cv2.imwrite(path, im)
        print(f'wrote {path} ({int(s["keypoints"].sum())} keypoints)')


if __name__ == '__main__':
    main()
