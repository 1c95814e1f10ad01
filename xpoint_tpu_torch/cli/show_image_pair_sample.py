"""Show an optical / thermal pair of a dataset side by side (port of
``cli/show_image_pair_sample.py``).

    python -m xpoint_tpu_torch.cli.show_image_pair_sample [-i FILE]
        [-k KEYPOINTS] [-n 0] [-r 4] [-o outputs]

The files are HDF5 or ``.npz`` files of named groups
(``data/group_file.py``); writes ``pair_<name>.png``, with the keypoints
drawn when a keypoint file is given, as the JAX CLI does.
"""
import argparse
import os

import cv2
import numpy as np

from .show_keypoints import draw, read_keypoints, read_sample


def main(argv=None):
    parser = argparse.ArgumentParser(description='Show an image pair sample')
    parser.add_argument('-i', '--input-file', default='/tmp/test.hdf5')
    parser.add_argument('-k', '--keypoint-file', default=None)
    parser.add_argument('-n', dest='sample_number', type=int, default=0)
    parser.add_argument('-r', '--radius', default=4, type=int)
    parser.add_argument('-o', '--output-dir', default='outputs')
    args = parser.parse_args(argv)

    name, optical, thermal = read_sample(args.input_file, args.sample_number)
    kp_o = kp_t = None
    if args.keypoint_file:
        kp_o, kp_t = read_keypoints(args.keypoint_file, name)
    os.makedirs(args.output_dir, exist_ok=True)
    out = np.concatenate([draw(optical, kp_o, args.radius),
                          draw(thermal, kp_t, args.radius)], axis=1)
    path = os.path.join(args.output_dir, f'pair_{name}.png')
    cv2.imwrite(path, out)
    print(f'wrote {path}')


if __name__ == '__main__':
    main()
