"""Draw exported keypoints on a dataset sample (port of
``cli/show_keypoints.py``).

    python -m xpoint_tpu_torch.cli.show_keypoints -d DATASET -k KEYPOINTS
        [-n 0] [-r 4] [-o outputs]

The dataset and the keypoint file are HDF5 or ``.npz`` files of named
groups (``data/group_file.py``); writes ``show_{optical,thermal}_<name>.png``
with a green circle at each keypoint, as the JAX CLI does.
"""
import argparse
import os

import cv2
import numpy as np

from ..data.group_file import open_group_file


def read_sample(path, index):
    """(name, optical, thermal) of member ``index`` (in name order); a
    member without a thermal image shows its optical one twice."""
    with open_group_file(path) as f:
        name = list(f.keys())[index]
        optical = np.asarray(f[name]['optical'])
        thermal = (np.asarray(f[name]['thermal']) if 'thermal' in f[name]
                   else optical)
    return name, optical, thermal


def read_keypoints(path, name):
    """(optical, thermal) keypoints of group ``name``: the per-side sets,
    or the one set for both."""
    with open_group_file(path) as f:
        grp = f[name]
        if 'keypoints_optical' in grp:
            return (np.asarray(grp['keypoints_optical']),
                    np.asarray(grp['keypoints_thermal']))
        kps = np.asarray(grp['keypoints'])
        return kps, kps


def draw(img, kps, radius):
    """A BGR uint8 image of ``img`` in [0, 1] with a circle at each (row,
    col) of ``kps`` (none for None)."""
    im = cv2.cvtColor((np.clip(img, 0, 1) * 255).astype(np.uint8),
                      cv2.COLOR_GRAY2BGR)
    if kps is not None:
        for r, c in kps:
            cv2.circle(im, (int(c), int(r)), radius, (0, 255, 0), 1)
    return im


def main(argv=None):
    parser = argparse.ArgumentParser(description='Show keypoints on a sample')
    parser.add_argument('-d', '--dataset-path', required=True)
    parser.add_argument('-k', '--keypoint-file', required=True)
    parser.add_argument('-n', dest='sample_number', type=int, default=0)
    parser.add_argument('-r', '--radius', default=4, type=int)
    parser.add_argument('-o', '--output-dir', default='outputs')
    args = parser.parse_args(argv)

    name, optical, thermal = read_sample(args.dataset_path,
                                         args.sample_number)
    kp_o, kp_t = read_keypoints(args.keypoint_file, name)
    os.makedirs(args.output_dir, exist_ok=True)
    for label, img, kps in (('optical', optical, kp_o),
                            ('thermal', thermal, kp_t)):
        path = os.path.join(args.output_dir, f'show_{label}_{name}.png')
        cv2.imwrite(path, draw(img, kps, args.radius))
        print(f'wrote {path} ({len(kps)} keypoints)')


if __name__ == '__main__':
    main()
