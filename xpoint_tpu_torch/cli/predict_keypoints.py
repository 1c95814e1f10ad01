"""Predict keypoints on dataset samples, with the repeatability evaluation
(``-e``) and the keypoint images (``-p``) (port of
``cli/predict_keypoints.py``, the reference predict_keypoints.py).

    python -m xpoint_tpu_torch.cli.predict_keypoints -y CONFIG.yaml \\
        -m MODEL_DIR [-v latest] [-i INDEX] [-e] [-t 3] [-mask] [-p] \\
        [-o outputs] [--device cuda]

Without ``-e``: the keypoints of both spectra of sample ``INDEX`` (NMS and
threshold of the config's prediction section; ``-mask`` keeps those inside
the sample's valid masks), and with ``-p`` one PNG a spectrum with the
keypoints drawn. With ``-e``: the repeatability at ``-t`` px over the
dataset, written to ``OUTPUT_DIR/repeatability.json`` with the JAX
package's keys. Runs on the card unless ``--device`` says otherwise.
"""
import argparse
import json
import os

import numpy as np

from ._common import load_eval_setup, report_at_exit, set_seeds


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Predict keypoints')
    parser.add_argument('-y', '--yaml-config', default='configs/cipdp.yaml')
    parser.add_argument('-m', '--model-dir', default='model_weights/xpoint')
    parser.add_argument('-v', '--version', default='latest')
    parser.add_argument('-i', '--index', default=0, type=int)
    parser.add_argument('-r', '--radius', default=4, type=int)
    parser.add_argument('-p', dest='plot', action='store_true')
    parser.add_argument('-e', dest='evaluation', action='store_true')
    parser.add_argument('-b', dest='batch', action='store_true')
    parser.add_argument('-t', dest='threshold', default=3, type=int,
                        help='Keypoint match distance threshold')
    parser.add_argument('-mask', dest='mask', action='store_true')
    parser.add_argument('-s', '--seed', default=0, type=int)
    parser.add_argument('-o', '--output-dir', default='outputs')
    parser.add_argument('--device', default='cuda',
                        help='torch device of the model (default: cuda)')
    return parser.parse_args(argv)


def main(argv=None):
    """With ``-e`` returns the repeatability dict written; else the
    keypoints (optical, thermal) of the sample."""
    args = parse_args(argv)
    report_at_exit('predict_keypoints')
    set_seeds(args.seed)

    config, _, infer, dataset = load_eval_setup(
        args, single_image_override=False)

    from ..data import DataLoader
    from ..eval.evaluation import compute_repeatability_multispectral

    if args.evaluation:
        loader = DataLoader(dataset, batch_size=1, shuffle=False)
        mean_rep, reps, n_kp_o, n_kp_t = compute_repeatability_multispectral(
            infer, loader, config, distance_thresh=args.threshold,
            verbose=True)
        print(f"repeatability@{args.threshold}px: {mean_rep:.4f} "
              f"(mean kp optical {np.mean(n_kp_o):.1f}, "
              f"thermal {np.mean(n_kp_t):.1f})")
        os.makedirs(args.output_dir, exist_ok=True)
        out = {'repeatability': mean_rep,
               'per_sample': list(map(float, reps)),
               'n_kp_optical': n_kp_o, 'n_kp_thermal': n_kp_t}
        with open(os.path.join(args.output_dir, 'repeatability.json'),
                  'w') as f:
            json.dump(out, f)
        return out

    sample = dataset[args.index]
    img_o = np.asarray(sample['optical']['image'])[None]
    img_t = np.asarray(sample['thermal']['image'])[None]
    prob_o, prob_t, _, _, _ = infer.forward_pair(img_o, img_t)
    prob_o_raw, prob_t_raw = prob_o, prob_t
    prob_o = infer.nms(prob_o)
    prob_t = infer.nms(prob_t)
    mask_o = np.asarray(sample['optical']['valid_mask'], np.float32) \
        if args.mask else None
    mask_t = np.asarray(sample['thermal']['valid_mask'], np.float32) \
        if args.mask else None
    kp_o = infer.keypoints_from_prob(prob_o[0], mask_o,
                                     prob_raw=prob_o_raw[0])
    kp_t = infer.keypoints_from_prob(prob_t[0], mask_t,
                                     prob_raw=prob_t_raw[0])
    print(f"sample {args.index}: {len(kp_o)} optical / {len(kp_t)} thermal "
          f"keypoints")

    if args.plot:
        import cv2
        os.makedirs(args.output_dir, exist_ok=True)
        for name, img, kp in (('optical', img_o, kp_o),
                              ('thermal', img_t, kp_t)):
            im = cv2.cvtColor(
                (np.clip(img[0, ..., 0], 0, 1) * 255).astype(np.uint8),
                cv2.COLOR_GRAY2BGR)
            for r, c in kp:
                cv2.circle(im, (int(c), int(r)), args.radius, (0, 255, 0), 1)
            path = os.path.join(args.output_dir,
                                f"keypoints_{name}_i{args.index}.png")
            cv2.imwrite(path, im)
            print(f"wrote {path}")
    return kp_o, kp_t


if __name__ == '__main__':
    main()
