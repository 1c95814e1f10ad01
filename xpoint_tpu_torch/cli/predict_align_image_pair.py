"""Detect, describe, match and register an optical / thermal pair (port of
``cli/predict_align_image_pair.py``, the reference
predict_align_image_pair.py).

    python -m xpoint_tpu_torch.cli.predict_align_image_pair -y CONFIG.yaml \\
        -m MODEL_DIR [-v latest] [-i INDEX] [-e] [-tk 4] [-th 1] [-p] \\
        [-o outputs] [--device cuda]

Without ``-e``: sample ``INDEX`` through the forward (timed), NMS,
keypoints, descriptors, the configured matcher and the homography
estimator of the config (``h_estimator``: MAGSAC, or ``device``), and with
``-p`` the matches drawn into a PNG. With ``-e``: NN-mAP, M-score and
h-correctness over the dataset at ``-tk`` / ``-th`` px, written to
``OUTPUT_DIR/<model dir>_<version>_results.json`` with the JAX package's
keys. Runs on the card unless ``--device`` says otherwise.
"""
import argparse
import json
import os
import time

import numpy as np

from ._common import load_eval_setup, report_at_exit, set_seeds


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Predict and align an image pair')
    parser.add_argument('-y', '--yaml-config', default='configs/cipdp.yaml')
    parser.add_argument('-m', '--model-dir', default='model_weights/xpoint')
    parser.add_argument('-v', '--version', default='latest',
                        help="Model version, 'none' for random weights")
    parser.add_argument('-i', '--index', default=0, type=int)
    parser.add_argument('-r', '--radius', default=4, type=int)
    parser.add_argument('-p', dest='plot', action='store_true')
    parser.add_argument('-e', dest='evaluation', action='store_true')
    parser.add_argument('-tk', dest='threshold_keypoints', default=4, type=int)
    parser.add_argument('-th', dest='threshold_homography', default=1,
                        type=int)
    parser.add_argument('-s', '--seed', default=0, type=int)
    parser.add_argument('-o', '--output-dir', default='outputs')
    parser.add_argument('--device', default='cuda',
                        help='torch device of the model (default: cuda)')
    return parser.parse_args(argv)


def main(argv=None):
    """With ``-e`` returns the results dict written; else (keypoints
    optical, keypoints thermal, matches, H_est)."""
    args = parse_args(argv)
    report_at_exit('predict_align_image_pair')
    set_seeds(args.seed)

    config, _, infer, dataset = load_eval_setup(
        args, single_image_override=False)

    from ..data import DataLoader
    from ..eval.evaluation import compute_descriptor_metrics
    from ..eval.metrics import estimate_homography

    if args.evaluation:
        loader = DataLoader(dataset, batch_size=1, shuffle=False)
        pred_cfg = dict(config['prediction'])
        out = compute_descriptor_metrics(
            infer, loader, pred_cfg,
            threshold_keypoints=args.threshold_keypoints,
            threshold_warp=args.threshold_homography, verbose=True)
        print(f"NN-mAP: {out['nn_map']:.4f}  M-score: {out['m_score']:.4f}  "
              f"h-correctness: {out['h_correctness']:.4f}  "
              f"avg h-error: {out['average_h_error']:.3f}")
        os.makedirs(args.output_dir, exist_ok=True)
        result_path = os.path.join(
            args.output_dir,
            f"{os.path.basename(args.model_dir)}_{args.version}_results.json")
        results = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                   for k, v in out.items() if k != 'H_est'}
        with open(result_path, 'w') as f:
            json.dump(results, f, indent=2)
        print(f"results written to {result_path}")
        return results

    # single-sample timed path (reference :177-210)
    sample = dataset[args.index]
    img_o = np.asarray(sample['optical']['image'])[None]
    img_t = np.asarray(sample['thermal']['image'])[None]

    t1 = time.time()
    prob_o, prob_t, desc_o, desc_t, _ = infer.forward_pair(img_o, img_t)
    t2 = time.time()
    print(f"forward: {t2 - t1:.3f} s ({1.0 / (t2 - t1):.2f} Hz)")

    prob_o_raw, prob_t_raw = prob_o, prob_t
    prob_o = infer.nms(prob_o)
    prob_t = infer.nms(prob_t)
    kp_o = infer.keypoints_from_prob(prob_o[0], prob_raw=prob_o_raw[0])
    kp_t = infer.keypoints_from_prob(prob_t[0], prob_raw=prob_t_raw[0])
    d_o = infer.descriptors_at(kp_o, desc_o[0], prob_o.shape[1:3])
    d_t = infer.descriptors_at(kp_t, desc_t[0], prob_t.shape[1:3])
    matches = infer.match(d_o, d_t)
    print(f"keypoints: optical {len(kp_o)}, thermal {len(kp_t)}; "
          f"matches: {len(matches)}")

    pts_o = np.float32([kp_o[q][::-1] for q, t, d in matches])
    pts_t = np.float32([kp_t[t][::-1] for q, t, d in matches])
    H_est, _ = estimate_homography(
        pts_o, pts_t, config['prediction'].get('reprojection_threshold', 3),
        method=config['prediction'].get('h_estimator', 'magsac'),
        match_distances=[d for q, t, d in matches], device=infer.device)
    if H_est is not None:
        print("estimated homography:")
        print(np.array2string(H_est, precision=4))
    else:
        print("homography estimation failed (<4 matches)")

    if args.plot:
        import cv2
        os.makedirs(args.output_dir, exist_ok=True)
        im_o, im_t = (cv2.cvtColor(
            (np.clip(img[0, ..., 0], 0, 1) * 255).astype(np.uint8),
            cv2.COLOR_GRAY2BGR) for img in (img_o, img_t))
        kps_o = [cv2.KeyPoint(float(c[1]), float(c[0]), args.radius)
                 for c in kp_o]
        kps_t = [cv2.KeyPoint(float(c[1]), float(c[0]), args.radius)
                 for c in kp_t]
        dm = [cv2.DMatch(q, t, d) for q, t, d in matches]
        out_img = cv2.drawMatches(im_o, kps_o, im_t, kps_t, dm, None,
                                  flags=2)
        out_path = os.path.join(args.output_dir, f"matches_i{args.index}.png")
        cv2.imwrite(out_path, out_img)
        print(f"wrote {out_path}")
    return kp_o, kp_t, matches, H_est


if __name__ == '__main__':
    main()
