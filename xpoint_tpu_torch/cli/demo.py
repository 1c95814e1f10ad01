"""End-user demo: register a visible / other-spectrum image pair (port of
``cli/demo.py``, the reference demo.py).

    python -m xpoint_tpu_torch.cli.demo --visible A.png --other B.png \
        [--config configs/cipdp.yaml] [--model-dir DIR] [--version latest] \
        [--output demo_results] [--plot] [--device cuda]

Detect, describe, match and estimate the homography (MAGSAC, or the
device estimator with ``prediction: h_estimator: device``), with the
reference's metric report (per-stage runtime, keypoint counts, matching
score, match-distance statistics, inlier ratio, repeatability against the
estimated homography), the registered checkerboard and the matches as
PNGs, and with ``--plot`` the alignment figure (matplotlib, imported
there) and ``metrics.json``. The images are read as gray and cropped to
multiples of 32; the other image is resized to the visible one's size.
Runs on the card unless ``--device`` says otherwise.
"""
import argparse
import json
import os
import time

import cv2
import numpy as np

from ._common import report_at_exit


def load_gray(path, size=None):
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY).astype(np.float32) / 255.0
    if size is not None:
        gray = cv2.resize(gray, size[::-1], interpolation=cv2.INTER_LINEAR)
    h = gray.shape[0] // 32 * 32
    w = gray.shape[1] // 32 * 32
    return gray[:h, :w]


def checkerboard_overlay(im1, im2, cell_size=50):
    """Alternating-cell composite of the registered pair (reference
    create_checkerboard_visualization, demo.py:222-234: 50-px cells)."""
    H, W = im1.shape[:2]
    x, y = np.meshgrid(np.arange(W), np.arange(H))
    checker = ((x // cell_size) + (y // cell_size)) % 2
    return np.where(checker.astype(bool), im1, im2)


def compute_repeatability(kp_visible, kp_other, H_est, img_shape,
                          distance_thresh=3):
    """Repeatability vs the ESTIMATED homography (reference
    compute_repeatability, demo.py:183-220): warp visible keypoints by
    H_est (x,y-swapped for the matrix), keep in-bounds ones, count those
    with a nearest other-keypoint within distance_thresh, normalized by
    min(total counts)."""
    if H_est is None or len(kp_visible) == 0 or len(kp_other) == 0:
        return 0.0
    kv = np.asarray(kp_visible, np.float64)        # (n, 2) (row, col)
    ko = np.asarray(kp_other, np.float64)
    ones = np.ones((kv.shape[0], 1))
    hom = np.hstack([kv[:, [1, 0]], ones])         # (x, y, 1)
    warped = (H_est @ hom.T)
    warped = (warped[:2] / warped[2]).T[:, [1, 0]]  # back to (row, col)
    H, W = img_shape
    valid = ((warped[:, 0] >= 0) & (warped[:, 0] < H)
             & (warped[:, 1] >= 0) & (warped[:, 1] < W))
    warped = warped[valid]
    if len(warped) == 0:
        return 0.0
    d = np.linalg.norm(warped[:, None, :] - ko[None, :, :], axis=2)
    correct = (d.min(axis=1) <= distance_thresh).sum()
    return float(correct / min(len(kp_visible), len(kp_other)))


def compute_metrics(matches, kp_o, kp_t, H_est, inlier_mask, time_dict,
                    img_shape):
    """The reference's metrics dict (demo.py:295-350), identical keys."""
    metrics = {
        'runtime': {
            'total_time': sum(time_dict.values()),
            'forward_pass_time': time_dict.get('forward_pass', 0),
            'keypoint_detection_time': time_dict.get('keypoint_detection', 0),
            'descriptor_computation_time':
                time_dict.get('descriptor_computation', 0),
            'matching_time': time_dict.get('matching', 0),
        },
        'keypoints': {
            'n_keypoints_visible': len(kp_o),
            'n_keypoints_other': len(kp_t),
            'n_matches': len(matches),
        },
    }
    if len(kp_o) > 0 and len(kp_t) > 0:
        metrics['matching_score'] = len(matches) / min(len(kp_o), len(kp_t))
    else:
        metrics['matching_score'] = 0.0
    if matches:
        dist = sorted(d for _, _, d in matches)
        metrics['match_statistics'] = {
            'min_distance': float(dist[0]),
            'max_distance': float(dist[-1]),
            'mean_distance': float(sum(dist) / len(dist)),
            'median_distance': float(dist[len(dist) // 2]),
        }
    inliers = ([] if inlier_mask is None
               else [int(v) for v in np.ravel(inlier_mask)])
    metrics['homography'] = {
        'estimated': H_est is not None,
        'inlier_ratio': (sum(inliers) / len(inliers)) if inliers else 0.0,
        'num_inliers': int(sum(inliers)) if inliers else 0,
    }
    metrics['repeatability'] = compute_repeatability(kp_o, kp_t, H_est,
                                                     img_shape)
    return metrics


def print_metrics(metrics):
    """Formatted report, matching the reference print_metrics
    (demo.py:352-377) line for line."""
    print("\n=== Performance Metrics ===")
    r = metrics['runtime']
    print("\nRuntime Metrics:")
    print(f"Total processing time: {r['total_time']*1000:.2f} ms")
    print(f"Forward pass time: {r['forward_pass_time']*1000:.2f} ms")
    print(f"Keypoint detection time: {r['keypoint_detection_time']*1000:.2f} ms")
    print(f"Descriptor computation time: "
          f"{r['descriptor_computation_time']*1000:.2f} ms")
    print(f"Matching time: {r['matching_time']*1000:.2f} ms")
    k = metrics['keypoints']
    print("\nKeypoint Metrics:")
    print(f"Number of visible keypoints: {k['n_keypoints_visible']}")
    print(f"Number of other keypoints: {k['n_keypoints_other']}")
    print(f"Number of matches: {k['n_matches']}")
    print(f"Matching score: {metrics['matching_score']:.3f}")
    if 'match_statistics' in metrics:
        s = metrics['match_statistics']
        print("\nMatch Statistics:")
        print(f"Min distance: {s['min_distance']:.3f}")
        print(f"Max distance: {s['max_distance']:.3f}")
        print(f"Mean distance: {s['mean_distance']:.3f}")
        print(f"Median distance: {s['median_distance']:.3f}")
    h = metrics['homography']
    print("\nHomography Metrics:")
    print(f"Homography estimated: {h['estimated']}")
    print(f"Inlier ratio: {h['inlier_ratio']:.3f}")
    print(f"Number of inliers: {h['num_inliers']}")
    print("\nRepeatability Metrics:")
    print(f"Repeatability score: {metrics['repeatability']:.3f}")


def save_alignment_overlay(visible, other, H_est, path):
    """Alignment visualization (reference visualize_alignment,
    demo.py:236-292): originals, checkerboard, both warp directions, and
    the |difference| heatmap, in one figure."""
    if H_est is None:
        return
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    Hh, Ww = other.shape
    warped_visible = cv2.warpPerspective(visible, H_est, (Ww, Hh))
    warped_other = cv2.warpPerspective(other, np.linalg.inv(H_est), (Ww, Hh))
    fig, axes = plt.subplots(2, 3, figsize=(20, 10))
    panels = [
        (visible, 'Visible Spectrum Image', 'gray'),
        (other, 'Other Spectrum Image', 'gray'),
        (checkerboard_overlay(warped_visible, other),
         'Checkerboard Visualization', 'gray'),
        (warped_visible, 'Visible Warped to Other', 'gray'),
        (warped_other, 'Other Warped to Visible', 'gray'),
        (np.abs(warped_visible - other), 'Difference Image', 'hot'),
    ]
    for ax, (img, title, cmap) in zip(axes.ravel(), panels):
        im = ax.imshow(img, cmap=cmap)
        ax.set_title(title)
        ax.axis('off')
        if cmap == 'hot':
            fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(path, bbox_inches='tight', dpi=150)
    plt.close(fig)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='XPoint registration demo')
    parser.add_argument('--visible', required=True)
    parser.add_argument('--other', required=True)
    parser.add_argument('--config', default='configs/cipdp.yaml')
    parser.add_argument('--model-dir', default='model_weights/xpoint')
    parser.add_argument('--version', default='latest')
    parser.add_argument('--output', default='demo_results')
    parser.add_argument('--plot', action='store_true',
                        help='also write the alignment overlay and a '
                             'metrics JSON (reference --plot)')
    parser.add_argument('--device', default='cuda',
                        help='torch device of the model (default: cuda)')
    return parser.parse_args(argv)


def main(argv=None):
    """Runs the demo; returns (metrics, H_est)."""
    args = parse_args(argv)
    report_at_exit('demo')

    from ..config import load_yaml
    from ..eval.infer import XPointInference
    from ..eval.metrics import estimate_homography
    from ..model_io import load_model

    config = load_yaml(args.config)
    module, _ = load_model(args.model_dir, args.version, device=args.device)
    infer = XPointInference(module, config.get('prediction', {}))

    time_dict = {}
    t0 = time.time()
    visible = load_gray(args.visible)
    other = load_gray(args.other, size=visible.shape[:2])
    img_o = visible[None, ..., None]
    img_t = other[None, ..., None]
    time_dict['preprocessing'] = time.time() - t0

    # stage decomposition mirrors the reference's time_dict
    # (demo.py:413-463); each stage ends on a host-side numpy result
    t0 = time.time()
    prob_o, prob_t, desc_o, desc_t, _ = infer.forward_pair(img_o, img_t)
    time_dict['forward_pass'] = time.time() - t0

    t0 = time.time()
    prob_o_raw, prob_t_raw = prob_o, prob_t
    prob_o, prob_t = infer.nms(prob_o), infer.nms(prob_t)
    kp_o = infer.keypoints_from_prob(prob_o[0], prob_raw=prob_o_raw[0])
    kp_t = infer.keypoints_from_prob(prob_t[0], prob_raw=prob_t_raw[0])
    time_dict['keypoint_detection'] = time.time() - t0

    t0 = time.time()
    d_o = infer.descriptors_at(kp_o, desc_o[0], visible.shape[:2])
    d_t = infer.descriptors_at(kp_t, desc_t[0], visible.shape[:2])
    time_dict['descriptor_computation'] = time.time() - t0

    t0 = time.time()
    matches = infer.match(d_o, d_t)
    time_dict['matching'] = time.time() - t0

    H_est, inlier_mask = None, None
    if len(matches) >= 4:
        pts_o = np.float32([kp_o[q][::-1] for q, t, d in matches])
        pts_t = np.float32([kp_t[t][::-1] for q, t, d in matches])
        pred_cfg = config.get('prediction', {})
        H_est, inlier_mask = estimate_homography(
            pts_o, pts_t, pred_cfg.get('reprojection_threshold', 3),
            method=pred_cfg.get('h_estimator', 'magsac'),
            match_distances=[d for q, t, d in matches], device=infer.device)

    metrics = compute_metrics(matches, kp_o, kp_t, H_est, inlier_mask,
                              time_dict, visible.shape[:2])
    print_metrics(metrics)

    os.makedirs(args.output, exist_ok=True)
    vis8 = (np.clip(visible, 0, 1) * 255).astype(np.uint8)
    oth8 = (np.clip(other, 0, 1) * 255).astype(np.uint8)

    if H_est is not None:
        print("\nhomography:")
        print(np.array2string(H_est, precision=4))
        warped = cv2.warpPerspective(vis8, H_est, vis8.shape[:2][::-1])
        cv2.imwrite(os.path.join(args.output, 'registered_checkerboard.png'),
                    checkerboard_overlay(warped, oth8))
    else:
        print("\nregistration failed: not enough matches")

    kps_o = [cv2.KeyPoint(float(c[1]), float(c[0]), 4) for c in kp_o]
    kps_t = [cv2.KeyPoint(float(c[1]), float(c[0]), 4) for c in kp_t]
    dm = [cv2.DMatch(q, t, d) for q, t, d in matches]
    match_img = cv2.drawMatches(
        cv2.cvtColor(vis8, cv2.COLOR_GRAY2BGR), kps_o,
        cv2.cvtColor(oth8, cv2.COLOR_GRAY2BGR), kps_t, dm, None,
        matchColor=(0, 255, 0),
        flags=cv2.DrawMatchesFlags_NOT_DRAW_SINGLE_POINTS)
    cv2.imwrite(os.path.join(args.output, 'matches.png'), match_img)

    if args.plot:
        save_alignment_overlay(visible, other, H_est,
                               os.path.join(args.output, 'alignment.png'))
        metrics_json = dict(metrics)
        if H_est is not None:
            metrics_json['homography'] = dict(metrics['homography'],
                                              matrix=H_est.tolist())
        with open(os.path.join(args.output, 'metrics.json'), 'w') as f:
            json.dump(metrics_json, f, indent=4)
    print(f"outputs written to {args.output}/")
    return metrics, H_est


if __name__ == '__main__':
    main()
