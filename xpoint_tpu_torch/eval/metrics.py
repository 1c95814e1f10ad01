"""Evaluation metrics: repeatability, NN-mAP, M-score, homography
correctness (own copy of ``xpoint_tpu/eval/metrics.py``).

Parity target: reference xpoint/utils/evaluation.py. The metric math is
host numpy with the exact reference semantics, including its
idiosyncrasies kept for number parity:
  * homography-correctness corner set [[0,0],[H,0],[0,W],[H,H]]
    (evaluation.py:388 — the 4th corner is (H, H), not (H, W)),
  * MAGSAC params reproj-threshold/conf 0.9999/10k iters (:371-378),
  * failed estimates contribute pts_dist = 999.0 (:393).
"""
import cv2
import numpy as np

from ..geometry.homography import filter_points, warp_keypoints
from ..utils import div0


def compute_mAP(precision, recall):
    """PR-AUC (evaluation.py:99-103)."""
    return np.sum(precision[1:] * (recall[1:] - recall[:-1]))


def pr_from_tp(tp, n_gt):
    """Cumulative PR curve from sorted tp flags (evaluation.py:419-437)."""
    tp = np.asarray(tp, bool)
    fp = np.logical_not(tp)
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = div0(tp_cum, np.full_like(tp_cum, max(n_gt, 0)))
    precision = div0(tp_cum, tp_cum + fp_cum)
    recall = np.concatenate([[0], recall, [1]])
    precision = np.concatenate([[0], precision, [0]])
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    return precision, recall


def compute_tp_fp_dist(prob, keypoint_map, zero_threshold=1e-4,
                       distance_thresh=2.0):
    """Greedy TP/FP assignment of detections to GT keypoints
    (evaluation.py:57-97)."""
    kp = np.argwhere(np.asarray(keypoint_map))
    pred_mask = np.argwhere(prob > zero_threshold)
    scores = prob[pred_mask[:, 0], pred_mask[:, 1]]
    order = np.argsort(-scores)
    scores = scores[order]
    pred = pred_mask[order]

    if len(kp) == 0:
        tp = np.zeros(len(pred), bool)
        return tp, ~tp, scores, 0, np.array([])

    diff = pred[:, None, :] - kp[None, :, :]
    dist = np.linalg.norm(diff.astype(np.float64), axis=-1)
    matches = dist <= distance_thresh

    tp = []
    matched = np.zeros(len(kp), bool)
    for m in matches:
        correct = np.any(m)
        if correct and not np.all(matched):
            gt_idx = np.argmax(m)
            tp.append(not matched[gt_idx])
            matched[gt_idx] = True
        else:
            tp.append(False)
    tp = np.array(tp, bool)
    return tp, ~tp, scores, len(kp), dist[matches]


def repeatability_sample(kp_optical, kp_thermal, h_optical, h_thermal,
                         image_shape, distance_thresh=3):
    """Per-pair repeatability (evaluation.py:150-202). Keypoints (n, 2)
    int (row, col); homographies map original -> warped frame."""
    kp_optical = np.asarray(kp_optical, np.float64).reshape(-1, 2)
    kp_thermal = np.asarray(kp_thermal, np.float64).reshape(-1, 2)

    warped_optical = warp_keypoints(kp_optical, np.linalg.inv(h_optical))
    warped_optical = warp_keypoints(warped_optical, h_thermal)
    warped_optical = filter_points(warped_optical, image_shape)

    warped_thermal = warp_keypoints(kp_thermal, np.linalg.inv(h_thermal))
    warped_thermal = warp_keypoints(warped_thermal, h_optical)
    warped_thermal = filter_points(warped_thermal, image_shape)

    N_thermal = warped_thermal.shape[0]
    N_optical = warped_optical.shape[0]
    count1 = count2 = 0
    if kp_optical.shape[0] != 0 and N_thermal > 0:
        d1 = np.linalg.norm(warped_thermal[:, None] - kp_optical[None], axis=2)
        count1 = np.sum(np.min(d1, axis=1) <= distance_thresh)
    if kp_thermal.shape[0] != 0 and N_optical > 0:
        d2 = np.linalg.norm(warped_optical[:, None] - kp_thermal[None], axis=2)
        count2 = np.sum(np.min(d2, axis=1) <= distance_thresh)
    if N_thermal + N_optical > 0:
        return (count1 + count2) / (N_thermal + N_optical)
    return None


def estimate_homography(optical_pts, thermal_pts, reprojection_threshold=3,
                        method='magsac', match_distances=None,
                        device="cuda"):
    """Homography from matched (x, y) point arrays (evaluation.py:364-380).
    Returns None when under-determined.

    method: 'magsac' = cv2 USAC_MAGSAC host-side (reference parity,
    default); 'device' = the batched DLT+RANSAC on ``device``
    (geometry/ransac.py), selectable in the benchmark CLI via
    `prediction: h_estimator: device`.

    match_distances: optional per-match descriptor distances (lower is
    better); the device estimator uses them for PROSAC-style progressive
    sampling (the cv2 path ignores them — USAC sorts internally)."""
    if method == 'device':
        from ..geometry.ransac import estimate_homography_device
        return estimate_homography_device(
            optical_pts, thermal_pts,
            reprojection_threshold=reprojection_threshold,
            quality=match_distances, device=device)
    if method != 'magsac':
        raise ValueError(f"unknown h_estimator {method!r} "
                         "(expected 'magsac' or 'device')")
    optical_pts = np.float32(optical_pts).reshape(-1, 1, 2)
    thermal_pts = np.float32(thermal_pts).reshape(-1, 1, 2)
    if optical_pts.shape[0] < 4 or thermal_pts.shape[0] < 4:
        return None, None
    H_est, mask = cv2.findHomography(
        optical_pts, thermal_pts, method=cv2.USAC_MAGSAC,
        ransacReprojThreshold=reprojection_threshold,
        confidence=0.9999, maxIters=10000)
    return H_est, mask


def homography_corner_error(H_est, gt_homography, image_shape):
    """Mean 4-corner warp error with the reference's exact (quirky) corner
    set (evaluation.py:387-393). Returns 999.0 when H_est is None."""
    if H_est is None:
        return 999.0
    H_o, W_o = image_shape
    pts = np.array([[0, 0], [H_o, 0], [0, W_o], [H_o, H_o]])
    pts_gt = warp_keypoints(pts, gt_homography, float)
    pts_est = warp_keypoints(pts, H_est, float)
    return float(np.linalg.norm(pts_est - pts_gt, axis=1).sum() / 4)


def descriptor_metrics_sample(kp_optical, desc_optical, kp_thermal,
                              desc_thermal, h_optical, h_thermal, image_shape,
                              threshold_keypoints=3, matches_optical=None,
                              matches_thermal=None, matches_ransac=None,
                              reprojection_threshold=3, h_estimator='magsac',
                              device="cuda"):
    """Per-pair descriptor metrics (evaluation.py:272-395).

    matches_*: lists of (query_idx, train_idx, distance) tuples
        (matches_optical: optical->thermal; matches_thermal: the reverse;
        matches_ransac: matcher configured for homography estimation).

    Returns a dict of per-sample quantities to be aggregated by the caller.
    """
    kp_optical = np.asarray(kp_optical, np.float64).reshape(-1, 2)
    kp_thermal = np.asarray(kp_thermal, np.float64).reshape(-1, 2)
    gt_homography = h_thermal @ np.linalg.inv(h_optical)

    warped_optical = warp_keypoints(kp_optical, gt_homography, float)
    warped_thermal = warp_keypoints(kp_thermal, np.linalg.inv(gt_homography), float)

    def correct_matrix(warped, targets):
        if len(warped) == 0 or len(targets) == 0:
            return np.zeros((len(warped), len(targets)), bool)
        d = np.linalg.norm(warped[:, None] - targets[None], axis=-1)
        return d <= threshold_keypoints

    correct_optical = correct_matrix(warped_optical, kp_thermal)
    correct_thermal = correct_matrix(warped_thermal, kp_optical)

    n_gt_optical = int(np.count_nonzero(correct_optical.sum(1)))
    n_gt_thermal = int(np.count_nonzero(correct_thermal.sum(1)))

    matches_optical = sorted(matches_optical or [], key=lambda m: m[2])
    matches_thermal = sorted(matches_thermal or [], key=lambda m: m[2])

    tp_optical, dist_optical, num_matched_optical = [], [], 0
    for q, t, d in matches_optical:
        c = bool(correct_optical[q, t])
        num_matched_optical += c
        tp_optical.append(c)
        dist_optical.append(d)
    tp_thermal, dist_thermal, num_matched_thermal = [], [], 0
    for q, t, d in matches_thermal:
        c = bool(correct_thermal[q, t])
        num_matched_thermal += c
        tp_thermal.append(c)
        dist_thermal.append(d)

    N_optical = filter_points(warped_optical, image_shape).shape[0]
    N_thermal = filter_points(warped_thermal, image_shape).shape[0]
    m_score_optical = (num_matched_optical / N_optical) if N_optical > 0 else 0.0
    m_score_thermal = (num_matched_thermal / N_thermal) if N_thermal > 0 else 0.0

    # homography estimation from the ransac matcher's matches ((x, y) order)
    mr = matches_ransac if matches_ransac is not None else matches_optical
    optical_pts = np.float32([kp_optical[q][::-1] for q, t, d in mr])
    thermal_pts = np.float32([kp_thermal[t][::-1] for q, t, d in mr])
    H_est, _ = estimate_homography(optical_pts, thermal_pts,
                                   reprojection_threshold,
                                   method=h_estimator,
                                   match_distances=[d for q, t, d in mr],
                                   device=device)
    pts_dist = homography_corner_error(H_est, gt_homography, image_shape)

    return {
        'tp_optical': tp_optical, 'distance_optical': dist_optical,
        'tp_thermal': tp_thermal, 'distance_thermal': dist_thermal,
        'n_gt_optical': n_gt_optical, 'n_gt_thermal': n_gt_thermal,
        'm_score_optical': m_score_optical, 'm_score_thermal': m_score_thermal,
        'num_matched_optical': num_matched_optical,
        'num_matched_thermal': num_matched_thermal,
        'pts_dist': pts_dist, 'H_est': H_est,
    }


def aggregate_descriptor_metrics(samples, threshold_warp=3):
    """Fold per-sample dicts into the reference output dict
    (evaluation.py:397-475)."""
    def pr_side(side):
        tp = np.concatenate([np.asarray(s['tp_' + side], bool)
                             for s in samples]) if samples else np.array([], bool)
        dist = np.concatenate([np.asarray(s['distance_' + side])
                               for s in samples]) if samples else np.array([])
        order = np.argsort(dist)
        tp = tp[order]
        n_gt = sum(s['n_gt_' + side] for s in samples)
        precision, recall = pr_from_tp(tp, n_gt)
        return tp, dist[order], precision, recall

    tp_o, dist_o, precision_o, recall_o = pr_side('optical')
    tp_t, dist_t, precision_t, recall_t = pr_side('thermal')
    nn_map_optical = compute_mAP(precision_o, recall_o)
    nn_map_thermal = compute_mAP(precision_t, recall_t)

    m_score_optical = np.array([s['m_score_optical'] for s in samples])
    m_score_thermal = np.array([s['m_score_thermal'] for s in samples])
    pts_dist = np.array([s['pts_dist'] for s in samples])

    return {
        'tp_optical': tp_o, 'tp_thermal': tp_t,
        'fp_optical': ~tp_o, 'fp_thermal': ~tp_t,
        'distance_optical': dist_o, 'distance_thermal': dist_t,
        'recall_optical': recall_o, 'recall_thermal': recall_t,
        'precision_optical': precision_o, 'precision_thermal': precision_t,
        'nn_map_optical': nn_map_optical, 'nn_map_thermal': nn_map_thermal,
        'nn_map': (nn_map_optical + nn_map_thermal) * 0.5,
        'm_score_optical': m_score_optical, 'm_score_thermal': m_score_thermal,
        'm_score': (m_score_optical.mean() + m_score_thermal.mean()) * 0.5
                   if len(samples) else 0.0,
        'pts_dist': pts_dist,
        'average_h_error': pts_dist.mean() if len(samples) else 999.0,
        'h_correctness': ((pts_dist < threshold_warp).sum() / len(pts_dist))
                         if len(samples) else 0.0,
        'matching_kp_numbers': [
            (s['num_matched_optical'] + s['num_matched_thermal']) // 2
            for s in samples],
    }
