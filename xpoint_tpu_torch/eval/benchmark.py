"""Benchmark sweep + timing harness (reference benchmark_evaluation.py;
port of ``xpoint_tpu/eval/benchmark.py`` less ``model_cost``).

One pass over the dataset computing repeatability / descriptor metrics /
homography correctness over LISTS of thresholds (repeatability 1-10, kp
correctness 1-10, warp eps 1-10, ransac ths), plus the per-stage timing
harness with the reference's exact decomposition: two_forward / nms /
interpolate, each stage fenced with ``torch.cuda.synchronize()`` on the card
(the reference's own fence).
"""
import time

import numpy as np
import torch

from ..geometry.homography import filter_points, warp_keypoints
from .metrics import (estimate_homography, homography_corner_error,
                      pr_from_tp, compute_mAP)
from .evaluation import _homographies


def _fence(infer):
    if infer.device.type == "cuda":
        torch.cuda.synchronize(infer.device)


def timing_harness(infer, dataset, indices, config, n_warmup=1):
    """Stage timing over dataset samples (benchmark_evaluation.py:16-134).

    Returns dict of per-stage second lists: two_forward / nms / interpolate.
    """
    time_dict = {"two_forward": [], "nms": [], "interpolate": []}
    pred_cfg = config['prediction']

    sample = dataset[indices[0]]
    img_o = np.asarray(sample['optical']['image'])[None]
    img_t = np.asarray(sample['thermal']['image'])[None]
    for _ in range(n_warmup):
        out = infer.forward_pair_device(img_o, img_t)
        pn = infer.nms(out[0])
        kp = infer.keypoints_from_prob(pn[0])
        infer.descriptors_at(kp, out[2][0], pn.shape[1:3])

    for index in indices:
        sample = dataset[index]
        img_o = np.asarray(sample['optical']['image'])[None]
        img_t = np.asarray(sample['thermal']['image'])[None]
        mask_o = infer._to_device(sample['optical']['valid_mask'])[None]
        mask_t = infer._to_device(sample['thermal']['valid_mask'])[None]

        _fence(infer)
        t1 = time.time()
        prob_o, prob_t, desc_o, desc_t, _ = infer.forward_pair_device(
            img_o, img_t)
        _fence(infer)
        t2 = time.time()
        time_dict["two_forward"].append(t2 - t1)

        t2 = time.time()
        if pred_cfg['nms'] > 0:
            prob_o = infer.nms(prob_o * mask_o)
            prob_t = infer.nms(prob_t * mask_t)
        else:
            prob_o, prob_t = prob_o.cpu().numpy(), prob_t.cpu().numpy()
        t3 = time.time()
        time_dict["nms"].append(t3 - t2)

        kp_o = infer.keypoints_from_prob(prob_o[0])
        kp_t = infer.keypoints_from_prob(prob_t[0])
        t4 = time.time()
        infer.descriptors_at(kp_o, desc_o[0], prob_o.shape[1:3])
        infer.descriptors_at(kp_t, desc_t[0], prob_t.shape[1:3])
        t5 = time.time()
        time_dict["interpolate"].append(t5 - t4)
    return time_dict


def print_timing(time_dict):
    """Reference-style ms & Hz report (benchmark.py:151-164)."""
    total = 0.0
    for stage, times in time_dict.items():
        mean = float(np.mean(times))
        total += mean
        print(f"{stage}: {mean * 1000:.2f} ms, {1.0 / mean:.2f} Hz")
    print(f"total: {total * 1000:.2f} ms, {1.0 / total:.2f} Hz")
    return total


def compute_metrics(infer, dataloader, config,
                    threshold_repeatability=tuple(range(1, 11)),
                    threshold_keypoints=tuple(range(1, 11)),
                    threshold_warp=tuple(range(1, 11)),
                    threshold_ransac=(2,),
                    verbose=True):
    """Full sweep over threshold grids in one dataset pass
    (benchmark_evaluation.py:832-964).

    Returns {'repeatability': {th: mean}, 'descriptor': {th_kp: {...}},
             'homography': {th_ransac: {...}}, 'n_kp_optical'/'n_kp_thermal'}.
    """
    pred_cfg = config['prediction']
    det_th = float(pred_cfg['detection_threshold'])
    # 'magsac' (cv2 host-side, reference parity) or 'device' (batched
    # on-device DLT+RANSAC, geometry/ransac.py)
    h_estimator = pred_cfg.get('h_estimator', 'magsac')

    rep_acc = {th: [] for th in threshold_repeatability}
    n_kp_optical, n_kp_thermal = [], []
    desc_acc = {th: {'tp_optical': [], 'tp_thermal': [],
                     'distance_optical': [], 'distance_thermal': [],
                     'm_score_optical': [], 'm_score_thermal': [],
                     'n_gt_optical': 0, 'n_gt_thermal': 0}
                for th in threshold_keypoints}
    pts_dist_acc = {th: [] for th in threshold_ransac}

    for batch in dataloader:
        B = batch['optical']['image'].shape[0]
        H_o = _homographies(batch['optical'], B)
        H_t = _homographies(batch['thermal'], B)
        prob_o_raw, prob_t_raw, desc_o, desc_t, _ = infer.forward_pair(
            batch['optical']['image'], batch['thermal']['image'])
        mask_o = np.asarray(batch['optical']['valid_mask'], np.float32)
        mask_t = np.asarray(batch['thermal']['valid_mask'], np.float32)
        if pred_cfg['nms'] > 0:
            prob_o = infer.nms(prob_o_raw * mask_o)
            prob_t = infer.nms(prob_t_raw * mask_t)
        else:
            prob_o, prob_t = prob_o_raw * mask_o, prob_t_raw * mask_t
        image_shape = prob_o.shape[1:3]

        for i in range(B):
            kp_o = infer.keypoints_from_prob(
                prob_o[i], prob_raw=prob_o_raw[i] * mask_o[i])
            kp_t = infer.keypoints_from_prob(
                prob_t[i], prob_raw=prob_t_raw[i] * mask_t[i])
            n_kp_optical.append(len(kp_o))
            n_kp_thermal.append(len(kp_t))

            # ---- repeatability over distance thresholds ----
            wo = warp_keypoints(kp_o.astype(np.float64),
                                np.linalg.inv(H_o[i]))
            wo = filter_points(warp_keypoints(wo, H_t[i]), image_shape)
            wt = warp_keypoints(kp_t.astype(np.float64),
                                np.linalg.inv(H_t[i]))
            wt = filter_points(warp_keypoints(wt, H_o[i]), image_shape)
            N_o, N_t = wo.shape[0], wt.shape[0]
            d1 = (np.linalg.norm(wt[:, None] - kp_o[None], axis=2)
                  if len(kp_o) and N_t else None)
            d2 = (np.linalg.norm(wo[:, None] - kp_t[None], axis=2)
                  if len(kp_t) and N_o else None)
            for th in threshold_repeatability:
                c1 = np.sum(np.min(d1, axis=1) <= th) if d1 is not None else 0
                c2 = np.sum(np.min(d2, axis=1) <= th) if d2 is not None else 0
                if N_o + N_t > 0:
                    rep_acc[th].append((c1 + c2) / (N_o + N_t))

            # ---- descriptor metrics over keypoint thresholds ----
            do = infer.descriptors_at(kp_o, desc_o[i], image_shape)
            dt = infer.descriptors_at(kp_t, desc_t[i], image_shape)
            matches_o = sorted(infer.match_crosscheck(do, dt),
                               key=lambda m: m[2])
            matches_t = sorted(infer.match_crosscheck(dt, do),
                               key=lambda m: m[2])
            matches_ransac = infer.match(do, dt)

            gt_H = H_t[i] @ np.linalg.inv(H_o[i])
            w_o = warp_keypoints(kp_o.astype(np.float64), gt_H, float)
            w_t = warp_keypoints(kp_t.astype(np.float64),
                                 np.linalg.inv(gt_H), float)
            dmat_o = (np.linalg.norm(w_o[:, None] - kp_t[None], axis=-1)
                      if len(kp_o) and len(kp_t)
                      else np.zeros((len(kp_o), len(kp_t))) + 1e9)
            dmat_t = (np.linalg.norm(w_t[:, None] - kp_o[None], axis=-1)
                      if len(kp_o) and len(kp_t)
                      else np.zeros((len(kp_t), len(kp_o))) + 1e9)
            N_o_in = filter_points(w_o, image_shape).shape[0]
            N_t_in = filter_points(w_t, image_shape).shape[0]

            for th in threshold_keypoints:
                acc = desc_acc[th]
                correct_o = dmat_o <= th
                correct_t = dmat_t <= th
                acc['n_gt_optical'] += int(np.count_nonzero(correct_o.sum(1)))
                acc['n_gt_thermal'] += int(np.count_nonzero(correct_t.sum(1)))
                nm_o = nm_t = 0
                for q, t, d in matches_o:
                    c = bool(correct_o[q, t])
                    nm_o += c
                    acc['tp_optical'].append(c)
                    acc['distance_optical'].append(d)
                for q, t, d in matches_t:
                    c = bool(correct_t[q, t])
                    nm_t += c
                    acc['tp_thermal'].append(c)
                    acc['distance_thermal'].append(d)
                acc['m_score_optical'].append(nm_o / N_o_in if N_o_in else 0.0)
                acc['m_score_thermal'].append(nm_t / N_t_in if N_t_in else 0.0)

            # ---- homography over ransac thresholds ----
            pts_o = np.float32([kp_o[q][::-1] for q, t, d in matches_ransac])
            pts_t = np.float32([kp_t[t][::-1] for q, t, d in matches_ransac])
            match_d = [d for q, t, d in matches_ransac]
            for th in threshold_ransac:
                H_est, _ = estimate_homography(pts_o, pts_t, th,
                                               method=h_estimator,
                                               match_distances=match_d,
                                               device=infer.device)
                pts_dist_acc[th].append(
                    homography_corner_error(H_est, gt_H, image_shape))

    if verbose:
        print(f"metric sweep: {len(n_kp_optical)} pairs", flush=True)

    # ---- aggregate ----
    results = {
        'repeatability': {th: float(np.mean(v)) if v else 0.0
                          for th, v in rep_acc.items()},
        'n_kp_optical': n_kp_optical, 'n_kp_thermal': n_kp_thermal,
        'descriptor': {}, 'homography': {},
    }
    for th, acc in desc_acc.items():
        out = {}
        for side in ('optical', 'thermal'):
            tp = np.asarray(acc['tp_' + side], bool)
            dist = np.asarray(acc['distance_' + side])
            order = np.argsort(dist)
            precision, recall = pr_from_tp(tp[order], acc['n_gt_' + side])
            out['nn_map_' + side] = compute_mAP(precision, recall)
            out['m_score_' + side] = float(np.mean(acc['m_score_' + side])) \
                if acc['m_score_' + side] else 0.0
        out['nn_map'] = (out['nn_map_optical'] + out['nn_map_thermal']) * 0.5
        out['m_score'] = (out['m_score_optical'] + out['m_score_thermal']) * 0.5
        results['descriptor'][th] = out
    for th, dists in pts_dist_acc.items():
        d = np.asarray(dists)
        results['homography'][th] = {
            'average_h_error': float(d.mean()) if len(d) else 999.0,
            'h_correctness': {
                f'epsilon_warp_th{tw}': float((d < tw).sum() / len(d))
                if len(d) else 0.0
                for tw in threshold_warp},
        }
    return results
