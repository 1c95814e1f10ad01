"""Dataset-level evaluation loops (reference evaluation.py drivers; port of
``xpoint_tpu/eval/evaluation.py``). Plain loops: with ``verbose`` a count
line is printed at the end in place of a progress bar."""
import numpy as np

from .metrics import (compute_tp_fp_dist, pr_from_tp, repeatability_sample,
                      descriptor_metrics_sample, aggregate_descriptor_metrics)


def _homographies(side, B):
    if 'homography' in side:
        return np.asarray(side['homography'])
    return np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))


def compute_detector_metrics(infer, dataloader, config, distance_thresh=2.0):
    """Single-image PR-curve + localization (evaluation.py:10-55)."""
    tp, fp, prob_all, n_gt, dist = [], [], [], 0, []
    for batch in dataloader:
        probs, _ = infer.forward_single(batch['image'], batch['is_optical'])
        probs = probs * np.asarray(batch['valid_mask'], np.float32)
        if config.get('nms', 0) > 0:
            probs = infer.nms(probs)
        for p, k in zip(probs, np.asarray(batch['keypoints'])):
            t, f, s, n, d = compute_tp_fp_dist(p, k,
                                               distance_thresh=distance_thresh)
            tp.append(t)
            fp.append(f)
            prob_all.append(s)
            n_gt += n
            dist.append(d)
    tp = np.concatenate(tp)
    prob_all = np.concatenate(prob_all)
    dist = np.concatenate(dist) if dist else np.array([])
    order = np.argsort(-prob_all)
    precision, recall = pr_from_tp(tp[order], n_gt)
    return precision, recall, prob_all[order], dist


def compute_repeatability_multispectral(infer, dataloader, config,
                                        distance_thresh=3, verbose=False):
    """Mutual <=eps keypoint recovery ratio (evaluation.py:105-204)."""
    repeatability, n_kp_optical, n_kp_thermal = [], [], []
    pred_cfg = config['prediction']
    for batch in dataloader:
        B = batch['optical']['image'].shape[0]
        H_o = _homographies(batch['optical'], B)
        H_t = _homographies(batch['thermal'], B)
        prob_o, prob_t, _, _, _ = infer.forward_pair(
            batch['optical']['image'], batch['thermal']['image'])
        prob_o_raw, prob_t_raw = prob_o, prob_t
        if pred_cfg['nms'] > 0:
            prob_o = infer.nms(prob_o)
            prob_t = infer.nms(prob_t)
        for i in range(B):
            m_o = np.asarray(batch['optical']['valid_mask'][i], np.float32)
            m_t = np.asarray(batch['thermal']['valid_mask'][i], np.float32)
            kp_o = infer.keypoints_from_prob(prob_o[i], m_o,
                                             prob_raw=prob_o_raw[i] * m_o)
            kp_t = infer.keypoints_from_prob(prob_t[i], m_t,
                                             prob_raw=prob_t_raw[i] * m_t)
            n_kp_optical.append(len(kp_o))
            n_kp_thermal.append(len(kp_t))
            r = repeatability_sample(kp_o, kp_t, H_o[i], H_t[i],
                                     prob_o[i].shape, distance_thresh)
            if r is not None:
                repeatability.append(r)
    if verbose:
        print(f"repeatability: {len(n_kp_optical)} pairs", flush=True)
    return (np.mean(repeatability) if repeatability else 0.0,
            repeatability, n_kp_optical, n_kp_thermal)


def compute_descriptor_metrics(infer, dataloader, config,
                               threshold_keypoints=3, threshold_warp=3,
                               verbose=False):
    """NN-mAP / M-score / homography correctness (evaluation.py:213-475)."""
    samples = []
    for batch in dataloader:
        B = batch['optical']['image'].shape[0]
        H_o = _homographies(batch['optical'], B)
        H_t = _homographies(batch['thermal'], B)
        prob_o, prob_t, desc_o, desc_t, _ = infer.forward_pair(
            batch['optical']['image'], batch['thermal']['image'])
        prob_o = prob_o * np.asarray(batch['optical']['valid_mask'], np.float32)
        prob_t = prob_t * np.asarray(batch['thermal']['valid_mask'], np.float32)
        prob_o_raw, prob_t_raw = prob_o, prob_t
        if config.get('nms', 0) > 0:
            prob_o = infer.nms(prob_o)
            prob_t = infer.nms(prob_t)

        image_shape = prob_o.shape[1:3]
        for i in range(B):
            kp_o = infer.keypoints_from_prob(prob_o[i],
                                             prob_raw=prob_o_raw[i])
            kp_t = infer.keypoints_from_prob(prob_t[i],
                                             prob_raw=prob_t_raw[i])
            d_o = infer.descriptors_at(kp_o, desc_o[i], image_shape)
            d_t = infer.descriptors_at(kp_t, desc_t[i], image_shape)
            matches_optical = infer.match_crosscheck(d_o, d_t)
            matches_thermal = infer.match_crosscheck(d_t, d_o)
            # homography estimation uses the CONFIGURED matcher (ref :351-357)
            matches_ransac = infer.match(d_o, d_t)
            samples.append(descriptor_metrics_sample(
                kp_o, d_o, kp_t, d_t, H_o[i], H_t[i], image_shape,
                threshold_keypoints, matches_optical, matches_thermal,
                matches_ransac=matches_ransac,
                reprojection_threshold=config.get('reprojection_threshold', 3),
                h_estimator=config.get('h_estimator', 'magsac'),
                device=infer.device))
    if verbose:
        print(f"descriptor metrics: {len(samples)} pairs", flush=True)
    return aggregate_descriptor_metrics(samples, threshold_warp)
