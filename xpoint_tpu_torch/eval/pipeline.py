"""Detect + describe + match for an image pair (port of
``xpoint_tpu/eval/pipeline.py::make_pair_pipeline``, without RANSAC).

forward(optical) + forward(thermal) (each through its own spectrum's
route: encoder and statistics of a multispectral model) -> cell softmax +
depth-to-space -> box-NMS (both spectra in one call) -> top-k keypoints ->
bilinear descriptor sampling -> mutual-NN matching. The JAX per-sample
vmap is a batch dimension here. Homography estimation
(``estimate_homography``) is not ported yet (ROADMAP.md Queue 1 item 9).
"""
import torch

from ..ops.descriptor import interpolate_descriptors
from ..ops.detector import prob_from_logits
from ..ops.matching import mnn_match
from ..ops.nms import box_nms_extract


def make_pair_pipeline(module, image_shape, k=1024, nms_size=8,
                       detection_threshold=0.015, iou=0.1,
                       match_threshold=None, cross_check=True, ratio=8):
    """Returns fn(img_o, img_t) -> dict of tensors on the module's device.

    Images: (B, H, W, 1). Output keys are those of the JAX pipeline:
    prob_*, keypoints_*, scores_*, mask_*, desc_* for both spectra, and
    match_idx, match_dist, matched.
    """
    H, W = image_shape

    @torch.no_grad()
    def run(img_o, img_t):
        B = img_o.shape[0]
        pred_o = module(img_o, "optical")
        pred_t = module(img_t, "thermal")
        prob_o = prob_from_logits(pred_o["logits"], ratio)
        prob_t = prob_from_logits(pred_t["logits"], ratio)
        kps, sc, m = box_nms_extract(torch.cat([prob_o, prob_t]), nms_size,
                                     detection_threshold, iou, k)
        kps_o, kps_t = kps[:B], kps[B:]
        d_o = interpolate_descriptors(kps_o.float(), pred_o["desc"], (H, W))
        d_t = interpolate_descriptors(kps_t.float(), pred_t["desc"], (H, W))
        idx2, dist, matched = mnn_match(d_o, d_t, m[:B], m[B:],
                                        match_threshold, cross_check)
        return {
            "prob_optical": prob_o, "prob_thermal": prob_t,
            "keypoints_optical": kps_o, "keypoints_thermal": kps_t,
            "scores_optical": sc[:B], "scores_thermal": sc[B:],
            "mask_optical": m[:B], "mask_thermal": m[B:],
            "desc_optical": d_o, "desc_thermal": d_t,
            "match_idx": idx2, "match_dist": dist, "matched": matched,
        }

    return run
