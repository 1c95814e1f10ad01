"""Inference wrapper used by the label export (a first part of
``xpoint_tpu/eval/infer.py::XPointInference``: heatmaps, NMS and the
dynamic-count keypoint extraction).

Heatmaps and NMS run on the module's device; keypoint extraction is
host-side with exact reference semantics (threshold, then ``np.argwhere``).
Descriptor sampling at keypoints and the matcher dispatch are not ported yet
(ROADMAP.md Queue 1 item 9).
"""
import numpy as np
import torch

from ..ops.detector import prob_from_logits
from ..ops.nms import box_nms


class XPointInference:
    def __init__(self, module, prediction_config=None):
        self.module = module
        self.cfg = dict({'nms': 8, 'detection_threshold': 0.015, 'topk': 0,
                         'subpixel': False},
                        **(prediction_config or {}))
        if self.cfg['subpixel']:
            raise NotImplementedError(
                "subpixel keypoint refinement (refine_keypoints_subpixel) "
                "is not ported yet: ROADMAP.md Queue 1 item 9")
        self.ratio = module.encoder_downsample_ratio
        self.device = next(module.parameters()).device

    def _to_device(self, x):
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def forward_pair(self, img_o, img_t):
        """images (B, H, W, 1) numpy -> numpy (prob_o, prob_t, desc_o,
        desc_t, pred_hm)."""
        pred_o, pred_t, pred_hm = self.module.forward_pair(
            self._to_device(img_o), self._to_device(img_t))
        out = (prob_from_logits(pred_o['logits'], self.ratio),
               prob_from_logits(pred_t['logits'], self.ratio),
               pred_o['desc'], pred_t['desc'], pred_hm)
        return [None if o is None else o.float().cpu().numpy() for o in out]

    @torch.no_grad()
    def forward_single(self, img, is_optical):
        """image (B, H, W, 1) numpy -> numpy [prob, desc]. The model shares
        one encoder between the spectra, so ``is_optical`` selects
        nothing here."""
        pred = self.module(self._to_device(img))
        return [prob_from_logits(pred['logits'], self.ratio).cpu().numpy(),
                pred['desc'].float().cpu().numpy()]

    @torch.no_grad()
    def nms(self, prob):
        """(B, H, W) heatmaps, numpy or tensor -> numpy, suppressed scores
        zeroed (identity with ``nms: 0``)."""
        p = self._to_device(prob)
        if self.cfg['nms'] > 0:
            p = box_nms(p, self.cfg['nms'],
                        float(self.cfg['detection_threshold']),
                        keep_top_k=int(self.cfg.get('topk') or 0))
        return p.cpu().numpy()

    def keypoints_from_prob(self, prob_nms, valid_mask=None):
        """Host threshold + nonzero on one (H, W) map: (n, 2) integer (row,
        col) keypoints."""
        p = np.asarray(prob_nms)
        if valid_mask is not None:
            p = p * valid_mask
        return np.argwhere(p > float(self.cfg['detection_threshold']))
