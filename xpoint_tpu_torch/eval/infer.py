"""Inference wrapper of the evaluation loops, the label export and the CLIs
(port of ``xpoint_tpu/eval/infer.py``: ``XPointInference`` and the
classical baselines' ``ClassicInference``).

Heatmaps, NMS, subpixel refinement, descriptor sampling and matching run on
the module's device; keypoint extraction is host-side with exact reference
semantics (threshold, then ``np.argwhere``), where the JAX package reads
back to the host too. PyTorch needs no static shapes, so descriptors are
sampled and matched at exactly the n keypoints found: nothing is padded and
no keypoint is ever dropped. ``max_kp`` is kept as the recorded capacity,
grown by powers of two as in the JAX package, with a warning that says
nothing is allocated to it.
"""
import warnings

import numpy as np
import torch

from ..ops.descriptor import interpolate_descriptors
from ..ops.detector import prob_from_logits, refine_keypoints_subpixel
from ..ops.matching import (knn2_match, matches_to_list, mnn_match,
                            threshold_match)
from ..ops.nms import box_nms


class XPointInference:
    """``module`` None is a host-side baseline (``ClassicInference``),
    which brings its own forward; NMS, descriptor sampling and matching
    then run on ``device``. Otherwise they run on the module's device."""

    def __init__(self, module, prediction_config=None, max_kp=4096,
                 device="cuda"):
        self.module = module
        self.cfg = dict({'nms': 8, 'detection_threshold': 0.015, 'topk': 0,
                         'subpixel': False},
                        **(prediction_config or {}))
        # an extension of the JAX package, off by default: quadratic-peak
        # refinement of the integer keypoints on the raw heatmap
        self.subpixel = bool(self.cfg['subpixel'])
        self.max_kp = max_kp
        if module is None:
            self.ratio, self.device = None, torch.device(device)
        else:
            self.ratio = module.encoder_downsample_ratio
            self.device = next(module.parameters()).device

        # the configured matcher (reference matching.py:4-36 dispatch)
        mcfg = self.cfg.get('matching') or {}
        method = mcfg.get('method', 'bfmatcher')
        kwargs = mcfg.get('method_kwargs') or {}
        self._threshold_mode = method == 'thresholdmatcher'
        if mcfg.get('knn_matches', False):
            def match(d1, d2):
                return knn2_match(d1, d2, ratio=0.9)
        elif self._threshold_mode:
            match_thr = float(kwargs.get('threshold', 0.4))

            def match(d1, d2):
                return threshold_match(d1, d2, threshold=match_thr)
        else:
            cross = bool(kwargs.get('crossCheck', method == 'bfmatcher'))
            match_thr = kwargs.get('threshold')
            if method == 'nnmatcher':
                match_thr = float(kwargs.get('threshold', 0.7))
                cross = True
            elif method == 'flann':
                # cv2's FLANN is an approximate NN without cross-check; the
                # exact NN is run instead, and said so
                cross = False
                match_thr = None
                print("matching method 'flann': using exact on-device "
                      "nearest-neighbor (cv2 FLANN is an approximate NN; "
                      "exact NN dominates it)", flush=True)

            def match(d1, d2):
                return mnn_match(d1, d2, threshold=match_thr,
                                 cross_check=cross)
        self._match = match

    def takes_pair(self):
        return True

    def _to_device(self, x):
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    # ---- heatmaps ----
    @torch.no_grad()
    def forward_pair_device(self, img_o, img_t):
        """images (B, H, W, 1) -> tensors on the device (prob_o, prob_t,
        desc_o, desc_t, pred_hm)."""
        pred_o, pred_t, pred_hm = self.module.forward_pair(
            self._to_device(img_o), self._to_device(img_t))
        return (prob_from_logits(pred_o['logits'], self.ratio),
                prob_from_logits(pred_t['logits'], self.ratio),
                pred_o['desc'], pred_t['desc'], pred_hm)

    def forward_pair(self, img_o, img_t):
        """images (B, H, W, 1) numpy -> numpy (prob_o, prob_t, desc_o,
        desc_t, pred_hm)."""
        return [None if o is None else o.float().cpu().numpy()
                for o in self.forward_pair_device(img_o, img_t)]

    @torch.no_grad()
    def forward_single(self, img, is_optical):
        """image (B, H, W, 1) numpy, is_optical (B,) bool -> numpy [prob,
        desc]: the model run 'mixed', each sample through its spectrum's
        route."""
        is_optical = torch.as_tensor(np.asarray(is_optical, bool).reshape(-1))
        pred = self.module(self._to_device(img), "mixed",
                           is_optical.to(self.device))
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

    # ---- dynamic-count helpers ----
    @torch.no_grad()
    def keypoints_from_prob(self, prob_nms, valid_mask=None, prob_raw=None):
        """Host threshold + nonzero on one (H, W) map: (n, 2) integer (row,
        col) keypoints. With ``subpixel: true`` and the pre-NMS map passed
        as ``prob_raw``, they are refined on the device (quadratic peak
        interpolation) and returned as float32."""
        p = np.asarray(prob_nms)
        if valid_mask is not None:
            p = p * valid_mask
        kps = np.argwhere(p > float(self.cfg['detection_threshold']))
        if not self.subpixel or prob_raw is None or len(kps) == 0:
            return kps
        self._capacity(len(kps))
        refined = refine_keypoints_subpixel(
            self._to_device(prob_raw), torch.from_numpy(kps).to(self.device))
        return refined.cpu().numpy()

    def _capacity(self, n):
        """Grow the recorded capacity ``max_kp`` by powers of two to hold n
        keypoints, as the JAX package does, and warn when it grows. Nothing
        is padded to it: every keypoint is kept whatever its value."""
        k = self.max_kp
        while k < n:
            k *= 2
        if k > self.max_kp:
            warnings.warn(f"{n} keypoints exceed max_kp={self.max_kp}; "
                          f"recording capacity {k} (nothing is padded or "
                          f"allocated to it)")
            self.max_kp = k
        return k

    @torch.no_grad()
    def descriptors_at(self, keypoints, desc_map, image_shape):
        """L2-normed descriptors (n, D) numpy sampled at (n, 2) host
        keypoints from one (Hc, Wc, D) map (numpy or tensor)."""
        self._capacity(len(keypoints))
        kps = torch.as_tensor(np.asarray(keypoints, np.float32).reshape(-1, 2))
        d = interpolate_descriptors(kps.to(self.device)[None],
                                    self._to_device(desc_map)[None],
                                    tuple(image_shape))
        return d[0].cpu().numpy()

    def match_crosscheck(self, desc1, desc2):
        """Always cross-checked mutual NN (the reference hard-codes
        BFMatcher crossCheck=True for the NN-mAP and M-score matches,
        evaluation.py:286-301, whatever matcher is configured)."""
        return self._match_host(
            desc1, desc2, lambda a, b: mnn_match(a, b, cross_check=True),
            False)

    def match(self, desc1, desc2):
        """The configured matcher (used for the homography estimation, as
        in the reference, evaluation.py:351-357)."""
        return self._match_host(desc1, desc2, self._match,
                                self._threshold_mode)

    @torch.no_grad()
    def _match_host(self, desc1, desc2, fn, threshold_mode):
        """(n1, D), (n2, D) host descriptors -> list of (i, j, dist)."""
        n1, n2 = len(desc1), len(desc2)
        if n1 == 0 or n2 == 0:
            return []
        self._capacity(max(n1, n2))
        out = fn(self._to_device(desc1)[None], self._to_device(desc2)[None])
        if threshold_mode:
            match_mat, dmat = (t[0].cpu().numpy() for t in out)
            ii, jj = np.nonzero(match_mat)
            return [(int(i), int(j), float(dmat[i, j]))
                    for i, j in zip(ii, jj)]
        return matches_to_list(*(t[0] for t in out))


def _host(img):
    return img.cpu().numpy() if torch.is_tensor(img) else np.asarray(img)


class ClassicInference(XPointInference):
    """The benchmark adapter of the classical baselines (SIFT / SURF / LGHD
    / RIFT2, ``models.classic.ClassicDetectors``), as in the JAX package:
    the forward is the host-side cv2 model, whose sparse prob / desc maps
    go to ``device``; NMS (the grid NMS kernel on the card), descriptor
    sampling, matching and every metric downstream are
    XPointInference's, so the baseline's numbers and a learned model's come
    from the same code."""

    def __init__(self, model, prediction_config=None, max_kp=4096,
                 device="cuda"):
        super().__init__(None, prediction_config, max_kp, device)
        self.model = model

    def takes_pair(self):
        return bool(self.model.takes_pair())

    def _forward_pair_host(self, img_o, img_t):
        out_o = self.model({'image': _host(img_o)})
        out_t = self.model({'image': _host(img_t)})
        desc_o, desc_t = out_o['desc'], out_t['desc']
        # a side with no detection gives a depth-1 placeholder plane; pad
        # so that the descriptor metrics see one depth
        if desc_o.shape[-1] != desc_t.shape[-1]:
            depth = max(desc_o.shape[-1], desc_t.shape[-1])

            def _pad(d):
                return np.pad(d, [(0, 0)] * (d.ndim - 1)
                              + [(0, depth - d.shape[-1])])
            desc_o, desc_t = _pad(desc_o), _pad(desc_t)
        return out_o['prob'], out_t['prob'], desc_o, desc_t

    def forward_pair_device(self, img_o, img_t):
        """images (1, H, W, 1) -> the sparse maps as tensors on the device
        (prob_o, prob_t, desc_o, desc_t, None)."""
        return (*(self._to_device(m) for m in self._forward_pair_host(
            img_o, img_t)), None)

    def forward_pair(self, img_o, img_t):
        return [*self._forward_pair_host(img_o, img_t), None]

    def forward_single(self, img, is_optical):
        out = self.model({'image': _host(img)})
        return [out['prob'], out['desc']]
