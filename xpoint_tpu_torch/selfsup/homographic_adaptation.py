"""Homographic adaptation: self-supervised pseudo-ground-truth keypoints
(port of ``xpoint_tpu/selfsup/homographic_adaptation.py``).

  * run the detector on the original optical/thermal pair, aggregate the two
    probability maps (prod / sum / window),
  * for each of num-1 random homographies: warp both images, re-run the
    detector, un-warp the probabilities, accumulate count-weighted,
  * prod -> sqrt, sum -> x0.5; zero out where count < min_count,
  * 'window' mode cross-checks keypoints within a k x k window between the
    two spectra (``search_window``).

Homographies are sampled on the host up front (numpy); the warp -> forward
-> unwarp -> accumulate loop runs on the images' device, ``warp_batch``
homographies per step, under ``torch.no_grad()``; its warps go through
``ops/warp_projective.py`` (the projective-warp kernel on the card, the
plain gather on the CPU, at any image size). Images and probability
maps are channels-last / (B, H, W), as on the JAX side.
``make_sharded_ha_fn`` runs the program over the ranks of a mesh: each
rank its rows of the sample batch, the homography stack replicated, no
collective inside; the outputs are gathered over the ranks.
"""
import copy
from math import pi

import numpy as np
import torch
import torch.nn.functional as F

from .. import obs
from ..geometry.homography import (compute_valid_mask_device,
                                   sample_homography)
from ..ops import warp_projective as wp
from ..parallel.mesh import gather_rows
from ..utils import dict_update


HA_DEFAULT_CONFIG = {
    'num': 100,
    'aggregation': 'prod',
    'homographies': {
        'translation': True, 'rotation': True, 'scaling': True,
        'perspective': True, 'scaling_amplitude': 0.15,
        'perspective_amplitude_x': 0.15, 'perspective_amplitude_y': 0.15,
        'patch_ratio': 0.9, 'max_angle': pi, 'allow_artifacts': True,
    },
    'erosion_radius': 5,
    'mask_border': True,
    'min_count': 2,
    'filter_size': 0,
    'weighted_window': True,
    'window_size': 5,
}

# own copy of configs/config_export_keypoints.yaml (homographic_adaptation
# and prediction blocks): the label-export settings
EXPORT_HA_CONFIG = {
    'num': 10,
    'aggregation': 'window',
    'weighted_window': True,
    'window_size': 5,
    'erosion_radius': 3,
    'mask_border': True,
    'min_count': 5,
    'filter_size': 0,
    'homographies': {
        'translation': True, 'rotation': True, 'scaling': True,
        'perspective': True, 'scaling_amplitude': 0.2,
        'perspective_amplitude_x': 0.2, 'perspective_amplitude_y': 0.2,
        'patch_ratio': 0.85, 'max_angle': 1.57, 'allow_artifacts': True,
    },
}
EXPORT_PREDICTION_CONFIG = {'detection_threshold': 0.015, 'nms': 8,
                            'topk': 0}


def search_window(prob1, prob2, window_size, weighted_window):
    """Cross-spectral window check: keep (and weight) each keypoint by the
    total probability mass of the OTHER spectrum within a window_size x
    window_size neighborhood (zero-padded window sum). prob: (B, H, W)."""
    assert window_size % 2 == 1

    def window_sum(p):
        return F.avg_pool2d(p[:, None], window_size, stride=1,
                            padding=window_size // 2,
                            divisor_override=1)[:, 0]

    f1 = window_sum(prob2) * prob1
    f2 = window_sum(prob1) * prob2
    if not weighted_window:
        f1 = (f1 > 0).to(prob1.dtype)
        f2 = (f2 > 0).to(prob2.dtype)
    return f1, f2


def _gaussian_kernel(size, sigma=None):
    if sigma is None:
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    g = np.arange(size) - (size - 1) / 2.0
    gx, gy = np.meshgrid(g, g)
    k = np.exp(-(gx ** 2 + gy ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _smooth(prob, size):
    """Reflect-padded gaussian smoothing of (B, H, W) heatmaps."""
    k = torch.from_numpy(_gaussian_kernel(size)).to(prob.device)
    pad = (size - 1) // 2
    p = F.pad(prob[:, None], (pad, pad, pad, pad), mode="reflect")
    return F.conv2d(p, k[None, None])[:, 0]


def sample_ha_homographies(config, image_shape, rng=None):
    """Host-side: the stack of (num-1) fp32 homographies of one HA run,
    (num-1, 3, 3). The eroded valid masks are derived on the device
    (``compute_valid_mask_device``) by the HA program."""
    with obs.span("xp.ha.sample"):
        Hs = [sample_homography(np.array(image_shape), rng=rng,
                                **config['homographies']).astype(np.float32)
              for _ in range(max(config['num'] - 1, 0))]
    return np.stack(Hs) if Hs else np.zeros((0, 3, 3), np.float32)


def make_ha_fn(prob_fn, config=None, warp_batch=8):
    """Build the multispectral HA program.

    Args:
        prob_fn: (image (B,H,W,1), is_optical: bool) -> prob (B,H,W): the
            detector forward + cell softmax, on the image's device.
        config: HA config dict (merged over HA_DEFAULT_CONFIG).
        warp_batch: warps processed per step: each step runs the net on
            (warp_batch * B) images at once; the count-weighted accumulation
            is associative, so the result does not depend on it.

    Returns (fn(img_o, img_t, homographies (n,3,3), valid_masks (n,H,W)|None)
        -> dict with 'prob' (prod/sum modes) or 'prob_optical' /
        'prob_thermal' (window mode) and the per-pixel 'count', merged
        config). valid_masks=None computes the eroded masks on the device.
    """
    cfg = dict_update(copy.deepcopy(HA_DEFAULT_CONFIG), config or {})
    if cfg['num'] < 1:
        raise ValueError('num must be >= 1 for homographic adaptation')
    if cfg['filter_size'] % 2 == 0 and cfg['filter_size'] != 0:
        raise ValueError('filter_size must be odd')
    if cfg['aggregation'] == 'window' and cfg['filter_size'] > 0:
        raise ValueError('window aggregation requires filter_size == 0')
    if cfg['aggregation'] not in ('prod', 'sum', 'window'):
        raise ValueError(f"unknown aggregation: {cfg['aggregation']}")

    @torch.no_grad()
    def run(img_o, img_t, homographies, valid_masks=None):
        return _ha_run_impl(prob_fn, cfg, warp_batch, img_o, img_t,
                            homographies, valid_masks)

    return run, cfg


def make_sharded_ha_fn(prob_fn, config, mesh, warp_batch=8):
    """Mesh-sharded HA program for multi-device label export (port of the
    JAX ``make_sharded_ha_fn``; its ``make_prob_fn(variables)`` is
    ``prob_fn`` here, the module being the replicated variables). Every
    rank passes the same global sample batch (its size a multiple of the
    mesh size) and homography stack; each runs the program of
    :func:`make_ha_fn` on its rows, with no collective, and the outputs
    are gathered over the ranks (one all-reduce an output, bit for bit).
    Per-sample outputs are those of one device: every per-sample
    computation is independent.

    Returns (run(img_o, img_t, homographies) -> dict, merged config)."""
    run_local, cfg = make_ha_fn(prob_fn, config, warp_batch)

    def run(img_o, img_t, homographies):
        out = run_local(mesh.rows(img_o), mesh.rows(img_t), homographies)
        return {k: None if v is None else gather_rows(v, mesh)
                for k, v in out.items()}

    run.local = run_local
    return run, cfg


def _ha_run_impl(prob_fn, cfg, warp_batch, img_o, img_t, homographies,
                 valid_masks=None):
    agg = cfg['aggregation']
    fs = cfg['filter_size']

    def maybe_smooth(p):
        return _smooth(p, fs) if fs > 0 else p

    B = img_o.shape[0]
    n = homographies.shape[0]
    wb = max(min(warp_batch, n), 1)
    with obs.span("xp.ha.sample"):
        if valid_masks is None:
            valid_masks = compute_valid_mask_device(
                homographies, img_o.shape[1:3], cfg['erosion_radius'],
                cfg['mask_border']) if n else img_o.new_zeros(
                    (0,) + tuple(img_o.shape[1:3]))
        if n % wb != 0:
            # pad with identity homographies + ZERO masks (count 0 => inert)
            pad = wb - n % wb
            eye = torch.eye(3, dtype=homographies.dtype,
                            device=homographies.device)
            homographies = torch.cat([homographies, eye.expand(pad, 3, 3)])
            valid_masks = torch.cat([valid_masks, valid_masks.new_zeros(
                (pad,) + valid_masks.shape[1:])])
    with obs.span("xp.ha.forward"):
        prob_o = maybe_smooth(prob_fn(img_o, True))
        prob_t = maybe_smooth(prob_fn(img_t, False))
    with obs.span("xp.ha.aggregate"):
        count = torch.ones_like(prob_o)
        if agg == 'prod':
            acc = prob_o * prob_t
        elif agg == 'sum':
            acc = prob_o + prob_t
        else:
            acc_o, acc_t = search_window(prob_o, prob_t, cfg['window_size'],
                                         cfg['weighted_window'])

    stacked = torch.cat([img_o, img_t], dim=-1)                # (B,H,W,2)
    for i in range(0, homographies.shape[0], wb):
        Hmats, vmasks = homographies[i:i + wb], valid_masks[i:i + wb]
        with obs.span("xp.ha.warp"):
            # ONE shared-index multi-warp applies every homography to both
            # spectra at once (index maps shared over batch AND channel)
            w = wp.warp_multi(stacked, Hmats, "bilinear", "reflection")
            w = w.reshape((wb * B,) + w.shape[2:])             # (wb*B,H,W,2)
        with obs.span("xp.ha.forward"):
            po = maybe_smooth(prob_fn(w[..., :1], True))       # (wb*B,H,W)
            pt = maybe_smooth(prob_fn(w[..., 1:], False))
            po = po.reshape((wb, B) + po.shape[1:])
            pt = pt.reshape((wb, B) + pt.shape[1:])

        with obs.span("xp.ha.unwarp"):
            Hinv = torch.linalg.inv(Hmats)                     # (wb, 3, 3)
            # the valid masks don't vary over B: unwarp once per homography
            count_sample = wp.warp_batch(vmasks[..., None], Hinv, "nearest",
                                          "zeros")[..., 0]
            count_sample = count_sample[:, None]               # (wb,1,H,W)
            # B rides the channel axis, so the inverse warp's index maps
            # are shared across the batch: (wb, B', H, W) in and out
            if agg == 'window':
                p = torch.cat([po, pt], dim=1)                 # (wb,2B,H,W)
            else:
                p = po * pt if agg == 'prod' else po + pt      # (wb,B,H,W)
            u = wp.warp_batch(p.permute(0, 2, 3, 1), Hinv, "bilinear",
                              "zeros").permute(0, 3, 1, 2)

        with obs.span("xp.ha.aggregate"):
            if agg == 'window':
                fo, ft = search_window(u[:, :B].flatten(0, 1),
                                       u[:, B:].flatten(0, 1),
                                       cfg['window_size'],
                                       cfg['weighted_window'])
                fo = fo.reshape((wb, B) + fo.shape[1:])
                ft = ft.reshape((wb, B) + ft.shape[1:])
                acc_o = acc_o + (fo * count_sample).sum(0)
                acc_t = acc_t + (ft * count_sample).sum(0)
            else:
                acc = acc + (u * count_sample).sum(0)
            count = count + count_sample.sum(0)

    keep = count >= cfg['min_count']

    def finish(out):
        if cfg['min_count'] > 0:
            out = torch.where(keep, out, torch.zeros_like(out))
        return out

    if agg == 'window':
        return {'prob': None, 'prob_optical': finish(acc_o / count),
                'prob_thermal': finish(acc_t / count), 'count': count}
    out = acc / count
    out = torch.sqrt(out) if agg == 'prod' else out * 0.5
    return {'prob': finish(out), 'prob_optical': None, 'prob_thermal': None,
            'count': count}


def homographic_adaptation_multispectral(img_o, img_t, prob_fn, config=None,
                                         rng=None):
    """Convenience wrapper: sample the homographies on the host, run the HA
    program on the images' device."""
    run, cfg = make_ha_fn(prob_fn, config)
    Hs = sample_ha_homographies(cfg, img_o.shape[1:3], rng)
    return run(img_o, img_t, torch.from_numpy(Hs).to(img_o.device))


@torch.no_grad()
def homographic_adaptation(img, prob_fn, config=None, rng=None):
    """Single-spectrum variant: the count-weighted average of the unwarped
    probabilities of one image batch (B, H, W, C), one warp per step."""
    cfg = dict_update(copy.deepcopy(HA_DEFAULT_CONFIG), config or {})
    fs = cfg['filter_size']

    def maybe_smooth(p):
        return _smooth(p, fs) if fs > 0 else p

    Hs = torch.from_numpy(
        sample_ha_homographies(cfg, img.shape[1:3], rng)).to(img.device)
    masks = compute_valid_mask_device(Hs, img.shape[1:3],
                                      cfg['erosion_radius'],
                                      cfg['mask_border'])
    prob = maybe_smooth(prob_fn(img, True))
    count = torch.ones_like(prob)
    for Hmat, vmask in zip(Hs, masks):
        w = wp.warp_multi(img, Hmat[None], "bilinear", "reflection")[0]
        p = maybe_smooth(prob_fn(w, True))
        Hinv = torch.linalg.inv(Hmat)[None]
        count_sample = wp.warp_batch(vmask[None, :, :, None], Hinv, "nearest",
                                      "zeros")[0, ..., 0]          # (H, W)
        unwarped = wp.warp_multi(p[..., None], Hinv, "bilinear",
                                 "zeros")[0, ..., 0]
        prob = prob + unwarped * count_sample
        count = count + count_sample
    out = prob / count
    if cfg['min_count'] > 0:
        out = torch.where(count >= cfg['min_count'], out,
                          torch.zeros_like(out))
    return out
