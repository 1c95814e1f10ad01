"""Detect + describe + match (+ register) for an image pair (port of
``xpoint_tpu/eval/pipeline.py::make_pair_pipeline``).

forward(optical) + forward(thermal) (each through its own spectrum's
route: encoder and statistics of a multispectral model) -> cell softmax +
depth-to-space -> box-NMS (both spectra in one call) -> top-k keypoints ->
bilinear descriptor sampling -> mutual-NN matching -> optionally the
homography by RANSAC on the device (``geometry.ransac``). The JAX
per-sample vmap is a batch dimension here.

``make_sharded_pair_pipeline`` is the data-parallel serving of
``xpoint_tpu/eval/pipeline.py:95-151``: each rank of a mesh runs the same
pipeline on its rows of the global batch, with no collective inside it,
and the outputs are gathered over the ranks at the end.
"""
import torch

from .. import obs
from ..geometry.ransac import gumbel_noise, ransac_homography
from ..ops.descriptor import interpolate_descriptors
from ..ops.detector import prob_from_logits
from ..ops.matching import mnn_match
from ..ops.nms import box_nms_extract
from ..parallel.mesh import gather_rows


def make_pair_pipeline(module, image_shape, k=1024, nms_size=8,
                       detection_threshold=0.015, iou=0.1,
                       match_threshold=None, cross_check=True, ratio=8,
                       estimate_homography=False, ransac_iters=512,
                       ransac_threshold=3.0, mesh=None):
    """Returns fn(img_o, img_t, generator=None) -> dict of tensors on the
    module's device.

    Images: (B, H, W, 1). Output keys are those of the JAX pipeline:
    prob_*, keypoints_*, scores_*, mask_*, desc_* for both spectra, and
    match_idx, match_dist, matched. With ``estimate_homography`` the
    registration homography is fitted on the device too, from the matched
    points in (x, y) with the match distances as the PROSAC quality, and
    the output gains H_est (B, 3, 3), ransac_inliers, ransac_score and
    ransac_n_inliers. Each sample's RANSAC noise is drawn from
    ``generator`` (default: a generator on the device seeded with 0), where
    the JAX pipeline splits one key a sample. With ``mesh``, the images are
    this rank's rows of a global batch and the noise is the global batch's
    draw, this rank's rows kept (the JAX keys split over the global batch
    and sharded).
    """
    H, W = image_shape

    @torch.no_grad()
    def run(img_o, img_t, generator=None):
        with obs.root("xp.pipe.call", batch=img_o.shape[0]):
            return _run(img_o, img_t, generator)

    def _run(img_o, img_t, generator):
        B = img_o.shape[0]
        with obs.span("xp.pipe.forward", spectrum="optical"):
            pred_o = module(img_o, "optical")
        with obs.span("xp.pipe.forward", spectrum="thermal"):
            pred_t = module(img_t, "thermal")
        with obs.span("xp.pipe.detect"):
            prob_o = prob_from_logits(pred_o["logits"], ratio)
            prob_t = prob_from_logits(pred_t["logits"], ratio)
        with obs.span("xp.pipe.nms"):
            kps, sc, m = box_nms_extract(torch.cat([prob_o, prob_t]),
                                         nms_size, detection_threshold, iou,
                                         k)
        kps_o, kps_t = kps[:B], kps[B:]
        with obs.span("xp.pipe.describe"):
            d_o = interpolate_descriptors(kps_o.float(), pred_o["desc"],
                                          (H, W))
            d_t = interpolate_descriptors(kps_t.float(), pred_t["desc"],
                                          (H, W))
        with obs.span("xp.pipe.match"):
            idx2, dist, matched = mnn_match(d_o, d_t, m[:B], m[B:],
                                            match_threshold, cross_check)
        extra = {}
        if estimate_homography:
            with obs.span("xp.pipe.ransac"):
                extra = _ransac(kps_o, kps_t, idx2, dist, matched,
                                generator)
        return {
            **extra,
            "prob_optical": prob_o, "prob_thermal": prob_t,
            "keypoints_optical": kps_o, "keypoints_thermal": kps_t,
            "scores_optical": sc[:B], "scores_thermal": sc[B:],
            "mask_optical": m[:B], "mask_thermal": m[B:],
            "desc_optical": d_o, "desc_thermal": d_t,
            "match_idx": idx2, "match_dist": dist, "matched": matched,
        }

    def _ransac(kps_o, kps_t, idx2, dist, matched, generator):
        B, dev = kps_o.shape[0], kps_o.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        p1 = kps_o.float().flip(-1)
        p2 = torch.gather(kps_t.float(), 1,
                          idx2.long()[..., None].expand(-1, -1, 2)).flip(-1)
        n_ranks = mesh.size if mesh is not None else 1
        g = gumbel_noise((B * n_ranks, ransac_iters, kps_o.shape[1]),
                         generator, dev)
        if mesh is not None:
            g = mesh.rows(g)
        r = ransac_homography(p1, p2, matched, g,
                              threshold=ransac_threshold, quality=dist)
        return {"H_est": r["H"], "ransac_inliers": r["inliers"],
                "ransac_score": r["score"], "ransac_n_inliers": r["n_inliers"]}

    return run


def make_sharded_pair_pipeline(module, image_shape, mesh, **kw):
    """Data-parallel serving over the ranks of ``mesh`` (port of the JAX
    ``make_sharded_pair_pipeline``). Returns fn(img_o, img_t,
    generator=None): every rank passes the same global batch (its size a
    multiple of the mesh size), runs :func:`make_pair_pipeline`'s program
    on its rows (``fn.base``; no collective inside it), and the outputs are
    gathered over the ranks (one all-reduce a key, bit for bit), so every
    rank returns the global batch's outputs. RANSAC noise is the global
    batch's draw, so per-sample outputs are those of one device on the
    global batch."""
    base = make_pair_pipeline(module, image_shape, mesh=mesh, **kw)

    def run(img_o, img_t, generator=None):
        dev = next(module.parameters()).device
        out = base(mesh.rows(img_o).to(dev), mesh.rows(img_t).to(dev),
                   generator)
        return {k: gather_rows(v, mesh) for k, v in out.items()}

    run.base = base
    return run
