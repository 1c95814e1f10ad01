"""The comparison that decides ``correct``.

Serving: for a sample of the window's calls, drawn from the seed, the
reference runs the two forwards in float32 on the same images and weights,
and the stages after the model follow the program's own outputs:

  * ``prob_gap``: the widest gap between the program's and the reference's
    detector probability maps;
  * ``desc_gap``: the widest L2 gap between the program's descriptors and
    the reference's descriptor map sampled at the program's keypoints;
  * ``nms_wrong``: keypoints, scores and masks that box-NMS with top-k,
    run by the reference on the program's probability maps, does not give
    (exact: a returned keypoint that NMS does not keep, a score that is
    not the map's, a top-k score list that differs, a padding row that is
    not zero);
  * ``match_wrong``: queries whose match index, distance or mutual flag
    differs from mutual-NN matching run by the reference on the program's
    descriptors and masks (exact but for near-ties, ``TIE`` apart).

Training: the reference follows the first three steps in float32 from the
same weights, batches and generator states:

  * ``loss_gap``: the widest relative gap of a step's loss;
  * ``grad_gap``: the first gradient as the program's Adam holds it
    (mu / (1 - b1) after one step), by the worst leaf: the gap between the
    program's and the reference's norms over the larger of the reference
    leaf's norm and the median leaf's;
  * ``delta_gap``: the same for each leaf's change over the three steps,
    over the leaves whose reference gradient is at least a thousandth of
    the median leaf's (a bias followed by a BatchNorm in train mode has
    none, and moves under Adam by round-off alone).
"""
import torch

from . import reference
from .reference import ops as R
from .reference.train import Adam, xpoint_loss

TIE = 1e-5


def _ref_forwards(model, img_o, img_t):
    with torch.no_grad():
        po, pt = model(img_o), model(img_t)
    return po, pt


def serve_readings(model, ratio, traffic, img_o, img_t, out):
    """The four serving numbers of one call: ``out``, the program's outputs
    (or the control's) for the images, against the reference ``model``."""
    H, W = traffic["image"]
    po, pt = _ref_forwards(model, img_o, img_t)
    prob_gap = desc_gap = 0.0
    nms_wrong = 0
    for side, pred in (("optical", po), ("thermal", pt)):
        prob_ref = R.prob_from_logits(pred["logits"], ratio)
        prob = out[f"prob_{side}"].float()
        prob_gap = max(prob_gap, (prob - prob_ref).abs().max().item())
        kps, sc, m = (out[f"keypoints_{side}"], out[f"scores_{side}"],
                      out[f"mask_{side}"])
        d_ref = R.interpolate_descriptors(kps, pred["desc"], (H, W))
        gap = torch.linalg.vector_norm(out[f"desc_{side}"].float() - d_ref,
                                       dim=-1)
        desc_gap = max(desc_gap, torch.where(m, gap, 0.0).max().item())
        nms_wrong += nms_mismatches(prob, kps, sc, m, traffic)
    match_wrong = match_mismatches(out)
    return {"prob_gap": prob_gap, "desc_gap": desc_gap,
            "nms_wrong": nms_wrong, "match_wrong": match_wrong}


def nms_mismatches(prob, kps, sc, m, traffic):
    """Rows of (keypoints, scores, mask) that NMS with top-k on ``prob``
    does not give: a returned keypoint that NMS does not keep or whose
    score is not the map's, a padding row that is not zero, a keypoint
    returned twice, and each kept pixel above the lowest returned score
    (any kept pixel, where fewer than k came back) that was not returned.
    A kept pixel whose score exactly equals that of a returned pixel of its
    overlap set is not counted: greedy NMS keeps one box of such a tie."""
    B, H, W = prob.shape
    k, thr, size = traffic["k"], traffic["threshold"], traffic["nms_size"]
    keep = R.box_nms_keep(prob, size, thr, traffic["iou"])
    flat = kps[..., 0].long() * W + kps[..., 1].long()
    b = torch.arange(B, device=prob.device)[:, None]
    kept = keep.reshape(B, -1)[b, flat]
    at = prob.reshape(B, -1)[b, flat]
    bad = m & (~kept | (at != sc))
    bad |= ~m & ((kps != 0).any(-1) | (sc != 0))
    dup = torch.sort(torch.where(m, flat, -1 - torch.arange(
        flat.shape[1], device=flat.device)), dim=1)[0]
    wrong = int(bad.sum().item()) + int((dup[:, 1:] == dup[:, :-1]).sum())
    returned = torch.zeros(B, H * W, dtype=torch.bool, device=prob.device)
    returned[b.expand_as(flat)[m], flat[m]] = True
    returned = returned.reshape(B, H, W)
    n = m.sum(1)
    low = torch.where(n >= k, torch.where(m, sc, float("inf")).amin(1),
                      torch.full_like(n, -1, dtype=prob.dtype))
    missing = keep & ~returned & (prob > low[:, None, None])
    widths = R.overlap_widths(size, traffic["iou"])
    for bi, y, x in missing.nonzero().tolist():
        v = prob[bi, y, x]
        tied = False
        for dy in range(-(size - 1), size):
            w = widths[abs(dy)]
            if w < 0 or not 0 <= y + dy < H:
                continue
            x0, x1 = max(0, x - w), min(W, x + w + 1)
            row = slice(x0, x1)
            if bool((returned[bi, y + dy, row]
                     & (prob[bi, y + dy, row] == v)).any()):
                tied = True
                break
        wrong += not tied
    return wrong


def match_mismatches(out):
    """Queries whose match differs from mutual-NN matching of the
    program's own descriptors and masks, near-ties aside."""
    d1, d2 = out["desc_optical"].float(), out["desc_thermal"].float()
    m1, m2 = out["mask_optical"], out["mask_thermal"]
    dmat = R.distance_matrix(d1, d2, m1, m2)
    idx = out["match_idx"].long()
    dist, matched = out["match_dist"].float(), out["matched"]
    own = torch.gather(dmat, 2, idx[..., None])[..., 0]
    row_best = dmat.min(2).values
    bad = (own > row_best + TIE) | ((own - dist).abs() > TIE)
    # the best other query for the chosen column
    colmat = torch.gather(dmat.transpose(1, 2), 1,
                          idx[..., None].expand(-1, -1, dmat.shape[1]))
    rows = torch.arange(dmat.shape[1], device=dmat.device)
    others = torch.where(rows[None, None, :] == rows[None, :, None],
                         torch.full((), R.BIG, device=dmat.device), colmat)
    other_best = others.min(2).values
    valid = m1 & (row_best < R.BIG)
    must = valid & (own < other_best - TIE)
    must_not = ~valid | (own > other_best + TIE)
    bad |= (must & ~matched) | (must_not & matched)
    return int(bad.sum().item())


def reference_outputs(model, ratio, traffic, img_o, img_t):
    """The serving chain run by the reference model (the control, where
    that model computes in a lower precision), with the program's output
    keys."""
    H, W = traffic["image"]
    k, thr = traffic["k"], traffic["threshold"]
    po, pt = _ref_forwards(model, img_o, img_t)
    out = {}
    for side, pred in (("optical", po), ("thermal", pt)):
        prob = R.prob_from_logits(pred["logits"], ratio)
        keep = R.box_nms_keep(prob, traffic["nms_size"], thr, traffic["iou"])
        sc, idx, m = R.top_k(prob, keep, k, thr)
        kps = torch.stack([idx // W, idx % W], -1)
        out.update({f"prob_{side}": prob,
                    f"keypoints_{side}": torch.where(m[..., None], kps, 0),
                    f"scores_{side}": torch.where(m, sc, 0.0),
                    f"mask_{side}": m})
        out[f"desc_{side}"] = R.interpolate_descriptors(
            out[f"keypoints_{side}"], pred["desc"], (H, W))
    idx2, dist, matched = R.mnn_match(out["desc_optical"],
                                      out["desc_thermal"],
                                      out["mask_optical"], out["mask_thermal"])
    out.update(match_idx=idx2, match_dist=dist, matched=matched)
    return out


# ---- training ---------------------------------------------------------------

def _rel_gap(a, b, floor):
    return abs(a - b) / max(abs(b), floor)


def _leaf_gaps(prog, ref, names, only=None):
    """{leaf: |norm(prog) - norm(ref)| / max(norm(ref), the median leaf's
    norm)} over the leaves ``only`` admits."""
    pn = {n: torch.linalg.vector_norm(prog[n].float()).item() for n in names}
    rn = {n: torch.linalg.vector_norm(ref[n].float()).item() for n in names}
    med = sorted(rn.values())[len(rn) // 2]
    use = [n for n in names if only is None or only(n)]
    return {n: _rel_gap(pn[n], rn[n], med) for n in use}


def reference_steps(config, state, batches, seeds, device, control=None):
    """The reference (or the control) through the first steps: the losses,
    the first step's gradients and each parameter's change, by name."""
    model, prec = reference.build(config["model"], config["precision"],
                                  state, device, control=control)
    model.train()
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    p0 = [p.detach().clone() for p in params]
    tr = config["training"]
    opt = Adam(params, float(tr["learningrate"]),
               float(tr.get("weight_decay", 0) or 0))
    losses, grads0 = [], None
    for batch, seed in zip(batches, seeds):
        gen = torch.Generator(device=device).manual_seed(seed)
        po, pt, hm = model.forward_pair(batch["optical"]["image"],
                                        batch["thermal"]["image"], gen)
        loss = xpoint_loss(batch, po, pt, hm, config["loss"], gen, prec)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if grads0 is None:
            grads0 = dict(zip(names, grads))
        opt.step(grads)
        losses.append(loss.item())
    delta = {n: (p.detach() - q) for n, p, q in zip(names, params, p0)}
    return {"losses": losses, "grads": grads0, "delta": delta}


def train_readings(prog, ref):
    """The three training numbers of the program's (or a control's)
    record against the reference's."""
    names = list(ref["grads"])
    loss_gap = max(_rel_gap(a, b, 1e-12) for a, b in zip(prog["losses"],
                                                          ref["losses"]))
    grads = _leaf_gaps(prog["grads"], ref["grads"], names)
    gn = {n: torch.linalg.vector_norm(ref["grads"][n]).item() for n in names}
    med = sorted(gn.values())[len(gn) // 2]
    delta = _leaf_gaps(prog["delta"], ref["delta"], names,
                       only=lambda n: gn[n] >= 1e-3 * med)
    g_leaf, d_leaf = max(grads, key=grads.get), max(delta, key=delta.get)
    return ({"loss_gap": loss_gap, "grad_gap": grads[g_leaf],
             "delta_gap": delta[d_leaf]},
            {"grad_gap": g_leaf, "delta_gap": d_leaf})


def verdict(readings, limits):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit."""
    table = {n: {"value": readings[n], "limit": limits[n]} for n in limits}
    return all(readings[n] <= limits[n] for n in limits), table
