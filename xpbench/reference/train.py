"""The XPoint training loss and the Adam update in plain float32 PyTorch.

The loss is the configuration's ``loss`` section as published: the
65-class detector cross entropy with soft assignment of the keypoints a
cell holds and a weighted dustbin, normalised by each sample's valid cells;
the dense descriptor hinge over every pair of cells, with the valid-mask
product and, where the configuration asks for it, the hard-negative term;
the MSE of the RegNet output against the normalised corner offsets. The
detector loss draws its tiebreak noise (unused by soft assignment) from
the generator as the program does, so that both sides' generators stay in
step. Adam is optax's ``scale_by_adam`` followed by ``scale(-lr)``, with
torch-style L2 weight decay.
"""
import torch
import torch.nn.functional as F

from .ops import space_to_depth


def warp_points(points, h):
    """(B, N, 2) (row, col) by (B, 3, 3) homographies on (x, y, 1)."""
    xy = points.flip(-1)
    hom = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
    w = (h[:, None, :, :] * hom[:, :, None, :]).sum(-1)
    return (w[..., :2] / w[..., 2:]).flip(-1)


def detector_loss(logits, keypoints, valid_mask, cfg, gen):
    r = 8
    labels = space_to_depth(keypoints.float(), r)
    valid = torch.prod(space_to_depth(valid_mask.float(), r), dim=-1)
    torch.rand(labels.shape, generator=gen, device=labels.device)
    if cfg["detector_handle_multiple_keypoints"] != "soft_assignment":
        raise ValueError("the reference holds soft assignment")
    if cfg["detector_loss_function"] != "cross_entropy":
        raise ValueError("the reference holds the cross entropy")
    soft = labels / (labels.sum(-1, keepdim=True) + 1e-6)
    target = torch.cat([soft, 1.0 - soft.sum(-1, keepdim=True)], -1)
    w = torch.ones(logits.shape[-1], device=logits.device)
    w[-1] = cfg["detector_dustbin_loss_weight"]
    values = -(w * target * F.log_softmax(logits, dim=-1)).sum(-1) * valid
    return (values.sum((1, 2)) / valid.sum((1, 2)).clamp_min(1.0)).mean()


def descriptor_loss(d1, d2, h1, h2, v1, v2, cfg, prec):
    B, Hc, Wc, D = d1.shape
    dev = d1.device
    ys, xs = torch.meshgrid(torch.arange(Hc, device=dev),
                            torch.arange(Wc, device=dev), indexing="ij")
    cells = (torch.stack([ys, xs], -1).float() * 8.0 + 4.0).reshape(1, -1, 2)
    cells = cells.expand(B, -1, -1)
    w1 = warp_points(cells, torch.linalg.inv(h1))
    w2 = warp_points(cells, torch.linalg.inv(h2))
    corr = (torch.linalg.vector_norm(w2[:, :, None] - w1[:, None], dim=-1)
            <= cfg["descriptor_loss_threshold"]).float()
    dot = prec.matmul(d2.reshape(B, -1, D), d1.reshape(B, -1, D)
                      .transpose(1, 2), "fp32")
    m1 = torch.prod(space_to_depth(v1.float(), 8), -1).reshape(B, -1)
    m2 = torch.prod(space_to_depth(v2.float(), 8), -1).reshape(B, -1)
    vm = m2[:, :, None] * m1[:, None, :]
    if not cfg["descriptor_loss_use_mask"]:
        raise ValueError("the reference holds the masked descriptor loss")
    pos = cfg["lambda_d"] * corr * (cfg["positive_margin"] - dot).clamp_min(
        0.0) * vm
    hinge = (dot - cfg["negative_margin"]).clamp_min(0.0)
    neg = (1 - corr) * hinge * vm
    norm = vm.sum((1, 2)).clamp_min(1.0)
    total = (pos + neg).sum((1, 2)) / norm
    hn = cfg.get("hard_negative_weighting", {}) or {}
    if hn.get("check"):
        if not hn.get("keep_uniform", True):
            raise ValueError("the reference keeps the uniform negatives")
        e = torch.exp(dot / float(hn.get("temperature", 0.1))) * (1 - corr) \
            * vm
        num = e * hinge

        def anchored(dim):
            den = e.sum(dim)
            ok = den > 0
            ratio = torch.where(ok, num.sum(dim) / torch.where(ok, den, 1.0),
                                0.0)
            return ratio.sum(1) / ok.float().sum(1).clamp_min(1.0)

        total = total + float(hn.get("weight", 0.2)) * 0.5 * (
            anchored(2) + anchored(1))
    return total.mean()


def xpoint_loss(batch, po, pt, hm, cfg, gen, prec):
    """The loss of a pair batch: detector losses of both sides, lambda
    times the descriptor loss, gamma times the homography loss."""
    o, t = batch["optical"], batch["thermal"]
    loss = detector_loss(po["logits"], o["keypoints"], o["valid_mask"], cfg,
                         gen)
    loss = loss + detector_loss(pt["logits"], t["keypoints"],
                                t["valid_mask"], cfg, gen)
    loss = loss + cfg["lambda"] * descriptor_loss(
        po["desc"], pt["desc"], o["homography"], t["homography"],
        o["valid_mask"], t["valid_mask"], cfg, prec)
    hmc = cfg.get("homography_regression_loss", {}) or {}
    if hmc.get("check") and hm is not None:
        gt = batch["hfour_points"].reshape(-1, 8).float()
        gt = gt / torch.linalg.vector_norm(gt, dim=1, keepdim=True).clamp_min(
            1e-12)
        loss = loss + hmc.get("gamma", 1.0) * ((hm - gt) ** 2).mean()
    return loss


class Adam:
    """Per-parameter Adam: b1 0.9, b2 0.999, eps 1e-8, bias-corrected
    moments, update -lr mu_hat / (sqrt(nu_hat) + eps)."""

    def __init__(self, params, lr, weight_decay=0.0):
        self.params = list(params)
        self.lr, self.wd, self.t = lr, weight_decay, 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            if self.wd:
                g = g + self.wd * p
            mu.mul_(0.9).add_(0.1 * g)
            nu.mul_(0.999).add_(0.001 * g * g)
            p.sub_(self.lr * (mu / c1) / (torch.sqrt(nu / c2) + 1e-8))
