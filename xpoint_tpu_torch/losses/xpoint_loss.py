"""XPoint training losses (port of ``xpoint_tpu/losses/xpoint_loss.py:
26-430``).

  detector loss    space_to_depth(8) labels -> 65-class CE / focal /
                   blended, hard (random tiebreak) or soft assignment,
                   valid-mask x per-sample normalisation, TP/FP diagnostics
  descriptor loss  dense cell-centre hinge with homography-warped
                   correspondences (distance <= threshold), valid-mask outer
                   product, optional hard-negative weighting; streamed over
                   chunks of the cell2 axis with fp32 sums; the sparse
                   variant samples Hc*Wc // divisor cells
  hm loss          MSE on the L2-normalised 8-vector
  encoder sim      1 - cosine similarity of the flattened features

Config schema identical to the reference ``loss:`` YAML section. Random
draws (the hard-assignment tiebreak, the sparse loss's cells) come from
the ``torch.Generator`` passed in; in soft-assignment mode the tiebreak
only feeds the diagnostics. The JAX package draws the sparse cells with
``jax.random.randint``, which torch cannot reproduce: the same cells can be
handed to :func:`descriptor_loss` instead.

Inside a data-parallel step (``parallel.data_parallel``) every term is this
rank's share of the global batch's: the per-sample normalised terms and
the diagnostic ratios are means over equal shards, which the step averages
over the ranks; the blended loss's keypoint ratio is all-reduced here, and
the tiebreak draws the global batch's noise and keeps this rank's rows.
"""
import copy

import torch
import torch.nn.functional as F

from ..geometry.homography import warp_points
from ..ops.gridops import device_constant, space_to_depth
from ..parallel.mesh import global_mean, rand_rows
from ..utils import dict_update

DEFAULT_CONFIG = {
    'detector_loss': True,
    'detector_loss_function': 'cross_entropy',
    'detector_handle_multiple_keypoints': 'soft_assignment',
    'detector_dustbin_loss_weight': 1.0,
    'detector_focal_loss': {'use': True, 'alpha': 0.25, 'gamma': 2.0},
    'descriptor_loss': True,
    'descriptor_loss_threshold': 8.0,
    'sparse_descriptor_loss': False,
    'sparse_descriptor_loss_num_cell_divisor': 64,
    'descriptor_loss_use_mask': True,
    'positive_margin': 1.0,
    'negative_margin': 0.2,
    'lambda_d': 250,
    'lambda': 0.0001,
    # XPoint-TPU extension (off = reference uniform negative averaging):
    # softmax(dot / temperature)-weighted negatives per anchor cell, both
    # anchor directions, 'weight' scales the term, 'keep_uniform' keeps
    # the uniform term beside it.
    'hard_negative_weighting': {'check': False, 'temperature': 0.1,
                                'weight': 0.2, 'keep_uniform': True},
    'space_to_depth_ratio': 8,
    'use_encoder_similarity': False,
    'homography_regression_loss': {'check': False, 'gamma': 1.0},
}

def _weighted_ce(logits, target, class_weights):
    """-sum_c w_c t_c log softmax_c per position."""
    return -(class_weights * target * F.log_softmax(logits, dim=-1)).sum(-1)


def _focal(logits, target, alpha, gamma):
    """ce -> pt = exp(-ce) -> alpha (1 - pt)^gamma ce."""
    ce = -(target * F.log_softmax(logits, dim=-1)).sum(-1)
    return alpha * (1.0 - torch.exp(-ce)) ** gamma * ce


def _cell_valid(valid_mask, r, shape, device):
    """(B, H, W) mask -> (B, Hc, Wc): 1 where every pixel of the cell is."""
    if valid_mask is None:
        return torch.ones(shape, device=device)
    return torch.prod(space_to_depth(valid_mask.float(), r), dim=-1)


def detector_loss(logits, keypoint_map, valid_mask, config, gen=None):
    """Detector loss of one spectrum: logits (B, Hc, Wc, r^2+1) fp32,
    keypoint_map and valid_mask (B, H, W). Returns (loss, components)."""
    r = config['space_to_depth_ratio']
    n_classes = logits.shape[-1]
    dev = logits.device
    labels = space_to_depth(keypoint_map.float(), r)       # (B, Hc, Wc, r^2)
    valid = _cell_valid(valid_mask, r, labels.shape[:-1], dev)

    # hard assignment with a random tiebreak; also used for the diagnostic
    # ratios whatever the training assignment
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    noise = rand_rows(labels.shape, gen, dev)
    hard = torch.cat([3.0 * labels + noise,
                      torch.full(labels.shape[:-1] + (1,), 2.0, device=dev)],
                     dim=-1)
    labels_hard = hard.argmax(-1)

    method = config['detector_handle_multiple_keypoints']
    if method == 'hard_assignment':
        target = F.one_hot(labels_hard, n_classes).float()
    elif method == 'soft_assignment':
        soft = labels / (labels.sum(-1, keepdim=True) + 1e-6)
        target = torch.cat([soft, 1.0 - soft.sum(-1, keepdim=True)], dim=-1)
    else:
        raise ValueError(f"unknown keypoint handling: {method}")

    fn = config['detector_loss_function']
    weights = device_constant([1.0] * (n_classes - 1)
                              + [config['detector_dustbin_loss_weight']], dev)
    fl = config['detector_focal_loss']
    if fn == 'cross_entropy':
        loss_values = _weighted_ce(logits, target, weights)
    elif fn == 'focal_loss':
        loss_values = _focal(logits, target, fl['alpha'], fl['gamma'])
    elif fn == 'cross_entropy_focal_blended':
        probs = torch.softmax(logits, dim=-1)
        # the global batch's ratio inside a data-parallel step
        kp_pred = (probs[..., :-1].sum(-1) > probs[..., -1]).float()
        kp_ratio = global_mean(kp_pred, tuple(range(kp_pred.ndim)))
        threshold = 0.0015
        blend = ((threshold - kp_ratio) / threshold).clamp(0.0, 1.0)
        loss_values = ((1 - blend) * _weighted_ce(logits, target, weights)
                       + blend * _focal(logits, target, fl['alpha'],
                                        fl['gamma']))
    else:
        raise ValueError(f"unknown detector loss: {fn}")

    loss_values = loss_values * valid
    denom = valid.sum(dim=(1, 2)).clamp_min(1.0)
    normalized = (loss_values.sum(dim=(1, 2)) / denom).mean()

    # diagnostics. Multiplying the hard labels by the valid mask maps
    # masked-out cells to class 0 (a keypoint class), skewing TP/FN under
    # non-trivial masks: the reference does exactly this (losses.py:490),
    # and the JAX package keeps it for parity of the reported ratios.
    with torch.no_grad():
        pred_cls = logits.argmax(-1)
        hard_masked = (labels_hard * valid).long()
        total = hard_masked.numel()
        dustbin = n_classes - 1
        kp_pred, kp_true = pred_cls <= dustbin - 1, hard_masked <= dustbin - 1
        db_pred, db_true = pred_cls == dustbin, hard_masked == dustbin
        components = {
            'correct_ratio': (pred_cls == hard_masked).float().mean(),
            'TP_ratio': (kp_pred & kp_true).sum() / total,
            'FP_ratio': (kp_pred & db_true).sum() / total,
            'FN_ratio': (db_pred & kp_true).sum() / total,
            'TN_ratio': (db_pred & db_true).sum() / total,
        }
    components = {'detector_loss': loss_values.mean(),
                  'detector_normalized_loss': normalized, **components}
    return normalized, components


def _chunk_size(N):
    """Largest divisor of N that is <= 512."""
    return next(g for g in range(min(512, N), 0, -1) if N % g == 0)


def _wmean(num, den, dim):
    """Mean over anchors of sum(num) / sum(den) along ``dim``, anchors with
    an empty denominator left out. where() on both sides of the division:
    the gradient of x / max(den, eps) overflows for empty anchors."""
    d = den.sum(dim)
    ok = d > 0.0
    m = torch.where(ok, num.sum(dim) / torch.where(ok, d, 1.0), 0.0)
    return m.sum(1) / ok.float().sum(1).clamp_min(1.0)


def sparse_descriptor_loss(desc1, desc2, homography1, homography2, config,
                           gen=None, cells=None):
    """The sparse descriptor hinge loss (``xpoint_loss.py:173-230``):
    ``cells`` ((n, 2) int (row, col) cell indices, n = Hc*Wc // divisor;
    drawn from ``gen`` when not given) are warped by each side's
    homography, each side's descriptors gathered at its rounded warped
    cell; a pair corresponds when the two cells lie within sqrt(0.5), and
    is valid where the first side's warped row and the second side's warped
    column fall inside the grid. fp32 dot matrix, optional hard negatives.
    Returns (total, positive, negative)."""
    B, Hc, Wc, D = desc1.shape
    dev = desc1.device
    pos_margin = config['positive_margin']
    neg_margin = config['negative_margin']
    lambda_d = config['lambda_d']
    if cells is None:
        n = int((Hc * Wc) // config['sparse_descriptor_loss_num_cell_divisor'])
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(0)
        cells = torch.stack(
            [torch.randint(0, Hc, (n,), generator=gen, device=dev),
             torch.randint(0, Wc, (n,), generator=gen, device=dev)], -1)
    cells = cells.to(dev, torch.float32)[None].expand(B, -1, -1)

    w1 = cells if homography1 is None else warp_points(cells, homography1)
    w2 = cells if homography2 is None else warp_points(cells, homography2)
    dist = torch.linalg.vector_norm(cells[:, None, :, :] - cells[:, :, None, :],
                                    dim=-1)
    corr = (dist <= 0.5 ** 0.5).float()
    valid = (((w1[:, :, 0] > -0.5) & (w1[:, :, 0] < Hc - 0.5))[:, None, :]
             & ((w2[:, :, 1] > -0.5) & (w2[:, :, 1] < Wc - 0.5))[:, :, None]
             ).float()

    def clampi(idx, hi):
        return torch.round(idx).long().clamp(0, hi - 1)

    rows = torch.arange(B, device=dev)[:, None]
    d1 = desc1[rows, clampi(w1[..., 0], Hc), clampi(w1[..., 1], Wc)]
    d2 = desc2[rows, clampi(w2[..., 0], Hc), clampi(w2[..., 1], Wc)]
    dot = torch.bmm(d2.float(), d1.float().transpose(1, 2))
    positive = lambda_d * corr * (pos_margin - dot).clamp_min(0.0) * valid
    neg_hinge = (dot - neg_margin).clamp_min(0.0)
    negative = (1 - corr) * neg_hinge * valid
    loss = positive + negative
    norm = valid.sum(dim=(1, 2)).clamp_min(1.0)
    hn = config['hard_negative_weighting']
    hard = 0.0
    if hn.get('check'):
        # the dense path's softmax(dot / tau) emphasis on the sampled-cell
        # matrix, both anchor directions
        e = (torch.exp(dot / float(hn.get('temperature', 0.1)))
             * (1 - corr) * valid)
        e_num = e * neg_hinge
        hard = float(hn.get('weight', 0.2)) * 0.5 * (
            _wmean(e_num, e, 2) + _wmean(e_num, e, 1))
        if not hn.get('keep_uniform', True):
            loss = positive
            negative = torch.zeros_like(negative)
    total = (loss.sum(dim=(1, 2)) / norm + hard).mean()
    pos = (positive.sum(dim=(1, 2)) / norm).mean()
    neg = (negative.sum(dim=(1, 2)) / norm + hard).mean()
    return total, pos, neg


def descriptor_loss(desc1, desc2, homography1, homography2,
                    valid_mask1, valid_mask2, config, gen=None, cells=None):
    """Descriptor hinge loss; desc (B, Hc, Wc, D) L2-normalised. Returns
    (total, positive, negative). With ``sparse_descriptor_loss``, the
    sparse variant on ``cells`` (or cells drawn from ``gen``).

    Dense: cell centres (i*8+4) are warped by each side's inverse
    homography; a pair (cell2, cell1) corresponds when the warped centres
    lie within the threshold. The (B, N, N) hinge volume is streamed over
    chunks of the cell2 axis (the largest G <= 512 dividing N) with fp32
    sums, as the JAX scan does."""
    if config['sparse_descriptor_loss']:
        return sparse_descriptor_loss(desc1, desc2, homography1, homography2,
                                      config, gen, cells)
    B, Hc, Wc, D = desc1.shape
    r = config['space_to_depth_ratio']
    pos_margin = config['positive_margin']
    neg_margin = config['negative_margin']
    lambda_d = config['lambda_d']
    dev = desc1.device

    ys, xs = torch.meshgrid(torch.arange(Hc, dtype=torch.float32, device=dev),
                            torch.arange(Wc, dtype=torch.float32, device=dev),
                            indexing="ij")
    # cell centres use the reference's hardcoded *8+4 (losses.py:690)
    cells = (torch.stack([ys, xs], -1) * 8.0 + 4.0).reshape(1, -1, 2)
    cells = cells.expand(B, -1, -1)
    N = Hc * Wc

    def warped(h):
        return cells if h is None else warp_points(cells,
                                                   torch.linalg.inv_ex(h)[0])

    w1f, w2f = warped(homography1), warped(homography2)
    d1f = desc1.reshape(B, N, D)
    d2f = desc2.reshape(B, N, D)
    m1 = m2 = None
    if config['descriptor_loss_use_mask']:
        m1 = _cell_valid(valid_mask1, r, (B, Hc, Wc), dev).reshape(B, N)
        m2 = _cell_valid(valid_mask2, r, (B, Hc, Wc), dev).reshape(B, N)

    G = _chunk_size(N)
    thr = config['descriptor_loss_threshold']
    hn = config['hard_negative_weighting']
    hn_on = bool(hn.get('check'))
    hn_tau = float(hn.get('temperature', 0.1))

    zero = torch.zeros(B, device=dev)
    t_sum, p_sum, n_sum, v_sum = zero, zero, zero, zero
    row_s, row_c = zero, zero
    col_n = torch.zeros(B, N, device=dev)
    col_d = torch.zeros(B, N, device=dev)
    for c0 in range(0, N, G):
        d2c, w2c = d2f[:, c0:c0 + G], w2f[:, c0:c0 + G]
        dist = torch.linalg.vector_norm(w2c[:, :, None, :] - w1f[:, None],
                                        dim=-1)                 # (B, G, N)
        corr = (dist <= thr).float()
        dot = torch.bmm(d2c.float(), d1f.float().transpose(1, 2))
        positive = lambda_d * corr * (pos_margin - dot).clamp_min(0.0)
        neg_hinge = (dot - neg_margin).clamp_min(0.0)
        negative = (1 - corr) * neg_hinge
        if m2 is not None:
            vm = m2[:, c0:c0 + G, None] * m1[:, None, :]
            positive = positive * vm
            negative = negative * vm
            v_sum = v_sum + vm.sum(dim=(1, 2))
        else:
            vm = torch.ones_like(corr)
        if hn_on:
            # |dot| <= 1 for unit descriptors, so exp(dot / tau) is bounded
            # and sums across chunks without a running max. Rows (anchor =
            # cell2) normalise within the chunk; columns (anchor = cell1)
            # carry (numerator, denominator) sums.
            e = torch.exp(dot / hn_tau) * (1 - corr) * vm
            e_num = e * neg_hinge
            r_num = e_num.sum(2)
            r_den = e.sum(2)
            r_ok = r_den > 0.0
            # safe divide with where() on BOTH sides: the gradient of
            # x / max(den, eps) overflows for empty rows (then inf * 0 = nan)
            row_s = row_s + torch.where(
                r_ok, r_num / torch.where(r_ok, r_den, 1.0), 0.0).sum(1)
            row_c = row_c + r_ok.float().sum(1)
            col_n = col_n + e_num.sum(1)
            col_d = col_d + e.sum(1)
        p = positive.sum(dim=(1, 2))
        n = negative.sum(dim=(1, 2))
        t_sum, p_sum, n_sum = t_sum + p + n, p_sum + p, n_sum + n

    norm = v_sum.clamp_min(1.0) if m2 is not None else float(N * N)
    if hn_on:
        row_mean = row_s / row_c.clamp_min(1.0)
        c_ok = col_d > 0.0
        col_mean = (torch.where(c_ok, col_n / torch.where(c_ok, col_d, 1.0),
                                0.0).sum(1)
                    / c_ok.float().sum(1).clamp_min(1.0))
        hard = float(hn.get('weight', 0.2)) * 0.5 * (row_mean + col_mean)
        if not hn.get('keep_uniform', True):
            t_sum = t_sum - n_sum
            n_sum = torch.zeros_like(n_sum)
        return ((t_sum / norm + hard).mean(), (p_sum / norm).mean(),
                (n_sum / norm + hard).mean())
    return (t_sum / norm).mean(), (p_sum / norm).mean(), (n_sum / norm).mean()


class XPointLoss:
    """Callable aggregating all loss terms."""

    def __init__(self, config=None):
        self.config = dict_update(copy.deepcopy(DEFAULT_CONFIG), config or {})

    def __call__(self, data, pred, pred2=None, pred_hm=None, gen=None):
        """data: 'optical'/'thermal' sub-dicts (keypoints (B,H,W),
        valid_mask (B,H,W), homography (B,3,3)) and optionally
        'hfour_points' (B,4,2), or a flat single-spectrum dict; pred/pred2:
        model outputs with 'logits'/'desc' (NHWC). Returns (loss,
        components)."""
        cfg = self.config
        d1 = data['optical'] if 'optical' in data else data
        d2 = data.get('thermal') if 'optical' in data else None
        loss = 0.0
        components = {}

        if cfg['detector_loss']:
            l1, c1 = detector_loss(pred['logits'], d1['keypoints'],
                                   d1.get('valid_mask'), cfg, gen)
            loss = loss + l1
            components.update({k + '1': v for k, v in c1.items()})
            if pred2 is not None:
                l2, c2 = detector_loss(pred2['logits'], d2['keypoints'],
                                       d2.get('valid_mask'), cfg, gen)
                loss = loss + l2
                components.update({k + '2': v for k, v in c2.items()})

        if cfg['descriptor_loss']:
            if pred2 is None:
                raise ValueError('descriptor loss requires two predictions')
            dl, pos, neg = descriptor_loss(
                pred['desc'], pred2['desc'],
                d1.get('homography'), d2.get('homography'),
                d1.get('valid_mask'), d2.get('valid_mask'), cfg, gen)
            components['descriptor_loss'] = dl
            components['positive_dist'] = pos
            components['negative_dist'] = neg
            loss = loss + cfg['lambda'] * dl

        if cfg['homography_regression_loss']['check'] and pred_hm is not None:
            gt = data['hfour_points'].reshape(-1, 8).float()
            gt = gt / torch.linalg.vector_norm(gt, dim=1,
                                               keepdim=True).clamp_min(1e-12)
            hm_loss = ((pred_hm - gt) ** 2).mean()
            loss = loss + cfg['homography_regression_loss']['gamma'] * hm_loss
            components['homography_regression_loss'] = hm_loss

        if cfg['use_encoder_similarity']:
            a = pred['encoder_output'].reshape(
                pred['encoder_output'].shape[0], -1)
            b = pred2['encoder_output'].reshape(
                pred2['encoder_output'].shape[0], -1)
            cos = (a * b).sum(-1) / (
                torch.linalg.vector_norm(a, dim=-1)
                * torch.linalg.vector_norm(b, dim=-1)).clamp_min(1e-12)
            sim_loss = 1.0 - cos.mean()
            loss = loss + sim_loss
            components['encoder_similarity_loss'] = sim_loss

        return loss, components
