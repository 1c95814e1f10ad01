"""Plain float32 operations of the reference: the products with their
precision class, the selective scan, and the serving chain's detector,
box-NMS with top-k, descriptor sampling and mutual-NN matching.

Every matrix product and convolution of the reference goes through
:class:`Prec`, which names its precision class: ``"act"`` for work that the
configuration states in its activation precision, ``"fp32"`` for work it
states in float32. The reference itself computes every class in float32
(TF32 off). The same object can instead round each product's operands,
and in training the gradient of its result, to the next precision below
the stated one (the control: float8 e4m3 or int8 for bfloat16, bfloat16
for float32), or keep the products at their stated precision and compute
the float32 work that is no product (LayerNorm, BatchNorm, softmax, the
scan) in bfloat16 (the control ``"bf16_work"``), and can count each product's operations by the stated
precision, for the work a call or step needs.
"""
import torch
import torch.nn.functional as F

FP8_MAX = 448.0        # largest finite float8 e4m3fn
BIG = 1e9              # distance of a masked descriptor pair


def _round_fp8(x):
    """x rounded to float8 e4m3 with one scale a tensor (amax to 448)."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _round_int8(x):
    """x rounded to int8 with one scale a tensor (amax to 127)."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 127.0
    return torch.round(x / scale).clamp(-127.0, 127.0) * scale


def _round_bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _straight_through(x, rounded):
    """``rounded`` forward, identity backward."""
    return x + (rounded - x).detach()


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the gradient rounded by ``fn`` backward, so that a
    product's backward products take a rounded operand too."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class Prec:
    """How the reference computes its products.

    ``stated``: class -> the precision the configuration states for it
    (``{"act": "bfloat16", "fp32": "float32"}``). ``control``: None, or
    the name of the rounding below bfloat16 (``"fp8"``: float8 e4m3;
    ``"int8"``), with which each operand is rounded first (float32 work is
    rounded to bfloat16); or ``"bf16_work"``: each product's operands
    rounded to its stated precision, and the norms, the softmax and the
    scan computed in bfloat16 (each step's result rounded). ``count``: add each product's operations
    (forward, and the backward products of the operands that need a
    gradient) to ``flops[stated precision]``."""

    BELOW_BF16 = {"fp8": _round_fp8, "int8": _round_int8}

    def __init__(self, stated, control=None, count=False):
        self.stated = dict(stated)
        self.lower = self.work = None
        if control == "bf16_work":
            self.lower = {"bfloat16": _round_bf16, "float16": _round_bf16,
                          "float32": lambda x: x}
            self.work = _round_bf16
        elif control:
            low = self.BELOW_BF16[control]
            self.lower = {"bfloat16": low, "float16": low,
                          "float32": _round_bf16}
        self.count = count
        self.flops = {}

    def _q(self, x, cls):
        if self.lower is None:
            return x
        return _straight_through(x, self.lower[self.stated[cls]](x))

    def _out(self, y, cls):
        """The product's result; in the control its gradient is rounded as
        its operands are, so the backward products are lower too."""
        if self.lower is None or not y.requires_grad:
            return y
        return _RoundGrad.apply(y, self.lower[self.stated[cls]])

    def _add(self, cls, flops, *operands):
        if not self.count:
            return
        grads = (sum(1 for t in operands if t.requires_grad)
                 if torch.is_grad_enabled() else 0)
        prec = self.stated[cls]
        self.flops[prec] = self.flops.get(prec, 0) + flops * (1 + grads)

    def low(self, x):
        """``x`` as the float32 work that is no product holds it: itself,
        or in the control ``"bf16_work"`` rounded to bfloat16 (and its
        gradient too)."""
        if self.work is None:
            return x
        x = _straight_through(x, self.work(x))
        return _RoundGrad.apply(x, self.work) if x.requires_grad else x

    def layer_norm(self, x, norm):
        """LayerNorm over the last dim with ``norm``'s affine and eps."""
        if self.work is None:
            return F.layer_norm(x.float(), norm.normalized_shape,
                                norm.weight, norm.bias, norm.eps)
        r = self.low
        x = r(x.float())
        mean = r(x.mean(-1, keepdim=True))
        xc = r(x - mean)
        inv = r(torch.rsqrt(r((xc * xc).mean(-1, keepdim=True)) + norm.eps))
        return r(r(r(xc * inv) * norm.weight) + norm.bias)

    def batch_norm(self, x, mean, var, eps, weight, bias):
        """(x - mean) / sqrt(var + eps) * weight + bias over the last dim."""
        r = self.low
        inv = r(torch.rsqrt(r(var) + eps))
        return r(r(r(r(x - r(mean)) * inv) * weight) + bias)

    def softmax(self, x):
        """Softmax over the last dim."""
        return self.low(torch.softmax(self.low(x), dim=-1))

    def linear(self, x, w, b=None, cls="act"):
        """x @ w.T + b, w (out, in)."""
        n_rows = x.numel() // x.shape[-1]
        self._add(cls, 2 * n_rows * w.shape[0] * w.shape[1], x, w)
        return self._out(F.linear(self._q(x, cls), self._q(w, cls), b), cls)

    def matmul(self, a, b, cls="act"):
        """a @ b over batched (..., m, k) x (..., k, n)."""
        m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
        batch = max(a.numel() // (m * k), b.numel() // (k * n))
        self._add(cls, 2 * batch * m * k * n, a, b)
        return self._out(torch.matmul(self._q(a, cls), self._q(b, cls)), cls)

    def conv(self, x, w, stride=1, padding=0, groups=1, cls="act"):
        """NHWC conv with an OIHW weight, no bias."""
        y = F.conv2d(self._q(x, cls).permute(0, 3, 1, 2), self._q(w, cls),
                     None, stride, padding, 1, groups)
        out = y.shape[0] * y.shape[2] * y.shape[3]
        self._add(cls, 2 * out * w.numel(), x, w)
        return self._out(y.permute(0, 2, 3, 1), cls)


def softplus(x):
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def linear_recurrence(a, b, chunk=128, step=lambda h: h):
    """h_t = a_t h_(t-1) + b_t along dim -2 of (..., L, D), h_(-1) = 0, in
    float32: each chunk of ``chunk`` steps from a zero entry, the chunk
    entries carried over the chunks, and the carry folded back in through
    the running product of a. ``step`` is applied to each state computed
    (the control's rounding)."""
    L, D = a.shape[-2], a.shape[-1]
    n = -(-L // chunk)
    pad = n * chunk - L
    if pad:
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad), value=0.0)
    lead = a.shape[:-2]
    a = a.reshape(*lead, n, chunk, D)
    b = b.reshape(*lead, n, chunk, D)
    h = torch.zeros(*lead, n, D, dtype=a.dtype, device=a.device)
    local = []
    for i in range(chunk):
        h = step(a[..., i, :] * h + b[..., i, :])
        local.append(h)
    local = torch.stack(local, dim=-2)
    prod = step(torch.cumprod(a, dim=-2))
    e = torch.zeros(*lead, D, dtype=a.dtype, device=a.device)
    entries = []
    for c in range(n):
        entries.append(e)
        e = step(prod[..., c, -1, :] * e + local[..., c, -1, :])
    h = step(local + prod * torch.stack(entries, dim=-2)[..., None, :])
    return h.reshape(*lead, n * chunk, D)[..., :L, :]


# ---- the serving chain ------------------------------------------------------

def depth_to_space(x, r):
    """(B, H', W', r*r*C) -> (B, H'*r, W'*r, C), channel (i*r + j)*C + c."""
    B, Hc, Wc, C = x.shape
    c = C // (r * r)
    x = x.reshape(B, Hc, Wc, r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hc * r, Wc * r, c)


def space_to_depth(x, r):
    """(B, H, W) or (B, H, W, C) -> (B, H/r, W/r, r*r*C)."""
    if x.ndim == 3:
        x = x[..., None]
    B, H, W, C = x.shape
    x = x.reshape(B, H // r, r, W // r, r, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // r, W // r, r * r * C)


def prob_from_logits(logits, ratio):
    """Cell logits -> (B, H, W) heatmap: softmax, dustbin dropped."""
    prob = torch.softmax(logits.float(), dim=-1)[..., :-1]
    return depth_to_space(prob, ratio)[..., 0]


def overlap_widths(size, iou):
    """Allowed |dx| for each |dy| < size: equal boxes at offset (dy, dx)
    overlap by more than ``iou``; -1 where none does."""
    s = float(size)
    thr = 2.0 * iou * s * s / (1.0 + iou)
    out = []
    for dy in range(size):
        w = -1
        for dx in range(size):
            if (s - dy) * (s - dx) > thr:
                w = dx
        out.append(w)
    return out


def _shift(a, d, dim):
    """out[i] = a[i + d] along ``dim``, -inf outside."""
    n = a.shape[dim]
    shape = list(a.shape)
    shape[dim] = min(abs(d), n)
    fill = torch.full(shape, float("-inf"), dtype=a.dtype, device=a.device)
    if abs(d) >= n:
        return fill
    if d > 0:
        return torch.cat([a.narrow(dim, d, n - d), fill], dim)
    return torch.cat([fill, a.narrow(dim, 0, n + d)], dim)


def _neighbour_max(S, widths, size):
    max_w = max((w for w in widths if w >= 0), default=0)
    row = [S]
    for w in range(1, max_w + 1):
        row.append(torch.maximum(row[-1], torch.maximum(_shift(S, w, -1),
                                                        _shift(S, -w, -1))))
    out = torch.full_like(S, float("-inf"))
    for dy in range(-(size - 1), size):
        w = widths[abs(dy)]
        if w >= 0:
            out = torch.maximum(out, row[w] if dy == 0
                                else _shift(row[w], dy, -2))
    return out


def box_nms_keep(prob, size, min_prob, iou):
    """Greedy equal-box NMS as its fixed point: a pixel above ``min_prob``
    is kept unless a kept pixel of its overlap set scores strictly higher.
    (B, H, W) -> keep (B, H, W) bool."""
    widths = overlap_widths(size, iou)
    valid = prob > min_prob
    neg = torch.full((), float("-inf"), device=prob.device)
    keep, prev = valid, ~valid
    for _ in range(prob.shape[1] * prob.shape[2]):
        if not bool((keep != prev).any()):
            break
        S = torch.where(keep, prob, neg)
        keep, prev = valid & ~(_neighbour_max(S, widths, size) > prob), keep
    return keep


def top_k(prob, keep, k, min_prob):
    """The k highest kept scores of each map, ties to the lower flat index:
    (B, k) scores and flat indices, and the mask score > min_prob."""
    B, H, W = prob.shape
    kept = torch.where(keep, prob, torch.zeros((), device=prob.device))
    scores, idx = torch.sort(kept.reshape(B, H * W), dim=1, descending=True,
                             stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    return scores, idx, scores > min_prob


def interpolate_descriptors(kps, desc_map, image_shape):
    """Bilinear samples of (B, Hc, Wc, D) at (B, N, 2) (row, col) pixels
    (align_corners: row / H * (Hc - 1)), L2-normalised."""
    H, W = image_shape
    B, Hc, Wc, _ = desc_map.shape
    kp = kps.float()
    py, px = kp[..., 0] / H * (Hc - 1), kp[..., 1] / W * (Wc - 1)
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = (py - y0)[..., None], (px - x0)[..., None]
    y0i, x0i = y0.long().clamp(0, Hc - 1), x0.long().clamp(0, Wc - 1)
    y1i, x1i = (y0i + 1).clamp(0, Hc - 1), (x0i + 1).clamp(0, Wc - 1)
    b = torch.arange(B, device=desc_map.device)[:, None]
    d = ((desc_map[b, y0i, x0i] * (1 - wx) + desc_map[b, y0i, x1i] * wx)
         * (1 - wy)
         + (desc_map[b, y1i, x0i] * (1 - wx) + desc_map[b, y1i, x1i] * wx)
         * wy)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(
        1e-12)


def distance_matrix(d1, d2, m1, m2):
    """(B, N, N) L2 distances of unit descriptors, BIG where masked."""
    dots = torch.matmul(d1.float(), d2.float().transpose(1, 2))
    dmat = torch.sqrt((2.0 - 2.0 * dots.clamp(-1.0, 1.0)).clamp_min(0.0))
    big = torch.full((), BIG, device=dmat.device)
    dmat = torch.where(m1[:, :, None], dmat, big)
    return torch.where(m2[:, None, :], dmat, big)


def mnn_match(d1, d2, m1, m2):
    """Mutual nearest neighbours: idx2, dist, matched (B, N)."""
    dmat = distance_matrix(d1, d2, m1, m2)
    idx2 = torch.argmin(dmat, dim=2)
    dist = torch.gather(dmat, 2, idx2[..., None])[..., 0]
    idx1 = torch.argmin(dmat, dim=1)
    rows = torch.arange(d1.shape[1], device=dmat.device)
    matched = (dist < BIG) & (torch.gather(idx1, 1, idx2) == rows)
    return idx2, dist, matched
