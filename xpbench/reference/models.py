"""The XPoint model in plain float32 PyTorch: the VMamba encoder of the
forward type ``v05_noz`` with state size 1 (the four-direction cross scan),
the SwinV2 encoder, the detector and descriptor heads, and the RegNet
homography head.

It follows the published models' equations and holds its parameters under
the same names as ``xpoint_tpu_torch``'s modules, so one state dict loads
into both. Each product states its precision class (``ops.Prec``): the
encoders' and heads' products are "act" (the configuration's activation
precision), LayerNorm, BatchNorm, the scan, RegNet's dense layers, SwinV2's
``proj``, MLP, patch merging and attention logits are "fp32". The
reference computes both classes in float32. Stochastic layers (DropPath,
Dropout) draw from the generator passed to ``forward`` in the order and
shapes of the program's layers, so that a training step's masks are the
same on both sides.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .ops import depth_to_space, linear_recurrence, softplus


def _ln(norm, x):
    return norm.prec.layer_norm(x, norm)


def _layer_norm(dim, prec):
    norm = nn.LayerNorm(dim, eps=1e-6)
    norm.prec = prec
    return norm


def _drop(x, rate, shape, gen):
    keep = 1.0 - rate
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), device=x.device))


class DropPath(nn.Module):
    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, gen):
        if not self.training or self.rate == 0.0:
            return x
        return _drop(x, self.rate, (x.shape[0],) + (1,) * (x.ndim - 1), gen)


def _param(*shape):
    return nn.Parameter(torch.zeros(*shape))


# ---- VMamba (v05_noz, d_state 1) --------------------------------------------

class StridedConv3x3(nn.Module):
    def __init__(self, c_in, c_out, prec):
        super().__init__()
        self.prec = prec
        self.weight = _param(c_out, c_in, 3, 3)
        self.bias = _param(c_out)

    def forward(self, x):
        return self.prec.conv(x, self.weight, 2, 1) + self.bias


class Mlp(nn.Module):
    def __init__(self, dim, hidden, prec):
        super().__init__()
        self.prec = prec
        self.Dense_0 = nn.Linear(dim, hidden)
        self.Dense_1 = nn.Linear(hidden, dim)

    def forward(self, x):
        p = self.prec
        x = p.linear(x, self.Dense_0.weight, self.Dense_0.bias)
        return p.linear(F.gelu(x, approximate="tanh"), self.Dense_1.weight,
                        self.Dense_1.bias)


class SS2D(nn.Module):
    """Cross-scan selective scan, state size 1, no gate: directions k = 0
    row-major, 1 column-major, 2 and 3 the same reversed; each a
    recurrence h_t = exp(delta_t A) h_(t-1) + delta_t B_t u_t, y_t = C_t h_t
    + D u_t with delta = softplus(dt + bias); the four outputs summed at
    their pixels."""

    def __init__(self, d_model, prec, d_conv=3):
        super().__init__()
        self.prec = prec
        D, K = d_model, 4
        R = math.ceil(d_model / 16)
        self.d_inner, self.dt_rank = D, R
        self.in_proj = nn.Linear(d_model, D, bias=False)
        self.conv2d = nn.Conv2d(D, D, d_conv, padding=1, groups=D,
                                bias=False)
        self.x_proj_weight = _param(K, R + 2, D)
        self.dt_projs_weight = _param(K, D, R)     # stored + R^-0.5
        self.dt_projs_bias = _param(K, D)
        self.A_logs = _param(K * D, 1)
        self.Ds = _param(K * D)
        self.out_norm = _layer_norm(D, prec)
        self.out_proj = nn.Linear(D, d_model, bias=False)

    def forward(self, x):
        p = self.prec
        B, H, W, _ = x.shape
        D, R, L = self.d_inner, self.dt_rank, H * W
        xs = p.linear(x, self.in_proj.weight)
        xs = F.silu(p.conv(xs, self.conv2d.weight, 1, 1, groups=D))
        row = xs.reshape(B, L, D)
        col = xs.transpose(1, 2).reshape(B, L, D)
        u = torch.stack([row, col, row.flip(1), col.flip(1)], 1)  # B,4,L,D
        x_dbl = p.matmul(u, self.x_proj_weight.transpose(1, 2))   # B,4,L,R+2
        dt = p.matmul(x_dbl[..., :R], (self.dt_projs_weight
                                       - R ** -0.5).transpose(1, 2))
        delta = softplus(dt + self.dt_projs_bias[None, :, None, :])
        A = -torch.exp(self.A_logs.reshape(4, 1, D))
        a = torch.exp(delta * A)
        b = delta * x_dbl[..., R:R + 1] * u
        h = linear_recurrence(p.low(a), p.low(b), step=p.low)
        y = p.low(x_dbl[..., R + 1:R + 2] * h + self.Ds.reshape(4, 1, D) * u)
        y_row = y[:, 0] + y[:, 2].flip(1)
        y_col = y[:, 1] + y[:, 3].flip(1)
        y = (y_row.reshape(B, H, W, D)
             + y_col.reshape(B, W, H, D).transpose(1, 2))
        return p.linear(_ln(self.out_norm, y), self.out_proj.weight)


class VSSBlock(nn.Module):
    def __init__(self, dim, drop_path, mlp_ratio, prec):
        super().__init__()
        self.norm = _layer_norm(dim, prec)
        self.op = SS2D(dim, prec)
        self.drop_path = DropPath(drop_path)
        self.norm2 = _layer_norm(dim, prec)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), prec)

    def forward(self, x, gen):
        x = x + self.drop_path(self.op(_ln(self.norm, x)), gen)
        return x + self.drop_path(self.mlp(_ln(self.norm2, x)), gen)


class VSSM(nn.Module):
    """Patch embedding (two stride-2 convs), four stages of VSS blocks with
    stride-2 conv downsampling, depth_to_space(4) at the end."""

    def __init__(self, vssm, drop_path_rate, prec):
        super().__init__()
        if (vssm.get("SSM_FORWARDTYPE") != "v05_noz"
                or int(vssm.get("SSM_D_STATE", 1)) != 1
                or float(vssm.get("SSM_RATIO", 1.0)) != 1.0
                or vssm.get("SSM_CONV_BIAS", False)
                or int(vssm.get("SSM_CONV", 3)) != 3):
            raise ValueError("the reference holds VMamba v05_noz, d_state 1,"
                             " ssm_ratio 1, a 3x3 conv without bias")
        self.depths = tuple(vssm["DEPTHS"])
        E = int(vssm["EMBED_DIM"])
        dims = [E * 2 ** i for i in range(len(self.depths))]
        dpr = iter(float(v) for v in np.linspace(0, drop_path_rate,
                                                 sum(self.depths)))
        self.patch_embed_conv1 = StridedConv3x3(3, E // 2, prec)
        self.patch_embed_norm1 = _layer_norm(E // 2, prec)
        self.patch_embed_conv2 = StridedConv3x3(E // 2, E, prec)
        self.patch_embed_norm2 = _layer_norm(E, prec)
        for i, depth in enumerate(self.depths):
            for d in range(depth):
                self.add_module(f"layers_{i}_blocks_{d}", VSSBlock(
                    dims[i], next(dpr), float(vssm.get("MLP_RATIO", 4.0)),
                    prec))
            if i < len(self.depths) - 1:
                self.add_module(f"layers_{i}_downsample_conv",
                                StridedConv3x3(dims[i], dims[i + 1], prec))
                self.add_module(f"layers_{i}_downsample_norm",
                                _layer_norm(dims[i + 1], prec))

    def forward(self, x, gen):
        x = x.float().expand(-1, -1, -1, 3)
        x = F.gelu(_ln(self.patch_embed_norm1, self.patch_embed_conv1(x)),
                   approximate="tanh")
        x = _ln(self.patch_embed_norm2, self.patch_embed_conv2(x))
        for i, depth in enumerate(self.depths):
            for d in range(depth):
                x = getattr(self, f"layers_{i}_blocks_{d}")(x, gen)
            if i < len(self.depths) - 1:
                x = _ln(getattr(self, f"layers_{i}_downsample_norm"),
                        getattr(self, f"layers_{i}_downsample_conv")(x))
        return depth_to_space(x, 4)


# ---- SwinV2 -----------------------------------------------------------------

def _coords_table(ws):
    h = np.arange(-(ws - 1), ws, dtype=np.float32)
    t = np.stack(np.meshgrid(h, h, indexing="ij"), -1)[None]
    t = t / max(ws - 1, 1) * 8
    return np.sign(t) * np.log2(np.abs(t) + 1.0) / np.log2(8)


def _position_index(ws):
    c = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    f = c.reshape(2, -1)
    rel = (f[:, :, None] - f[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]


def _shift_mask(H, W, ws, shift):
    img = np.zeros((H, W), np.int64)
    n = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = n
            n += 1
    m = img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3)
    m = m.reshape(-1, ws * ws)
    return np.where(m[:, None, :] != m[:, :, None], -100.0, 0.0)


def _windows(x, ws):
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def _unwindows(w, ws, H, W):
    C = w.shape[-1]
    B = w.shape[0] // (H * W // ws // ws)
    x = w.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


class Dense(nn.Module):
    def __init__(self, c_in, c_out, prec, bias=True, cls="fp32"):
        super().__init__()
        self.prec, self.cls = prec, cls
        self.weight = _param(c_out, c_in)
        self.bias = _param(c_out) if bias else None

    def forward(self, x):
        return self.prec.linear(x, self.weight, self.bias, self.cls)


class WindowAttention(nn.Module):
    """Cosine attention with a clamped learned temperature and the
    continuous relative-position bias (16 sigmoid of a 2-layer MLP)."""

    def __init__(self, dim, heads, prec):
        super().__init__()
        self.prec, self.heads = prec, heads
        self.logit_scale = _param(heads, 1, 1)
        self.qkv_kernel = _param(dim, 3 * dim)
        self.q_bias = _param(dim)
        self.v_bias = _param(dim)
        self.cpb_fc1 = Dense(2, 512, prec)
        self.cpb_fc2 = Dense(512, heads, prec, bias=False)
        self.proj = Dense(dim, dim, prec)

    def forward(self, x, ws, mask):
        p = self.prec
        B_, N, C = x.shape
        nh = self.heads
        qkv = p.matmul(x, self.qkv_kernel) + torch.cat(
            [self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        q, k, v = qkv.reshape(B_, N, 3, nh, C // nh).permute(2, 0, 3, 1, 4)
        qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(
            1e-12)
        kn = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(
            1e-12)
        attn = p.matmul(qn, kn.transpose(-2, -1), "fp32")
        attn = attn * torch.exp(self.logit_scale.clamp_max(math.log(100.0)))
        dev = x.device
        table = torch.tensor(_coords_table(ws), dtype=torch.float32,
                             device=dev)
        idx = torch.tensor(_position_index(ws).reshape(-1), device=dev)
        cpb = self.cpb_fc2(F.relu(self.cpb_fc1(table))).reshape(-1, nh)
        attn = attn + 16.0 * torch.sigmoid(
            cpb[idx].reshape(N, N, nh).permute(2, 0, 1))[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, nh, N, N)
                    + mask[None, :, None]).reshape(B_, nh, N, N)
        out = p.matmul(p.softmax(attn), v)
        return self.proj(out.transpose(1, 2).reshape(B_, N, C))


class SwinBlock(nn.Module):
    """Post-norm residuals around shifted-window attention and the MLP."""

    def __init__(self, dim, heads, ws, shift, mlp_ratio, drop_path, prec):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.attn = WindowAttention(dim, heads, prec)
        self.norm1 = _layer_norm(dim, prec)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio), prec)
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim, prec)
        self.norm2 = _layer_norm(dim, prec)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, res, gen):
        H, W = res
        B, L, C = x.shape
        ws, shift = self.ws, self.shift
        if min(H, W) <= ws:
            ws, shift = min(H, W), 0
        xs = x.reshape(B, H, W, C)
        mask = None
        if shift:
            xs = torch.roll(xs, (-shift, -shift), dims=(1, 2))
            mask = torch.tensor(_shift_mask(H, W, ws, shift),
                                dtype=torch.float32, device=x.device)
        xs = _unwindows(self.attn(_windows(xs, ws), ws, mask), ws, H, W)
        if shift:
            xs = torch.roll(xs, (shift, shift), dims=(1, 2))
        x = x + self.drop_path(_ln(self.norm1, xs.reshape(B, L, C)), gen)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(x), approximate="tanh"))
        return x + self.drop_path(_ln(self.norm2, y), gen)


class PatchMerging(nn.Module):
    def __init__(self, dim, prec):
        super().__init__()
        self.reduction = Dense(4 * dim, 2 * dim, prec, bias=False)
        self.norm = _layer_norm(2 * dim, prec)

    def forward(self, x, res):
        H, W = res
        B, _, C = x.shape
        xs = x.reshape(B, H, W, C)
        xs = torch.cat([xs[:, 0::2, 0::2], xs[:, 1::2, 0::2],
                        xs[:, 0::2, 1::2], xs[:, 1::2, 1::2]], -1)
        return _ln(self.norm, self.reduction(xs.reshape(B, -1, 4 * C)))


class SwinV2(nn.Module):
    """Stride-4 patch embedding, four stages of SwinV2 blocks with patch
    merging, a final norm and depth_to_space(4); inputs reflect-padded at
    the bottom and right to a multiple of 32 * ws / 2 and the output
    cropped back."""

    def __init__(self, swin, drop_path_rate, prec):
        super().__init__()
        E = int(swin["EMBED_DIM"])
        self.depths = tuple(swin["DEPTHS"])
        heads = tuple(swin["NUM_HEADS"])
        self.ws = int(swin["WINDOW_SIZE"])
        mlp = float(swin.get("MLP_RATIO", 4.0))
        if any(swin.get("PRETRAINED_WINDOW_SIZES", (0,) * 4)):
            raise ValueError("the reference holds pretrained window size 0")
        self.prec, self.embed = prec, E
        self.patch_embed = nn.Module()
        self.patch_embed.weight = _param(E, 3, 4, 4)
        self.patch_embed.bias = _param(E)
        self.patch_embed_norm = _layer_norm(E, prec)
        dpr = iter(float(v) for v in np.linspace(0, drop_path_rate,
                                                 sum(self.depths)))
        for i, depth in enumerate(self.depths):
            dim = E * 2 ** i
            for d in range(depth):
                self.add_module(f"layers_{i}_blocks_{d}", SwinBlock(
                    dim, heads[i], self.ws, 0 if d % 2 == 0 else self.ws // 2,
                    mlp, next(dpr), prec))
            if i < len(self.depths) - 1:
                self.add_module(f"layers_{i}_downsample",
                                PatchMerging(dim, prec))
        self.norm = _layer_norm(E * 2 ** (len(self.depths) - 1), prec)

    def forward(self, x, gen):
        x = x.float().expand(-1, -1, -1, 3)
        B, H_in, W_in, _ = x.shape
        ratio = 2 ** (len(self.depths) - 1) * 4
        rate = ratio * self.ws // 2
        ph, pw = -H_in % rate, -W_in % rate
        if ph:
            x = torch.cat([x, x[:, H_in - 1 - ph:H_in - 1].flip(1)], 1)
        if pw:
            x = torch.cat([x, x[:, :, W_in - 1 - pw:W_in - 1].flip(2)], 2)
        H, W = H_in + ph, W_in + pw
        x = self.prec.conv(x, self.patch_embed.weight, 4) + \
            self.patch_embed.bias
        res = (H // 4, W // 4)
        x = _ln(self.patch_embed_norm, x.reshape(B, -1, self.embed))
        for i, depth in enumerate(self.depths):
            for d in range(depth):
                x = getattr(self, f"layers_{i}_blocks_{d}")(x, res, gen)
            if i < len(self.depths) - 1:
                x = getattr(self, f"layers_{i}_downsample")(x, res)
                res = (res[0] // 2, res[1] // 2)
        x = depth_to_space(_ln(self.norm, x).reshape(B, res[0], res[1], -1),
                           4)
        return x[:, :H_in // ratio * 4, :W_in // ratio * 4]


# ---- heads ------------------------------------------------------------------

class BatchNorm(nn.Module):
    """Batch statistics (mean, biased variance as E[x^2] - E[x]^2) in train
    mode, running statistics in eval mode; eps 1e-5, running update with
    momentum 0.9."""

    def __init__(self, c, prec):
        super().__init__()
        self.prec = prec
        self.weight = _param(c)
        self.bias = _param(c)
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        x = x.float()
        if self.training:
            dims = tuple(range(x.ndim - 1))
            mean = x.mean(dims)
            var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        return self.prec.batch_norm(x, mean, var, 1e-5, self.weight,
                                    self.bias)


class Conv(nn.Module):
    def __init__(self, c_in, c_out, k, prec):
        super().__init__()
        self.prec = prec
        self.weight = _param(c_out, c_in, k, k)
        self.bias = _param(c_out)

    def forward(self, x):
        return self.prec.conv(x, self.weight) + self.bias


def _reflect1(x):
    x = torch.cat([x[:, 1:2], x, x[:, -2:-1]], 1)
    return torch.cat([x[:, :, 1:2], x, x[:, :, -2:-1]], 2)


class ConvBNRelu(nn.Module):
    def __init__(self, c_in, c_out, prec):
        super().__init__()
        self.Conv_0 = Conv(c_in, c_out, 3, prec)
        self.BatchNorm_0 = BatchNorm(c_out, prec)

    def forward(self, x):
        return self.BatchNorm_0(F.relu(self.Conv_0(_reflect1(x))))


class Head(nn.Module):
    """Reflect pad, 3x3 conv, ReLU, BatchNorm, 1x1 conv, BatchNorm."""

    def __init__(self, c_in, c_mid, c_out, prec):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(c_in, c_mid, prec)
        self.Conv_0 = Conv(c_mid, c_out, 1, prec)
        self.BatchNorm_0 = BatchNorm(c_out, prec)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(self.ConvBNRelu_0(x)))


def _resize_weights(n_in, n_out, device):
    """(n_in, n_out) weights of a linear resize with half-pixel centres,
    the triangle widened by n_in / n_out when shrinking, each column
    normalised, zero for samples outside [-0.5, n_in - 0.5]."""
    scale = n_in / n_out
    sample = (torch.arange(n_out, device=device) + 0.5) * scale - 0.5
    src = torch.arange(n_in, device=device, dtype=torch.float32)
    w = (1.0 - (sample[None] - src[:, None]).abs() / max(scale, 1.0)
         ).clamp_min(0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None], w, 0.0)


def _to_16(x):
    """(N, H, W, C) -> (N, 16, 16, C): block means where 16 divides the
    sides, else the linear resize."""
    N, H, W, C = x.shape
    if H % 16 == 0 and W % 16 == 0:
        return x.reshape(N, 16, H // 16, 16, W // 16, C).mean(dim=(2, 4))
    return torch.einsum("nhwc,hi,wj->nijc", x,
                        _resize_weights(H, 16, x.device),
                        _resize_weights(W, 16, x.device))


def _l2n(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-12)


class RegNet(nn.Module):
    """Siamese conv backbone on both encoder outputs, 16 x 16 maps, the
    mean of the L2-normalised cost volume, two dense layers (Dropout 0.5
    before each) to the 8 corner offsets."""

    def __init__(self, c_in, prec):
        super().__init__()
        self.prec = prec
        self.conv1 = nn.Module()
        self.conv1.weight = _param(96, c_in, 3, 3)
        self.bn1 = BatchNorm(96, prec)
        self.conv2 = nn.Module()
        self.conv2.weight = _param(192, 96, 3, 3)
        self.bn2 = BatchNorm(192, prec)
        self.fc1 = Dense(256, 64, prec)
        self.fc2 = Dense(64, 8, prec)

    def _backbone(self, x):
        p = self.prec
        x = F.relu(self.bn1(p.conv(x, self.conv1.weight, padding=1)))
        x = F.relu(self.bn2(p.conv(x, self.conv2.weight, padding=1)))
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)

    def forward(self, x1, x2, gen):
        f1, f2 = _to_16(self._backbone(x1)), _to_16(self._backbone(x2))
        N, H, W, C = f1.shape
        f1 = _l2n(f1).reshape(N, H * W, C)
        f2 = _l2n(f2).reshape(N, H * W, C)
        x = self.prec.matmul(f1, f2.transpose(1, 2), "fp32").mean(2)
        if self.training:
            x = _drop(x, 0.5, x.shape, gen)
        x = F.relu(self.fc1(x))
        if self.training:
            x = _drop(x, 0.5, x.shape, gen)
        return self.fc2(x)


class XPoint(nn.Module):
    """Encoder, detector head (r^2 + 1 classes), descriptor head (unit
    descriptors) and RegNet, built from the configuration's ``model``
    section."""

    def __init__(self, model_cfg, prec):
        super().__init__()
        ua = model_cfg["use_attention"]
        mp = ua["model_parameters"]["MODEL"]
        rate = float(mp.get("DROP_PATH_RATE", 0.2))
        if ua["type"] == "VMamba":
            vssm = mp["VSSM"]
            self.encoder = VSSM(vssm, rate, prec)
            n = len(vssm["DEPTHS"])
            c_enc = int(vssm["EMBED_DIM"]) * 2 ** (n - 1) // 16
            self.ratio = 8
        elif ua["type"] in ("Swinv2", "SwinV2"):
            swin = mp["SWINV2"]
            self.encoder = SwinV2(swin, rate, prec)
            n = len(swin["DEPTHS"])
            c_enc = int(swin["EMBED_DIM"]) * 2 ** (n - 1) // 16
            self.ratio = 2 ** (n - 1)
        else:
            raise ValueError(f"no reference encoder {ua['type']}")
        if (model_cfg.get("multispectral") or not model_cfg.get(
                "normalize_descriptors", True)
                or not model_cfg.get("final_batchnorm", True)
                or not model_cfg.get("reflection_pad", True)
                or model_cfg.get("bn_first")
                or model_cfg.get("channel_version", 0) != 0):
            raise ValueError("the reference holds one encoder, reflect pads, "
                             "ReLU before BatchNorm, final BatchNorm and "
                             "unit descriptors")
        D = int(model_cfg.get("descriptor_size", 256))
        self.detector_head = Head(c_enc, 256, self.ratio ** 2 + 1, prec)
        self.descriptor_head = Head(c_enc, 256, D, prec)
        hm = model_cfg.get("homography_regression_head", {})
        if hm.get("check"):
            if hm.get("type", "RegNet") != "RegNet":
                raise ValueError("the reference holds the RegNet head")
            self.hm_regressor = RegNet(c_enc, prec)

    def forward(self, image, gen=None):
        x = self.encoder(image, gen)
        logits = self.detector_head(x)
        desc = self.descriptor_head(x)
        return {"logits": logits,
                "desc": desc / torch.linalg.vector_norm(
                    desc, dim=-1, keepdim=True).clamp_min(1e-12),
                "encoder_output": x.detach()}

    def forward_pair(self, opt, thermal, gen=None):
        po, pt = self(opt, gen), self(thermal, gen)
        hm = None
        if hasattr(self, "hm_regressor"):
            hm = self.hm_regressor(po["encoder_output"], pt["encoder_output"],
                                   gen)
        return po, pt, hm
