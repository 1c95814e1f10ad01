"""SwinTransformerV2 encoder, NHWC (port of ``xpoint_tpu/models/swinv2.py``).

  * arbitrary input sizes: reflect-pad (bottom and right) to a multiple of
    overall_downsample_ratio * window_size / 2, crop the padding off at
    the end;
  * SwinV2 blocks: post-norm residuals, cosine attention with a learned
    logit scale clamped at log(100), continuous relative-position bias
    from a log-spaced coordinate table through a 2-layer MLP, shifted
    windows with the -100 SW-MSA mask; a stage whose resolution is not
    larger than the window uses one window of that size and no shift;
  * PatchMerging with the norm after the 2x reduction;
  * PatchEmbed conv with stride 4, and depth_to_space(4) at the end: the
    output is (B, H/8, W/8, embed * 2^(n-1) / 16) for four stages.

Precision follows the flax module's casts one by one. With a bf16
``dtype``, only the patch embedding and ``qkv`` run in bf16; the flax
``nn.Dense`` layers without a dtype (``proj``, ``mlp_fc1`` / ``mlp_fc2``,
``reduction``, the CPB MLP) promote their bf16 input against the fp32
parameters and compute and return fp32 (:class:`Dense`); the attention
logits and softmax are fp32, the softmax is cast to the activation dtype
before the product with v; every LayerNorm runs in fp32 (eps 1e-6, flax's)
and casts back to the dtype of the block's input. GELU is the tanh
approximation (flax's ``nn.gelu``).

Submodule and parameter names follow the flax module tree (``patch_embed``,
``patch_embed_norm``, ``layers_{i}_blocks_{j}`` with ``attn`` holding
``logit_scale``, ``qkv_kernel`` (C, 3C) in flax's layout, ``q_bias``,
``v_bias``, ``cpb_fc1``, ``cpb_fc2`` and ``proj``; ``layers_{i}_downsample``,
``norm``), so the weight bridge maps them one to one. The shift masks,
coordinate tables and index tables depend on the input size only and are
built on the host once per size and device and copied without a wait.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import obs
from ..ops.gridops import depth_to_space, device_constant
from .heads import Conv
from .vssm import DropPath, _layer_norm_module


def window_partition(x, ws):
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(windows, ws, H, W):
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    C = windows.shape[-1]
    B = windows.shape[0] // (H * W // ws // ws)
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def _relative_coords_table(ws, pretrained_ws):
    """Log-spaced continuous relative-position coordinates,
    (1, 2ws-1, 2ws-1, 2) fp32."""
    h = np.arange(-(ws - 1), ws, dtype=np.float32)
    table = np.stack(np.meshgrid(h, h, indexing="ij"), -1)[None]
    denom = (pretrained_ws - 1) if pretrained_ws > 0 else (ws - 1)
    table = table / max(denom, 1)
    table *= 8
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8)
    return table.astype(np.float32)


def _relative_position_index(ws):
    """(ws^2, ws^2) index into the (2ws-1)^2 table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1).astype(np.int64)


def _attn_mask(H, W, ws, shift):
    """SW-MSA mask, (nW, ws^2, ws^2) of 0 / -100 fp32."""
    img = np.zeros((H, W), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wss] = cnt
            cnt += 1
    m = img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3)
    m = m.reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


_CONSTANTS = {}


def _constant(key, make, device):
    """A host-built table on ``device``, built and copied once per key."""
    key = key + (str(device),)
    if key not in _CONSTANTS:
        arr = make()
        _CONSTANTS[key] = device_constant(
            arr, device, torch.int64 if arr.dtype == np.int64
            else torch.float32)
    return _CONSTANTS[key]


class Dense(nn.Module):
    """flax ``nn.Dense`` without a dtype: the input is promoted to fp32
    against the fp32 parameters, and the output is fp32. ``init`` names
    the kernel's initialiser ("trunc_normal" 0.02 or flax's default
    "lecun_normal"; ``models.init``)."""

    def __init__(self, in_features, features, bias=True,
                 init="trunc_normal"):
        super().__init__()
        self.init = init
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x):
        return F.linear(x.float(), self.weight, self.bias)


def _ln_to(norm, x, dtype):
    """LayerNorm in fp32, cast to ``dtype`` (span ``xp.enc.norm``, the
    casts included)."""
    with obs.span("xp.enc.norm"):
        return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                            norm.bias, norm.eps).to(dtype)


class WindowAttention(nn.Module):
    def __init__(self, dim, num_heads, pretrained_window_size=0,
                 qkv_bias=True):
        super().__init__()
        self.num_heads = num_heads
        self.pretrained_window_size = pretrained_window_size
        self.logit_scale = nn.Parameter(
            torch.full((num_heads, 1, 1), math.log(10.0)))
        self.qkv_kernel = nn.Parameter(torch.empty(dim, 3 * dim))
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
        self.cpb_fc1 = Dense(2, 512, init="lecun_normal")
        self.cpb_fc2 = Dense(512, num_heads, bias=False, init="lecun_normal")
        self.proj = Dense(dim, dim)

    @obs.spanned("xp.enc.attn")
    def forward(self, x, ws, mask=None):
        B_, N, C = x.shape
        nh = self.num_heads
        qkv = x @ self.qkv_kernel.to(x.dtype)
        if hasattr(self, "q_bias"):
            bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                              self.v_bias])
            qkv = qkv + bias.to(qkv.dtype)
        qkv = qkv.reshape(B_, N, 3, nh, C // nh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]

        # cosine attention with a clamped learned temperature; fp32 logits
        # (preferred_element_type=float32 on the JAX side)
        qn = q / torch.linalg.vector_norm(q, dim=-1,
                                          keepdim=True).clamp_min(1e-12)
        kn = k / torch.linalg.vector_norm(k, dim=-1,
                                          keepdim=True).clamp_min(1e-12)
        attn = qn.float() @ kn.float().transpose(-2, -1)
        scale = torch.exp(self.logit_scale.clamp_max(math.log(1.0 / 0.01)))
        attn = attn * scale

        # continuous relative position bias
        dev = x.device
        table = _constant(("table", ws, self.pretrained_window_size),
                          lambda: _relative_coords_table(
                              ws, self.pretrained_window_size), dev)
        idx = _constant(("index", ws), lambda: _relative_position_index(
            ws).reshape(-1), dev)
        cpb = self.cpb_fc2(F.relu(self.cpb_fc1(table))).reshape(-1, nh)
        bias = cpb[idx].reshape(N, N, nh).permute(2, 0, 1)
        attn = attn + 16.0 * torch.sigmoid(bias)[None]

        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, nh, N, N)
                    + mask[None, :, None]).reshape(B_, nh, N, N)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size, shift_size,
                 mlp_ratio=4.0, drop_path=0.0, pretrained_window_size=0):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.attn = WindowAttention(dim, num_heads, pretrained_window_size)
        self.norm1 = _layer_norm_module(dim)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim)
        self.norm2 = _layer_norm_module(dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, res, gen=None):
        H, W = res
        B, L, C = x.shape
        ws, shift = self.window_size, self.shift_size
        if min(H, W) <= ws:
            ws, shift = min(H, W), 0

        xs = x.reshape(B, H, W, C)
        if shift > 0:
            xs = torch.roll(xs, (-shift, -shift), dims=(1, 2))
        mask = (_constant(("mask", H, W, ws, shift),
                          lambda: _attn_mask(H, W, ws, shift), x.device)
                if shift > 0 else None)
        attn = self.attn(window_partition(xs, ws), ws, mask)
        xs = window_reverse(attn, ws, H, W)
        if shift > 0:
            xs = torch.roll(xs, (shift, shift), dims=(1, 2))
        # SwinV2 post-norm residuals
        x = x + self.drop_path(_ln_to(self.norm1, xs.reshape(B, L, C),
                                      x.dtype), gen)
        with obs.span("xp.enc.mlp"):
            y = self.mlp_fc2(F.gelu(self.mlp_fc1(x), approximate="tanh"))
        return x + self.drop_path(_ln_to(self.norm2, y, x.dtype), gen)


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.reduction = Dense(4 * dim, 2 * dim, bias=False)
        self.norm = _layer_norm_module(2 * dim)

    def forward(self, x, res):
        H, W = res
        B, L, C = x.shape
        xs = x.reshape(B, H, W, C)
        xs = torch.cat([xs[:, 0::2, 0::2], xs[:, 1::2, 0::2],
                        xs[:, 0::2, 1::2], xs[:, 1::2, 1::2]], -1)
        return _ln_to(self.norm, self.reduction(xs.reshape(B, -1, 4 * C)),
                      x.dtype)


def _reflect_pad_end(x, pad_h, pad_w):
    """Reflect-pad (B, H, W, C) at the bottom and right (the edge not
    repeated), built from slices and flips: their backward on the card
    sums in a fixed order (F.pad's reflect backward adds with atomics)."""
    if pad_h:
        H = x.shape[1]
        x = torch.cat([x, x[:, H - 1 - pad_h:H - 1].flip(1)], dim=1)
    if pad_w:
        W = x.shape[2]
        x = torch.cat([x, x[:, :, W - 1 - pad_w:W - 1].flip(2)], dim=2)
    return x


class SwinTransformerV2(nn.Module):
    """Four-stage SwinV2 encoder (by default); (B, H, W, 1 or 3) ->
    (B, H/8, W/8, embed * 2^(n-1) / 16) in ``dtype``."""

    def __init__(self, embed_dim=96, depths=(2, 2, 6, 2),
                 num_heads=(3, 6, 12, 24), window_size=8, mlp_ratio=4.0,
                 drop_path_rate=0.2, pretrained_window_sizes=(0, 0, 0, 0),
                 downsample_ratio_beginning=4, in_chans=3,
                 dtype=torch.float32):
        super().__init__()
        self.embed_dim, self.depths = embed_dim, tuple(depths)
        self.window_size = window_size
        self.r0 = downsample_ratio_beginning
        self.in_chans, self.dtype = in_chans, dtype
        r0 = downsample_ratio_beginning
        self.patch_embed = Conv(in_chans, embed_dim, r0, stride=r0)
        self.patch_embed_norm = _layer_norm_module(embed_dim)
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(depths))]
        block_idx = 0
        for i, depth in enumerate(self.depths):
            dim = int(embed_dim * 2 ** i)
            for d in range(depth):
                self.add_module(f"layers_{i}_blocks_{d}", SwinBlock(
                    dim, num_heads[i], window_size,
                    0 if d % 2 == 0 else window_size // 2, mlp_ratio,
                    dpr[block_idx], pretrained_window_sizes[i]))
                block_idx += 1
            if i < len(self.depths) - 1:
                self.add_module(f"layers_{i}_downsample", PatchMerging(dim))
        self.norm = _layer_norm_module(int(embed_dim * 2 ** (len(depths) - 1)))

    @property
    def overall_downsample_ratio(self):
        return 2 ** (len(self.depths) - 1) * self.r0

    def forward(self, x, gen=None):
        if self.in_chans == 3 and x.shape[-1] == 1:
            x = torch.cat([x, x, x], dim=-1)
        x = x.to(self.dtype)
        B, H_in, W_in, _ = x.shape
        rate = self.overall_downsample_ratio * self.window_size // 2
        pad_h = -H_in % rate
        pad_w = -W_in % rate
        x = _reflect_pad_end(x, pad_h, pad_w)
        H, W = H_in + pad_h, W_in + pad_w

        x = self.patch_embed(x)
        res = (H // self.r0, W // self.r0)
        x = _ln_to(self.patch_embed_norm,
                   x.reshape(B, res[0] * res[1], self.embed_dim), self.dtype)
        for i, depth in enumerate(self.depths):
            for d in range(depth):
                x = getattr(self, f"layers_{i}_blocks_{d}")(x, res, gen)
            if i < len(self.depths) - 1:
                x = getattr(self, f"layers_{i}_downsample")(x, res)
                res = (res[0] // 2, res[1] // 2)
        x = _ln_to(self.norm, x, self.dtype).reshape(B, res[0], res[1], -1)
        x = depth_to_space(x, 4)
        h = H_in // self.overall_downsample_ratio * 4
        w = W_in // self.overall_downsample_ratio * 4
        return x[:, :h, :w]


def build_swin_from_config(swin_cfg, dtype=torch.float32):
    """SwinTransformerV2 from the reference MODEL.SWINV2 dict (with
    MODEL.DROP_PATH_RATE merged in as ``DROP_PATH_RATE``)."""
    get = swin_cfg.get
    return SwinTransformerV2(
        embed_dim=int(get("EMBED_DIM", 96)),
        depths=tuple(get("DEPTHS", (2, 2, 6, 2))),
        num_heads=tuple(get("NUM_HEADS", (3, 6, 12, 24))),
        window_size=int(get("WINDOW_SIZE", 8)),
        mlp_ratio=float(get("MLP_RATIO", 4.0)),
        drop_path_rate=float(get("DROP_PATH_RATE", 0.2)),
        pretrained_window_sizes=tuple(get("PRETRAINED_WINDOW_SIZES",
                                          (0, 0, 0, 0))),
        dtype=dtype)
