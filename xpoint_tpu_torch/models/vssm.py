"""VSSM (VMamba) encoder, NHWC (port of ``xpoint_tpu/models/vssm.py``).

Supported: the forward types v05, v051d, v052d and v052dc (SS2D in scan
modes 0 cross2d, 1 unidi, 2 bidi and -1 cascade2d) with their ``_noz`` /
``_nozact`` / ``_oact`` tags, any ``d_state`` N >= 1, with or without the conv
bias, forward and backward. The flagship ``v05_noz`` with N = 1 runs the
flip-free token-major bidirectional scan; ``v051d`` / ``v052d`` with N = 1
run ``cross_scan``, the single-direction fused scan and ``cross_merge``;
N > 1 and cascade2d run ``ops.selective_scan.selective_scan``. ``SS2Dv3``
(xv) and ``SS2Dm0`` raise NotImplementedError (ROADMAP.md, Queue 1 item 7).

Submodule and parameter names follow the flax module tree, so the weight
bridge (``compat.from_flax``) maps names one to one. Parameters are fp32;
activations run in ``dtype``; LayerNorm (eps 1e-6, flax's) runs in fp32;
GELU is the tanh approximation (flax's ``nn.gelu`` default).

Train mode (``module.train()``) is the JAX ``deterministic=False``: DropPath
draws its per-sample masks from the ``torch.Generator`` passed to
``forward`` (the counterpart of the flax "droppath" rng stream), and SS2D's
scans run through their autograd Functions (``SelectiveScanBidir``,
``SelectiveScanFusedBkld``, ``LinearScan``).
"""
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cross_scan import cross_merge, cross_scan
from ..ops.gridops import depth_to_space
from ..ops.selective_scan import selective_scan
from ..ops.selective_scan_cuda import scan_bidir, selective_scan_fused_bkld

_ROADMAP_ITEM = "ROADMAP.md Queue 1 item 7 (other encoders and forward types)"


def layer_norm(norm, x):
    """flax ``nn.LayerNorm(dtype=float32)`` then a cast back to x's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(x.dtype)


def _layer_norm_module(dim):
    return nn.LayerNorm(dim, eps=1e-6)


def _conv_nhwc(x, weight, stride=1, padding=0, groups=1):
    """NHWC conv with an OIHW weight cast to x's dtype (no bias)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), None, stride,
                 padding, 1, groups)
    return y.permute(0, 2, 3, 1)


class StridedConv3x3(nn.Module):
    """3x3 stride-2 pad-1 conv (patch embed v2 / downsample v3).

    The JAX module evaluates it as a 2x2 conv over the space-to-depth
    input, a TPU workaround; a plain stride-2 conv computes the same.
    The bias is added after the conv, in the activation dtype, as in JAX.
    """

    def __init__(self, in_features, features):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        y = _conv_nhwc(x, self.weight, stride=2, padding=1)
        return y + self.bias.to(y.dtype)


def _drop(x, rate, mask_shape, gen):
    """Keep with probability 1 - rate (jax.random.bernoulli: uniform <
    keep, a mask of ``mask_shape`` broadcast over x) and scale by 1 / keep.
    ``gen`` is required: the port draws from explicit generators only."""
    if gen is None:
        raise ValueError("a stochastic layer in train mode needs the "
                         "torch.Generator passed to forward")
    keep = 1.0 - rate
    mask = torch.rand(mask_shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x, rate, training, gen):
    """flax ``nn.Dropout``: a mask per element in train mode."""
    if not training or rate == 0.0:
        return x
    return _drop(x, rate, x.shape, gen)


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm DropPath, ``vssm.py:87-100``): in
    train mode each sample is kept with probability 1 - rate and scaled by
    1 / keep; identity in eval mode or at rate 0."""

    def __init__(self, rate=0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, gen=None):
        if not self.training or self.rate == 0.0:
            return x
        return _drop(x, self.rate, (x.shape[0],) + (1,) * (x.ndim - 1), gen)


class Mlp(nn.Module):
    def __init__(self, dim, hidden_dim, out_dim):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x):
        x = F.linear(x, self.Dense_0.weight.to(x.dtype),
                     self.Dense_0.bias.to(x.dtype))
        x = F.gelu(x, approximate="tanh")
        return F.linear(x, self.Dense_1.weight.to(x.dtype),
                        self.Dense_1.bias.to(x.dtype))


class SS2D(nn.Module):
    """2D selective scan block, forward types v05 / v051d / v052d / v052dc
    (``scan_mode`` 0 cross2d, 1 unidi, 2 bidi, -1 cascade2d), with the
    state size ``d_state`` N >= 1, the optional gate branch (``disable_z``
    False: ``in_proj`` emits x and z, y is multiplied by SiLU(z), or by z
    itself with ``disable_z_act``) and the optional GELU on the normalised
    output (``out_act``). Constructor arguments in the flax module's order.

    With N = 1, mode 0 runs the token-major bidirectional scan and modes 1
    and 2 the single-direction fused scan in (B, K, L, D) layout; N > 1 and
    cascade2d go through ``ops.selective_scan.selective_scan`` in the
    reference layout."""

    def __init__(self, d_model, d_state=1, ssm_ratio=1.0, dt_rank="auto",
                 d_conv=3, conv_bias=False, disable_z=True,
                 disable_z_act=False, out_act=False, scan_mode=0):
        super().__init__()
        if scan_mode not in (-1, 0, 1, 2):
            raise ValueError(f"unknown SS2D scan mode {scan_mode}")
        self.scan_mode = scan_mode
        self.disable_z, self.disable_z_act = disable_z, disable_z_act
        self.out_act = out_act
        D = int(ssm_ratio * d_model)
        R = int(math.ceil(d_model / 16)) if dt_rank == "auto" else int(dt_rank)
        K, N = 4, int(d_state)
        self.d_inner, self.dt_rank, self.d_state = D, R, N
        self.in_proj = nn.Linear(d_model, D if disable_z else 2 * D,
                                 bias=False)
        if d_conv > 1:
            # padding 1 whatever the kernel size, as the flax module has it
            self.conv2d = nn.Conv2d(D, D, d_conv, padding=1, groups=D,
                                    bias=conv_bias)
        self.x_proj_weight = nn.Parameter(torch.empty(K, R + 2 * N, D))
        # stored unshifted in [0, 2 R^-0.5); the effective weight is
        # dt_projs_weight - R^-0.5 (vssm.py:181-185)
        self.dt_projs_weight = nn.Parameter(torch.empty(K, D, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K, D))
        self.A_logs = nn.Parameter(torch.empty(K * D, N))
        self.Ds = nn.Parameter(torch.ones(K * D))
        self.out_norm = _layer_norm_module(D)
        self.out_proj = nn.Linear(D, d_model, bias=False)

    def forward(self, x):
        _, H, W, _ = x.shape
        D, R, N = self.d_inner, self.dt_rank, self.d_state
        dtype = x.dtype
        xs, z = F.linear(x, self.in_proj.weight.to(dtype)), None
        if not self.disable_z:
            xs, z = xs.chunk(2, dim=-1)
            if not self.disable_z_act:
                z = F.silu(z)
        if hasattr(self, "conv2d"):
            bias = self.conv2d.bias
            xs = _conv_nhwc(xs, self.conv2d.weight, padding=1, groups=D)
            if bias is not None:
                xs = xs + bias.to(dtype)
        xs = F.silu(xs)
        dt_w = (self.dt_projs_weight - R ** -0.5).to(dtype)
        if self.scan_mode == -1:
            y = self._cascade2d(xs, dt_w)
        elif self.scan_mode == 0 and N == 1:
            y = self._cross2d(xs, -torch.exp(self.A_logs.reshape(-1)), dt_w)
        else:
            # token-wise projections per direction k on the expanded
            # (B, K, L, D) planes, the scan, merge
            xk = cross_scan(xs, self.scan_mode)
            x_dbl = torch.einsum("bkld,kcd->bklc", xk,
                                 self.x_proj_weight.to(dtype))
            dts, Bs, Cs = torch.split(x_dbl, [R, N, N], dim=-1)
            dts = torch.einsum("bklr,kdr->bkld", dts, dt_w)
            if N == 1:
                ys = selective_scan_fused_bkld(
                    xk.contiguous(), dts.contiguous(),
                    -torch.exp(self.A_logs.reshape(-1)), Bs.contiguous(),
                    Cs.contiguous(), self.Ds, self.dt_projs_bias.reshape(-1))
            else:
                ys = self._reference_scan(xk, dts, Bs, Cs, slice(0, 4))
            y = cross_merge(ys, H, W, self.scan_mode)
        y = layer_norm(self.out_norm, y).to(dtype)
        if self.out_act:
            y = F.gelu(y, approximate="tanh")
        if z is not None:
            y = y * z
        return F.linear(y, self.out_proj.weight.to(dtype))

    def _reference_scan(self, xk, dts, Bs, Cs, ks):
        """(B, k, L, D) planes of directions ``ks`` through the scan in the
        canonical layout (B, k*D, L) -> fp32 (B, k, L, D)."""
        B, k, L, D = xk.shape
        N = self.d_state
        cl = lambda v: v.transpose(2, 3).reshape(B, k * D, L)  # noqa: E731
        A = -torch.exp(self.A_logs.reshape(4, D, N)[ks].reshape(-1, N))
        ys = selective_scan(
            cl(xk), cl(dts), A, Bs.transpose(2, 3), Cs.transpose(2, 3),
            self.Ds.reshape(4, D)[ks].reshape(-1),
            self.dt_projs_bias[ks].reshape(-1), True)
        return ys.reshape(B, k, D, L).transpose(2, 3)

    def _cascade2d(self, xs, dt_w):
        """Scan mode -1 (v052dc): rows scanned in both directions with the
        parameters of directions 0-1, a parameter-free LayerNorm, then
        columns with those of directions 2-3."""
        D, R, N, dtype = self.d_inner, self.dt_rank, self.d_state, xs.dtype

        def plain_ln(v):
            return F.layer_norm(v.float(), (D,), None, None, 1e-5)

        def scan_axis(v, k0, along_w):
            seq = v if along_w else v.transpose(1, 2)
            Bb, S, Ln, _ = seq.shape                  # (B, n_seq, L, D)
            seq = seq.reshape(Bb * S, Ln, D)
            xk2 = torch.stack([seq, seq.flip(1)], dim=1)    # (BS, 2, L, D)
            ks = slice(k0, k0 + 2)
            x_dbl = torch.einsum("bkld,kcd->bklc", xk2,
                                 self.x_proj_weight[ks].to(dtype))
            dts, Bs, Cs = torch.split(x_dbl, [R, N, N], dim=-1)
            dts = torch.einsum("bklr,kdr->bkld", dts, dt_w[ks])
            ys = self._reference_scan(xk2, dts, Bs, Cs, ks)
            # the two directions are summed WITHOUT un-reversing the flipped
            # one, as the reference does (kept for checkpoint parity)
            merged = (ys[:, 0] + ys[:, 1]).reshape(Bb, S, Ln, D)
            return merged if along_w else merged.transpose(1, 2)

        y_row = scan_axis(plain_ln(xs).to(dtype), 0, True)
        return scan_axis(plain_ln(y_row).to(dtype), 2, False)

    def _cross2d(self, xs, A, dt_w):
        """Scan mode 0, N = 1, on (B, H, W, D) activations -> merged
        (B, H, W, D)."""
        B, H, W, D = xs.shape
        R, N, L, dtype = self.dt_rank, 1, H * W, xs.dtype
        # token-major operands: row-major (j=0) and column-major (j=1)
        # base orders; direction k = 2 r + j, r = reversed
        u_t = torch.stack([xs.permute(1, 2, 0, 3).reshape(L, B, D),
                           xs.permute(2, 1, 0, 3).reshape(L, B, D)], dim=2)
        w4 = self.x_proj_weight.to(dtype).reshape(2, 2, R + 2 * N, D)
        x_dbl = torch.einsum("lbjd,rjcd->rlbjc", u_t, w4)
        dts, Bs, Cs = torch.split(x_dbl, [R, N, N], dim=-1)
        dts = torch.einsum("rlbjs,rjds->rlbjd", dts,
                           dt_w.reshape(2, 2, D, R))
        ys_f, ys_r = scan_bidir(
            u_t.contiguous(), dts.contiguous(), Bs[..., 0].contiguous(),
            Cs[..., 0].contiguous(), A, self.Ds.contiguous(),
            self.dt_projs_bias.reshape(-1))
        ysum = ys_f + ys_r                                  # (L, B, 2, D)
        return (ysum[:, :, 0].reshape(H, W, B, D).permute(2, 0, 1, 3)
                + ysum[:, :, 1].reshape(W, H, B, D).permute(2, 1, 0, 3))


class VSSBlock(nn.Module):
    def __init__(self, dim, ssm_ratio=1.0, dt_rank="auto", mlp_ratio=4.0,
                 drop_path=0.0, scan_mode=0, d_state=1, ssm_conv=3,
                 ssm_conv_bias=False, disable_z=True, disable_z_act=False,
                 out_act=False):
        super().__init__()
        self.norm = _layer_norm_module(dim)
        self.op = SS2D(dim, d_state, ssm_ratio, dt_rank, ssm_conv,
                       ssm_conv_bias, disable_z, disable_z_act, out_act,
                       scan_mode)
        self.drop_path = DropPath(drop_path)
        self.mlp_ratio = mlp_ratio
        if mlp_ratio > 0:
            self.norm2 = _layer_norm_module(dim)
            self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, gen=None):
        x = x + self.drop_path(self.op(layer_norm(self.norm, x)), gen)
        if self.mlp_ratio > 0:
            x = x + self.drop_path(self.mlp(layer_norm(self.norm2, x)), gen)
        return x


class VSSM(nn.Module):
    """4-stage VMamba encoder; (B, H, W, 1|3) -> (B, H/8, W/8, embed/2)."""

    def __init__(self, depths=(2, 2, 2, 2), embed_dim=96, ssm_ratio=1.0,
                 dt_rank="auto", mlp_ratio=4.0, drop_path_rate=0.2,
                 dtype=torch.float32, scan_mode=0, **ss2d_args):
        """``ss2d_args``: VSSBlock's d_state, ssm_conv, ssm_conv_bias,
        disable_z, disable_z_act and out_act, the same for every block."""
        super().__init__()
        self.depths = tuple(depths)
        self.dtype = dtype
        dims = [int(embed_dim * 2 ** i) for i in range(len(depths))]
        # linear stochastic-depth schedule over all blocks (vssm.py:634-635)
        dpr = iter(float(v) for v in
                   np.linspace(0, drop_path_rate, sum(self.depths)))
        self.patch_embed_conv1 = StridedConv3x3(3, embed_dim // 2)
        self.patch_embed_norm1 = _layer_norm_module(embed_dim // 2)
        self.patch_embed_conv2 = StridedConv3x3(embed_dim // 2, embed_dim)
        self.patch_embed_norm2 = _layer_norm_module(embed_dim)
        for i, depth in enumerate(depths):
            for d in range(depth):
                self.add_module(f"layers_{i}_blocks_{d}", VSSBlock(
                    dims[i], ssm_ratio, dt_rank, mlp_ratio, next(dpr),
                    scan_mode, **ss2d_args))
            if i < len(depths) - 1:
                self.add_module(f"layers_{i}_downsample_conv",
                                StridedConv3x3(dims[i], dims[i + 1]))
                self.add_module(f"layers_{i}_downsample_norm",
                                _layer_norm_module(dims[i + 1]))

    def forward(self, x, gen=None):
        if x.shape[-1] == 1:
            x = torch.cat([x, x, x], dim=-1)      # grayscale -> 3 channels
        x = x.to(self.dtype)
        x = layer_norm(self.patch_embed_norm1, self.patch_embed_conv1(x))
        x = F.gelu(x, approximate="tanh")
        x = layer_norm(self.patch_embed_norm2, self.patch_embed_conv2(x))
        for i, depth in enumerate(self.depths):
            for d in range(depth):
                x = getattr(self, f"layers_{i}_blocks_{d}")(x, gen)
            if i < len(self.depths) - 1:
                x = getattr(self, f"layers_{i}_downsample_conv")(x)
                x = layer_norm(getattr(self, f"layers_{i}_downsample_norm"), x)
        # H/32 x W/32 x 8E -> H/8 x W/8 x E/2
        return depth_to_space(x, 4)


def build_vssm_from_config(vssm_cfg, dtype=torch.float32):
    """VSSM from the reference MODEL.VSSM dict (with MODEL.DROP_PATH_RATE
    merged in as ``DROP_PATH_RATE``), parsed as
    ``xpoint_tpu.models.vssm.build_vssm_from_config`` parses it: the
    forward type's base (v05 cross2d, v051d unidi, v052d bidi, v052dc
    cascade2d) and its postfix tags (_noz, _nozact, _oact). The xv (SS2Dv3)
    and m0 (SS2Dm0) forward types raise NotImplementedError."""
    get = vssm_cfg.get
    ftype = str(get("SSM_FORWARDTYPE", "v05_noz"))
    base = ftype.split("_")[0]
    if base.startswith(("m", "xv")):
        raise NotImplementedError(
            f"VSSM forward type {ftype}: the xv and m0 families are not "
            f"ported; see {_ROADMAP_ITEM}")
    dt_rank = get("SSM_DT_RANK", "auto")
    return VSSM(
        depths=tuple(get("DEPTHS", [2, 2, 2, 2])),
        embed_dim=int(get("EMBED_DIM", 96)),
        ssm_ratio=float(get("SSM_RATIO", 1.0)),
        dt_rank=dt_rank if dt_rank == "auto" else int(dt_rank),
        mlp_ratio=float(get("MLP_RATIO", 4.0)),
        drop_path_rate=float(get("DROP_PATH_RATE", 0.2)),
        dtype=dtype,
        scan_mode={"v051d": 1, "v052d": 2, "v052dc": -1}.get(base, 0),
        d_state=int(get("SSM_D_STATE", 1)),
        ssm_conv=int(get("SSM_CONV", 3)),
        ssm_conv_bias=bool(get("SSM_CONV_BIAS", False)),
        disable_z=ftype.endswith("_noz") or "_noz_" in ftype,
        disable_z_act="_nozact" in ftype,
        out_act="_oact" in ftype,
    )
