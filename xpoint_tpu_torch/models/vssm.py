"""VSSM (VMamba) encoder, NHWC (port of ``xpoint_tpu/models/vssm.py``).

Supported: the forward types v05, v051d, v052d and v052dc (SS2D in scan
modes 0 cross2d, 1 unidi, 2 bidi and -1 cascade2d) with their ``_noz`` /
``_nozact`` / ``_oact`` tags, any ``d_state`` N >= 1, with or without the conv
bias, forward and backward. The flagship ``v05_noz`` with N = 1 runs the
flip-free token-major bidirectional scan; ``v051d`` / ``v052d`` with N = 1
run ``cross_scan``, the single-direction fused scan and ``cross_merge``;
N > 1 and cascade2d run ``ops.selective_scan.selective_scan``. The xv
forward types (``SS2Dv3``: xv1a, xv2a, xv3a with their postfixes) scan
through ``selective_scan`` too, so N = 1 runs the single-direction fused
scan and N > 1 the composition around the linear-recurrence kernel; the m0
family (``SS2Dm0``) runs the chunked SSD scan (``ops.ssd``).

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

from .. import obs
from ..ops.cross_scan import cross_merge, cross_scan
from ..ops.gridops import depth_to_space
from ..parallel.mesh import rand_rows
from ..ops.selective_scan import selective_scan
from ..ops.selective_scan_cuda import scan_bidir, selective_scan_fused_bkld
from ..ops.ssd import ssd_chunked


def layer_norm(norm, x):
    """flax ``nn.LayerNorm(dtype=float32)`` then a cast back to x's dtype
    (span ``xp.enc.norm``, the casts included)."""
    with obs.span("xp.enc.norm"):
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
    ``gen`` is required: the port draws from explicit generators only.
    ``mask_shape`` leads with the batch: in a data-parallel step the global
    batch's mask is drawn and this rank's rows kept
    (``parallel.mesh.rand_rows``)."""
    if gen is None:
        raise ValueError("a stochastic layer in train mode needs the "
                         "torch.Generator passed to forward")
    keep = 1.0 - rate
    mask = rand_rows(mask_shape, gen, x.device) < keep
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

    @obs.spanned("xp.enc.mlp")
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
    reference layout. With ``scan_backend="ring"`` every scan takes that
    canonical-layout route with ``selective_scan``'s sequence-parallel
    backend (L sharded over the ranks of ``parallel.ring_mesh``), never the
    bidirectional or single-direction fused kernels."""

    def __init__(self, d_model, d_state=1, ssm_ratio=1.0, dt_rank="auto",
                 d_conv=3, conv_bias=False, disable_z=True,
                 disable_z_act=False, out_act=False, scan_mode=0,
                 scan_backend=None):
        super().__init__()
        if scan_mode not in (-1, 0, 1, 2):
            raise ValueError(f"unknown SS2D scan mode {scan_mode}")
        self.scan_mode = scan_mode
        self.scan_backend = scan_backend
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
        D, dtype = self.d_inner, x.dtype
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
        with obs.span("xp.enc.scan"):
            y = self._scan(xs, H, W)
        y = layer_norm(self.out_norm, y).to(dtype)
        if self.out_act:
            y = F.gelu(y, approximate="tanh")
        if z is not None:
            y = y * z
        return F.linear(y, self.out_proj.weight.to(dtype))

    def _scan(self, xs, H, W):
        """The projections into the scan, the scan and the merge:
        (B, H, W, D) -> merged (B, H, W, D)."""
        R, N, dtype = self.dt_rank, self.d_state, xs.dtype
        dt_w = (self.dt_projs_weight - R ** -0.5).to(dtype)
        if self.scan_mode == -1:
            return self._cascade2d(xs, dt_w)
        if self.scan_mode == 0 and N == 1 and self.scan_backend is None:
            return self._cross2d(xs, -torch.exp(self.A_logs.reshape(-1)),
                                 dt_w)
        # token-wise projections per direction k on the expanded
        # (B, K, L, D) planes, the scan, merge
        xk = cross_scan(xs, self.scan_mode)
        x_dbl = torch.einsum("bkld,kcd->bklc", xk,
                             self.x_proj_weight.to(dtype))
        dts, Bs, Cs = torch.split(x_dbl, [R, N, N], dim=-1)
        dts = torch.einsum("bklr,kdr->bkld", dts, dt_w)
        if N == 1 and self.scan_backend is None:
            ys = selective_scan_fused_bkld(
                xk.contiguous(), dts.contiguous(),
                -torch.exp(self.A_logs.reshape(-1)), Bs.contiguous(),
                Cs.contiguous(), self.Ds, self.dt_projs_bias.reshape(-1))
        else:
            ys = self._reference_scan(xk, dts, Bs, Cs, slice(0, 4))
        return cross_merge(ys, H, W, self.scan_mode)

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
            self.dt_projs_bias[ks].reshape(-1), True, self.scan_backend)
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


def _one_by_one_scan(x, H, W):
    """cross_scan with one_by_one: (B, H, W, 4 N), direction k owning the
    channels [k N, (k + 1) N), each laid out in its own scan order ->
    (B, 4, L, N)."""
    B, N = x.shape[0], x.shape[-1] // 4
    row = lambda v: v.reshape(B, H * W, N)  # noqa: E731
    col = lambda v: v.transpose(1, 2).reshape(B, H * W, N)  # noqa: E731
    parts = [x[..., k * N:(k + 1) * N] for k in range(4)]
    return torch.stack([row(parts[0]), col(parts[1]), row(parts[2]).flip(1),
                        col(parts[3]).flip(1)], dim=1)


def _strip(tag, v):
    """(whether v ends with tag, v without it)."""
    return (True, v[:-len(tag)]) if v.endswith(tag) else (False, v)


def _depthwise(features, d_conv, bias):
    # padding 1 whatever the kernel size, as the flax module has it
    return nn.Conv2d(features, features, d_conv, padding=1, groups=features,
                     bias=bias)


def _depthwise_nhwc(conv, x):
    """A depthwise ``nn.Conv2d`` on NHWC x in x's dtype, bias after."""
    y = _conv_nhwc(x, conv.weight, padding=1, groups=x.shape[-1])
    return y if conv.bias is None else y + conv.bias.to(y.dtype)


_CONV_ACTS = {"none": lambda v: v, "silu": F.silu,
              "gelu": lambda v: F.gelu(v, approximate="tanh")}


class SS2Dv3(nn.Module):
    """The xv forward types (``xpoint_tpu/models/vssm.py::SS2Dv3``):
    ``in_proj`` emits u, dt and the per-direction B / C planes at once (no
    ``x_proj``), with optional input / output depthwise convs.

    Modes: xv1a (dt from a shared rank-R projection), xv2a (dt emitted at
    the full width D, no projection), xv3a (per-direction rank-R
    projections). Postfixes, stripped in the JAX module's order: the output
    norms ``_onnone`` / ``_ondwconv3`` / ``_oncnorm`` / ``_onsoftmax`` /
    ``_onsigmoid`` (default LayerNorm), ``_mul`` (gate by u), ``_act``
    (GELU), then behind the mode ``_ca`` / ``_ca1`` (SiLU / GELU after the
    convs), ``_ocov2`` / ``_ocov`` / ``_cpos`` (conv placement).
    ``dt_projs_weight`` is held as the effective weight (no shift, unlike
    SS2D's). The scan runs in ``selective_scan``'s layout: N = 1 through the
    fused single-direction scan, N > 1 around the linear recurrence;
    ``scan_backend="ring"`` selects ``selective_scan``'s sequence-parallel
    backend."""

    def __init__(self, d_model, d_state=16, ssm_ratio=2.0, dt_rank="auto",
                 d_conv=3, conv_bias=True, forward_type="xv1a",
                 scan_backend=None):
        super().__init__()
        self.scan_backend = scan_backend
        D = int(ssm_ratio * d_model)
        R = int(math.ceil(d_model / 16)) if dt_rank == "auto" else int(dt_rank)
        N = int(d_state)
        self.d_inner, self.dt_rank, self.d_state = D, R, N
        ftype = forward_type
        tags = {}
        for tag in ("_onnone", "_ondwconv3", "_oncnorm", "_onsoftmax",
                    "_onsigmoid", "_mul", "_act"):
            tags[tag], ftype = _strip(tag, ftype)
        mode, rest = ftype[:4], ftype[4:]
        if mode not in ("xv1a", "xv2a", "xv3a"):
            raise ValueError(f"unknown xv forward type {forward_type}")
        for tag in ("_ca", "_ca1", "_ocov2", "_ocov", "_cpos"):
            tags[tag], rest = _strip(tag, rest)
        self.mode = mode
        self.out_mul, self.out_gelu = tags["_mul"], tags["_act"]
        # the first output-norm tag present, in the JAX module's elif order
        self.out_kind = next((t for t in ("_onnone", "_oncnorm",
                                          "_ondwconv3", "_onsoftmax",
                                          "_onsigmoid") if tags[t]), "ln")
        self.conv_act = ("gelu" if tags["_ca1"] else
                         "silu" if tags["_ca"] else "none")
        conv = d_conv > 1
        ocov, ocov2 = tags["_ocov"] and conv, tags["_ocov2"] and conv
        self.in_conv = ("act" if conv and not (tags["_ocov"] or tags["_ocov2"])
                        else "residual" if tags["_cpos"] and conv else None)
        if self.in_conv and ocov2:
            raise ValueError(f"{forward_type}: _cpos and _ocov2 both name "
                             f"the conv 'conv2d'")
        self.dts_dim = {"xv1a": R, "xv2a": D, "xv3a": 4 * R}[mode]
        d_all = D + self.dts_dim + 8 * N
        if self.in_conv:
            self.conv2d = _depthwise(d_model, d_conv, conv_bias)
        self.in_proj = nn.Linear(d_model, d_all, bias=False)
        self.out_conv2 = bool(ocov2)
        if ocov2:
            self.conv2d = _depthwise(d_all, d_conv, conv_bias)
        self.A_logs = nn.Parameter(torch.empty(4 * D, N))
        self.Ds = nn.Parameter(torch.ones(4 * D))
        self.dt_projs_bias = nn.Parameter(torch.empty(4, D))
        if mode != "xv2a":
            self.dt_projs_weight = nn.Parameter(torch.empty(4, D, R))
        if self.out_kind in ("ln", "_oncnorm"):
            self.out_norm = _layer_norm_module(D)
        if self.out_kind in ("_oncnorm", "_ondwconv3"):
            self.out_norm_conv = _depthwise(D, 3, False)
        if ocov:
            self.oconv2d = _depthwise(D, d_conv, conv_bias)
        self.out_proj = nn.Linear(D, d_model, bias=False)

    def forward(self, x):
        B, H, W, _ = x.shape
        D, L = self.d_inner, H * W
        cact = _CONV_ACTS[self.conv_act]
        if self.in_conv == "act":
            x = cact(_depthwise_nhwc(self.conv2d, x))
        elif self.in_conv == "residual":
            x = x + _depthwise_nhwc(self.conv2d, x)
        x = F.linear(x, self.in_proj.weight.to(x.dtype))
        if self.out_conv2:
            x = _depthwise_nhwc(self.conv2d, x)
        dtype = x.dtype
        us = x[..., :D]
        with obs.span("xp.enc.scan"):
            y = self._scan(x, H, W)
        if self.out_kind in ("ln", "_oncnorm"):
            y = layer_norm(self.out_norm, y.float())
        if self.out_kind in ("_oncnorm", "_ondwconv3"):
            y = _depthwise_nhwc(self.out_norm_conv, y.float())
        elif self.out_kind == "_onsoftmax":
            # softmax over the L positions of each channel
            y = torch.softmax(y.reshape(B, L, D).float(), dim=1).reshape(
                B, H, W, D)
        elif self.out_kind == "_onsigmoid":
            y = torch.sigmoid(y)
        y = y.to(dtype)
        if self.out_gelu:
            y = F.gelu(y, approximate="tanh")
        if self.out_mul:
            y = y * us
        if hasattr(self, "oconv2d"):
            y = y + cact(_depthwise_nhwc(self.oconv2d, us))
        return F.linear(y, self.out_proj.weight.to(dtype))

    def _scan(self, x, H, W):
        """The operands of the four directions cut from ``in_proj``'s
        output, the scan and the merge -> (B, H, W, D) fp32."""
        B, L, D, N = x.shape[0], H * W, self.d_inner, self.d_state
        e = D + self.dts_dim
        us, dts = x[..., :D], x[..., D:e]
        Bs4 = _one_by_one_scan(x[..., e:e + 4 * N], H, W)      # (B, 4, L, N)
        Cs4 = _one_by_one_scan(x[..., e + 4 * N:], H, W)
        us4 = cross_scan(us, 0)                                 # (B, 4, L, D)
        dts4 = (_one_by_one_scan(dts, H, W) if self.mode == "xv3a"
                else cross_scan(dts, 0))
        if self.mode != "xv2a":
            dts4 = torch.einsum("bklr,kdr->bkld", dts4,
                                self.dt_projs_weight.to(dts4.dtype))
        cl = lambda v: v.transpose(2, 3).reshape(B, 4 * D, L)  # noqa: E731
        ys = selective_scan(cl(us4), cl(dts4), -torch.exp(self.A_logs),
                            Bs4.transpose(2, 3), Cs4.transpose(2, 3),
                            self.Ds, self.dt_projs_bias.reshape(-1), True,
                            self.scan_backend)
        return cross_merge(ys.reshape(B, 4, D, L).transpose(2, 3), H, W, 0)


class SS2Dm0(nn.Module):
    """The Mamba-2 (SSD) SS2D of the m0 forward types
    (``xpoint_tpu/models/vssm.py::SS2Dm0``): 4 R scalar-A heads of width
    D / R, GELU on the conv output and on the gate, the chunked SSD scan
    (``ops.ssd``) in fp32, the output cast to the activation dtype before
    ``cross_merge`` and normalised in fp32."""

    def __init__(self, d_model, d_state=64, ssm_ratio=2.0, dt_rank="auto",
                 d_conv=3, conv_bias=True, disable_z=False,
                 disable_z_act=False, out_act=False, scan_mode=0,
                 chunk_size=64):
        super().__init__()
        K = 4
        D = int(ssm_ratio * d_model)
        R = int(math.ceil(d_model / 16)) if dt_rank == "auto" else int(dt_rank)
        N = int(d_state)
        self.d_inner, self.dt_rank, self.d_state = D, R, N
        self.head_dim = D // R
        self.disable_z, self.disable_z_act = disable_z, disable_z_act
        self.out_act, self.scan_mode = out_act, scan_mode
        self.chunk_size = chunk_size
        self.in_proj = nn.Linear(d_model, D if disable_z else 2 * D,
                                 bias=False)
        if d_conv > 1:
            self.conv2d = _depthwise(D, d_conv, conv_bias)
        self.x_proj_weight = nn.Parameter(torch.empty(K, R + 2 * N, D))
        self.A_logs = nn.Parameter(torch.zeros(K, R))
        self.Ds = nn.Parameter(torch.ones(K, R, self.head_dim))
        self.dt_projs_bias = nn.Parameter(torch.empty(K, R))
        self.out_norm = _layer_norm_module(D)
        self.out_proj = nn.Linear(D, d_model, bias=False)

    def forward(self, x):
        B, H, W, _ = x.shape
        K, R, N, L = 4, self.dt_rank, self.d_state, H * W
        Dh, dtype = self.head_dim, x.dtype
        xs, z = F.linear(x, self.in_proj.weight.to(dtype)), None
        if not self.disable_z:
            xs, z = xs.chunk(2, dim=-1)
            if not self.disable_z_act:
                z = F.gelu(z, approximate="tanh")
        if hasattr(self, "conv2d"):
            xs = _depthwise_nhwc(self.conv2d, xs)
        xs = F.gelu(xs, approximate="tanh")
        with obs.span("xp.enc.scan"):
            xk = cross_scan(xs, self.scan_mode)                 # (B, K, L, D)
            x_dbl = torch.einsum("bkld,kcd->bklc", xk,
                                 self.x_proj_weight.to(xk.dtype))
            dts, Bsp, Csp = torch.split(x_dbl, [R, N, N], dim=-1)
            # heads (B, L, K R, Dh); groups K, B / C shared by a group's R
            # heads
            y, _ = ssd_chunked(
                xk.transpose(1, 2).reshape(B, L, K * R, Dh),
                dts.transpose(1, 2).reshape(B, L, K * R),
                -torch.exp(self.A_logs.reshape(-1)), Bsp.transpose(1, 2),
                Csp.transpose(1, 2), self.Ds.reshape(K * R, Dh),
                self.dt_projs_bias.reshape(-1), chunk_size=self.chunk_size)
            ys = y.reshape(B, L, K, R * Dh).transpose(1, 2)
            out = cross_merge(ys.to(dtype), H, W, self.scan_mode)
        out = layer_norm(self.out_norm, out)
        if self.out_act:
            out = F.gelu(out, approximate="tanh")
        if z is not None:
            out = out * z
        return F.linear(out, self.out_proj.weight.to(dtype))


class VSSBlock(nn.Module):
    def __init__(self, dim, ssm_ratio=1.0, dt_rank="auto", mlp_ratio=4.0,
                 drop_path=0.0, scan_mode=0, d_state=1, ssm_conv=3,
                 ssm_conv_bias=False, disable_z=True, disable_z_act=False,
                 out_act=False, xv_type="", use_m0=False, scan_backend=None):
        super().__init__()
        self.norm = _layer_norm_module(dim)
        if xv_type:
            self.op = SS2Dv3(dim, d_state, ssm_ratio, dt_rank, ssm_conv,
                             ssm_conv_bias, xv_type, scan_backend)
        elif use_m0:
            self.op = SS2Dm0(dim, d_state, ssm_ratio, dt_rank, ssm_conv,
                             ssm_conv_bias, disable_z, disable_z_act,
                             out_act, scan_mode)
        else:
            self.op = SS2D(dim, d_state, ssm_ratio, dt_rank, ssm_conv,
                           ssm_conv_bias, disable_z, disable_z_act, out_act,
                           scan_mode, scan_backend)
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
        disable_z, disable_z_act, out_act, xv_type, use_m0 and
        scan_backend, the same for every block."""
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


def build_vssm_from_config(vssm_cfg, dtype=torch.float32, scan_backend=None):
    """VSSM from the reference MODEL.VSSM dict (with MODEL.DROP_PATH_RATE
    merged in as ``DROP_PATH_RATE``), parsed as
    ``xpoint_tpu.models.vssm.build_vssm_from_config`` parses it: the
    forward type's base (v05 cross2d, v051d unidi, v052d bidi, v052dc
    cascade2d, m* the SSD block SS2Dm0, xv* the SS2Dv3 block with the whole
    forward type as its mode and postfixes) and the tags _noz, _nozact and
    _oact. The state size is ``SSM_D_STATE`` (default 1) for every family.
    ``scan_backend``: None, or ``"ring"`` (``selective_scan``'s
    sequence-parallel backend in every SS2D / SS2Dv3 block)."""
    get = vssm_cfg.get
    ftype = str(get("SSM_FORWARDTYPE", "v05_noz"))
    base = ftype.split("_")[0]
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
        xv_type=ftype if base.startswith("xv") else "",
        use_m0=base.startswith("m"),
        scan_backend=scan_backend,
    )
