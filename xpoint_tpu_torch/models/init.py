"""Parameter initialisation with the JAX package's distributions.

The machine with the card has no JAX, so the port draws its own weights
from a seeded ``torch.Generator`` (the numbers differ from flax's; the
distributions match ``xpoint_tpu/models/vssm.py:83-134`` and the flax
defaults used by ``xpoint_tpu/models/heads.py``):

  * Dense layers of the encoder (``in_proj`` of width D, or 2 D with the
    gate) and ``x_proj_weight`` (K, R + 2 N, D): normal(0.02) truncated to
    +-2 std; so are Swin's ``qkv_kernel``, ``proj``, ``mlp_fc1`` /
    ``mlp_fc2`` and ``reduction`` (``xpoint_tpu/models/swinv2.py``);
  * convolutions, RegNet's and HomographyNet's dense layers and Swin's CPB
    MLP: lecun_normal (truncated normal, fan_in scaling), bias 0;
  * Swin's ``logit_scale``: log 10; its q / v biases: 0;
  * ``dt_projs_weight``: uniform [0, 2 R^-0.5) (SS2D's, stored unshifted);
    uniform [-R^-0.5, R^-0.5) (SS2Dv3's, ``_dt_w_init``);
  * ``dt_projs_bias``: softplus-inverse of log-uniform dt in [1e-3, 0.1]
    (SS2D, SS2Dv3); uniform [0, 0.1) (SS2Dm0);
  * ``A_logs`` (K D, N): log(1..N) in every row (SS2D, SS2Dv3); zeros of
    (K, R) (SS2Dm0); ``Ds``: 1; the SS2D blocks' convs: lecun_normal, bias
    0;
  * LayerNorm / BatchNorm: scale 1, bias 0, running stats 0 / 1 (both
    spectra's slots of a SpectralBatchNorm).
"""
import math

import torch
from torch import nn

from .heads import SPECTRA, BatchNorm, Conv, SpectralBatchNorm
from .regnet import Conv3x3, Dense
from .swinv2 import Dense as SwinDense
from .swinv2 import WindowAttention
from .vssm import SS2D, SS2Dm0, SS2Dv3, StridedConv3x3

# std of the standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def _trunc_normal_(t, std, gen):
    """normal(0, 1) truncated to [-2, 2], times std (inverse-CDF sampling)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(t.shape, generator=gen) * (hi - lo) + lo
    t.copy_(torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0) * std)
    t.clamp_(-2.0 * std, 2.0 * std)


def _lecun_normal_(w, gen):
    fan_in = math.prod(w.shape[1:])
    _trunc_normal_(w, math.sqrt(1.0 / fan_in) / _TRUNC_STD, gen)


@torch.no_grad()
def _dt_bias_(t, gen, dt_min=0.001, dt_max=0.1, dt_floor=1e-4):
    dt = torch.exp(torch.rand(t.shape, generator=gen)
                   * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = dt.clamp_min(dt_floor)
    t.copy_(dt + torch.log(-torch.expm1(-dt)))


@torch.no_grad()
def _init_ss2d_(m, gen):
    """SS2D and SS2Dv3 (xv): the mamba_init draws, and their convs."""
    R = m.dt_rank
    if isinstance(m, SS2D):
        _trunc_normal_(m.x_proj_weight, 0.02, gen)
        m.dt_projs_weight.copy_(torch.rand(m.dt_projs_weight.shape,
                                           generator=gen) * (2 * R ** -0.5))
    elif hasattr(m, "dt_projs_weight"):
        m.dt_projs_weight.copy_((torch.rand(m.dt_projs_weight.shape,
                                            generator=gen) * 2 - 1)
                                * R ** -0.5)
    _dt_bias_(m.dt_projs_bias, gen)
    n = m.A_logs.shape[-1]
    m.A_logs.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32))
                   .expand_as(m.A_logs))
    m.Ds.fill_(1.0)
    _init_convs_(m, gen)


@torch.no_grad()
def _init_ss2d_m0_(m, gen):
    """SS2Dm0: the v2 initialisation (A = -1, Ds 1, dt bias in [0, 0.1))."""
    _trunc_normal_(m.x_proj_weight, 0.02, gen)
    m.A_logs.zero_()
    m.Ds.fill_(1.0)
    m.dt_projs_bias.copy_(torch.rand(m.dt_projs_bias.shape, generator=gen)
                          * 0.1)
    _init_convs_(m, gen)


@torch.no_grad()
def _init_convs_(m, gen):
    for name in ("conv2d", "oconv2d", "out_norm_conv"):
        conv = getattr(m, name, None)
        if conv is not None:
            _lecun_normal_(conv.weight, gen)
            if conv.bias is not None:
                conv.bias.zero_()


@torch.no_grad()
def init_xpoint_(module, gen):
    """Initialise every parameter and buffer of ``module`` in place."""
    for m in module.modules():
        if isinstance(m, (SS2D, SS2Dv3)):
            _init_ss2d_(m, gen)
        elif isinstance(m, SS2Dm0):
            _init_ss2d_m0_(m, gen)
        elif isinstance(m, WindowAttention):
            m.logit_scale.fill_(math.log(10.0))
            _trunc_normal_(m.qkv_kernel, 0.02, gen)
            if hasattr(m, "q_bias"):
                m.q_bias.zero_()
                m.v_bias.zero_()
        elif isinstance(m, SwinDense):
            if m.init == "lecun_normal":
                _lecun_normal_(m.weight, gen)
            else:
                _trunc_normal_(m.weight, 0.02, gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            _trunc_normal_(m.weight, 0.02, gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (StridedConv3x3, Conv, Dense)):
            _lecun_normal_(m.weight, gen)
            m.bias.zero_()
        elif isinstance(m, Conv3x3):
            _lecun_normal_(m.weight, gen)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, SpectralBatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            for s in SPECTRA:
                getattr(m, f"mean_{s}").zero_()
                getattr(m, f"var_{s}").fill_(1.0)
