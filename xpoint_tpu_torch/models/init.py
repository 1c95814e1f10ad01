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
  * ``dt_projs_weight``: uniform [0, 2 R^-0.5) (stored unshifted);
  * ``dt_projs_bias``: softplus-inverse of log-uniform dt in [1e-3, 0.1];
  * ``A_logs`` (K D, N): log(1..N) in every row; ``Ds``: 1; SS2D's conv
    bias, where configured: 0;
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
from .vssm import SS2D, StridedConv3x3

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
def _init_ss2d_(m, gen, dt_min=0.001, dt_max=0.1, dt_floor=1e-4):
    R = m.dt_rank
    _trunc_normal_(m.x_proj_weight, 0.02, gen)
    m.dt_projs_weight.copy_(torch.rand(m.dt_projs_weight.shape, generator=gen)
                            * (2 * R ** -0.5))
    dt = torch.exp(torch.rand(m.dt_projs_bias.shape, generator=gen)
                   * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = dt.clamp_min(dt_floor)
    m.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
    n = m.A_logs.shape[-1]
    m.A_logs.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32))
                   .expand_as(m.A_logs))
    m.Ds.fill_(1.0)


@torch.no_grad()
def init_xpoint_(module, gen):
    """Initialise every parameter and buffer of ``module`` in place."""
    for m in module.modules():
        if isinstance(m, SS2D):
            _init_ss2d_(m, gen)
            if hasattr(m, "conv2d"):
                _lecun_normal_(m.conv2d.weight, gen)
                if m.conv2d.bias is not None:
                    m.conv2d.bias.zero_()
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
