"""Detector / descriptor heads and the plain-CNN encoder, NHWC (port of
``xpoint_tpu/models/heads.py:17-157``).

Head: pad 1 -> conv3 (head channels) -> ReLU and BN (order per
``bn_first``) -> conv1 (out) -> BN (``final_batchnorm``), output fp32.
CNNEncoder: four blocks of one or two ConvBNRelu (``double_convolution``),
a 2x2 max-pool after the first three. Convs run in the activation dtype,
BatchNorm (eps 1e-5) in fp32. With ``spectral_stats`` every BatchNorm is a
SpectralBatchNorm, which takes the static ``spectrum`` of the forward.
Submodule names follow the flax tree (``ConvBNRelu_0..7``, ``Conv_0``,
``BatchNorm_0``, ``SpectralBatchNorm_0``).
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import active_mesh, batch_moments, global_mean
from .vssm import _conv_nhwc

BN_MOMENTUM, BN_EPS = 0.9, 1e-5  # every flax BatchNorm of the model
SPECTRA = ("optical", "thermal")


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis, computed in fp32, with the
    arithmetic of flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``.

    Eval mode normalises with the running statistics. Train mode normalises
    with the batch statistics of the fp32 input over every axis but the
    last: the mean and the BIASED variance, in flax's form
    max(0, E[x^2] - E[x]^2); inside a data-parallel step
    (``parallel.data_parallel``) both moments are the global batch's, their
    sums and counts all-reduced in fp32 with autograd through the
    reduction, so every rank normalises and updates alike. It then
    updates, in place,
    running <- 0.9 * running + 0.1 * batch (BN_MOMENTUM), with that same
    biased variance (``torch.nn.BatchNorm2d`` would use the unbiased one and
    momentum 0.1 in the other sense). A caller that must undo a step
    snapshots the buffers.
    """

    def __init__(self, features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, spectrum=None):
        del spectrum                      # one set of statistics
        x = x.float()
        if self.training:
            dims = tuple(range(x.ndim - 1))
            mean, mean_sq = batch_moments(x, dims)
            var = (mean_sq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean) * mul + self.bias


class SpectralBatchNorm(nn.Module):
    """BatchNorm with a shared affine and one set of running statistics per
    spectrum (``mean_optical``, ``var_optical``, ``mean_thermal``,
    ``var_thermal``; ``model: spectral_norm_stats: true``).

    Train mode normalises with the batch mean and the variance
    mean((x - mean)^2) of the fp32 input (``x32.var()`` in JAX, not the
    E[x^2] - E[x]^2 form of :class:`BatchNorm`; in a data-parallel step two
    all-reduced passes over the global batch), then updates, in place,
    the slot of ``spectrum``, or both slots for ``"mixed"``, with momentum
    0.9. Eval mode normalises a single spectrum with its own slot and
    ``"mixed"`` with the statistics of the 50/50 mixture: mean
    0.5 (m_o + m_t), variance 0.5 (v_o + v_t) + 0.25 (m_o - m_t)^2.
    """

    def __init__(self, features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        for s in SPECTRA:
            self.register_buffer(f"mean_{s}", torch.zeros(features))
            self.register_buffer(f"var_{s}", torch.ones(features))

    def forward(self, x, spectrum="mixed"):
        x = x.float()
        if self.training:
            dims = tuple(range(x.ndim - 1))
            if active_mesh() is None:
                mean = x.mean(dims)
                var = x.var(dims, unbiased=False)
            else:
                mean = global_mean(x, dims)
                var = global_mean((x - mean) ** 2, dims)
            slots = SPECTRA if spectrum == "mixed" else (spectrum,)
            with torch.no_grad():
                m = BN_MOMENTUM
                for s in slots:
                    rm, rv = getattr(self, f"mean_{s}"), getattr(self,
                                                                  f"var_{s}")
                    rm.copy_(m * rm + (1 - m) * mean)
                    rv.copy_(m * rv + (1 - m) * var)
        elif spectrum == "mixed":
            m_o, m_t = self.mean_optical, self.mean_thermal
            mean = 0.5 * (m_o + m_t)
            var = (0.5 * (self.var_optical + self.var_thermal)
                   + 0.25 * (m_o - m_t) ** 2)
        else:
            mean = getattr(self, f"mean_{spectrum}")
            var = getattr(self, f"var_{spectrum}")
        return (x - mean) * torch.rsqrt(var + BN_EPS) * self.weight + self.bias


def _pad1(x, reflect):
    """Pad H and W of an NHWC tensor by 1: reflected (the edge not
    repeated) or zeros. Reflection is built from slices and cat, whose
    backward on the card sums in a fixed order (F.pad's reflect backward
    adds with atomics)."""
    if not reflect:
        return F.pad(x, (0, 0, 1, 1, 1, 1))
    x = torch.cat([x[:, 1:2], x, x[:, -2:-1]], dim=1)
    return torch.cat([x[:, :, 1:2], x, x[:, :, -2:-1]], dim=2)


def _batchnorm(features, spectral_stats):
    """(flax name, module) of the BatchNorm a block holds."""
    if spectral_stats:
        return "SpectralBatchNorm_0", SpectralBatchNorm(features)
    return "BatchNorm_0", BatchNorm(features)


class Conv(nn.Module):
    """flax ``nn.Conv`` (VALID padding unless ``padding``): conv in x's
    dtype, then bias."""

    def __init__(self, in_features, features, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        y = _conv_nhwc(x, self.weight, self.stride, self.padding)
        return y + self.bias.to(y.dtype)


class ConvBNRelu(nn.Module):
    """pad 1 (reflect, or zeros without ``reflection_pad``) -> conv3 valid
    -> ReLU then BN (BN then ReLU with ``bn_first``) -> cast back to the
    input's dtype."""

    def __init__(self, in_features, features, reflection_pad=True,
                 bn_first=False, spectral_stats=False):
        super().__init__()
        self.reflection_pad = reflection_pad
        self.bn_first = bn_first
        self.Conv_0 = Conv(in_features, features, 3)
        self.bn_name, bn = _batchnorm(features, spectral_stats)
        self.add_module(self.bn_name, bn)

    def forward(self, x, spectrum="mixed"):
        dtype = x.dtype
        x = self.Conv_0(_pad1(x, self.reflection_pad))
        bn = getattr(self, self.bn_name)
        if self.bn_first:
            x = F.relu(bn(x, spectrum))
        else:
            x = bn(F.relu(x), spectrum)
        return x.to(dtype)


class CNNEncoder(nn.Module):
    """VGG-like encoder, downsample ratio 8: ``n_channels`` (1, c1, .., c4);
    the input is cast to ``dtype`` first."""

    def __init__(self, n_channels=(1, 64, 64, 128, 128), reflection_pad=True,
                 bn_first=False, double_convolution=True,
                 dtype=torch.float32, spectral_stats=False):
        super().__init__()
        self.dtype = dtype
        self.double_convolution = double_convolution
        k = 0
        for i in range(4):
            for c_in in ((n_channels[i], n_channels[i + 1])
                         if double_convolution else (n_channels[i],)):
                self.add_module(f"ConvBNRelu_{k}", ConvBNRelu(
                    c_in, n_channels[i + 1], reflection_pad, bn_first,
                    spectral_stats))
                k += 1

    def forward(self, x, spectrum="mixed"):
        x = x.to(self.dtype)
        per_block = 2 if self.double_convolution else 1
        for i in range(4):
            for j in range(per_block):
                x = getattr(self, f"ConvBNRelu_{i * per_block + j}")(
                    x, spectrum)
            if i < 3:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return x


class Head(nn.Module):
    """ConvBNRelu (head channels) -> conv1 (out) -> BN
    (``final_batchnorm``) -> fp32."""

    def __init__(self, in_features, head_channels, out_channels,
                 final_batchnorm=True, reflection_pad=True, bn_first=False,
                 spectral_stats=False):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(in_features, head_channels,
                                       reflection_pad, bn_first,
                                       spectral_stats)
        self.Conv_0 = Conv(head_channels, out_channels, 1)
        self.bn_name = None
        if final_batchnorm:
            self.bn_name, bn = _batchnorm(out_channels, spectral_stats)
            self.add_module(self.bn_name, bn)

    def forward(self, x, spectrum="mixed"):
        x = self.Conv_0(self.ConvBNRelu_0(x, spectrum))
        if self.bn_name is not None:
            x = getattr(self, self.bn_name)(x, spectrum)
        return x.float()
