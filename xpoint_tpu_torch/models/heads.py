"""Detector / descriptor heads, NHWC (port of
``xpoint_tpu/models/heads.py:84-157``, plain BatchNorm).

Head: reflect pad 1 -> conv3 (head channels) -> ReLU -> BN -> conv1 (out)
-> BN, output fp32. Convs run in the activation dtype, BatchNorm
(eps 1e-5) in fp32. Submodule names follow the flax tree.
"""
import torch
import torch.nn.functional as F
from torch import nn

from .vssm import _conv_nhwc

BN_MOMENTUM, BN_EPS = 0.9, 1e-5  # every flax BatchNorm of the model


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis, computed in fp32, with the
    arithmetic of flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``.

    Eval mode normalises with the running statistics. Train mode normalises
    with the batch statistics of the fp32 input over every axis but the
    last: the mean and the BIASED variance, in flax's form
    max(0, E[x^2] - E[x]^2). It then updates, in place,
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

    def forward(self, x):
        x = x.float()
        if self.training:
            dims = tuple(range(x.ndim - 1))
            mean = x.mean(dims)
            var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean) * mul + self.bias


class Conv(nn.Module):
    """flax ``nn.Conv`` with VALID padding: conv in x's dtype, then bias."""

    def __init__(self, in_features, features, kernel_size):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        y = _conv_nhwc(x, self.weight)
        return y + self.bias.to(y.dtype)


class ConvBNRelu(nn.Module):
    """reflect pad 1 -> conv3 valid -> ReLU -> BN (bn_first=False) -> cast."""

    def __init__(self, in_features, features):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, 3)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        dtype = x.dtype
        x = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        x = self.Conv_0(x.permute(0, 2, 3, 1))
        return self.BatchNorm_0(F.relu(x)).to(dtype)


class Head(nn.Module):
    def __init__(self, in_features, head_channels, out_channels):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(in_features, head_channels)
        self.Conv_0 = Conv(head_channels, out_channels, 1)
        self.BatchNorm_0 = BatchNorm(out_channels)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(self.ConvBNRelu_0(x))).float()
