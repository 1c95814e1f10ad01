"""RegNet homography-regression head, NHWC (port of
``xpoint_tpu/models/regnet.py:14-69``).

Siamese backbone shared by both encoder outputs (conv1 96 -> BN -> ReLU ->
conv2 192 -> BN -> ReLU -> 2x2 max pool; BatchNorm sees the two inputs as
two separate calls), then each map to 16x16 (``to_16``), an L2-normalised
cost volume, its mean over the second cell axis, Dropout(0.5), fc1 64,
ReLU, Dropout(0.5), fc2 8. Convs run in ``dtype``, BatchNorm and the dense
layers in fp32. Submodule names follow the flax tree (conv1, bn1, conv2,
bn2, fc1, fc2).
"""
import torch
import torch.nn.functional as F
from torch import nn

from .heads import BatchNorm
from .vssm import _conv_nhwc, dropout


class Conv3x3(nn.Module):
    """flax ``nn.Conv(features, (3, 3), padding 1, use_bias=False)``."""

    def __init__(self, in_features, features):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, 3, 3))

    def forward(self, x):
        return _conv_nhwc(x, self.weight, padding=1)


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=float32)``: fp32 ``x @ kernel + bias``. Its
    own class, because its initialiser (lecun_normal) is not the encoder's
    Linear one."""

    def __init__(self, in_features, features):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.linear(x.float(), self.weight, self.bias)


def _linear_resize_weights(n_in, n_out, device):
    """(n_in, n_out) weights of ``jax.image.resize(method="linear")`` along
    one axis (``compute_weight_mat`` with the triangle kernel, antialiased:
    the kernel is widened by n_in / n_out when downsampling), fp32."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = (1.0 - (sample[None, :] - src[:, None]).abs() / kernel_scale
         ).clamp_min(0.0)
    total = w.sum(0, keepdim=True)
    eps32 = torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > 1000.0 * eps32,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def to_16(x):
    """(N, H, W, C) -> (N, 16, 16, C): identity at 16x16, the exact block
    mean when 16 divides both sides, else the antialiased linear resize."""
    N, H, W, C = x.shape
    if H == 16 and W == 16:
        return x
    if H % 16 == 0 and W % 16 == 0:
        return x.reshape(N, 16, H // 16, 16, W // 16, C).mean(dim=(2, 4))
    wh = _linear_resize_weights(H, 16, x.device).to(x.dtype)
    ww = _linear_resize_weights(W, 16, x.device).to(x.dtype)
    return torch.einsum("nhwc,hi,wj->nijc", x, wh, ww)


def _l2norm(x):
    return x / torch.linalg.vector_norm(x, dim=-1,
                                        keepdim=True).clamp_min(1e-12)


class RegNet(nn.Module):
    """(x1, x2) encoder outputs (N, H, W, C) -> (N, 8) corner offsets."""

    def __init__(self, in_features, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv3x3(in_features, 96)
        self.bn1 = BatchNorm(96)
        self.conv2 = Conv3x3(96, 192)
        self.bn2 = BatchNorm(192)
        self.fc1 = Dense(256, 64)
        self.fc2 = Dense(64, 8)

    def _backbone(self, x):
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype)))).to(self.dtype)
        x = F.relu(self.bn2(self.conv2(x))).to(self.dtype)
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
        return x.permute(0, 2, 3, 1)

    def forward(self, x1, x2, gen=None):
        x1 = to_16(self._backbone(x1))
        x2 = to_16(self._backbone(x2))
        N, H, W, C = x1.shape
        f1 = _l2norm(x1).reshape(N, H * W, C).float()
        f2 = _l2norm(x2).reshape(N, H * W, C).float()
        # fp32 products of the dtype values: preferred_element_type=float32
        cv = torch.bmm(f1, f2.transpose(1, 2))            # (N, HW, HW)
        x = dropout(cv.mean(dim=2), 0.5, self.training, gen)
        x = dropout(F.relu(self.fc1(x)), 0.5, self.training, gen)
        return self.fc2(x)
