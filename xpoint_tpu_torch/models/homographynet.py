"""HomographyNet-style regression head on channel-mean encoder maps, NHWC
(port of ``xpoint_tpu/models/homographynet.py:18-33``).

Four 3x3 convs (64, 64, 128, 128; padding 1, in ``dtype``), each followed
by BatchNorm (fp32, flax's momentum 0.9 and eps 1e-5) and ReLU cast back
to ``dtype``, a 2x2 max pool after the second and the fourth; then the
global mean, Dropout(0.5), Dense 256 + ReLU and Dense 8 in fp32. Submodule
names follow the flax tree: ``conv0..3`` and flax's automatic names
``BatchNorm_0..3``, ``Dense_0``, ``Dense_1``.
"""
import torch
import torch.nn.functional as F
from torch import nn

from .heads import BatchNorm, Conv
from .regnet import Dense
from .vssm import dropout

FEATURES = (64, 64, 128, 128)


class HomographyNet(nn.Module):
    """(B, Hc, Wc, 2) channel-mean maps -> (B, 8) corner offsets."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        c_in = 2
        for i, feats in enumerate(FEATURES):
            self.add_module(f"conv{i}", Conv(c_in, feats, 3, padding=1))
            self.add_module(f"BatchNorm_{i}", BatchNorm(feats))
            c_in = feats
        self.Dense_0 = Dense(FEATURES[-1], 256)
        self.Dense_1 = Dense(256, 8)

    def forward(self, x, gen=None):
        for i in range(len(FEATURES)):
            x = getattr(self, f"conv{i}")(x.to(self.dtype))
            x = F.relu(getattr(self, f"BatchNorm_{i}")(x)).to(self.dtype)
            if i % 2 == 1:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(
                    0, 2, 3, 1)
        x = dropout(x.mean(dim=(1, 2)), 0.5, self.training, gen)
        return self.Dense_1(F.relu(self.Dense_0(x)))
