"""MagicLeap SuperPoint, NHWC (port of ``xpoint_tpu/models/superpoint.py``):
a VGG encoder of four double-conv blocks with three 2x2 max-pools, a 65
channel detector head and a 256-d descriptor head L2-normalised at the
coarse level. The layers carry MagicLeap's names (``conv1a`` ... ``convDb``),
which are also the flax module's, so ``compat.from_flax`` maps them one to
one and a ``superpoint_v1.pth`` state_dict loads after a cast to fp32.
The forward takes ``(image, spectrum, ...)`` like XPointNet's, so that
``eval.make_pair_pipeline`` and ``eval.infer.XPointInference`` run it
unchanged; SuperPoint has one encoder for both spectra.
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.detector import prob_from_logits
from .heads import Conv

_LAYERS = (("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3),
           ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
           ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
           ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
           ("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
           ("convDa", 128, 256, 3), ("convDb", 256, 256, 1))
LAYER_NAMES = tuple(name for name, *_ in _LAYERS)


class SuperPointMagicLeap(nn.Module):
    encoder_downsample_ratio = 8

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        for name, c_in, c_out, k in _LAYERS:
            self.add_module(name, Conv(c_in, c_out, k, padding=k // 2))

    def forward(self, image, spectrum=None, is_optical=None, gen=None):
        """image (B, H, W, 1) -> {'logits' (B, H/8, W/8, 65), 'desc'
        (B, H/8, W/8, 256) unit length, 'prob' (B, H, W)}, fp32; the
        spectrum arguments are accepted and unused."""
        del spectrum, is_optical, gen
        x = image.to(self.dtype)
        for i, block in enumerate(("1", "2", "3", "4")):
            x = F.relu(getattr(self, f"conv{block}a")(x))
            x = F.relu(getattr(self, f"conv{block}b")(x))
            if i < 3:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        semi = self.convPb(F.relu(self.convPa(x))).float()
        desc = self.convDb(F.relu(self.convDa(x))).float()
        desc = desc / torch.linalg.vector_norm(
            desc, dim=-1, keepdim=True).clamp_min(1e-12)
        return {"logits": semi, "desc": desc,
                "prob": prob_from_logits(semi, 8)}

    def forward_impl(self, image, spectrum="optical", is_optical=None,
                     gen=None):
        return self(image)

    def init_all(self, image):
        return self(image)

    def forward_pair(self, img_o, img_t, gen=None, is_optical_o=None,
                     is_optical_t=None, optical_not_warped=None):
        return self(img_o), self(img_t), None


def convert_magicleap_weights(state_dict):
    """MagicLeap's ``superpoint_v1.pth`` state_dict (torch convs
    ``conv1a`` ... ``convDb``) -> the port's state_dict: the same names and
    layout, as fp32 tensors."""
    out = {}
    for name in LAYER_NAMES:
        for leaf in ("weight", "bias"):
            out[f"{name}.{leaf}"] = torch.as_tensor(
                state_dict[f"{name}.{leaf}"]).detach().float().cpu().clone()
    return out


def build_superpoint(config=None, device="cuda", seed=0):
    """(module, config): SuperPoint with the JAX package's initialiser
    distributions (lecun_normal convs, zero biases) drawn from ``seed``,
    in eval mode on ``device``."""
    from .init import init_xpoint_
    module = SuperPointMagicLeap()
    init_xpoint_(module, torch.Generator().manual_seed(seed))
    return module.to(device).eval(), dict(config or {})
