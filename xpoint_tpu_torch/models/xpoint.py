"""XPoint model: one shared VMamba encoder + detector and descriptor heads
+ the optional RegNet homography head (port of
``xpoint_tpu/models/xpoint.py:32-322``).

Ported: ``XPointNet.forward_impl`` and ``forward_pair`` with a single shared
VMamba encoder (``multispectral: false``), the RegNet head, and the
``build_xpoint`` config merge. ``train()`` / ``eval()`` switch BatchNorm,
DropPath and Dropout between their train and eval behaviour (the JAX
``train`` flag); their randomness comes from the ``torch.Generator``
passed to the forward. Not ported yet, and raising NotImplementedError: the
CNN and Swin encoders, the two-encoder multispectral model, the
HomographyNet head, ``bn_first`` heads, and the spectrum-split BatchNorm
(ROADMAP.md Queue 1 items 4 and 10).
"""
import copy

import torch
from torch import nn

from ..utils import dict_update
from .heads import Head
from .init import init_xpoint_
from .regnet import RegNet
from .vssm import build_vssm_from_config

# The flagship model (own copy of __graft_entry__.py::VMAMBA_MODEL_CFG):
# VMamba v05_noz, d_state 1, depths [2, 2, 2, 2], embed 96, bf16.
VMAMBA_MODEL_CFG = {
    "type": "XPoint",
    "multispectral": False,
    "takes_pair": True,
    "descriptor_size": 256,
    "mixed_precision": True,
    "homography_regression_head": {"check": True, "type": "RegNet"},
    "use_attention": {
        "check": True, "type": "VMamba", "height": 256, "width": 256,
        "model_parameters": {
            "DATA": {"IMG_SIZE": 512},
            "MODEL": {
                "DROP_PATH_RATE": 0.2,
                "VSSM": {
                    "DEPTHS": [2, 2, 2, 2], "EMBED_DIM": 96,
                    "MLP_RATIO": 4.0, "PATCHEMBED": "v2", "DOWNSAMPLE": "v3",
                    "SSM_CONV": 3, "SSM_CONV_BIAS": False,
                    "SSM_DT_RANK": "auto", "SSM_D_STATE": 1,
                    "SSM_FORWARDTYPE": "v05_noz", "SSM_RATIO": 1.0,
                },
            },
        },
        "pretrained": {"check": True},
    },
}

# The flagship training config: own copy of configs/xpoint_vmamba.yaml (the
# machine with the card has no YAML reader). Its pretrained-encoder block is
# off: the VMamba ImageNet weights it names are not in the repository, so
# training starts from the port's seeded initialiser.
VMAMBA_TRAIN_CFG = {
    "dataset": {
        "type": "ImagePairDataset",
        "filename": "data/MULTIPOINT/training.hdf5",
        "keypoints_filename": "data/labels/rift2.hdf5",
        "single_image": False,
        "random_pairs": False,
        "height": 256,
        "width": 256,
        "augmentation": {
            "photometric": {
                "enable": False,
                "primitives": ["random_brightness", "random_contrast",
                               "additive_speckle_noise",
                               "additive_gaussian_noise", "additive_shade",
                               "motion_blur"],
                "params": {
                    "random_brightness": {"max_abs_change": 0.15},
                    "random_contrast": {"strength_range": [0.3, 1.8]},
                    "additive_gaussian_noise": {"stddev_range": [0, 0.06]},
                    "additive_speckle_noise": {"prob_range": [0, 0.0035]},
                    "additive_shade": {"transparency_range": [-0.5, 0.8],
                                       "kernel_size_range": [50, 100]},
                    "motion_blur": {"max_kernel_size": 3},
                },
            },
            "homographic": {
                "enable": True,
                "params": {
                    "corner_homography": {
                        "enable": False,
                        "params": {"patch_size": 128, "rho": 32}},
                    "translation": True,
                    "rotation": True,
                    "scaling": True,
                    "perspective": True,
                    "scaling_amplitude": 0.2,
                    "perspective_amplitude_x": 0.2,
                    "perspective_amplitude_y": 0.2,
                    "patch_ratio": 0.85,
                    "max_angle": 1.57,
                    "allow_artifacts": True,
                    "translation_overflow": 0.05,
                },
                "valid_border_margin": 0,
                "border_reflect": True,
            },
        },
    },
    "model": {
        "type": "XPoint",
        "multispectral": False,
        "descriptor_head": True,
        "descriptor_size": 256,
        "intepolation_mode": "bilinear",
        "normalize_descriptors": True,
        "final_batchnorm": True,
        "reflection_pad": True,
        "bn_first": False,
        "mixed_precision": True,
        "takes_pair": True,
        "homography_regression_head": {"check": True, "type": "RegNet"},
        "use_attention": {
            "check": True, "type": "VMamba", "height": 256, "width": 256,
            "model_parameters": {
                "DATA": {"IMG_SIZE": 512},
                "MODEL": {
                    "DROP_PATH_RATE": 0.2,
                    "NAME": "vssm_tiny_segmentation",
                    "TYPE": "vssm",
                    "VSSM": {
                        "DEPTHS": [2, 2, 2, 2], "DOWNSAMPLE": "v3",
                        "EMBED_DIM": 96, "MLP_RATIO": 4.0,
                        "PATCHEMBED": "v2", "SSM_CONV": 3,
                        "SSM_CONV_BIAS": False, "SSM_DT_RANK": "auto",
                        "SSM_D_STATE": 1, "SSM_FORWARDTYPE": "v05_noz",
                        "SSM_RATIO": 1.0,
                    },
                },
            },
            "pretrained": {"check": False},
        },
    },
    "loss": {
        "type": "XPointLoss",
        "detector_loss": True,
        "detector_loss_function": "cross_entropy",
        "detector_handle_multiple_keypoints": "soft_assignment",
        "detector_dustbin_loss_weight": 0.025,
        "detector_focal_loss": {"use": False, "alpha": 0.25, "gamma": 2.0},
        "descriptor_loss": True,
        "descriptor_loss_threshold": 4.0,
        "descriptor_loss_use_mask": True,
        "sparse_descriptor_loss": False,
        "sparse_descriptor_loss_num_cell_divisor": 64,
        "positive_margin": 1.0,
        "negative_margin": 0.2,
        "lambda_d": 250,
        "lambda": 1.0,
        "hard_negative_weighting": {"check": True, "temperature": 0.1,
                                    "weight": 0.2, "keep_uniform": True},
        "use_encoder_similarity": False,
        "homography_regression_loss": {"check": True, "gamma": 1.0},
    },
    "training": {
        "allow_gpu": True,
        "batchsize": 16,
        "learningrate": 1e-4,
        "mixed_precision": True,
        "n_epochs": 3000,
        "num_worker": 8,
        "output_directory": "model_weights/XPoint-EXP1",
        "save_every_n_epoch": 20,
        "use_writer": True,
        "weight_decay": 0,
        "scheduler": {"use_scheduler": False, "type": "ExponentialLR",
                      "gamma": 0.89, "step_size": 2},
        "validation": {"compute_validation_loss": False},
    },
}

DEFAULT_CONFIG = {
    'multispectral': True,
    'descriptor_head': True,
    'intepolation_mode': 'bilinear',
    'descriptor_size': 256,
    'normalize_descriptors': True,
    'final_batchnorm': True,
    'reflection_pad': True,
    'bn_first': False,
    'double_convolution': True,
    'channel_version': 0,
    'mixed_precision': False,
    'takes_pair': False,
    'spectral_norm_stats': False,
    'homography_regression_head': {'check': False, 'type': 'HomographyNet'},
    'use_attention': {'check': False, 'type': 'SimpleViT',
                      'height': 256, 'width': 256,
                      'pretrained': {'check': True, 'type_dir': ''}},
}

# channel_version -> head channels (None: descriptor_size)
_HEAD_CHANNELS = {0: 256, 1: None, 2: None}


class XPointNet(nn.Module):
    """Shared VMamba encoder + detector head (r^2 + 1 cell classes) +
    descriptor head (+ RegNet with ``hm_head``). Construct via
    :func:`build_xpoint`."""

    def __init__(self, encoder, encoder_channels, head_channels,
                 descriptor_size=256, encoder_downsample_ratio=8,
                 hm_head=None):
        super().__init__()
        self.encoder = encoder
        self.encoder_downsample_ratio = encoder_downsample_ratio
        self.detector_head = Head(encoder_channels, head_channels,
                                  encoder_downsample_ratio ** 2 + 1)
        self.descriptor_head = Head(encoder_channels, head_channels,
                                    descriptor_size)
        if hm_head is not None:
            self.hm_regressor = hm_head

    def forward_impl(self, image, gen=None):
        """image (B, H, W, 1) -> dict of logits (B, Hc, Wc, r^2+1) fp32,
        unit descriptors desc (B, Hc, Wc, D) fp32 and encoder_output fp32.
        encoder_output carries no gradient (``xpoint.py:156``, the
        reference's ``.clone().detach()``): the HM head trains on it without
        reaching the encoder. ``gen`` feeds DropPath in train mode."""
        x = self.encoder(image, gen)
        desc = self.descriptor_head(x)
        return {"logits": self.detector_head(x),
                "desc": desc / torch.linalg.vector_norm(
                    desc, dim=-1, keepdim=True).clamp_min(1e-12),
                "encoder_output": x.detach().float()}

    def forward(self, image, gen=None):
        return self.forward_impl(image, gen)

    def forward_pair(self, optical_image, thermal_image, gen=None):
        """takes_pair forward (``xpoint.py:178-221``): two passes through
        the shared encoder, then RegNet on both encoder outputs. Returns
        (pred_optical, pred_thermal, pred_hm or None)."""
        pred_o = self.forward_impl(optical_image, gen)
        pred_t = self.forward_impl(thermal_image, gen)
        pred_hm = None
        if hasattr(self, "hm_regressor"):
            pred_hm = self.hm_regressor(pred_o["encoder_output"],
                                        pred_t["encoder_output"], gen)
        return pred_o, pred_t, pred_hm


def build_xpoint(config=None, dtype=None, device="cuda", seed=0):
    """Build an XPointNet from the reference YAML ``model:`` dict.

    Returns (module, merged_config). The module is initialised from
    ``seed`` with the JAX package's initialiser distributions
    (``models.init``), in eval mode, on ``device``. dtype defaults to
    bf16 with ``mixed_precision`` and fp32 otherwise. The RegNet head is
    built when ``homography_regression_head`` is ``{check: true, type:
    RegNet}``.
    """
    cfg = dict_update(copy.deepcopy(DEFAULT_CONFIG), config or {})
    ua = cfg.get('use_attention', {})
    if not (ua.get('check') and ua.get('type') == 'VMamba'):
        raise NotImplementedError(
            "only the VMamba encoder is ported (CNN/Swin encoders: "
            "ROADMAP.md Queue 1 items 4 and 10)")
    if cfg['multispectral']:
        raise NotImplementedError(
            "multispectral (two-encoder) XPoint: ROADMAP.md Queue 1 item 4")
    if (cfg['bn_first'] or cfg['spectral_norm_stats']
            or not all(cfg[k] for k in ('descriptor_head', 'final_batchnorm',
                                        'normalize_descriptors',
                                        'reflection_pad'))):
        raise NotImplementedError(
            "heads other than the reference default (reflect pad, ReLU then "
            "BN, final BN, normalised descriptor head): ROADMAP.md Queue 1 "
            "item 4")
    pre = ua.get('pretrained', {}) or {}
    if pre.get('check') and (pre.get('yaml_file') or pre.get('type_dir')):
        raise NotImplementedError(
            "pretrained encoder YAML merge: ROADMAP.md Queue 1 item 4")
    vssm = (ua.get('model_parameters', {}) or {}).get('MODEL', {})
    vssm_cfg = dict(vssm.get('VSSM', {}))
    vssm_cfg['DROP_PATH_RATE'] = vssm.get('DROP_PATH_RATE', 0.2)
    if dtype is None:
        dtype = torch.bfloat16 if cfg.get('mixed_precision') else torch.float32
    encoder = build_vssm_from_config(vssm_cfg, dtype=dtype)
    head_channels = _HEAD_CHANNELS.get(cfg['channel_version'], 256)
    if head_channels is None:
        head_channels = cfg['descriptor_size']
    # the encoder ends in depth_to_space(4) of the last stage's width
    n_stages = len(vssm_cfg.get('DEPTHS', [2, 2, 2, 2]))
    enc_channels = (int(vssm_cfg.get('EMBED_DIM', 96)) * 2 ** (n_stages - 1)
                    // 16)
    hm = cfg.get('homography_regression_head', {})
    hm_head = None
    if hm.get('check'):
        if hm.get('type', 'RegNet') != 'RegNet':
            raise NotImplementedError(
                f"homography head {hm.get('type')}: only RegNet is ported "
                f"(HomographyNet: ROADMAP.md Queue 1 item 10)")
        hm_head = RegNet(enc_channels, dtype=dtype)
    module = XPointNet(encoder, enc_channels, head_channels,
                       descriptor_size=cfg['descriptor_size'],
                       hm_head=hm_head)
    init_xpoint_(module, torch.Generator().manual_seed(seed))
    return module.to(device).eval(), cfg
