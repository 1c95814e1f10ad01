"""XPoint model: encoder(s) + detector head (+ descriptor head) (+ the
RegNet homography head), port of ``xpoint_tpu/models/xpoint.py:32-322``.

The encoder is the plain CNN (``models.heads.CNNEncoder``) or VMamba; with
``multispectral`` there are two, ``encoder_optical`` and
``encoder_thermal``, routed by the static ``spectrum`` of the forward:
``"optical"`` / ``"thermal"`` run one, ``"mixed"`` runs both on the whole
batch and selects per sample with ``is_optical`` (so that in train mode
each encoder's BatchNorm sees every sample, as in JAX). The heads take
the spectrum too, for their per-spectrum statistics
(``spectral_norm_stats``). ``train()`` / ``eval()`` switch BatchNorm,
DropPath and Dropout between their train and eval behaviour (the JAX
``train`` flag); their randomness comes from the ``torch.Generator``
passed to the forward. Not ported yet, and raising NotImplementedError:
the Swin encoder and the HomographyNet head (ROADMAP.md Queue 1 item 10),
and the pretrained-encoder YAML merge (Queue 1 item 7).
"""
import copy
import os

import torch
from torch import nn

from ..utils import dict_update
from .heads import CNNEncoder, Head
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

# channel_version -> (encoder channels, head channels; None: descriptor_size)
_CHANNEL_VERSIONS = {
    0: ((1, 64, 64, 128, 128), 256),
    1: ((1, 32, 64, 96, 128), None),
    2: ((1, 8, 16, 32, 64), None),
}


class XPointNet(nn.Module):
    """Encoder(s) + detector head (r^2 + 1 cell classes) + optional
    descriptor head (+ RegNet with ``hm_head``). Construct via
    :func:`build_xpoint`; ``make_encoder()`` builds one encoder, and
    ``encoder_type`` ("cnn" or "vmamba") says how it is called."""

    def __init__(self, make_encoder, encoder_type, encoder_channels,
                 head_channels, descriptor_size=256,
                 encoder_downsample_ratio=8, multispectral=False,
                 descriptor_head=True, normalize_descriptors=True,
                 final_batchnorm=True, reflection_pad=True, bn_first=False,
                 spectral_norm_stats=False, hm_head=None):
        super().__init__()
        self.encoder_type = encoder_type
        self.multispectral = multispectral
        self.normalize_descriptors = normalize_descriptors
        if multispectral:
            self.encoder_optical = make_encoder()
            self.encoder_thermal = make_encoder()
        else:
            self.encoder = make_encoder()
        self.encoder_downsample_ratio = encoder_downsample_ratio
        head_kw = dict(final_batchnorm=final_batchnorm,
                       reflection_pad=reflection_pad, bn_first=bn_first,
                       spectral_stats=spectral_norm_stats)
        self.detector_head = Head(encoder_channels, head_channels,
                                  encoder_downsample_ratio ** 2 + 1,
                                  **head_kw)
        if descriptor_head:
            self.descriptor_head = Head(encoder_channels, head_channels,
                                        descriptor_size, **head_kw)
        if hm_head is not None:
            self.hm_regressor = hm_head

    def _run(self, encoder, image, spectrum, gen):
        if self.encoder_type == "cnn":
            return encoder(image, spectrum)
        return encoder(image, gen)

    def encode(self, image, spectrum, is_optical=None, gen=None):
        """The encoder(s) for a static ``spectrum``: 'optical', 'thermal'
        or 'mixed' (both encoders, selected per sample by ``is_optical``,
        (B,) bool)."""
        if not self.multispectral:
            return self._run(self.encoder, image, spectrum, gen)
        if spectrum == "optical":
            return self._run(self.encoder_optical, image, spectrum, gen)
        if spectrum == "thermal":
            return self._run(self.encoder_thermal, image, spectrum, gen)
        xo = self._run(self.encoder_optical, image, spectrum, gen)
        xt = self._run(self.encoder_thermal, image, spectrum, gen)
        return torch.where(is_optical.reshape(-1, 1, 1, 1), xo, xt)

    def forward_impl(self, image, spectrum="optical", is_optical=None,
                     gen=None):
        """image (B, H, W, 1) -> dict of logits (B, Hc, Wc, r^2+1) fp32,
        descriptors desc (B, Hc, Wc, D) fp32 (unit length with
        ``normalize_descriptors``; absent without a descriptor head) and
        encoder_output fp32. encoder_output carries no gradient
        (``xpoint.py:156``, the reference's ``.clone().detach()``): the HM
        head trains on it without reaching the encoder. ``gen`` feeds
        DropPath in train mode."""
        x = self.encode(image, spectrum, is_optical, gen)
        out = {"logits": self.detector_head(x, spectrum)}
        if hasattr(self, "descriptor_head"):
            desc = self.descriptor_head(x, spectrum)
            if self.normalize_descriptors:
                desc = desc / torch.linalg.vector_norm(
                    desc, dim=-1, keepdim=True).clamp_min(1e-12)
            out["desc"] = desc
        out["encoder_output"] = x.detach().float()
        return out

    def forward(self, image, spectrum="optical", is_optical=None, gen=None):
        return self.forward_impl(image, spectrum, is_optical, gen)

    def forward_pair(self, optical_image, thermal_image, gen=None,
                     is_optical_o=None, is_optical_t=None):
        """takes_pair forward (``xpoint.py:178-221``): the optical image
        through the optical route and the thermal one through the thermal
        route, or, with two encoders and a per-sample ``is_optical_o`` /
        ``is_optical_t``, each side 'mixed'; then RegNet on both encoder
        outputs. Returns (pred_optical, pred_thermal, pred_hm or None)."""
        if self.multispectral and is_optical_o is not None:
            pred_o = self.forward_impl(optical_image, "mixed", is_optical_o,
                                       gen)
        else:
            pred_o = self.forward_impl(optical_image, "optical", gen=gen)
        if self.multispectral and is_optical_t is not None:
            pred_t = self.forward_impl(thermal_image, "mixed", is_optical_t,
                                       gen)
        else:
            pred_t = self.forward_impl(thermal_image, "thermal", gen=gen)
        pred_hm = None
        if hasattr(self, "hm_regressor"):
            pred_hm = self.hm_regressor(pred_o["encoder_output"],
                                        pred_t["encoder_output"], gen)
        return pred_o, pred_t, pred_hm


def _pretrained_yaml(pre):
    """The pretrained encoder's YAML that the JAX ``build_xpoint`` would
    merge under the inline VMamba parameters (``yaml_file``, else the
    first ``.yaml`` in ``type_dir``; only if it exists), or None."""
    if not pre.get('check'):
        return None
    yaml_file = pre.get('yaml_file')
    tdir = pre.get('type_dir')
    if not yaml_file and tdir and os.path.isdir(tdir):
        yamls = sorted(f for f in os.listdir(tdir) if f.endswith('.yaml'))
        yaml_file = os.path.join(tdir, yamls[0]) if yamls else None
    return yaml_file if yaml_file and os.path.exists(yaml_file) else None


def build_xpoint(config=None, dtype=None, device="cuda", seed=0):
    """Build an XPointNet from the reference YAML ``model:`` dict.

    Returns (module, merged_config). The encoder is the CNN (channel
    version 0, 1 or 2) unless ``use_attention`` asks for VMamba. The
    module is initialised from ``seed`` with the JAX package's initialiser
    distributions (``models.init``), in eval mode, on ``device``. dtype
    defaults to bf16 with ``mixed_precision`` and fp32 otherwise. The
    RegNet head is built when ``homography_regression_head`` is ``{check:
    true, type: RegNet}``.
    """
    cfg = dict_update(copy.deepcopy(DEFAULT_CONFIG), config or {})
    if dtype is None:
        dtype = torch.bfloat16 if cfg.get('mixed_precision') else torch.float32
    n_channels, head_channels = _CHANNEL_VERSIONS.get(
        cfg['channel_version'], _CHANNEL_VERSIONS[0])
    if head_channels is None:
        head_channels = cfg['descriptor_size']
    ua = cfg.get('use_attention', {})
    if not ua.get('check'):
        encoder_type, enc_channels = "cnn", n_channels[4]

        def make_encoder():
            return CNNEncoder(n_channels, cfg['reflection_pad'],
                              cfg['bn_first'], cfg['double_convolution'],
                              dtype, cfg['spectral_norm_stats'])
    elif ua.get('type') == 'VMamba':
        if _pretrained_yaml(ua.get('pretrained', {}) or {}):
            raise NotImplementedError(
                "pretrained encoder YAML merge: ROADMAP.md Queue 1 item 7")
        vssm = (ua.get('model_parameters', {}) or {}).get('MODEL', {})
        vssm_cfg = dict(vssm.get('VSSM', {}))
        vssm_cfg['DROP_PATH_RATE'] = vssm.get('DROP_PATH_RATE', 0.2)
        encoder_type = "vmamba"
        # the encoder ends in depth_to_space(4) of the last stage's width
        n_stages = len(vssm_cfg.get('DEPTHS', [2, 2, 2, 2]))
        enc_channels = (int(vssm_cfg.get('EMBED_DIM', 96))
                        * 2 ** (n_stages - 1) // 16)

        def make_encoder():
            return build_vssm_from_config(vssm_cfg, dtype=dtype)
    else:
        raise NotImplementedError(
            f"encoder {ua.get('type')}: only the CNN and VMamba encoders "
            f"are ported (Swin: ROADMAP.md Queue 1 item 10)")
    hm = cfg.get('homography_regression_head', {})
    hm_head = None
    if hm.get('check'):
        if hm.get('type', 'RegNet') != 'RegNet':
            raise NotImplementedError(
                f"homography head {hm.get('type')}: only RegNet is ported "
                f"(HomographyNet: ROADMAP.md Queue 1 item 10)")
        hm_head = RegNet(enc_channels, dtype=dtype)
    module = XPointNet(
        make_encoder, encoder_type, enc_channels, head_channels,
        descriptor_size=cfg['descriptor_size'],
        multispectral=cfg['multispectral'],
        descriptor_head=cfg['descriptor_head'],
        normalize_descriptors=cfg['normalize_descriptors'],
        final_batchnorm=cfg['final_batchnorm'],
        reflection_pad=cfg['reflection_pad'], bn_first=cfg['bn_first'],
        spectral_norm_stats=cfg['spectral_norm_stats'], hm_head=hm_head)
    init_xpoint_(module, torch.Generator().manual_seed(seed))
    return module.to(device).eval(), cfg
