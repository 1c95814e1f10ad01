"""Gold-standard checkpoint-conversion parity: run the actual reference
torch model, convert its state_dict, and compare forward outputs."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xpoint_tpu.models import build_xpoint
from xpoint_tpu.compat import convert_torch_state_dict
from xpoint_tpu.ops.detector import prob_from_logits

from reference_oracle import get_reference
from torch_env import torch_env  # noqa: F401 (autouse)


def _forward_jax(module, variables, img_nchw, spectrum="optical"):
    img = jnp.asarray(np.transpose(img_nchw, (0, 2, 3, 1)))
    # jitted apply: eager flax dispatch on the 1-core CPU runner dominates
    # these parity tests; jitted programs hit the persistent cache
    out = jax.jit(module.apply, static_argnums=2)(variables, img, spectrum)
    prob = prob_from_logits(out["logits"], module.encoder_downsample_ratio)
    return np.asarray(prob), np.asarray(out["desc"]).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("multispectral", [False, True])
def test_cnn_checkpoint_conversion_parity(multispectral):
    XPointRef = get_reference()
    cfg = {"multispectral": multispectral,
           "homography_regression_head": {"check": False}}
    ref = XPointRef(dict(cfg))
    ref.eval()

    module, mcfg = build_xpoint(cfg)
    variables = convert_torch_state_dict(ref.state_dict(), module, mcfg)

    rng = np.random.default_rng(0)
    img = rng.uniform(size=(2, 1, 64, 64)).astype(np.float32)
    with torch.no_grad():
        data = {"image": torch.from_numpy(img)}
        if multispectral:
            data["is_optical"] = torch.ones(2, 1, dtype=torch.bool)
        out_ref = ref.forward_impl(data)
    prob_ref = out_ref["prob"][:, 0].numpy()
    desc_ref = out_ref["desc"].numpy()

    prob, desc = _forward_jax(module, variables, img)
    np.testing.assert_allclose(prob, prob_ref, atol=1e-4)
    np.testing.assert_allclose(desc, desc_ref, atol=1e-4)


def test_vmamba_checkpoint_conversion_parity(tmp_path):
    """Full production-config VSSM encoder conversion: reference VMamba
    (v05_noz, d_state 1, torch backend) vs our NHWC VSSM."""
    XPointRef = get_reference()

    vssm_params = {
        "DATA": {"IMG_SIZE": 512},
        "MODEL": {
            "DROP_PATH_RATE": 0.2,
            "VSSM": {
                "DEPTHS": [1, 1, 1, 1], "EMBED_DIM": 32,
                "MLP_RATIO": 4.0, "PATCHEMBED": "v2", "DOWNSAMPLE": "v3",
                "SSM_CONV": 3, "SSM_CONV_BIAS": False,
                "SSM_DT_RANK": "auto", "SSM_D_STATE": 1,
                "SSM_FORWARDTYPE": "v05_noz", "SSM_RATIO": 1.0,
            },
        },
    }
    yaml_file = tmp_path / "vssm_tiny.yaml"
    yaml_file.write_text("MODEL:\n  TYPE: vssm\n  NAME: vssm_test\n")

    cfg = {
        "multispectral": False,
        "homography_regression_head": {"check": False},
        "use_attention": {
            "check": True, "type": "VMamba", "height": 64, "width": 64,
            "model_parameters": vssm_params,
            "pretrained": {"check": True, "yaml_file": str(yaml_file)},
        },
    }
    ref = XPointRef(dict(cfg))
    ref.eval()

    module, mcfg = build_xpoint(cfg)
    variables = convert_torch_state_dict(ref.state_dict(), module, mcfg)

    rng = np.random.default_rng(1)
    img = rng.uniform(size=(1, 1, 64, 64)).astype(np.float32)
    with torch.no_grad():
        out_ref = ref.forward_impl({"image": torch.from_numpy(img)})
    prob_ref = out_ref["prob"][:, 0].numpy()
    desc_ref = out_ref["desc"].numpy()

    prob, desc = _forward_jax(module, variables, img)
    np.testing.assert_allclose(prob, prob_ref, atol=5e-4)
    np.testing.assert_allclose(desc, desc_ref, atol=5e-3)


@pytest.mark.parametrize("ftype,tol", [("v05", 5e-4), ("v051d_noz", 5e-4),
                                       ("v052d_noz", 5e-4), ("v05_noz_oact", 5e-4)])
def test_vmamba_forward_type_variants_parity(tmp_path, ftype, tol):
    """SS2D variant parity: gated (v05), unidirectional (v051d),
    bidirectional (v052d), output-GELU (_oact)."""
    XPointRef = get_reference()
    vssm_params = {
        "DATA": {"IMG_SIZE": 512},
        "MODEL": {"DROP_PATH_RATE": 0.2,
                  "VSSM": {"DEPTHS": [1, 1, 1, 1], "EMBED_DIM": 32,
                           "MLP_RATIO": 4.0, "PATCHEMBED": "v2",
                           "DOWNSAMPLE": "v3", "SSM_CONV": 3,
                           "SSM_CONV_BIAS": False, "SSM_DT_RANK": "auto",
                           "SSM_D_STATE": 2, "SSM_FORWARDTYPE": ftype,
                           "SSM_RATIO": 2.0}}}
    yaml_file = tmp_path / "v.yaml"
    yaml_file.write_text("MODEL:\n  TYPE: vssm\n")
    cfg = {"multispectral": False,
           "homography_regression_head": {"check": False},
           "use_attention": {"check": True, "type": "VMamba",
                             "height": 32, "width": 32,
                             "model_parameters": vssm_params,
                             "pretrained": {"check": True,
                                            "yaml_file": str(yaml_file)}}}
    ref = XPointRef(dict(cfg))
    ref.eval()
    module, mcfg = build_xpoint(cfg)
    variables = convert_torch_state_dict(ref.state_dict(), module, mcfg)

    rng = np.random.default_rng(2)
    img = rng.uniform(size=(1, 1, 32, 32)).astype(np.float32)
    with torch.no_grad():
        out_ref = ref.forward_impl({"image": torch.from_numpy(img)})
    prob, desc = _forward_jax(module, variables, img)
    np.testing.assert_allclose(prob, out_ref["prob"][:, 0].numpy(), atol=tol)


def test_pretrained_encoder_bootstrap(tmp_path):
    """backbone.-prefixed VSSM checkpoint loads into the XPoint encoder."""
    import jax
    from xpoint_tpu.compat.torch_converter import convert_pretrained_encoder

    XPointRef = get_reference()
    vssm_params = {
        "DATA": {"IMG_SIZE": 512},
        "MODEL": {"DROP_PATH_RATE": 0.2,
                  "VSSM": {"DEPTHS": [1, 1, 1, 1], "EMBED_DIM": 32,
                           "MLP_RATIO": 4.0, "PATCHEMBED": "v2",
                           "DOWNSAMPLE": "v3", "SSM_CONV": 3,
                           "SSM_CONV_BIAS": False, "SSM_DT_RANK": "auto",
                           "SSM_D_STATE": 1, "SSM_FORWARDTYPE": "v05_noz",
                           "SSM_RATIO": 1.0}}}
    yaml_file = tmp_path / "v.yaml"
    yaml_file.write_text("MODEL:\n  TYPE: vssm\n")
    cfg = {"multispectral": False,
           "homography_regression_head": {"check": False},
           "use_attention": {"check": True, "type": "VMamba",
                             "height": 32, "width": 32,
                             "model_parameters": vssm_params,
                             "pretrained": {"check": True,
                                            "yaml_file": str(yaml_file)}}}
    ref = XPointRef(dict(cfg))
    # fake a pretrained backbone checkpoint: encoder keys with backbone. prefix
    enc_sd = {("backbone." + k[len("encoder."):]): v.numpy()
              for k, v in ref.state_dict().items() if k.startswith("encoder.")}

    module, mcfg = build_xpoint(cfg)
    variables = jax.jit(lambda r: module.init(
        r, jnp.zeros((1, 32, 32, 1)), method=module.init_all))(
        jax.random.PRNGKey(0))
    new_vars = convert_pretrained_encoder(enc_sd, module, variables)
    # encoder weights replaced, heads untouched
    ref_w = ref.state_dict()["encoder.patch_embed.0.weight"].numpy()
    got = np.asarray(new_vars["params"]["encoder"]["patch_embed_conv1"]["kernel"])
    np.testing.assert_allclose(got, ref_w.transpose(2, 3, 1, 0), atol=1e-6)


def test_vmamba_cascade2d_parity(tmp_path):
    """cascade2d (v052dc) forward-type parity vs the reference."""
    XPointRef = get_reference()
    vssm_params = {
        "DATA": {"IMG_SIZE": 512},
        "MODEL": {"DROP_PATH_RATE": 0.2,
                  "VSSM": {"DEPTHS": [1, 1, 1, 1], "EMBED_DIM": 32,
                           "MLP_RATIO": 4.0, "PATCHEMBED": "v2",
                           "DOWNSAMPLE": "v3", "SSM_CONV": 3,
                           "SSM_CONV_BIAS": False, "SSM_DT_RANK": "auto",
                           "SSM_D_STATE": 2,
                           "SSM_FORWARDTYPE": "v052dc_noz",
                           "SSM_RATIO": 2.0}}}
    yaml_file = tmp_path / "v.yaml"
    yaml_file.write_text("MODEL:\n  TYPE: vssm\n")
    cfg = {"multispectral": False,
           "homography_regression_head": {"check": False},
           "use_attention": {"check": True, "type": "VMamba",
                             "height": 32, "width": 32,
                             "model_parameters": vssm_params,
                             "pretrained": {"check": True,
                                            "yaml_file": str(yaml_file)}}}
    ref = XPointRef(dict(cfg))
    ref.eval()
    module, mcfg = build_xpoint(cfg)
    variables = convert_torch_state_dict(ref.state_dict(), module, mcfg)

    rng = np.random.default_rng(5)
    img = rng.uniform(size=(1, 1, 32, 32)).astype(np.float32)
    # the reference cascade2d path crashes on a non-contiguous .view
    # (VMamba.py:643); substitute reshape (identical semantics) to run it
    orig_view = torch.Tensor.view

    def safe_view(self, *args):
        try:
            return orig_view(self, *args)
        except RuntimeError:
            return self.reshape(*args)

    torch.Tensor.view = safe_view
    try:
        with torch.no_grad():
            out_ref = ref.forward_impl({"image": torch.from_numpy(img)})
    finally:
        torch.Tensor.view = orig_view
    prob, _ = _forward_jax(module, variables, img)
    np.testing.assert_allclose(prob, out_ref["prob"][:, 0].numpy(), atol=1e-3)


def _fixed_forwardxv(self, x, **kwargs):
    """Repaired reference SS2Dv3.forwardxv (VMamba.py:842-911) for the
    channel-last path: the upstream code views dts to (B, L, -1) where
    conv1d/selective_scan need (B, -1, L) (:874-877), feeds the channel-
    last one_by_one tensors without the (B, H, W, 4, C) reshape its own
    cross_scan_fn requires (the intended reshape survives as a commented
    line at :868), and applies nn.Conv2d to channel-last input. This copy
    fixes exactly those three mechanical defects, preserving the evident
    semantics."""
    import torch.nn.functional as F
    from xpoint.models.vmamba_src.csm_triton import (cross_scan_fn,
                                                     cross_merge_fn)
    from xpoint.models.vmamba_src.csms6s import selective_scan_fn

    B, H, W, _ = x.shape
    L = H * W
    nchw = lambda t: t.permute(0, 3, 1, 2).contiguous()
    nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()

    if self.iconv:
        x = self.cact(nhwc(self.conv2d(nchw(x))))
    elif self.cpos:
        x = x + nhwc(self.conv2d(nchw(x)))
    x = self.in_proj(x)
    if self.oconv2:
        x = nhwc(self.conv2d(nchw(x)))

    us, dts, Bs, Cs = x.split(
        [self.d_inner, self.dts_dim, 4 * self.d_state, 4 * self.d_state],
        dim=-1)
    _us = us
    us = cross_scan_fn(us.contiguous(), in_channel_first=False,
                       out_channel_first=True).view(B, -1, L)
    Bs = cross_scan_fn(Bs.view(B, H, W, 4, -1).contiguous(),
                       in_channel_first=False, out_channel_first=True,
                       one_by_one=True).view(B, 4, -1, L)
    Cs = cross_scan_fn(Cs.view(B, H, W, 4, -1).contiguous(),
                       in_channel_first=False, out_channel_first=True,
                       one_by_one=True).view(B, 4, -1, L)
    one = self.dts_dim == 4 * self.dt_rank
    dts_in = dts.view(B, H, W, 4, -1).contiguous() if one else dts.contiguous()
    dts = cross_scan_fn(dts_in, in_channel_first=False,
                        out_channel_first=True,
                        one_by_one=one).view(B, -1, L)
    if self.dts_dim in (self.dt_rank, 4 * self.dt_rank):
        dts = F.conv1d(dts, self.dt_projs_weight.view(
            4 * self.d_inner, self.dt_rank, 1), None, groups=4)

    As = -self.A_logs.to(torch.float).exp()
    Ds = self.Ds.to(torch.float)
    delta_bias = self.dt_projs_bias.view(-1).to(torch.float)
    ys = selective_scan_fn(us, dts, As, Bs, Cs, Ds, delta_bias, True,
                           oflex=True, backend="torch").view(B, 4, -1, H, W)
    y = cross_merge_fn(ys.contiguous(), in_channel_first=True,
                       out_channel_first=True)
    y = y.view(B, -1, L).transpose(1, 2).contiguous().view(B, H, W, -1)
    y = self.out_norm(y)
    y = y.to(x.dtype)
    y = self.out_act(y)
    if self.omul:
        y = y * _us
    if self.oconv:
        y = y + self.cact(nhwc(self.oconv2d(nchw(_us))))
    return self.dropout(self.out_proj(y))


@pytest.mark.parametrize("ftype", ["xv1a", "xv2a", "xv3a_act_mul"])
def test_vmamba_xv_parity(ftype, tmp_path):
    """xv (SS2Dv3) forward-type parity vs the minimally-repaired reference
    oracle (the upstream path is non-executable as written; see
    _fixed_forwardxv)."""
    import types
    XPointRef = get_reference()
    vssm_params = {
        "DATA": {"IMG_SIZE": 512},
        "MODEL": {"DROP_PATH_RATE": 0.2,
                  "VSSM": {"DEPTHS": [1, 1, 1, 1], "EMBED_DIM": 32,
                           "MLP_RATIO": 4.0, "PATCHEMBED": "v2",
                           "DOWNSAMPLE": "v3", "SSM_CONV": 3,
                           "SSM_CONV_BIAS": False, "SSM_DT_RANK": "auto",
                           "SSM_D_STATE": 2,
                           "SSM_FORWARDTYPE": ftype,
                           "SSM_RATIO": 2.0}}}
    yaml_file = tmp_path / "v.yaml"
    yaml_file.write_text("MODEL:\n  TYPE: vssm\n")
    cfg = {"multispectral": False,
           "homography_regression_head": {"check": False},
           "use_attention": {"check": True, "type": "VMamba",
                             "height": 32, "width": 32,
                             "model_parameters": vssm_params,
                             "pretrained": {"check": True,
                                            "yaml_file": str(yaml_file)}}}
    ref = XPointRef(dict(cfg))
    ref.eval()
    # bind the repaired forward onto every SS2Dv3 op
    n_bound = 0
    for m in ref.modules():
        if hasattr(m, "dts_dim"):
            m.forward = types.MethodType(_fixed_forwardxv, m)
            n_bound += 1
    assert n_bound == 4

    module, mcfg = build_xpoint(cfg)
    variables = convert_torch_state_dict(ref.state_dict(), module, mcfg)

    rng = np.random.default_rng(7)
    img = rng.uniform(size=(1, 1, 32, 32)).astype(np.float32)
    with torch.no_grad():
        out_ref = ref.forward_impl({"image": torch.from_numpy(img)})
    prob, _ = _forward_jax(module, variables, img)
    np.testing.assert_allclose(prob, out_ref["prob"][:, 0].numpy(), atol=1e-3)
