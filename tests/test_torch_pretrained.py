"""The pretrained-encoder path: a backbone checkpoint under the reference's
torch key names, built here from seeded numpy (no pretrained weights are in
the repository), through the JAX package's convert_pretrained_encoder and
the weight bridge on one side and the port's converter on the other. The
encoder entries must be equal in fp32, for Swin, VMamba (with the legacy
names and prefixes) and a multispectral model (the same weights in both
encoders)."""
import copy
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xpoint_tpu.compat.torch_converter import \
    convert_pretrained_encoder as jx_convert_pretrained_encoder
from xpoint_tpu.models import build_xpoint as jx_build_xpoint

from xpoint_tpu_torch.compat.from_flax import flax_to_state_dict
from xpoint_tpu_torch.compat.torch_converter import (
    convert_pretrained_encoder, load_pretrained_encoder, normalize_torch_keys)
from xpoint_tpu_torch.models import build_xpoint

from test_torch_models import tiny_cfg
from test_torch_swinv2 import swin_cfg
from torch_env import torch_env  # noqa: F401 (autouse)


def _swin_ref_key(k):
    """A port Swin encoder key -> the reference's name for it."""
    if k in ("patch_embed.weight", "patch_embed.bias"):
        return k.replace("patch_embed.", "patch_embed.proj.")
    k = re.sub(r"layers_(\d+)_blocks_(\d+)", r"layers.\1.blocks.\2", k)
    k = re.sub(r"layers_(\d+)_downsample", r"layers.\1.downsample", k)
    for a, b in (("patch_embed_norm", "patch_embed.norm"),
                 ("attn.cpb_fc1", "attn.cpb_mlp.0"),
                 ("attn.cpb_fc2", "attn.cpb_mlp.2"),
                 ("mlp_fc1", "mlp.fc1"), ("mlp_fc2", "mlp.fc2"),
                 ("attn.qkv_kernel", "attn.qkv.weight")):
        k = k.replace(a, b)
    return k


def _vssm_ref_key(k):
    """A port VSSM encoder key -> the reference's legacy name for it
    (patch_embed.proj / .norm, ln_1, self_attention)."""
    for a, b in ((".op.", ".self_attention."), (".norm.", ".ln_1."),
                 ("patch_embed_conv1", "patch_embed.proj"),
                 ("patch_embed_norm1", "patch_embed.norm"),
                 ("patch_embed_conv2", "patch_embed.5"),
                 ("patch_embed_norm2", "patch_embed.7"),
                 ("mlp.Dense_0", "mlp.fc1"), ("mlp.Dense_1", "mlp.fc2")):
        k = k.replace(a, b)
    k = re.sub(r"layers_(\d+)_blocks_(\d+)", r"layers.\1.blocks.\2", k)
    k = re.sub(r"layers_(\d+)_downsample_conv", r"layers.\1.downsample.1", k)
    return re.sub(r"layers_(\d+)_downsample_norm", r"layers.\1.downsample.3",
                  k)


def reference_checkpoint(module, seed):
    """A reference-named backbone state_dict of torch tensors for
    ``module``'s encoder, seeded numpy values: Swin's qkv as (3C, C), its
    relative-position buffers and a classification head beside the
    weights; VSSM under 'module.backbone.' with its legacy names and
    out_proj stored as a Linear2d (O, I, 1, 1)."""
    rng = np.random.default_rng(seed)
    enc = (module.encoder_optical if module.multispectral
           else module.encoder)
    sd = {}
    for k, t in enc.state_dict().items():
        shape = tuple(t.shape)
        if module.encoder_type == "swin":
            name = _swin_ref_key(k)
            if name.endswith("qkv.weight"):
                shape = shape[::-1]
        else:
            name = "module.backbone." + _vssm_ref_key(k)
            if name.endswith("out_proj.weight"):
                shape = shape + (1, 1)
        sd[name] = torch.from_numpy(
            rng.normal(size=shape).astype(np.float32))
    if module.encoder_type == "swin":
        for k in list(sd):
            if k.endswith("attn.logit_scale"):
                blk = k[:-len("logit_scale")]
                sd[blk + "relative_position_index"] = torch.zeros(
                    16, 16, dtype=torch.int64)
                sd[blk + "relative_coords_table"] = torch.zeros(1, 7, 7, 2)
        sd["head.weight"] = torch.zeros(10, 8)
    else:
        sd["module.backbone.classifier.head.weight"] = torch.zeros(10, 8)
    return sd


CASES = {
    "swin": lambda: swin_cfg(),
    "vmamba": lambda: tiny_cfg(),
    "vmamba_multispectral": lambda: dict(tiny_cfg(), multispectral=True),
    "swin_multispectral": lambda: swin_cfg(multispectral=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pretrained_encoder_matches_jax_converter(case):
    cfg = CASES[case]()
    jm, _ = jx_build_xpoint(cfg, dtype=jnp.float32, scan_backend="assoc")
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 64, 64, 1), jnp.float32),
                                  method=jm.init_all))(jax.random.PRNGKey(0))
    tm, _ = build_xpoint(cfg, device="cpu")
    sd = reference_checkpoint(tm, 3)
    ref = flax_to_state_dict(jx_convert_pretrained_encoder(
        {k: t.numpy() for k, t in sd.items()}, jm, jax.device_get(v)))
    got = convert_pretrained_encoder(sd, tm)
    encoders = ("encoder_optical.", "encoder_thermal.") \
        if cfg["multispectral"] else ("encoder.",)
    want = {k: t for k, t in ref.items() if k.startswith(encoders)}
    assert set(got) == set(want)
    for k, t in want.items():
        np.testing.assert_array_equal(got[k].numpy(), t.numpy(), err_msg=k)

    # into the module: every encoder entry is the checkpoint's, the rest
    # keeps its initialisation
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    assert load_pretrained_encoder(tm, sd) == len(got)
    for k, t in tm.state_dict().items():
        assert torch.equal(t, got[k] if k in got else before[k]), k


def test_missing_key_raises_on_both_sides():
    cfg = swin_cfg()
    jm, _ = jx_build_xpoint(cfg, dtype=jnp.float32)
    tm, _ = build_xpoint(cfg, device="cpu")
    sd = reference_checkpoint(tm, 4)
    del sd["layers.1.blocks.0.mlp.fc2.weight"]
    with pytest.raises(KeyError, match="missing key"):
        jx_convert_pretrained_encoder({k: t.numpy() for k, t in sd.items()},
                                      jm, {"params": {}})
    with pytest.raises(KeyError, match="missing key"):
        convert_pretrained_encoder(sd, tm)


def test_normalize_torch_keys_renames_vssm_only():
    sd = {"a__module.backbone.patch_embed.proj.weight": 1,
          "module.layers.0.blocks.0.ln_1.bias": 2,
          "backbone.layers.0.blocks.0.self_attention.Ds": 3}
    assert list(normalize_torch_keys(sd, vssm_legacy=True)) == [
        "patch_embed.0.weight", "layers.0.blocks.0.norm.bias",
        "layers.0.blocks.0.op.Ds"]
    assert list(normalize_torch_keys(copy.deepcopy(sd))) == [
        "patch_embed.proj.weight", "layers.0.blocks.0.ln_1.bias",
        "layers.0.blocks.0.self_attention.Ds"]
