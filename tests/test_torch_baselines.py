"""The baselines and the reference-checkpoint converter of the port against
the JAX package on the CPU: the classical detectors (SIFT, LGHD, RIFT2 and
phase congruency, the same cv2 and numpy on both sides: bit for bit),
MagicLeap SuperPoint (weights through the bridge; fp32 1e-4 of max |ref|),
get_model, ClassicInference and the benchmark entry point with SIFT
(keypoints and matches equal, metrics within 1e-6), and the full-model
converter on reference-named state_dicts built here from seeded numpy (no
reference checkpoint is in the repository): equal to JAX's conversion
carried through the bridge, bit for bit, with model_io.load_model and
Trainer.load_weights (JAX's counts) on top."""
import json
import os

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import xpoint_tpu.trainer as jx_trainer
from xpoint_tpu.compat.torch_converter import \
    convert_pretrained_encoder as jx_convert_pretrained_encoder
from xpoint_tpu.compat.torch_converter import \
    convert_torch_state_dict as jx_convert_torch_state_dict
from xpoint_tpu.eval.benchmark import compute_metrics as jx_compute_metrics
from xpoint_tpu.eval.infer import ClassicInference as JxClassicInference
from xpoint_tpu.models import build_xpoint as jx_build_xpoint
from xpoint_tpu.models import get_model as jx_get_model
from xpoint_tpu.models.classic import ClassicDetectors as JxClassicDetectors
from xpoint_tpu.models.rift2 import phasecong as jx_phasecong
from xpoint_tpu.models.superpoint import \
    SuperPointMagicLeap as JxSuperPointMagicLeap
from xpoint_tpu.models.superpoint import \
    convert_magicleap_weights as jx_convert_magicleap_weights
from xpoint_tpu.parallel.train_step import TrainState as JxTrainState

from xpoint_tpu_torch.cli import benchmark as cli
from xpoint_tpu_torch.compat.from_flax import (flax_to_state_dict,
                                               load_flax_variables)
from xpoint_tpu_torch.compat.torch_converter import (
    convert_pretrained_encoder, convert_torch_state_dict,
    is_reference_checkpoint, load_pretrained_encoder, load_torch_checkpoint)
from xpoint_tpu_torch.config import save_yaml
from xpoint_tpu_torch.data import DataLoader, get_dataset
from xpoint_tpu_torch.eval.infer import ClassicInference
from xpoint_tpu_torch.model_io import load_model
from xpoint_tpu_torch.models import build_xpoint, get_model
from xpoint_tpu_torch.models.classic import ClassicDetectors
from xpoint_tpu_torch.models.rift2 import phasecong
from xpoint_tpu_torch.models.superpoint import (LAYER_NAMES,
                                                SuperPointMagicLeap,
                                                convert_magicleap_weights)
from xpoint_tpu_torch.models.xpoint import XPointNet
from xpoint_tpu_torch.trainer import Trainer

from test_baseline_models import make_structured_image
from test_torch_cli_benchmark import _config, _keys, corpus  # noqa: F401
from test_torch_cli_benchmark import _close as _close_tree
from test_torch_models import _perturb, tiny_cfg
from test_torch_pretrained import _swin_ref_key, _vssm_ref_key
from test_torch_swinv2 import swin_cfg
from test_torch_trainer import FrozenSingleImages, synth_config
from torch_env import torch_env  # noqa: F401 (autouse)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
T = torch.from_numpy


# ---- reference-named checkpoints ------------------------------------------

def _normal(rng, shape):
    return torch.from_numpy(rng.normal(size=tuple(shape)).astype(np.float32))


def _bn(sd, name, n, rng):
    for leaf in ("weight", "bias", "running_mean"):
        sd[f"{name}.{leaf}"] = _normal(rng, (n,))
    sd[f"{name}.running_var"] = torch.from_numpy(
        rng.uniform(0.5, 2.0, size=n).astype(np.float32))
    sd[f"{name}.num_batches_tracked"] = torch.tensor(7)


def _conv(sd, name, weight, rng, bias=True):
    sd[f"{name}.weight"] = _normal(rng, weight.shape)
    if bias:
        sd[f"{name}.bias"] = _normal(rng, weight.shape[:1])


def reference_cnn_encoder(encoder, prefix, rng):
    """The reference's Sequential CNN encoder: block b's convs at 9b+1 and
    9b+5, BatchNorms at 9b+3 and 9b+7 (4b+1 / 4b+3 with one conv)."""
    sd, seq, k = {}, 0, 0
    per_block = 2 if encoder.double_convolution else 1
    for block in range(4):
        for _ in range(per_block):
            w = getattr(encoder, f"ConvBNRelu_{k}").Conv_0.weight
            _conv(sd, f"{prefix}{seq + 1}", w, rng)
            _bn(sd, f"{prefix}{seq + 3}", w.shape[0], rng)
            seq, k = seq + 4, k + 1
        seq += block < 3
    return sd


def reference_heads(module, seed):
    """The reference's head Sequentials: conv3 at 1, BN at 3, conv1 at 4,
    the final BN at 5."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name in ("detector_head", "descriptor_head"):
        head = getattr(module, name, None)
        if head is None:
            continue
        t = f"{name}_convolutions"
        w3, w1 = head.ConvBNRelu_0.Conv_0.weight, head.Conv_0.weight
        _conv(sd, f"{t}.1", w3, rng)
        _bn(sd, f"{t}.3", w3.shape[0], rng)
        _conv(sd, f"{t}.4", w1, rng)
        if head.bn_name is not None:
            _bn(sd, f"{t}.5", w1.shape[0], rng)
    return sd


def reference_checkpoint(module, seed):
    """A reference XPoint state_dict for ``module``: its encoder(s) (CNN
    Sequential, VSSM under its legacy names, Swin with qkv (3C, C)), the
    heads, and RegNet's layer1 / fc Sequentials where it has one; a
    'module.' prefix on every key, as DataParallel saves it."""
    rng = np.random.default_rng(seed)
    sd = {}
    names = (["encoder_optical", "encoder_thermal"] if module.multispectral
             else ["encoder"])
    for name in names:
        enc = getattr(module, name)
        if module.encoder_type == "cnn":
            sd.update(reference_cnn_encoder(enc, f"{name}.", rng))
            continue
        for k, t in enc.state_dict().items():
            shape = tuple(t.shape)
            if module.encoder_type == "swin":
                ref = _swin_ref_key(k)
                if ref.endswith("qkv.weight"):
                    shape = shape[::-1]
            else:
                ref = _vssm_ref_key(k)
            sd[f"{name}.{ref}"] = _normal(rng, shape)
    sd.update(reference_heads(module, seed + 1))
    hm = getattr(module, "hm_regressor", None)
    if hm is not None:
        _conv(sd, "hm_regressor.layer1.0", hm.conv1.weight, rng, bias=False)
        _bn(sd, "hm_regressor.layer1.1", 96, rng)
        _conv(sd, "hm_regressor.layer1.3", hm.conv2.weight, rng, bias=False)
        _bn(sd, "hm_regressor.layer1.4", 192, rng)
        _conv(sd, "hm_regressor.fc.1", hm.fc1.weight, rng)
        _conv(sd, "hm_regressor.fc.4", hm.fc2.weight, rng)
    return {f"module.{k}": v for k, v in sd.items()}


def jax_conversion(sd, cfg, module):
    """JAX's convert_torch_state_dict carried through the bridge into the
    port's names. Where the port holds SpectralBatchNorms, JAX's BatchNorm
    entries are put in both spectra's slots, as the port's converter
    does (the flax model of such a config has no BatchNorm_0 to read
    them)."""
    jm, merged = jx_build_xpoint(cfg, dtype=jnp.float32)
    ref = flax_to_state_dict(jx_convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jm, merged))
    if not cfg.get("spectral_norm_stats"):
        return ref
    target = module.state_dict()
    out = {}
    for k, v in ref.items():
        s = k.replace(".BatchNorm_0.", ".SpectralBatchNorm_0.")
        if s == k or s.rsplit(".", 1)[0] + ".mean_optical" not in target:
            out[k] = v
            continue
        base, leaf = s.rsplit(".", 1)
        if leaf in ("weight", "bias"):
            out[s] = v
        else:
            stat = "mean" if leaf == "running_mean" else "var"
            out[f"{base}.{stat}_optical"] = out[f"{base}.{stat}_thermal"] = v
    return out


def _cnn(**kw):
    return {**synth_config()["model"], "spectral_norm_stats": False,
            "descriptor_head": True, **kw}


CONVERTER_CASES = {
    "cnn": lambda: _cnn(multispectral=False),
    "cnn_multispectral": lambda: _cnn(),
    "cnn_single_convolution": lambda: _cnn(double_convolution=False),
    "cnn_spectral_stats": lambda: _cnn(spectral_norm_stats=True),
    "cnn_regnet": lambda: _cnn(multispectral=False,
                               homography_regression_head={"check": True,
                                                           "type": "RegNet"}),
    "vmamba_v05_noz": lambda: tiny_cfg(),
    "vmamba_xv1a": lambda: _vssm_type("xv1a"),
    "vmamba_m0_noz": lambda: _vssm_type("m0_noz"),
    "swin": lambda: swin_cfg(),
}


def _vssm_type(ftype):
    cfg = tiny_cfg()
    cfg["use_attention"]["model_parameters"]["MODEL"]["VSSM"][
        "SSM_FORWARDTYPE"] = ftype
    return cfg


@pytest.mark.parametrize("case", sorted(CONVERTER_CASES))
def test_convert_torch_state_dict_matches_jax(case):
    """Every entry of the module from the reference file, equal to JAX's
    conversion (bit for bit), through the 'module.' prefix, the legacy
    VSSM names, Linear2d-free dense layers and the BatchNorm statistics;
    a missing key raises KeyError on both sides."""
    cfg = CONVERTER_CASES[case]()
    tm, _ = build_xpoint(cfg, device="cpu")
    sd = reference_checkpoint(tm, 3)
    assert is_reference_checkpoint(sd)
    got = convert_torch_state_dict(sd, tm)
    want = jax_conversion(sd, cfg, tm)
    assert set(got) == set(want) == set(tm.state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    tm.load_state_dict(got, strict=True)
    del sd["module.detector_head_convolutions.4.weight"]
    with pytest.raises(KeyError):
        convert_torch_state_dict(sd, tm)


def test_load_torch_checkpoint_unwraps_and_tells_files_apart(tmp_path):
    """A .model holding the state_dict alone, under 'state_dict' or under
    'model' converts the same; a port state_dict or Trainer checkpoint is
    not a reference checkpoint."""
    cfg = CONVERTER_CASES["cnn"]()
    tm, _ = build_xpoint(cfg, device="cpu")
    sd = reference_checkpoint(tm, 5)
    want = convert_torch_state_dict(sd, tm)
    for i, obj in enumerate((sd, {"state_dict": sd}, {"model": sd,
                                                      "epoch": 3})):
        path = str(tmp_path / f"w{i}.model")
        torch.save(obj, path)
        got = load_torch_checkpoint(path, tm)
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert is_reference_checkpoint(obj)
    assert not is_reference_checkpoint(tm.state_dict())
    assert not is_reference_checkpoint({"module": tm.state_dict()})


def test_pretrained_cnn_encoder_matches_jax():
    """The CNN branch of convert_pretrained_encoder (it raised
    NotImplementedError before): a bare reference encoder Sequential into
    both encoders of a multispectral model, BatchNorm statistics included,
    equal to JAX's convert_pretrained_encoder through the bridge."""
    cfg = CONVERTER_CASES["cnn_multispectral"]()
    jm, _ = jx_build_xpoint(cfg, dtype=jnp.float32)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 1)),
                               method=jm.init_all))
    tm, _ = build_xpoint(cfg, device="cpu")
    sd = reference_cnn_encoder(tm.encoder_optical, "",
                               np.random.default_rng(2))
    ref = flax_to_state_dict(jx_convert_pretrained_encoder(
        {k: t.numpy() for k, t in sd.items()}, jm, v))
    got = convert_pretrained_encoder(sd, tm)
    want = {k: t for k, t in ref.items()
            if k.startswith(("encoder_optical.", "encoder_thermal."))}
    assert set(got) == set(want)
    for k, t in want.items():
        np.testing.assert_array_equal(got[k].numpy(), t.numpy(), err_msg=k)
    assert load_pretrained_encoder(tm, sd) == len(got)


# ---- model_io and Trainer.load_weights ------------------------------------

def test_load_model_reads_a_reference_checkpoint(tmp_path):
    """<version>.model of the params.yaml model: the module's state_dict is
    JAX's conversion of the file; a missing checkpoint raises."""
    cfg = CONVERTER_CASES["cnn_regnet"]()
    tm, merged = build_xpoint(cfg, device="cpu")
    save_yaml({"model": merged}, str(tmp_path / "params.yaml"))
    sd = reference_checkpoint(tm, 9)
    torch.save(sd, str(tmp_path / "ref.model"))
    module, _ = load_model(str(tmp_path), "ref", device="cpu")
    want = jax_conversion(sd, cfg, module)
    for k, t in module.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[k].numpy(), err_msg=k)
    with pytest.raises(FileNotFoundError):
        load_model(str(tmp_path), "e3", device="cpu")


@pytest.mark.parametrize("suffix", [".model", ".pth", ".pt"])
def test_load_weights_of_a_reference_checkpoint_counts_match_jax(
        suffix, tmp_path):
    """A reference checkpoint of a model with a descriptor head (16) read
    by a Trainer whose model has descriptor 32: the counts used / missing /
    unexpected / shape equal the JAX Trainer's, the used tensors are the
    converted ones; a .pt is told from the port's own by its keys."""
    src = synth_config(descriptor_head=True, spectral_norm_stats=False)
    dst = synth_config(descriptor_head=True, descriptor_size=32,
                       spectral_norm_stats=False)
    src_module, _ = build_xpoint(src["model"], device="cpu")
    sd = reference_checkpoint(src_module, 4)
    path = str(tmp_path / f"ref{suffix}")
    torch.save(sd, path)
    jt = jx_trainer.Trainer.__new__(jx_trainer.Trainer)
    jt.module, jt.model_cfg = jx_build_xpoint(dst["model"], dtype=jnp.float32)
    dv = jt.module.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 1)),
                        method=jt.module.init_all)
    tx, _ = jx_trainer.make_optimizer(dst["training"])
    jt.tx, jt.lr_at_epoch = tx, None
    jt.state = JxTrainState.create(dv["params"], dv["batch_stats"], tx)
    want = jt.load_weights(path)
    ds = FrozenSingleImages(4)
    pt = Trainer(dst, str(tmp_path / "dst"), device="cpu", dataset=ds,
                 val_dataset=ds)
    got = pt.load_weights(path)
    assert got == want and got["used"] > 0 and got["shape"] > 0
    conv = convert_torch_state_dict(sd, src_module)
    for k, t in pt.module.state_dict().items():
        if k in conv and conv[k].shape == t.shape:
            assert torch.equal(t, conv[k]), k


# ---- the classical detectors ----------------------------------------------

def _images():
    a = make_structured_image(160, 0)
    b = cv2.warpAffine(a, np.float32([[1, 0.05, 3], [-0.04, 1, 5]]),
                       (160, 160))
    return a, b


@pytest.mark.parametrize("method", ["SIFT", "LGHD", "RIFT2"])
def test_classic_detectors_equal_jax(method):
    """The same image through the port's and JAX's ClassicDetectors:
    bit-equal sparse maps; prob smoothing with SIFT."""
    cfg = {"method": method, "min_keypoints": 50, "image_H": 160,
           "image_W": 160}
    if method == "SIFT":
        cfg.update(prob_smoothing=True, smoothing_kernel_size=3)
    img = _images()[0][None, ..., None]
    got = ClassicDetectors(cfg)({"image": img})
    want = JxClassicDetectors(cfg)({"image": img})
    assert (got["prob"] > 0).sum() > 10
    for k in ("prob", "desc"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_classic_detectors_errors_match_jax():
    for cfg in ({"method": "ORB"}, {"method": "SIFT", "prob_smoothing": True,
                                    "smoothing_kernel_size": 4}):
        with pytest.raises(ValueError) as e_jax:
            JxClassicDetectors(cfg)
        with pytest.raises(ValueError) as e_port:
            ClassicDetectors(cfg)
        assert str(e_port.value) == str(e_jax.value)
    if not hasattr(cv2, "xfeatures2d"):
        with pytest.raises(RuntimeError, match="xfeatures2d"):
            ClassicDetectors({"method": "SURF"})


def test_phasecong_equals_jax():
    img = _images()[1][:96, :112] * 255.0
    got, want = phasecong(img), jx_phasecong(img)
    for a, b in zip(got, want):
        if isinstance(a, list):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)


# ---- SuperPoint and get_model ---------------------------------------------

def test_superpoint_matches_flax():
    """MagicLeap-named weights through JAX's convert_magicleap_weights and
    the bridge equal the port's conversion; the forward at 64 x 80 matches
    flax (fp32, 1e-4 of max |ref|) and has the XPointNet interface."""
    rng = np.random.default_rng(1)
    sd = {}
    for name, m in SuperPointMagicLeap().named_children():
        sd[f"{name}.weight"] = rng.normal(size=m.weight.shape).astype(
            np.float32) * 0.1
        sd[f"{name}.bias"] = rng.normal(size=m.bias.shape).astype(
            np.float32) * 0.1
    assert tuple(sorted(n for n in LAYER_NAMES)) == tuple(sorted(
        k[:-len(".weight")] for k in sd if k.endswith(".weight")))
    ref_sd = flax_to_state_dict(jx_convert_magicleap_weights(sd))
    got_sd = convert_magicleap_weights({k: T(v) for k, v in sd.items()})
    assert set(got_sd) == set(ref_sd)
    for k in ref_sd:
        assert torch.equal(got_sd[k], ref_sd[k]), k
    tm = SuperPointMagicLeap()
    tm.load_state_dict(got_sd, strict=True)
    img = rng.uniform(size=(2, 64, 80, 1)).astype(np.float32)
    ref = JxSuperPointMagicLeap().apply(
        jax.tree.map(jnp.asarray, jx_convert_magicleap_weights(sd)),
        jnp.asarray(img))
    with torch.no_grad():
        out = tm(T(img), "optical")
        pair = tm.forward_pair(T(img), T(img))
    for k in ("logits", "desc", "prob"):
        r = np.asarray(ref[k])
        np.testing.assert_allclose(out[k].numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=k)
    assert pair[2] is None and torch.equal(pair[0]["prob"], out["prob"])
    assert tm.encoder_downsample_ratio == 8


def test_superpoint_init_and_bridge():
    jm = JxSuperPointMagicLeap()
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1))),
                 2)
    tm = load_flax_variables(SuperPointMagicLeap(), v)
    img = np.random.default_rng(3).uniform(size=(1, 32, 40, 1)).astype(
        np.float32)
    ref = np.asarray(jm.apply(v, jnp.asarray(img))["logits"])
    with torch.no_grad():
        out = tm(T(img))["logits"].numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    seeded, _ = get_model({"type": "SuperPointMagicLeap"}, device="cpu",
                          seed=0)
    w = seeded.conv1b.weight
    np.testing.assert_allclose(float(w.detach().std()), (1 / (9 * 64)) ** 0.5,
                               rtol=0.15)
    assert not seeded.conv1b.bias.any() and not seeded.training


def test_get_model_types_match_jax():
    m, cfg = get_model(dict(tiny_cfg(), type="XPoint"), device="cpu")
    assert isinstance(m, XPointNet) and cfg["type"] == "XPoint"
    m, _ = get_model({"type": "SuperPointMagicLeap"}, device="cpu")
    assert isinstance(m, SuperPointMagicLeap)
    jm, jcfg = jx_get_model({"type": "ClassicDetectors", "method": "SIFT"})
    m, cfg = get_model({"type": "ClassicDetectors", "method": "SIFT"})
    assert isinstance(m, ClassicDetectors) and cfg == jcfg
    assert m.config == jm.config and not m.takes_pair()
    with pytest.raises(ValueError) as e_jax:
        jx_get_model({"type": "Nope"})
    with pytest.raises(ValueError) as e_port:
        get_model({"type": "Nope"})
    assert str(e_port.value) == str(e_jax.value)


# ---- ClassicInference and the benchmark entry point -----------------------

def test_classic_inference_equals_jax():
    """SIFT on a pair: the sparse maps (the one-sided depth padding), NMS,
    keypoints, descriptors and matches of the port's ClassicInference equal
    JAX's."""
    pred = {"detection_threshold": 0.015, "nms": 4}
    cfg = {"method": "SIFT", "min_keypoints": 30}
    a, b = _images()
    img_o, img_t = a[None, ..., None], b[None, ..., None]
    port = ClassicInference(ClassicDetectors(cfg), pred, device="cpu")
    jx = JxClassicInference(JxClassicDetectors(cfg), pred)
    assert port.device.type == "cpu" and port.ratio is None
    got, want = port.forward_pair(img_o, img_t), jx.forward_pair(img_o, img_t)
    dev = port.forward_pair_device(img_o, img_t)
    for g, w, d in zip(got[:4], want[:4], dev[:4]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(d.numpy(), w)
    assert got[4] is None and dev[4] is None
    descs = []
    for i in (0, 1):
        pn, jpn = port.nms(got[i]), np.asarray(jx.nms(want[i]))
        np.testing.assert_array_equal(pn, jpn)
        kp, jkp = port.keypoints_from_prob(pn[0]), jx.keypoints_from_prob(
            jpn[0])
        np.testing.assert_array_equal(kp, jkp)
        assert len(kp) > 10
        d = port.descriptors_at(kp, got[2 + i][0], pn.shape[1:3])
        jd = jx.descriptors_at(jkp, want[2 + i][0], pn.shape[1:3])
        # sampled and normalised in another order: 1e-5 of the unit norm
        np.testing.assert_allclose(d, jd, rtol=0, atol=1e-5)
        descs.append((d, jd))
    got_m = port.match(descs[0][0], descs[1][0])
    want_m = jx.match(descs[0][1], descs[1][1])
    assert [m[:2] for m in got_m] == [m[:2] for m in want_m] and got_m
    np.testing.assert_allclose([m[2] for m in got_m],
                               [m[2] for m in want_m], rtol=0, atol=1e-5)
    # a side with no detection: the depth-1 plane padded to the other's
    blank = np.zeros_like(img_t)
    got = port.forward_pair(img_o, blank)
    want = jx.forward_pair(img_o, blank)
    assert got[3].shape == got[2].shape == want[3].shape
    np.testing.assert_array_equal(got[3], want[3])
    single = port.forward_single(img_o, [True])
    np.testing.assert_array_equal(single[1], got[2])


def test_benchmark_cli_sift_matches_jax(corpus, tmp_path, monkeypatch):  # noqa
    """`-m none -v none` with a ClassicDetectors model section (the full
    cycle's CLASSICAL_MODEL_CFG): the JSON has JAX's keys, and every metric
    equals JAX's compute_metrics with JAX's ClassicInference (its own SIFT
    forward) on the same batches within 1e-6."""
    from xpoint_tpu_torch.tools.full_cycle import CLASSICAL_MODEL_CFG
    import yaml
    yaml_path, cfg = _config(corpus, tmp_path, detection_threshold=0.015,
                             nms=4)
    cfg["model"] = yaml.safe_load(CLASSICAL_MODEL_CFG)["model"]
    cfg["dataset"].update(height=96, width=96)
    save_yaml(cfg, yaml_path)
    out_path = cli.main(["-y", yaml_path, "-e", "-o", str(tmp_path / "out"),
                         "--device", "cpu", "--max-samples", "4", "-m",
                         "none", "-v", "none"])
    assert os.path.basename(out_path) == "benchmark_none_none_s0.json"
    with open(out_path) as f:
        got = json.load(f)
    batches = list(DataLoader(cli._Head(get_dataset(cfg["dataset"]), 4),
                              batch_size=1, shuffle=False))
    jx = JxClassicInference(JxClassicDetectors(cfg["model"]),
                            cfg["prediction"])
    want = jx_compute_metrics(
        jx, batches, cfg, threshold_repeatability=list(range(1, 11)),
        threshold_keypoints=list(range(1, 11)),
        threshold_warp=list(range(1, 11)), threshold_ransac=[2],
        verbose=False)
    want = json.loads(json.dumps(want, default=float))
    got.pop("timing_seconds")
    assert _keys(got) == _keys(want)
    assert sum(got["n_kp_optical"]) > 20
    assert got["n_kp_optical"] == want["n_kp_optical"]
    _close_tree(got, want, 1e-6)
