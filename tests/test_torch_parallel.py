"""The port's multi-device paths on 2 CPU ranks (gloo, one process each,
through ``parallel.launch``) against the JAX package's 2-device programs
on ``make_mesh(2)`` over the virtual CPU devices of tests/conftest.py, and
against the port on one device: the ring scan and its gradients, the
``"ring"`` backend of ``selective_scan`` and SS2D, sharded serving, sharded
HA and the label export, ``make_mesh`` and the launcher's failures.

The ranks run tests/torch_parallel_ranks.py, which imports no JAX; one
launch runs every 2-rank case (``ranked``), and its results are held here.
Inputs are made from seeds with numpy; fp32 on the CPU."""
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xpoint_tpu_torch.compat.from_flax import load_flax_variables
from xpoint_tpu_torch.eval import make_pair_pipeline
from xpoint_tpu_torch.models import build_xpoint
from xpoint_tpu_torch.models.vssm import SS2D
from xpoint_tpu_torch.ops.linear_scan import linear_scan
from xpoint_tpu_torch.ops.selective_scan import selective_scan
from xpoint_tpu_torch.parallel import launch, make_mesh
from xpoint_tpu_torch.parallel.launch import default_backend
from xpoint_tpu_torch.selfsup import homographic_adaptation as ha
from xpoint_tpu_torch.selfsup.export import NumpySink, export_keypoints

import torch_parallel_ranks as ranks
from test_torch_models import _jax_tiny_model, _perturb, tiny_cfg

T = torch.from_numpy
CPU2 = ["cpu", "cpu"]
# a launch's deadline (the launch of ``ranked`` takes ~15 s alone, several
# times that beside the rest of the suite); a hung collective raises after
# the launcher's own 60 s a collective
LAUNCH_S = 300
PIPE_KW = dict(k=64, nms_size=4, detection_threshold=1e-4)
HA_CFG = {"num": 4, "aggregation": "prod", "min_count": 1,
          "erosion_radius": 2}
EXPORT_HA = {"num": 3, "aggregation": "window", "min_count": 1,
             "erosion_radius": 2}
EXPORT_PRED = {"nms": 4, "detection_threshold": 0.015, "topk": 0}


def _jax_mesh():
    from xpoint_tpu.parallel import make_mesh as jx_make_mesh
    return jx_make_mesh(2)


def _smooth_pair(seed, B, S):
    """Smooth images (test_torch_selfsup.py's): bilinear warps of them
    agree across the two packages to roundoff."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    base = 0.5 + 0.4 * np.sin(xx / 5.0) * np.cos(yy / 4.0)
    img_o = np.clip(base[None, :, :, None] + 0.05 * rng.normal(
        size=(B, S, S, 1)), 0, 1).astype(np.float32)
    return img_o, np.clip(1.0 - img_o ** 1.5, 0, 1).astype(np.float32)


def _images(seed, B, S):
    rng = np.random.default_rng(seed)
    img_o = rng.uniform(size=(B, S, S, 1)).astype(np.float32)
    img_t = np.clip(img_o + 0.05 * rng.normal(size=img_o.shape), 0, 1
                    ).astype(np.float32)
    return img_o, img_t


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    inp = {"ring_a": rng.uniform(0.2, 0.99, (256, 8)).astype(np.float32),
           "ring_b": rng.normal(size=(256, 8)).astype(np.float32)}
    B, K, C, N, L = 2, 4, 6, 2, 64
    KC = K * C
    r3 = np.random.default_rng(3)
    inp["sel"] = [r3.normal(size=(B, KC, L)).astype(np.float32),
                  r3.normal(size=(B, KC, L)).astype(np.float32),
                  -np.exp(r3.normal(size=(KC, N))).astype(np.float32),
                  r3.normal(size=(B, K, N, L)).astype(np.float32),
                  r3.normal(size=(B, K, N, L)).astype(np.float32),
                  r3.normal(size=(KC,)).astype(np.float32),
                  (r3.normal(size=(KC,)) * 0.1).astype(np.float32)]

    from xpoint_tpu.models.vssm import SS2D as JxSS2D
    x = np.random.default_rng(4).normal(size=(1, 16, 16, 8)).astype(
        np.float32)
    jm = JxSS2D(d_model=8, d_state=1, scan_backend="assoc")
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    inp["ss2d_kw"] = {"d_model": 8, "d_state": 1}
    inp["ss2d_sd"] = load_flax_variables(SS2D(8), v).state_dict()
    inp["ss2d_x"], inp["ss2d_v"] = x, v

    jm, v = _jax_tiny_model()
    tm, cfg = build_xpoint(tiny_cfg(), device="cpu")
    load_flax_variables(tm, v)
    inp["model_cfg"], inp["model_sd"] = tiny_cfg(), tm.state_dict()
    inp["jm"], inp["v"], inp["tm"] = jm, v, tm
    inp["pipe_hw"], inp["pipe_kw"] = (64, 64), PIPE_KW
    inp["pipe_o"], inp["pipe_t"] = _images(3, 4, 64)

    inp["ha_cfg"] = HA_CFG
    inp["ha_o"], inp["ha_t"] = _smooth_pair(7, 4, 48)
    merged = ha.make_ha_fn(ranks.ha_prob_fn, HA_CFG)[1]
    inp["ha_hs"] = ha.sample_ha_homographies(merged, (48, 48),
                                             np.random.default_rng(5))
    inp["export_o"], inp["export_t"] = _images(11, 4, 64)
    inp["export_ha"], inp["export_pred"] = EXPORT_HA, EXPORT_PRED
    return inp


@pytest.fixture(scope="module")
def ranked(inputs):
    """Every 2-rank case in one launch (rank 0's results)."""
    send = {k: v for k, v in inputs.items()
            if k not in ("jm", "v", "tm", "ss2d_v")}
    return launch(ranks.parallel_cases, 2, args=(send,), devices=CPU2,
                  timeout=LAUNCH_S, threads=2)


def test_ranks_form_one_mesh(ranked):
    assert ranked["mesh"] == (0, 2, "cpu")


def test_make_mesh_raises_for_too_few_devices(ranked):
    """A mesh of 4 asked for inside a group of 2 ranks raises, as JAX's
    make_mesh does when fewer devices exist (never a silent cut)."""
    assert "asked for 4 devices" in ranked["make_mesh_4"]


@pytest.mark.parametrize("kw,match", [
    (dict(n_devices=2, device="cpu"), "asked for 2 devices"),
    (dict(devices=["cpu", "cpu"], device="cpu"), "2 devices named"),
    (dict(device="cuda:3"), "CUDA device"),
])
def test_make_mesh_raises_outside_a_group(kw, match):
    """Without a process group the mesh is one rank: asking for two, naming
    two devices, or a CUDA device that does not exist raises."""
    if "cuda" in str(kw.get("device")) and torch.cuda.device_count() > 3:
        pytest.skip("this host has the device")
    with pytest.raises(ValueError, match=match):
        make_mesh(**kw)


def test_make_mesh_of_one_cpu_rank():
    mesh = make_mesh(1, device="cpu")
    assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
    x = torch.arange(6)
    assert mesh.rows(x) is x


@pytest.mark.parametrize("devices,want", [
    (["cpu", "cpu"], "gloo"), (["cuda:0", "cuda:1"], "nccl"),
    (["cuda:0", "cuda:0"], None), (["cpu", "cuda:0"], None)])
def test_default_backend_has_no_fallback(devices, want):
    """nccl for distinct cards, gloo for CPU ranks; any other placement
    must name its backend (two ranks on one card: nccl refuses it)."""
    if want is None:
        with pytest.raises(ValueError, match="pass backend"):
            default_backend(devices)
    else:
        assert default_backend(devices) == want


def test_launcher_fails_fast_when_a_rank_raises():
    """Rank 1 raises while rank 0 waits in an all-reduce: the launch
    raises with rank 1's traceback well before its deadline, and no rank
    is left running."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch(ranks.failing_rank, 2, args=("raise",), devices=CPU2,
               timeout=LAUNCH_S, threads=1)
    assert time.monotonic() - t0 < 120


def test_launcher_raises_on_a_hung_collective():
    """Rank 1 never reaches the all-reduce that rank 0 waits in: rank 0's
    collective times out after its 15 s, and the launch raises with rank
    0's traceback long before its deadline, killing rank 1."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[0\] failed"):
        launch(ranks.failing_rank, 2, args=("hang",), devices=CPU2,
               timeout=LAUNCH_S, collective_timeout=15, threads=1)
    assert time.monotonic() - t0 < 120


def test_launcher_raises_on_a_late_rank():
    """Rank 1 never reaches the collective: the launch raises TimeoutError
    at its deadline (12 s) and kills both ranks."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        launch(ranks.failing_rank, 2, args=("hang",), devices=CPU2,
               timeout=12, threads=1)
    assert time.monotonic() - t0 < 60


def test_ring_linear_scan_matches_jax(inputs, ranked):
    """h of ring_linear_scan over 2 ranks against JAX's over 2 devices
    (1e-5) and one K6 scan over the whole L (plain version, 1e-5); every
    rank holds the same h."""
    from xpoint_tpu.parallel import ring_linear_scan as jx_ring
    a, b = inputs["ring_a"], inputs["ring_b"]
    mesh = _jax_mesh()
    with mesh:
        want = np.asarray(jax.jit(lambda x, y: jx_ring(x, y, mesh))(
            jnp.asarray(a), jnp.asarray(b)))
    got = ranked["ring_h"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    one = linear_scan(T(a), T(b)).numpy()
    np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-5)
    assert ranked["ring_same"]


def test_ring_linear_scan_gradients_match_jax(inputs, ranked):
    """The gradients of sum(h^2) in a and b (the mean over the ranks of
    each rank's, the train step's convention) against JAX's through its
    2-device shard_map, within 1e-4 (JAX's test_ring_scan_gradients)."""
    from xpoint_tpu.parallel import ring_linear_scan as jx_ring
    mesh = _jax_mesh()

    def loss(x, y):
        return (jx_ring(x, y, mesh) ** 2).sum()
    ga, gb = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(inputs["ring_a"]), jnp.asarray(inputs["ring_b"]))
    np.testing.assert_allclose(ranked["ring_ga"].numpy(), np.asarray(ga),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ranked["ring_gb"].numpy(), np.asarray(gb),
                               rtol=1e-4, atol=1e-4)


def test_ring_length_must_divide_the_ranks(ranked):
    assert "not divisible by the mesh size 2" in ranked["ring_odd"]


def test_ring_selective_scan_matches_jax(inputs, ranked):
    """selective_scan(backend="ring") on 2 ranks (the full S6 layout, K
    groups, N = 2) against JAX's ring backend on 2 devices and the port's
    own dispatch on one device: 2e-5, as JAX's test holds its ring to
    assoc."""
    from xpoint_tpu.ops.selective_scan import selective_scan as jx_scan
    from xpoint_tpu.parallel.ring_scan import ring_mesh as jx_ring_mesh
    args = [jnp.asarray(x) for x in inputs["sel"]]
    mesh = _jax_mesh()
    with mesh, jx_ring_mesh(mesh):
        want = np.asarray(jax.jit(lambda *a: jx_scan(*a, backend="ring"))(
            *args))
    got = ranked["sel_y"].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got, ranked["sel_y_direct"].numpy())
    one = selective_scan(*[T(x) for x in inputs["sel"]]).numpy()
    np.testing.assert_allclose(got, one, rtol=2e-5, atol=2e-5)


def test_selective_scan_refuses_an_unknown_backend(inputs):
    with pytest.raises(ValueError, match="unknown selective_scan backend"):
        selective_scan(*[T(x) for x in inputs["sel"]], backend="assoc")


def test_ring_backend_needs_a_mesh(inputs):
    with pytest.raises(RuntimeError, match="needs an active mesh"):
        selective_scan(*[T(x) for x in inputs["sel"]], backend="ring")


def test_ss2d_ring_backend_matches_jax(inputs, ranked):
    """SS2D built with scan_backend="ring" (the canonical-layout scan, L
    sharded over 2 ranks) against the flax SS2D with the ring backend on 2
    devices (2e-5 of JAX's test, 1e-4 here: the port's block carries its
    own roundoff, as test_ss2d_matches_flax holds it) and the port's SS2D
    on one device (its bidirectional scan, 1e-4)."""
    from xpoint_tpu.models.vssm import SS2D as JxSS2D
    from xpoint_tpu.parallel.ring_scan import ring_mesh as jx_ring_mesh
    x, v = inputs["ss2d_x"], inputs["ss2d_v"]
    mesh = _jax_mesh()
    jm = JxSS2D(d_model=8, d_state=1, scan_backend="ring")
    with mesh, jx_ring_mesh(mesh):
        want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    got = ranked["ss2d_y"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    tm = SS2D(8)
    tm.load_state_dict(inputs["ss2d_sd"])
    with torch.no_grad():
        one = tm(T(x)).numpy()
    np.testing.assert_allclose(got, one, rtol=1e-4, atol=1e-4)


def _pairs(kps_o, kps_t, idx, matched):
    return {(tuple(kps_o[i]), tuple(kps_t[idx[i]]))
            for i in np.flatnonzero(matched)}


def test_sharded_pipeline_matches_jax(inputs, ranked):
    """make_sharded_pair_pipeline over 2 ranks (B = 4, 2 a rank) against
    JAX's over 2 devices and the port's pipeline on one device at B = 4:
    probability maps within 1e-5, and per sample the masked keypoint sets
    and the matched pairs equal (as sets: exact ties may be ordered
    otherwise); against one device the integer and mask outputs are equal
    and the float ones within 1e-5 (the convs run at B = 2 against 4)."""
    from xpoint_tpu.eval.pipeline import \
        make_sharded_pair_pipeline as jx_sharded
    jm, v = inputs["jm"], inputs["v"]
    img_o, img_t = inputs["pipe_o"], inputs["pipe_t"]
    ref = jax.device_get(jx_sharded(jm, (64, 64), _jax_mesh(), **PIPE_KW)(
        v, img_o, img_t))
    out = {k: t.numpy() for k, t in ranked["pipe"].items()}
    assert set(out) == set(ref)
    for s in ("optical", "thermal"):
        np.testing.assert_allclose(out[f"prob_{s}"], ref[f"prob_{s}"],
                                   atol=1e-5)
    for b in range(4):
        for s in ("optical", "thermal"):
            mine = {tuple(p) for p, ok in zip(out[f"keypoints_{s}"][b],
                                              out[f"mask_{s}"][b]) if ok}
            theirs = {tuple(p) for p, ok in zip(ref[f"keypoints_{s}"][b],
                                                ref[f"mask_{s}"][b]) if ok}
            assert mine == theirs and mine, (b, s)
        got = _pairs(out["keypoints_optical"][b], out["keypoints_thermal"][b],
                     out["match_idx"][b], out["matched"][b])
        want = _pairs(ref["keypoints_optical"][b], ref["keypoints_thermal"][b],
                      ref["match_idx"][b], ref["matched"][b])
        assert got == want and got
    one = make_pair_pipeline(inputs["tm"], (64, 64), **PIPE_KW)(
        T(img_o), T(img_t))
    for k, t in one.items():
        if t.is_floating_point():
            np.testing.assert_allclose(out[k], t.numpy(), atol=1e-5, rtol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(out[k], t.numpy(), err_msg=k)


def test_sharded_pipeline_no_collectives(ranked):
    """The per-rank pipeline issues no collective (JAX's
    test_sharded_pipeline_no_collectives audits its HLO); a sharded call
    issues exactly one, the gather of each output."""
    c = ranked["pipe_collectives"]
    assert c["inside"] == 0
    assert c["call"] == c["keys"] == 13


def test_sharded_ransac_draws_the_global_batch(inputs, ranked):
    """With the device estimator, each rank keeps its rows of the global
    batch's noise: the sharded H_est and inliers equal one device's call
    on the same generator."""
    one = make_pair_pipeline(inputs["tm"], (64, 64), estimate_homography=True,
                             ransac_iters=16, **PIPE_KW)(
        T(inputs["pipe_o"]), T(inputs["pipe_o"]),
        torch.Generator().manual_seed(3))
    got = ranked["pipe_ransac"]
    for k in ("H_est", "ransac_inliers", "ransac_n_inliers"):
        np.testing.assert_allclose(got[k].double().numpy(),
                                   one[k].double().numpy(), atol=1e-6,
                                   err_msg=k)


def test_sharded_ha_matches_jax(inputs, ranked):
    """make_sharded_ha_fn over 2 ranks (4 samples at 48^2, the homography
    stack replicated) against JAX's over 2 devices with the same analytic
    detector (1e-4, the warps' limit in test_torch_selfsup.py, on all but
    0.5% of the pixels: a mask pixel on a warp's edge may round the other
    way), bit for bit against the port's unsharded program, and one
    collective an output (the gather)."""
    from xpoint_tpu.selfsup.homographic_adaptation import \
        make_sharded_ha_fn as jx_sharded_ha

    def jx_prob_fn(img, is_optical):
        k = jnp.asarray([[0.2, -0.1, 0.3], [0.5, 1.0, -0.4],
                         [0.1, 0.2, -0.3]])
        k = (k if is_optical else k[::-1])[None, None]
        z = jax.lax.conv_general_dilated(
            img.transpose(0, 3, 1, 2), k, (1, 1), "SAME",
            dimension_numbers=("NCHW", "OIHW", "NCHW"))[:, 0]
        return jax.nn.sigmoid(2.0 * z - 1.0) * 0.3

    run, _ = jx_sharded_ha(lambda _: jx_prob_fn, HA_CFG, _jax_mesh())
    ref = run({}, jnp.asarray(inputs["ha_o"]), jnp.asarray(inputs["ha_t"]),
              jnp.asarray(inputs["ha_hs"]))
    got = ranked["ha"]
    assert ranked["ha_collectives"] == 2          # prob and count
    want = np.asarray(ref["prob"])
    p = got["prob"].numpy()
    count = got["count"].numpy()
    single, _ = ha.make_ha_fn(ranks.ha_prob_fn, HA_CFG)
    one = single(T(inputs["ha_o"]), T(inputs["ha_t"]), T(inputs["ha_hs"]))
    np.testing.assert_array_equal(p, one["prob"].numpy())
    np.testing.assert_array_equal(count, one["count"].numpy())
    close = np.abs(p - want) <= 1e-4
    assert close.mean() > 0.995
    assert p.max() > 0.05


def test_sharded_export_equals_one_device(inputs, ranked):
    """export_keypoints over 2 ranks (batch 2: one sample a rank, the
    chunk's homography stack on both) writes from rank 0 the labels the
    one-device export writes with batch 2, sample by sample."""
    ref = NumpySink()
    n = export_keypoints(
        inputs["tm"], ranks.PairImages(inputs["export_o"],
                                       inputs["export_t"]),
        ref, EXPORT_HA, EXPORT_PRED, seed=3, batch=2)
    assert ranked["export_n"] == n == 4
    got = ranked["export"]
    assert sorted(got) == sorted(ref.groups)
    for name, arrays in ref.groups.items():
        assert set(got[name]) == {"keypoints_optical", "keypoints_thermal"}
        for k, want in arrays.items():
            np.testing.assert_array_equal(got[name][k], want,
                                          err_msg=f"{name}/{k}")
    assert any(len(a["keypoints_optical"]) for a in ref.groups.values())


def test_export_entry_point_defaults_to_a_batch_of_the_ranks(tmp_path):
    """cli.export_keypoints' rank path (``_export``, what ``main`` runs on
    each of several GPUs) launched on 2 CPU ranks (gloo) with no --batch:
    batches of 2, sharded, rank 0 writing the file; the labels equal the
    one-rank run with --batch 2. On the CPU ``main`` runs one rank."""
    from xpoint_tpu_torch.cli import export_keypoints as cli
    from xpoint_tpu_torch.cli._common import rank_count
    from xpoint_tpu_torch.config import save_yaml
    from xpoint_tpu_torch.data.group_file import open_group_file
    from xpoint_tpu_torch.tools import make_mini_corpus as corpus

    tm = build_xpoint(tiny_cfg(), device="cpu")[0]
    model_dir = str(tmp_path / "model")
    os.makedirs(model_dir)
    save_yaml({"model": tiny_cfg()}, os.path.join(model_dir, "params.yaml"))
    torch.save({"module": tm.state_dict()},
               os.path.join(model_dir, "latest.pt"))
    corpus.main(["--out", str(tmp_path / "corpus"), "--n-test", "2",
                 "--size", "64", "--splits", "test"])
    cfg = {"dataset": {"type": "ImagePairDataset",
                       "filename": str(tmp_path / "corpus" / "test.npz"),
                       "single_image": False, "augmentation": {}},
           "prediction": EXPORT_PRED, "homographic_adaptation": EXPORT_HA}
    yaml_path = str(tmp_path / "export.yaml")
    save_yaml(cfg, yaml_path)
    argv = ["-y", yaml_path, "-m", model_dir, "--device", "cpu", "-s", "3"]
    assert cli.parse_args(argv + ["-o", "x"]).batch is None
    assert rank_count(cli.parse_args(argv + ["-o", "x"])) == 1
    assert launch(cli._export, 2, args=(cli.parse_args(
        argv + ["-o", str(tmp_path / "two.npz")]),), devices=CPU2,
        timeout=LAUNCH_S, threads=2) == 2
    assert cli.main(argv + ["-o", str(tmp_path / "one.npz"), "--batch",
                            "2"]) == 2
    with open_group_file(str(tmp_path / "two.npz")) as a, \
            open_group_file(str(tmp_path / "one.npz")) as b:
        assert a.keys() == b.keys() and len(a.keys()) == 2
        for name in a.keys():
            for k in ("keypoints_optical", "keypoints_thermal"):
                np.testing.assert_array_equal(a[name][k], b[name][k])


def test_import_check_covers_the_parallel_package():
    """The AST rule of test_torch_pipeline.py (no jax, flax or xpoint_tpu
    in the port) walks the parallel package's modules too."""
    from test_torch_pipeline import ROOT, _imports, _port_files
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    mine = {f"xpoint_tpu_torch/parallel/{n}.py"
            for n in ("__init__", "mesh", "launch", "ring_scan")}
    assert mine <= files
    for path in sorted(mine):
        roots = {n.split(".")[0] for n in _imports(os.path.join(ROOT, path))}
        assert not roots & {"jax", "jaxlib", "flax", "optax", "xpoint_tpu"}
