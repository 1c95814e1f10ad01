"""``eval.benchmark.model_cost``: the FLOPs and bytes of one pair forward,
against the JAX package's ``model_cost`` (XLA's cost analysis) on the CPU.

A CNN model runs no hand-written kernel. Its count is the products that
``torch.utils.flop_counter.FlopCounterMode`` sees (convolutions, matmuls);
XLA also counts one operation an element of each elementwise op (BatchNorm,
ReLU, the softmax, the normalisation), 2.4-2.9% of the total on these
models. So the port's count lies within [0.95, 1.0] of JAX's.

The flagship's scans run in the hand-written kernel K1 on the card and in
its plain version here; ``kernels/cost.py`` counts K1's work from its
shapes on either route, so the count does not depend on the route: the
tiny flagship gives the same numbers with the plain version and with the
kernel's route forced (its launch replaced by another plain order that
issues other operators), and its K1 terms are the bound's formulas of
chip_smoke.py and PERF.md section 6 at each block's shapes.
"""
import jax
import pytest

from xpoint_tpu.eval.benchmark import model_cost as jx_model_cost

from xpoint_tpu_torch.compat.from_flax import load_flax_variables
from xpoint_tpu_torch.eval.benchmark import model_cost
from xpoint_tpu_torch.models import build_xpoint
from xpoint_tpu_torch.ops import selective_scan_cuda as ssc

from test_torch_cnn import cnn_cfg, jax_cnn
from test_torch_models import tiny_cfg
from torch_env import torch_env  # noqa: F401 (autouse)


@pytest.mark.parametrize("cfg", [
    cnn_cfg(), cnn_cfg(multispectral=False, spectral_norm_stats=False)],
    ids=["two_encoders", "one_encoder"])
def test_cnn_flops_match_jax(cfg):
    jm, v = jax_cnn(cfg)
    want = jx_model_cost(jm, v, (64, 64), batch=2)
    tm, _ = build_xpoint(cfg, device="cpu")
    load_flax_variables(tm, jax.device_get(v))
    tm.train()                  # counted in eval mode, as JAX's train=False
    got = model_cost(tm, (64, 64), batch=2)
    assert set(got) >= {"flops", "bytes_accessed", "cost_analysis"}
    assert 0.95 * want["flops"] <= got["flops"] <= want["flops"]
    assert got["kernels"] == {}
    assert got["cost_analysis"]["kernel flops"] == 0
    assert got["bytes_accessed"] > 0
    assert tm.training          # its mode given back


def _k1_terms(cfg, batch, hw):
    """K1's work at each VSS block of the tiny flagship (cross2d, N = 1,
    ssm_ratio 1): L = H_i W_i tokens, Dim = embed 2^i channels, M = 2 B Dim
    lanes, G = 2 B groups; serving's bound: bytes 2 (5 L M + 4 L G) +
    48 Dim, operations 2 x 14 L M. Two images a pair."""
    vssm = cfg["use_attention"]["model_parameters"]["MODEL"]["VSSM"]
    nbytes = flops = launches = 0
    for i, depth in enumerate(vssm["DEPTHS"]):
        L = (hw[0] // 4 >> i) * (hw[1] // 4 >> i)
        Dim = vssm["EMBED_DIM"] * 2 ** i
        M, G = 2 * batch * Dim, 2 * batch
        n = 2 * depth
        launches += n
        nbytes += n * (2 * (5 * L * M + 4 * L * G) + 3 * 4 * 4 * Dim)
        flops += n * 2 * 14 * L * M
    return launches, nbytes, flops


def test_flagship_count_is_the_same_on_either_route(monkeypatch):
    cfg = tiny_cfg()
    tm, _ = build_xpoint(cfg, device="cpu")
    plain = model_cost(tm, (64, 64), batch=2)

    def other_order(u_t, dt_t, bc_t, cc_t, A, D, delta_bias, emit_ckpt):
        ssc.selective_scan_bidir.launches += 1
        out = ssc.selective_scan_bidir_chunked(u_t, dt_t, bc_t, cc_t, A, D,
                                               delta_bias, segments=4)
        return tuple(x * 1.0 for x in out)[:2]
    monkeypatch.setattr(ssc, "_device_kind", lambda x, what: "cuda")
    monkeypatch.setattr(ssc, "_launch", other_order)
    before = ssc.selective_scan_bidir.launches
    routed = model_cost(tm, (64, 64), batch=2)
    assert ssc.selective_scan_bidir.launches - before == 8
    assert routed == plain

    launches, nbytes, flops = _k1_terms(cfg, 2, (64, 64))
    assert plain["kernels"] == {"selective_scan_bidir": {
        "launches": launches, "bytes": nbytes, "flops": flops,
        "transcendentals": flops * 6 // 28}}
    ca = plain["cost_analysis"]
    assert ca["kernel flops"] == flops and ca["kernel launches"] == 8
    assert plain["flops"] == ca["operator flops"] + flops
    assert plain["bytes_accessed"] == ca["operator bytes accessed"] + nbytes
