"""``work.py`` counts what the program's ``kernels/cost.py`` counts: the
kernel formulas at the four cells' shapes, the peaks, and a forward's
products by precision (the reference's count against the program's
``eval.benchmark.model_cost``)."""
import json
import os

import pytest
import torch

from xpbench import reference, work
from tiny import ALL_CELLS, ROOT, cell

from xpoint_tpu_torch.kernels import cost



def _cell(name):
    """(configuration, image, batch, training?) of a cell."""
    c = cell(name)
    return (c.config["name"], tuple(c.traffic["image"]), c.traffic["batch"],
            c.traffic["kind"] == "train")


def _config(name):
    with open(os.path.join(ROOT, "xpbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_peaks():
    assert work.PEAK_FLOP_PER_S["bfloat16"] == cost.BF16_TENSOR_FLOP_PER_S
    assert work.PEAK_FLOP_PER_S["float32"] == cost.FP32_FLOP_PER_S
    assert work.HBM_BYTES_PER_S == cost.HBM_BYTES_PER_S


@pytest.mark.parametrize("name", ALL_CELLS)
def test_kernel_formulas(name):
    cfg, hw, batch, train = _cell(name)
    launches = work.scan_launches(_config(cfg)["model"], hw, batch)
    assert len(launches) == (8 if cfg == "xpoint-vmamba" else 0)
    for L, M, G, Dim in launches:
        assert work.scan_bidir(L, M, G, Dim, train) == cost.scan_bidir(
            L, M, G, Dim, train)
        assert work.scan_bidir_bwd(L, M, G) == cost.scan_bidir_bwd(L, M, G)
        assert work.bound_s(work.scan_bidir(L, M, G, Dim)) * 1e3 == \
            cost.bound_ms(cost.scan_bidir(L, M, G, Dim))[0]


@pytest.mark.parametrize("cfg", ["xpoint-vmamba", "xpoint-swinv2"])
def test_launch_shapes_are_the_programs(cfg):
    """The (L, M, G, Dim) of each K1 launch, as the program records them
    at 128 x 128, batch 2."""
    from xpoint_tpu_torch.eval.benchmark import model_cost
    from xpoint_tpu_torch.models.xpoint import build_xpoint
    config = _config(cfg)
    module, _ = build_xpoint(config["model"], device="cpu")
    res = model_cost(module, (128, 128), batch=2)
    k1 = res["kernels"].get("selective_scan_bidir", {"launches": 0,
                                                     "bytes": 0})
    launches = work.scan_launches(config["model"], (128, 128), 2)
    assert k1["launches"] == 2 * len(launches)
    assert k1["bytes"] == 2 * sum(work.scan_bidir(*s)["bytes"]
                                  for s in launches)


@pytest.mark.parametrize("cfg", ["xpoint-vmamba", "xpoint-swinv2"])
def test_products_by_precision(cfg):
    """A pair forward's products at 256 x 256 (RegNet's maps 16 x 16), as
    the reference counts them and as the program's counter sees them."""
    from xpoint_tpu_torch.eval.benchmark import model_cost
    from xpoint_tpu_torch.models.xpoint import build_xpoint
    config = _config(cfg)
    module, _ = build_xpoint(config["model"], device="cpu")
    ca = model_cost(module, (256, 256), batch=1)["cost_analysis"]
    model, prec = reference.build(config["model"], config["precision"], None,
                                  "meta", count=True)
    img = torch.zeros(1, 256, 256, 1, device="meta")
    with torch.no_grad():
        model.forward_pair(img, img)
    assert prec.flops["bfloat16"] == ca["operator bf16 flops"]
    assert prec.flops["float32"] == (ca["operator flops"]
                                     - ca["operator bf16 flops"])
