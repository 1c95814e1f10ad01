"""The work of a call or step on the card, and the card's peaks.

The kernel formulas are frozen copies of the program's
``kernels/cost.py`` (each input byte read once, each output byte written
once; the operations a lane does), so that a later change to the program
cannot move the yardstick. The products of the model are counted on the
reference (``reference.ops.Prec``) at the cell's shapes, each at the
precision the configuration states for it.

Peaks: NVIDIA H100 SXM5 80 GB data sheet, dense, at its 700 W limit:
989e12 FLOP/s bf16 on the tensor cores, 67e12 FLOP/s float32 outside them,
3.35e12 B/s of HBM. A card set below 700 W (``nvidia-smi``'s
``power.limit``, printed beside every run) reaches less.
"""
import torch

PEAK_FLOP_PER_S = {"bfloat16": 989e12, "float16": 989e12,
                   "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
CKPT_CHUNK = 256


def _work(nbytes, flops, transcendentals=0):
    return {"bytes": int(nbytes), "flops": int(flops),
            "transcendentals": int(transcendentals)}


def scan_bidir(L, M, G, Dim, emit_ckpt=False):
    """K1, the bidirectional scan: bf16 u, dt_f, dt_r in and y_f, y_r out
    (L x M), compact B and C of both directions (L x G); serving reads
    three fp32 (4 Dim,) vectors, training writes the fp32 entry states of
    256-token chunks. 14 fp32 operations a lane a step a direction."""
    if emit_ckpt:
        nbytes = (2 * (5 * L * M + 4 * L * G)
                  + 4 * 2 * -(-L // CKPT_CHUNK) * M)
    else:
        nbytes = 2 * (5 * L * M + 4 * L * G) + 3 * 4 * 4 * Dim
    return _work(nbytes, 2 * 14 * L * M, 2 * 3 * L * M)


def scan_bidir_bwd(L, M, G):
    """K3, the scan's backward: u, dt_f, dt_r, g_f, g_r, compact B and C
    and the checkpoints in, du, ddt_f, ddt_r, dB, dC out; 40 operations a
    lane a step a direction."""
    nbytes = 2 * (8 * L * M + 8 * L * G) + 4 * 2 * -(-L // CKPT_CHUNK) * M
    return _work(nbytes, 2 * 40 * L * M, 2 * 3 * L * M)


def bound_s(work, flop_per_s=PEAK_FLOP_PER_S["float32"]):
    """The least seconds for ``work`` at the memory rate or at
    ``flop_per_s``, whichever is longer."""
    return max(work["bytes"] / HBM_BYTES_PER_S, work["flops"] / flop_per_s)


def scan_launches(model_cfg, image_hw, batch):
    """(L, M, G, Dim) of each K1 launch of one forward of a VMamba encoder
    at ``image_hw`` and ``batch``: one a block, the stage's tokens L, lanes
    M = B * 2 * Dim, groups G = B * 2. Empty for other encoders."""
    ua = model_cfg["use_attention"]
    if ua.get("type") != "VMamba":
        return []
    vssm = ua["model_parameters"]["MODEL"]["VSSM"]
    H, W = image_hw[0] // 4, image_hw[1] // 4
    out = []
    for i, depth in enumerate(vssm["DEPTHS"]):
        dim = int(vssm["EMBED_DIM"]) * 2 ** i
        hs, ws = H >> i, W >> i
        out += [(hs * ws, batch * 2 * dim, batch * 2, dim)] * depth
    return out


def least_seconds(flops):
    """The least seconds for {precision: flops} at the card's peaks, the
    classes one after the other."""
    return sum(f / PEAK_FLOP_PER_S[p] for p, f in flops.items())


def _add(total, part):
    for k, v in part.items():
        total[k] = total.get(k, 0) + v
    return total


def count(config, traffic):
    """{precision: flops} of one call (serving) or one step (training) of
    the cell: the reference's products on meta tensors at the cell's
    shapes, plus the scan's operations (K1, and K3 in training) and, in
    serving, the matching product, in float32."""
    from . import reference
    from .reference.train import xpoint_loss
    H, W = traffic["image"]
    B = traffic["batch"]
    model, prec = reference.build(config["model"], config["precision"], None,
                                  "meta", count=True)
    launches = scan_launches(config["model"], (H, W), B)
    scan = sum(scan_bidir(*s)["flops"] for s in launches) * 2
    img = torch.zeros(B, H, W, 1, device="meta")
    if traffic["kind"] == "serve":
        with torch.no_grad():
            model(img)
            model(img)
        k, D = traffic["k"], int(config["model"].get("descriptor_size", 256))
        return _add(dict(prec.flops), {"float32": scan + 2 * B * k * k * D})
    model.train()
    for p in model.parameters():
        p.requires_grad_(True)
    o = {"image": img, "keypoints": torch.zeros(B, H, W, device="meta"),
         "valid_mask": torch.zeros(B, H, W, device="meta"),
         "homography": torch.zeros(B, 3, 3, device="meta")}
    batch = {"optical": o, "thermal": dict(o),
             "hfour_points": torch.zeros(B, 4, 2, device="meta")}
    po, pt, hm = model.forward_pair(img, img)
    xpoint_loss(batch, po, pt, hm, config["loss"], None, prec)
    bwd = sum(scan_bidir_bwd(s[0], s[1], s[2])["flops"] for s in launches)
    return _add(dict(prec.flops), {"float32": scan + 2 * bwd})
