"""Per-stage roofline of the flagship 512^2 forward on the H100 (port of
``tools/roofline.py``).

One encoder pass is cut into its stages as the JAX tool cuts it: the
patch embedding, each stage's VSS blocks (and within them one block's
SS2D alone, without the MLP), the downsamples, and the heads (timed on an
encoder output, where the JAX tool takes the full forward less the
encoder: a difference of two noisy times). Each stage is timed at the flagship's geometry
over never-repeated inputs made on the card beforehand, dispatched as a
stream and fenced once, and its work is counted by
``kernels/cost.py`` (the operators through FlopCounterMode, the
hand-written kernels from their shapes). Its bound is the longest of

  t_tensor = bf16 product FLOPs / 989e12 FLOP/s (dense bf16 tensor cores)
  t_fp32   = other FLOPs (fp32 products, the scan kernels) / 67e12 FLOP/s
  t_hbm    = bytes / 3.35e12 B/s (HBM3)
  t_sfu    = transcendentals / the exp rate measured on the card

(the peaks of the NVIDIA H100 SXM5 80 GB data sheet, the card the port
targets; the exp rate is calibrated on the card by a chain of 64 exps an
element in one jiterator kernel, in place of the JAX tool's VPU
calibration). achieved = t_bound / t_measured; a stage above 1 would mean
that its count is wrong.

    python -m xpoint_tpu_torch.tools.roofline [--out outputs/roofline.json]
        [-B 8] [--device cuda]
"""
import argparse
import json
import os
import time

import torch
import torch.nn.functional as F

from ..kernels import cost
from ..models.vssm import layer_norm

N_ITERS = 10


def fence(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_stream(fn, make_input, n=N_ITERS):
    """ms a call of ``fn`` over a stream of n fresh inputs, made and
    fenced before the clock starts, after one warm-up call; one fence at
    the end (the card runs the calls in dispatch order)."""
    inputs = [make_input() for _ in range(n + 1)]
    dev = inputs[0].device
    fence(dev)
    with torch.no_grad():
        fn(inputs[0])
        fence(dev)
        t0 = time.perf_counter()
        for x in inputs[1:]:
            fn(x)
        fence(dev)
    return (time.perf_counter() - t0) / n * 1e3


def calibrate_exp_rate(device, n=1 << 24, chain=64):
    """exps a second in one elementwise kernel that chains ``chain`` exps
    on each element in registers (jiterator: compiled on the card), so
    that its bytes are amortised: the card's exp throughput. On the CPU
    (no jiterator) the same chain through torch.exp."""
    if torch.device(device).type == "cuda":
        from torch.cuda.jiterator import _create_jit_fn
        code = ("template <typename T> T exp_chain(T x) {"
                f" for (int i = 0; i < {chain}; ++i) x = exp(x * T(1e-6));"
                " return x; }")
        fn = _create_jit_fn(code)
    else:
        def fn(x):
            for _ in range(chain):
                x = torch.exp(x * 1e-6)
            return x
    gen = torch.Generator(device=device).manual_seed(0)
    ms = time_stream(fn, lambda: torch.rand(n, generator=gen,
                                             device=device), n=8)
    return n * chain / (ms / 1e3)


def bounds(work, exp_rate):
    """(the stage's t_* in ms, bound name, bound ms) of a cost result."""
    ca = work["cost_analysis"]
    tensor = ca["operator bf16 flops"]
    t = {"tensor": tensor / cost.BF16_TENSOR_FLOP_PER_S * 1e3,
         "fp32": (ca["flops"] - tensor) / cost.FP32_FLOP_PER_S * 1e3,
         "hbm": ca["bytes accessed"] / cost.HBM_BYTES_PER_S * 1e3,
         "sfu": ca["transcendentals"] / exp_rate * 1e3}
    name = max(t, key=t.get)
    return t, name, t[name]


def count(fn, x):
    with torch.no_grad(), cost.count() as c:
        fn(x)
    return c.result()


def probe(name, fn, make_input, rows, exp_rate, n=N_ITERS):
    """Time one stage, count its work, append its row; returns its ms."""
    ms = time_stream(fn, make_input, n)
    return add_row(name, ms, count(fn, make_input()), rows, exp_rate)


def add_row(name, ms, work, rows, exp_rate):
    t, bound, t_bound = bounds(work, exp_rate)
    ca = work["cost_analysis"]
    rows.append(dict(
        stage=name, ms=ms, gflop=ca["flops"] / 1e9,
        mb=ca["bytes accessed"] / 1e6, transc_m=ca["transcendentals"] / 1e6,
        kernel_launches=ca["kernel launches"],
        **{f"t_{k}_ms": v for k, v in t.items()}, bound=bound,
        bound_ms=t_bound, achieved=t_bound / ms if ms > 0 else None))
    share = 100 * t_bound / ms if ms > 0 else float("nan")
    print(f"{name:24s} {ms:8.3f} ms  roof[{bound}] {t_bound:7.3f} ms  -> "
          f"{share:5.1f}% of roof  ({ca['flops'] / 1e9:8.2f} "
          f"GF, {ca['bytes accessed'] / 1e6:8.1f} MB, "
          f"{ca['transcendentals'] / 1e6:7.2f} Mexp)", flush=True)
    return ms


def stage_table(module, B, S=512, exp_rate=None):
    """The rows of every stage of ``module``'s VMamba encoder at (B, S, S)
    and the module's heads; the encoder's dtype is the model's."""
    dev = next(module.parameters()).device
    enc = module.encoder
    dt = enc.dtype
    gen = torch.Generator(device=dev).manual_seed(0)
    exp_rate = exp_rate or calibrate_exp_rate(dev)
    rows = []

    def img():
        return torch.rand(B, S, S, 1, generator=gen, device=dev)

    def act(r, d):
        return lambda: torch.rand(B, r, r, d, generator=gen,
                                  device=dev).to(dt)

    def patch_embed(x):
        x = torch.cat([x, x, x], dim=-1).to(dt)
        x = layer_norm(enc.patch_embed_norm1, enc.patch_embed_conv1(x))
        x = F.gelu(x, approximate="tanh")
        return layer_norm(enc.patch_embed_norm2, enc.patch_embed_conv2(x))

    probe("patch_embed", patch_embed, img, rows, exp_rate)
    dims = [getattr(enc, f"layers_{i}_blocks_0").norm.normalized_shape[0]
            for i in range(len(enc.depths))]
    for i, depth in enumerate(enc.depths):
        blocks = [getattr(enc, f"layers_{i}_blocks_{j}")
                  for j in range(depth)]

        def run_blocks(x, blocks=blocks):
            for blk in blocks:
                x = blk(x)
            return x

        def ss2d(x, blk=blocks[0]):
            return x + blk.op(layer_norm(blk.norm, x))

        r = S // 4 >> i
        probe(f"stage{i}_blocks({depth})", run_blocks, act(r, dims[i]),
              rows, exp_rate)
        probe(f"stage{i}_ss2d_x1", ss2d, act(r, dims[i]), rows, exp_rate)
        if i < len(enc.depths) - 1:
            conv = getattr(enc, f"layers_{i}_downsample_conv")
            norm = getattr(enc, f"layers_{i}_downsample_norm")
            probe(f"down{i}", lambda x, c=conv, n=norm: layer_norm(n, c(x)),
                  act(r, dims[i]), rows, exp_rate)

    def heads(x):
        """forward_impl after the encoder: the detector and descriptor
        heads and the descriptors' normalisation."""
        out = {"logits": module.detector_head(x, "optical")}
        if hasattr(module, "descriptor_head"):
            desc = module.descriptor_head(x, "optical")
            if module.normalize_descriptors:
                desc = desc / torch.linalg.vector_norm(
                    desc, dim=-1, keepdim=True).clamp_min(1e-12)
            out["desc"] = desc
        out["encoder_output"] = x.float()
        return out

    def full(x):
        return module(x, "optical")

    with torch.no_grad():
        enc_shape = module.encode(img(), "optical").shape
    probe("heads", heads, lambda: torch.rand(
        enc_shape, generator=gen, device=dev).to(dt), rows, exp_rate)
    ms_full = time_stream(full, img)
    ca = count(full, img())["cost_analysis"]
    rows.append(dict(stage="one_full_forward", ms=ms_full,
                     gflop=ca["flops"] / 1e9, mb=ca["bytes accessed"] / 1e6,
                     transc_m=ca["transcendentals"] / 1e6,
                     kernel_launches=ca["kernel launches"]))
    print(f"{'one_full_forward':24s} {ms_full:8.3f} ms (x2 passes/pair-batch)",
          flush=True)
    return rows, exp_rate


def main(argv=None):
    from ..models import VMAMBA_MODEL_CFG, build_xpoint
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="outputs/roofline.json")
    ap.add_argument("-B", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("# calibrating the exp rate...", flush=True)
    exp_rate = calibrate_exp_rate(args.device)
    print(f"# measured exp throughput: {exp_rate / 1e9:.1f} Gexp/s",
          flush=True)
    module, _ = build_xpoint(VMAMBA_MODEL_CFG, device=args.device, seed=0)
    module.eval()
    rows, _ = stage_table(module, args.B, exp_rate=exp_rate)
    out = dict(B=args.B, exp_rate_gexps=exp_rate / 1e9,
               peaks={"bf16_tensor_flops": cost.BF16_TENSOR_FLOP_PER_S,
                      "fp32_flops": cost.FP32_FLOP_PER_S,
                      "hbm_bytes_per_s": cost.HBM_BYTES_PER_S,
                      "source": "NVIDIA H100 SXM5 80 GB data sheet"},
               device=(torch.cuda.get_device_name(args.device)
                       if torch.device(args.device).type == "cuda"
                       else "cpu"),
               stages=rows)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"written to {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
