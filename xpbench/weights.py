"""The model's weights, made on the device from the seed.

One draw of uniform numbers on the device covers every parameter; each
parameter is then shaped from its slice by the distribution that XPoint's
initialisers give that kind of parameter (the VMamba ``mamba_init`` draws,
truncated normals of std 0.02 for the encoders' dense layers, LeCun
normals for convolutions and the homography head). What those initialisers
set to a constant is drawn too, about that constant, so that no bias add,
norm affine, BatchNorm statistic or scan parameter is an identity and a
program that drops or misapplies one reads as not correct: biases and
norm shifts 0.02 N(0, 1) (truncated at two standard deviations), norm
scales 1 + 0.1 N, BatchNorm running means 0.1 N and variances uniform in
[0.5, 1.5], the scan's skip ``Ds`` 1 + 0.1 N and its ``A_logs`` their
``mamba_init`` value + 0.3 N, SwinV2's ``logit_scale`` log(10) + 0.1 N.
The same state is loaded into the program's module and into the
reference.
"""
import math

import torch

_TRUNC_STD = 0.87962566103423978   # std of N(0, 1) truncated to [-2, 2]
_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
_LECUN = ("hm_regressor.", "cpb_fc")


def _trunc_normal(u, std):
    x = torch.erfinv(2.0 * (u * (_HI - _LO) + _LO) - 1.0) * math.sqrt(2.0)
    return (x * std).clamp(-2.0 * std, 2.0 * std)


def _kind(name, shape):
    """(draws?, how) for one entry of the state. Every entry but
    ``num_batches_tracked`` draws."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "num_batches_tracked":
        return False, "zeros"
    if leaf in ("q_bias", "v_bias", "bias"):
        return True, "bias"
    if leaf == "running_mean":
        return True, "running_mean"
    if leaf == "running_var":
        return True, "running_var"
    if leaf == "Ds" or (leaf == "weight" and len(shape) == 1):
        return True, "scale"
    if leaf == "A_logs":
        return True, "a_logs"
    if leaf == "logit_scale":
        return True, "log10"
    if leaf == "dt_projs_bias":
        return True, "dt_bias"
    if leaf == "dt_projs_weight":
        return True, "dt_weight"
    if len(shape) == 4 or any(t in name for t in _LECUN):
        return True, "lecun"
    return True, "normal02"


def make_state(shapes, seed, device):
    """{name: tensor} for ``shapes`` ({name: shape}, parameters and
    buffers), from ``seed`` on ``device``, float32. The draw is sliced in
    the order of the names, so it does not depend on the order given."""
    shapes = dict(sorted(shapes.items()))
    kinds = {n: _kind(n, s) for n, s in shapes.items()}
    total = sum(math.prod(s) for n, s in shapes.items() if kinds[n][0])
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device)
    state, off = {}, 0
    for name, shape in shapes.items():
        draws, how = kinds[name]
        n = math.prod(shape)
        if draws:
            x, off = u[off:off + n].reshape(shape), off + n
        if how == "zeros":
            t = torch.zeros(shape, device=device)
        elif how == "bias":
            t = _trunc_normal(x, 0.02)
        elif how == "running_mean":
            t = _trunc_normal(x, 0.1)
        elif how == "running_var":
            t = 0.5 + x
        elif how == "scale":
            t = 1.0 + _trunc_normal(x, 0.1)
        elif how == "log10":
            t = math.log(10.0) + _trunc_normal(x, 0.1)
        elif how == "a_logs":
            t = torch.log(torch.arange(1, shape[-1] + 1, device=device,
                                       dtype=torch.float32)).expand(shape)
            t = t + _trunc_normal(x, 0.3)
        elif how == "dt_bias":
            dt = torch.exp(x * (math.log(0.1) - math.log(1e-3))
                           + math.log(1e-3)).clamp_min(1e-4)
            t = dt + torch.log(-torch.expm1(-dt))
        elif how == "dt_weight":
            t = x * (2.0 * shape[-1] ** -0.5)
        elif how == "lecun":
            t = _trunc_normal(x, math.sqrt(1.0 / math.prod(shape[1:]))
                              / _TRUNC_STD)
        else:
            t = _trunc_normal(x, 0.02)
        state[name] = t.contiguous()
    return state
