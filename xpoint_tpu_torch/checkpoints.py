"""Training checkpoints as torch files (port of
``xpoint_tpu/checkpoints.py:1-64``, which writes orbax directories).

``<output_dir>/<name>.pt`` holds the module's ``state_dict`` (parameters
and BatchNorm running statistics), the Adam state (moments by parameter
name and the count), the step and the epoch. Names are ``e{N}`` and
``latest``; a checkpoint without an epoch takes it from its ``e{N}`` name.
:func:`restore` loads all of it into a :class:`TrainState` in place, bit
for bit.
"""
import os
import re

import torch


def _path(output_dir, name):
    return os.path.join(output_dir, f"{name}.pt")


def save(output_dir, state, name, epoch):
    opt = state.opt_state
    payload = {
        "module": {k: v.detach().cpu()
                   for k, v in state.module.state_dict().items()},
        "opt_state": {"count": opt["count"].cpu(),
                      "mu": {n: t.cpu() for n, t in zip(state.names,
                                                        opt["mu"])},
                      "nu": {n: t.cpu() for n, t in zip(state.names,
                                                        opt["nu"])}},
        "step": state.step.cpu(),
        "epoch": int(epoch),
    }
    path = _path(output_dir, name)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)


def restore(output_dir, state, name="latest"):
    """Load ``<name>.pt`` into ``state`` (module, Adam state, step). Returns
    (state, epoch), or (None, 0) when the checkpoint is absent."""
    path = _path(output_dir, name)
    if not os.path.exists(path):
        return None, 0
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.module.load_state_dict(payload["module"], strict=True)
    opt = state.optimizer
    with torch.no_grad():
        for flat, key in ((opt.mu, "mu"), (opt.nu, "nu")):
            saved = payload["opt_state"][key]
            if set(saved) != set(state.names):
                raise KeyError(f"{path}: the optimiser state names other "
                               f"parameters than the model's")
            flat.copy_(torch.cat([saved[n].reshape(-1)
                                  for n in state.names]))
        opt.count.copy_(payload["opt_state"]["count"])
        state.step.copy_(payload["step"])
    epoch = payload.get("epoch", 0)
    if not epoch:
        m = re.match(r"e(\d+)", name)
        epoch = int(m.group(1)) if m else 0
    return state, epoch


def latest_epoch(output_dir):
    """Highest e{N} checkpoint number in a model dir."""
    best = 0
    for f in os.listdir(output_dir):
        m = re.match(r"e(\d+)\.pt$", f)
        if m:
            best = max(best, int(m.group(1)))
    return best
