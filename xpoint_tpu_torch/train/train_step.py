"""The training step: forward pair + loss + gradients + Adam (port of
``xpoint_tpu/parallel/train_step.py:19-151`` and
``xpoint_tpu/trainer.py:32-69::make_optimizer``).

PyTorch runs eagerly, so the state lives in the module (parameters,
BatchNorm running statistics) and in :class:`TrainState` (step count, Adam
moments, the optional per-epoch learning rate), and a step updates them in
place. Mixed precision is the JAX step's: fp32 parameters, activations in
the model dtype, no autocast and no loss scaling. Its non-finite skip plays
GradScaler's role: a step whose loss or any gradient is not finite leaves
parameters, Adam moments, the step count and the BatchNorm running
statistics exactly as they were.
"""
import functools

import torch


def make_optimizer(training_cfg):
    """Adam from the ``training:`` config (learningrate, weight_decay,
    scheduler): optax ``chain(add_decayed_weights(wd)?, scale_by_adam(),
    scale(-lr))`` is ``torch.optim.Adam(weight_decay=wd)`` (torch-style L2,
    g += wd * p before the moments; b1 0.9, b2 0.999, eps 1e-8 on both
    sides). Returns (tx, lr_at_epoch): ``tx(params)`` builds the optimiser;
    with a StepLR / ExponentialLR scheduler, ``lr_at_epoch(epoch)`` is the
    torch scheduler's learning rate for that epoch, to be set on
    ``TrainState.lr`` once per epoch; without one it is None and the
    optimiser's own lr applies."""
    lr = float(training_cfg.get('learningrate', 1e-4))
    sched = training_cfg.get('scheduler', {}) or {}
    lr_at_epoch = None
    if sched.get('use_scheduler'):
        stype = sched.get('type', 'ExponentialLR')
        gamma = float(sched.get('gamma', 0.9))
        step_size = int(sched.get('step_size', 1))
        if stype == 'StepLR':
            lr_at_epoch = (  # noqa: E731
                lambda e: lr * gamma ** (e // step_size))
        elif stype == 'ExponentialLR':
            lr_at_epoch = lambda e: lr * gamma ** e  # noqa: E731
        else:
            raise ValueError(f"unknown scheduler {stype}")
    wd = float(training_cfg.get('weight_decay', 0) or 0)
    return functools.partial(torch.optim.Adam, lr=lr,
                             weight_decay=wd), lr_at_epoch


class TrainState:
    """Counterpart of the JAX TrainState for a module trained in place:
    ``step`` (int), the module's parameters and BatchNorm statistics,
    ``optimizer`` (``tx(params)``), and ``lr`` (the per-epoch learning
    rate, or None for the optimiser's own)."""

    def __init__(self, module, tx, lr=None):
        self.module = module
        self.names = [n for n, _ in module.named_parameters()]
        self.params = [p for _, p in module.named_parameters()]
        self.optimizer = tx(self.params)
        self.step = 0
        self.lr = lr

    @property
    def opt_state(self):
        """optax's ScaleByAdamState after the first step: count, and the
        moments mu, nu in parameter order."""
        st = [self.optimizer.state[p] for p in self.params]
        return {"count": self.step, "mu": [s["exp_avg"] for s in st],
                "nu": [s["exp_avg_sq"] for s in st]}

    def batch_stats(self):
        return {n: b for n, b in self.module.named_buffers()
                if n.endswith(("running_mean", "running_var"))}

    def apply_gradients(self, grads):
        if self.lr is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad()
        self.step += 1


def make_train_step(module, loss_fn, batch_fn=None):
    """The pair train step: ``step(state, batch, gen) -> components``.

    Batch layout: batch['optical'|'thermal'] with image (B,H,W,1),
    keypoints (B,H,W), valid_mask (B,H,W), homography (B,3,3); optional
    batch['hfour_points']. With ``batch_fn``, the raw batch is first mapped
    through ``batch_fn(gen, batch)`` (the device-resident data path). ``gen``
    (a ``torch.Generator`` on the module's device) then drives DropPath,
    Dropout and the loss's tiebreak, in that order: the counterpart of the
    JAX step's rng split. Returns the loss components with 'loss' and
    'skipped_nonfinite' (0-d tensors).
    """

    def step(state, batch, gen):
        if batch_fn is not None:
            batch = batch_fn(gen, batch)
        module.train()
        stats = {n: b.clone() for n, b in state.batch_stats().items()}
        pred_o, pred_t, pred_hm = module.forward_pair(
            batch['optical']['image'], batch['thermal']['image'], gen)
        loss, comps = loss_fn(batch, pred_o, pred_t, pred_hm, gen)
        grads = torch.autograd.grad(loss, state.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(state.params, grads)]
        finite = torch.isfinite(loss) & torch.isfinite(
            torch.cat([g.reshape(-1) for g in grads])).all()
        # one host read per step: the skip decides what runs next
        if bool(finite):
            state.apply_gradients(grads)
        else:
            with torch.no_grad():
                for n, b in state.batch_stats().items():
                    b.copy_(stats[n])
        comps = {k: v.detach() for k, v in comps.items()}
        comps['loss'] = loss.detach()
        comps['skipped_nonfinite'] = 1.0 - finite.float()
        return comps

    return step


def make_eval_step(module, loss_fn):
    """Loss-only evaluation step ``eval(state, batch) -> (loss,
    components)``: eval-mode forward (running BatchNorm statistics, no
    DropPath or Dropout), no gradient."""

    @torch.no_grad()
    def eval_step(state, batch):
        module.eval()
        pred_o, pred_t, pred_hm = module.forward_pair(
            batch['optical']['image'], batch['thermal']['image'])
        return loss_fn(batch, pred_o, pred_t, pred_hm)

    return eval_step
