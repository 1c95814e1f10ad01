"""The training step: forward + loss + gradients + Adam (port of
``xpoint_tpu/parallel/train_step.py:19-151`` and
``xpoint_tpu/trainer.py:32-69::make_optimizer``).

PyTorch runs eagerly, so the state lives in the module (parameters,
BatchNorm running statistics) and in :class:`TrainState` (step count, Adam
moments and count, the optional per-epoch learning rate), and a step
updates them in place. Mixed precision is the JAX step's: fp32 parameters,
activations in the model dtype, no autocast and no loss scaling. Its
non-finite skip plays GradScaler's role: a step whose loss or any gradient
is not finite leaves parameters, Adam moments and count, the step count and
the BatchNorm running statistics exactly as they were. As in JAX, the skip
is a select on the device (``torch.where(finite, new, old)``, the JAX
step's ``jax.tree.map(jnp.where ...)``): nothing inside a step reads a
value back to the host, and the step count, the Adam count and
``skipped_nonfinite`` stay device tensors.

Data parallel (``mesh`` of n ranks, one process each): every rank runs the
step on its rows of the global batch inside ``parallel.data_parallel``, so
BatchNorm normalises with the global batch's statistics and the
batch-shaped draws are the global batch's rows. One all-reduce of the flat
gradient buffer, with the loss and its components packed behind it, gives
every rank the mean over the ranks: the gradient and the loss of the global
batch. The non-finite skip then decides on those, so every rank skips
together, and the parameters stay equal on every rank.
"""
import functools

import torch

from .. import obs
from ..parallel.mesh import data_parallel, mean_over_ranks


class Adam:
    """optax ``chain(add_decayed_weights(wd)?, scale_by_adam(), scale(-lr))``
    over a list of fp32 tensors: torch-style L2 (g += wd * p before the
    moments), b1 0.9, b2 0.999, eps 1e-8, with optax's arithmetic
    (mu_hat = mu / (1 - b1^t), update = -lr mu_hat / (sqrt(nu_hat) + eps)).

    The moments are one flat fp32 buffer each and the count an int32 0-d
    tensor, all on the parameters' device. :meth:`step` runs a handful of
    kernels over the flat buffers and reads nothing back to the host;
    ``state`` gives ``torch.optim``-style per-parameter views
    (``exp_avg``, ``exp_avg_sq``, ``step``)."""

    def __init__(self, params, lr=1e-3, weight_decay=0.0, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.params = list(params)
        if any(p.dtype != torch.float32 for p in self.params):
            raise TypeError("Adam keeps fp32 parameters only")
        self.lr, self.weight_decay = lr, float(weight_decay)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.sizes = [p.numel() for p in self.params]
        dev = self.params[0].device
        self.mu = torch.zeros(sum(self.sizes), device=dev)
        self.nu = torch.zeros_like(self.mu)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)

    def views(self, flat):
        """A flat buffer as one view per parameter, in parameter order."""
        return [t.view_as(p) for t, p in zip(flat.split(self.sizes),
                                             self.params)]

    @property
    def state(self):
        return {p: {"exp_avg": m, "exp_avg_sq": v, "step": self.count}
                for p, m, v in zip(self.params, self.views(self.mu),
                                   self.views(self.nu))}

    def flat_grads(self, grads=None):
        """The gradients (default: each parameter's ``.grad``; None counts
        as zero) as one flat fp32 buffer."""
        if grads is None:
            grads = [p.grad for p in self.params]
        return torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                          for p, g in zip(self.params, grads)])

    @torch.no_grad()
    def step(self, grads=None, finite=None, lr=None):
        """One update from ``grads`` (a list, or one flat buffer as
        :meth:`flat_grads` gives). With ``finite``, a 0-d bool tensor, the
        update is taken where it is true and parameters, moments and count
        stay bit for bit as they were where it is false. ``lr`` (a float or
        a 0-d tensor) replaces the optimiser's own."""
        g = grads if torch.is_tensor(grads) else self.flat_grads(grads)
        lr = self.lr if lr is None else lr
        p = torch.cat([q.reshape(-1) for q in self.params])
        if self.weight_decay:
            g = g + self.weight_decay * p
        count = self.count + 1
        mu = (1 - self.b1) * g + self.b1 * self.mu
        nu = (1 - self.b2) * (g * g) + self.b2 * self.nu
        t = count.float()
        mu_hat = mu / (1 - self.b1 ** t)
        nu_hat = nu / (1 - self.b2 ** t)
        new_p = p + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        if finite is not None:
            new_p = torch.where(finite, new_p, p)
            mu = torch.where(finite, mu, self.mu)
            nu = torch.where(finite, nu, self.nu)
            count = self.count + finite.to(torch.int32)
        self.mu.copy_(mu)
        self.nu.copy_(nu)
        self.count.copy_(count)
        torch._foreach_copy_(self.params, self.views(new_p))


def make_optimizer(training_cfg):
    """Adam from the ``training:`` config (learningrate, weight_decay,
    scheduler), the counterpart of the JAX ``make_optimizer``'s optax chain.
    Returns (tx, lr_at_epoch): ``tx(params)`` builds the :class:`Adam`; with
    a StepLR / ExponentialLR scheduler, ``lr_at_epoch(epoch)`` is the torch
    scheduler's learning rate for that epoch, to be set on
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
    return functools.partial(Adam, lr=lr, weight_decay=wd), lr_at_epoch


class TrainState:
    """Counterpart of the JAX TrainState for a module trained in place:
    ``step`` (an int32 0-d tensor on the module's device), the module's
    parameters and BatchNorm statistics, ``optimizer`` (``tx(params)``),
    and ``lr`` (the per-epoch learning rate, or None for the optimiser's
    own)."""

    def __init__(self, module, tx, lr=None):
        self.module = module
        self.names = [n for n, _ in module.named_parameters()]
        self.params = [p for _, p in module.named_parameters()]
        self.optimizer = tx(self.params)
        self.step = torch.zeros((), dtype=torch.int32,
                                device=self.params[0].device)
        self.lr = lr

    @property
    def opt_state(self):
        """optax's ScaleByAdamState: count, and the moments mu, nu in
        parameter order."""
        opt = self.optimizer
        return {"count": opt.count, "mu": opt.views(opt.mu),
                "nu": opt.views(opt.nu)}

    def batch_stats(self):
        """The BatchNorm running statistics (every buffer of the model)."""
        return dict(self.module.named_buffers())

    def apply_gradients(self, grads, finite):
        """Adam on ``grads`` where ``finite`` (0-d bool tensor) is true, as
        :meth:`Adam.step`; the step count follows it."""
        self.optimizer.step(grads, finite, self.lr)
        self.step.add_(finite.to(torch.int32))


def _pair_routing_args(batch):
    """Per-sample encoder routing (random_pairs spectrum shuffling) and
    HomographyNet input ordering from the batch, shared by the train and
    eval steps (``parallel/train_step.py:47-61``): optical_not_warped, (B,)
    bool where the optical homography is the identity within 1e-6 (None
    without a homography), and is_optical of each side, flattened to
    (B,), or None."""
    opt = batch["optical"]
    is_o = opt.get("is_optical")
    is_t = batch["thermal"].get("is_optical")
    optical_not_warped = None
    if "homography" in opt:
        h = opt["homography"]
        eye = torch.eye(3, dtype=torch.float32, device=h.device)
        optical_not_warped = ((h - eye).abs() < 1e-6).flatten(1).all(1)
    return (optical_not_warped,
            None if is_o is None else is_o.reshape(-1),
            None if is_t is None else is_t.reshape(-1))


def _forward_loss(module, loss_fn, batch, takes_pair, gen):
    if takes_pair:
        not_warped, is_o, is_t = _pair_routing_args(batch)
        with obs.span("xp.train.forward"):
            pred_o, pred_t, pred_hm = module.forward_pair(
                batch['optical']['image'], batch['thermal']['image'], gen,
                is_o, is_t, not_warped)
        with obs.span("xp.train.loss"):
            return loss_fn(batch, pred_o, pred_t, pred_hm, gen)
    with obs.span("xp.train.forward"):
        pred = module(batch['image'], "mixed",
                      batch['is_optical'].reshape(-1), gen)
    with obs.span("xp.train.loss"):
        return loss_fn(batch, pred, None, None, gen)


def _global(g, loss, comps, mesh):
    """The flat gradient, the loss and the components as the mean over the
    ranks, through one all-reduce of one buffer."""
    if mesh is None or mesh.size == 1:
        return g, loss, comps
    keys = list(comps)
    packed = torch.cat([g, loss.reshape(1).float()]
                       + [comps[k].reshape(1).float() for k in keys])
    packed = mean_over_ranks(packed, mesh)
    n = g.numel()
    return (packed[:n], packed[n],
            {k: packed[n + 1 + i] for i, k in enumerate(keys)})


def make_train_step(module, loss_fn, takes_pair=True, batch_fn=None,
                    mesh=None):
    """The train step: ``step(state, batch, gen) -> components``.

    Pair batch (takes_pair): batch['optical'|'thermal'] with image
    (B,H,W,1), keypoints (B,H,W), valid_mask (B,H,W), homography (B,3,3)
    and optionally is_optical (routing each sample of a side through the
    right encoder of a multispectral model); optional
    batch['hfour_points']. Single-image batch (``takes_pair=False``):
    image, keypoints, valid_mask and is_optical (B, 1), the model run
    'mixed' and the loss on the flat batch. With ``batch_fn``, the raw
    batch is first mapped through ``batch_fn(gen, batch)`` (the
    device-resident data path). ``gen`` (a ``torch.Generator`` on the
    module's device) then drives DropPath, Dropout and the loss's
    tiebreak, in that order: the counterpart of the JAX step's rng split.
    With ``mesh`` (``parallel.make_mesh``), ``batch`` is this rank's slice
    of the global batch (or, with ``batch_fn``, the payload every rank
    shares, which ``batch_fn`` slices) and the step is the data-parallel
    one of the module docstring; ``gen`` must be in the same state on every
    rank.
    Returns the loss components with 'loss' and 'skipped_nonfinite' (0-d
    device tensors; nothing is read back to the host).
    """

    def step(state, batch, gen):
        with obs.root("xp.train.step"), data_parallel(mesh):
            return _step(state, batch, gen)

    def _step(state, batch, gen):
        if batch_fn is not None:
            batch = batch_fn(gen, batch)
        module.train()
        stats = list(state.batch_stats().values())
        old = torch.cat([b.reshape(-1) for b in stats])
        loss, comps = _forward_loss(module, loss_fn, batch, takes_pair, gen)
        with obs.span("xp.train.backward"):
            grads = torch.autograd.grad(loss, state.params,
                                        allow_unused=True)
            g, loss, comps = _global(state.optimizer.flat_grads(grads),
                                     loss.detach(), comps, mesh)
        with obs.span("xp.train.optimizer"):
            finite = torch.isfinite(loss) & torch.isfinite(g).all()
            state.apply_gradients(g, finite)
            with torch.no_grad():
                new = torch.where(finite, torch.cat([b.reshape(-1)
                                                     for b in stats]), old)
                torch._foreach_copy_(stats, [t.view_as(b) for t, b in zip(
                    new.split([b.numel() for b in stats]), stats)])
        comps = {k: v.detach() for k, v in comps.items()}
        comps['loss'] = loss.detach()
        comps['skipped_nonfinite'] = 1.0 - finite.float()
        return comps

    return step


def make_eval_step(module, loss_fn, takes_pair=True, mesh=None):
    """Loss-only evaluation step ``eval(state, batch) -> (loss,
    components)``: eval-mode forward (running BatchNorm statistics, no
    DropPath or Dropout), no gradient, the batch routed as in the train
    step. With ``mesh``, ``batch`` is this rank's slice and the loss and
    components are the global batch's (the mean over the ranks)."""

    @torch.no_grad()
    def eval_step(state, batch):
        module.eval()
        with data_parallel(mesh):
            loss, comps = _forward_loss(module, loss_fn, batch, takes_pair,
                                        None)
        if mesh is None or mesh.size == 1:
            return loss, comps
        zero = torch.zeros(0, device=loss.device)
        _, loss, comps = _global(zero, loss, comps, mesh)
        return loss, comps

    return eval_step
