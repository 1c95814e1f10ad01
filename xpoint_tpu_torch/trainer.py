"""Training orchestration: dataset -> train step -> checkpoints and logs
(port of ``xpoint_tpu/trainer.py:72-392``).

As in the JAX ``Trainer``: the config is dumped to ``params.yaml`` in the
output directory; Adam with the optional per-epoch StepLR / ExponentialLR
rate; ``e{N}`` checkpoints every ``save_every_n_epoch`` and ``latest`` at
the end, the resume epoch parsed from the name; ``load_weights`` with
strict=False counts; the validation loss; TensorBoard scalars when a writer
imports. Losses and skip flags stay on the device and are read at log
points and once an epoch, never inside a step.

The datasets come from ``data.get_dataset`` by the config's ``dataset``
section unless passed in (``dataset=``, ``val_dataset=``).

Where it differs:
  * Randomness: the step's ``torch.Generator`` is seeded from (seed,
    epoch) at the start of every epoch, and a resumed run first draws the
    shuffles of the epochs before its start. The host datasets draw each
    sample from generators of its own, derived from (seed, epoch, index)
    (``data/seeding.py``; the epoch is set with the step's), where the JAX
    package's draw from the global ``random`` / ``np.random`` streams that
    its loader threads share in no fixed order. So a batch is the same
    whatever ``num_worker`` is, and a run resumed from ``e{N}`` sees the
    batches and draws a straight run sees and ends bit for bit where the
    straight run ends (the JAX ``Trainer`` restarts its streams from the
    seed on resume).
  * Devices: the JAX ``Trainer`` shards every batch over a mesh of every
    device in one program; here ``n_devices`` ranks run one process each
    (``parallel.launch``), and the Trainer built in each of them takes the
    mesh of the process group (``parallel.make_mesh``; one rank and no
    group is the one-device trainer). ``training: batchsize`` is the global
    batch: each rank loads its rows of it (the host loader) or slices it
    on its device (the resident data), and the train and eval steps are
    the data-parallel ones (``train.make_train_step(mesh=...)``), so n
    ranks compute what one device computes on the global batch. Every rank
    draws the same shuffles and generator states; rank 0 alone writes
    ``params.yaml``, the checkpoints, TensorBoard and the log lines, and
    every rank reads a checkpoint on resume. ``n_devices`` below the
    group's size trains on its first n ranks, as JAX's trains on its first
    n devices; a rank past them builds nothing, and its ``train`` returns
    None without a step or a collective.
"""
import os
import time

import numpy as np
import torch

from . import checkpoints as ckpt
from .compat.torch_converter import (convert_torch_state_dict,
                                     is_reference_checkpoint,
                                     load_pretrained_encoder,
                                     unwrap_checkpoint)
from .config import save_yaml
from .data import DataLoader, get_dataset
from .losses import XPointLoss
from .models import build_xpoint
from .ops.gridops import device_constant
from .parallel.mesh import barrier, make_mesh, replicate
from .train import TrainState, make_eval_step, make_optimizer  # noqa: F401
from .train import make_train_step


def batch_to_device_pair(batch, device):
    """A collated pair batch as the train step takes it, on ``device``
    (copied through pinned memory: the host does not wait)."""
    f32 = torch.float32

    def side(d):
        out = {k: device_constant(d[k], device, f32)
               for k in ('image', 'valid_mask', 'homography', 'keypoints')
               if k in d}
        if 'is_optical' in d:
            out['is_optical'] = device_constant(d['is_optical'], device,
                                                torch.bool)
        return out
    out = {'optical': side(batch['optical']),
           'thermal': side(batch['thermal'])}
    if 'hfour_points' in batch:
        out['hfour_points'] = device_constant(batch['hfour_points'], device,
                                              f32)
    return out


def batch_to_device_single(batch, device):
    """A collated single-image batch as the train step takes it."""
    out = {k: device_constant(batch[k], device, torch.float32)
           for k in ('image', 'valid_mask', 'keypoints') if k in batch}
    out['is_optical'] = device_constant(batch['is_optical'], device,
                                        torch.bool)
    return out


class Trainer:
    def __init__(self, config, output_dir, n_devices=None, seed=0,
                 device="cuda", dataset=None, val_dataset=None):
        self.config = config
        self.output_dir = output_dir
        self.seed = seed
        self.mesh = make_mesh(n_devices, device=device)
        self.device = self.mesh.device
        self.main = self.mesh.rank == 0
        self.state, self.start_epoch = None, 0
        if not self.mesh.member:
            return
        mesh = self.mesh if self.mesh.size > 1 else None
        if self.main:
            os.makedirs(output_dir, exist_ok=True)
            save_yaml(config, os.path.join(output_dir, 'params.yaml'))

        self.dataset = (dataset if dataset is not None
                        else get_dataset(config['dataset']))
        tcfg = config.get('training', {})
        self.batch_size = int(tcfg.get('batchsize', 1))
        workers = int(tcfg.get('num_worker', 1) or 1)
        self.loader = DataLoader(self.dataset, self.batch_size, shuffle=True,
                                 seed=seed, workers=workers, mesh=mesh)
        self.takes_pair = self.dataset.returns_pair()

        self.val_loader = None
        vcfg = tcfg.get('validation') or {}
        self.val_every = int(vcfg.get('every_nth_epoch', 1) or 1)
        if vcfg.get('compute_validation_loss'):
            if val_dataset is None:
                val_cfg = dict(config['dataset'])
                val_cfg['filename'] = vcfg.get('filename',
                                               val_cfg.get('filename'))
                if vcfg.get('keypoints'):
                    val_cfg['keypoints_filename'] = vcfg['keypoints']
                val_dataset = get_dataset(val_cfg)
            if hasattr(val_dataset, 'set_epoch'):
                val_dataset.set_epoch(0, seed)
            self.val_loader = DataLoader(val_dataset, self.batch_size,
                                         shuffle=False, seed=seed,
                                         workers=workers, mesh=mesh)

        self.module, self.model_cfg = build_xpoint(config['model'],
                                                   device=self.device,
                                                   seed=seed)
        loss_cfg = dict(config.get('loss', {}))
        loss_cfg['space_to_depth_ratio'] = self.module.encoder_downsample_ratio
        self.loss_fn = XPointLoss(loss_cfg)
        self.tx, self.lr_at_epoch = make_optimizer(tcfg)
        self.gen = torch.Generator(device=self.device)
        self._maybe_load_pretrained_encoder()
        self.state = self._fresh_state()
        self.start_epoch = 0
        self._shuffles_drawn = 0

        # device-resident data: the corpus on the card, batch assembly and
        # homographic augmentation inside the train step
        self.device_data = bool(tcfg.get('device_data')) and self.takes_pair
        batch_fn = None
        if self.device_data:
            from .data.device_dataset import (load_resident_pair_data,
                                              make_resident_batch_fn)
            self.resident_data, meta = load_resident_pair_data(
                self.dataset, device=self.device)
            hm_check = bool((config['model'].get(
                'homography_regression_head') or {}).get('check'))
            batch_fn = make_resident_batch_fn(self.dataset.config, meta,
                                              hm_input=hm_check, mesh=mesh)
            self.data_rng = np.random.default_rng(seed)

        self.train_step = make_train_step(self.module, self.loss_fn,
                                          takes_pair=self.takes_pair,
                                          batch_fn=batch_fn, mesh=mesh)
        self.eval_step = make_eval_step(self.module, self.loss_fn,
                                        takes_pair=self.takes_pair,
                                        mesh=mesh)

        self.writer = None
        if tcfg.get('use_writer') and self.main:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.writer = SummaryWriter(os.path.join(output_dir, 'tb'))
            except ImportError:
                pass

    def _log(self, *args, **kw):
        """print, on rank 0 only."""
        if self.main:
            print(*args, **kw)

    def _fresh_state(self):
        return TrainState(self.module, self.tx,
                          lr=(self.lr_at_epoch(0) if self.lr_at_epoch
                              else None))

    def _maybe_load_pretrained_encoder(self):
        ua = (self.config.get('model', {}) or {}).get('use_attention',
                                                      {}) or {}
        pre = ua.get('pretrained', {}) or {}
        if not (ua.get('check') and pre.get('check')):
            return
        type_dir = pre.get('type_dir')
        if not type_dir or not os.path.isdir(type_dir):
            self._log(f"pretrained encoder dir not found ({type_dir}); "
                  f"training from scratch", flush=True)
            return
        ckpts = [f for f in os.listdir(type_dir)
                 if f.endswith(('.pth', '.model', '.ckpt', '.pt'))]
        if not ckpts:
            self._log(f"no pretrained encoder checkpoint in {type_dir}; "
                  f"training from scratch", flush=True)
            return
        path = os.path.join(type_dir, sorted(ckpts)[0])
        sd = torch.load(path, map_location='cpu', weights_only=True)
        for key in ('state_dict', 'model', 'model_state_dict'):
            if isinstance(sd, dict) and isinstance(sd.get(key), dict):
                sd = sd[key]
                break
        load_pretrained_encoder(self.module, sd)
        self._log(f"loaded pretrained encoder weights from {path}", flush=True)

    def load_weights(self, path):
        """Initialise training from a checkpoint file, the fine-tuning
        entry point (reference train.py -w, torch.load +
        load_state_dict(strict=False)). strict=False: every entry whose
        name and shape match the model is taken from the file, everything
        else keeps its initialisation; returns the counts used / missing /
        unexpected / shape, as the JAX ``load_weights``. The optimiser state
        starts fresh.

        What the file is, is told by its content, not its suffix (the JAX
        package reads every ``.pt`` as a reference checkpoint, and this
        package writes its own ``.pt``): a dict with a ``module`` dict is a
        Trainer checkpoint of this package; a file whose keys name the
        reference's detector head (``detector_head_convolutions.*``, alone
        or under 'state_dict' / 'model') is a reference checkpoint
        (``.model`` / ``.pth`` / ``.pt``), converted by
        ``compat.torch_converter``; anything else is a bare state_dict of
        this package. An orbax ``.ckpt`` of the JAX package is not read."""
        if not self.mesh.member:
            return None
        if path.endswith('.ckpt'):
            raise NotImplementedError(
                f"{path}: orbax checkpoints of the JAX package are not read")
        loaded = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(loaded, dict) and isinstance(loaded.get('module'),
                                                   dict):
            loaded = loaded['module']
        elif is_reference_checkpoint(loaded):
            loaded = convert_torch_state_dict(unwrap_checkpoint(loaded),
                                              self.module)
        init = self.module.state_dict()
        stats = {'used': 0, 'missing': 0, 'unexpected': 0, 'shape': 0}
        take = {}
        for k, v in init.items():
            if k not in loaded:
                stats['missing'] += 1
            elif tuple(loaded[k].shape) != tuple(v.shape):
                stats['shape'] += 1
                self._log(f"  shape mismatch at {k}: {tuple(loaded[k].shape)} "
                      f"vs {tuple(v.shape)} (kept init)", flush=True)
            else:
                stats['used'] += 1
                take[k] = loaded[k]
        stats['unexpected'] = sum(1 for k in loaded if k not in init)
        self.module.load_state_dict(take, strict=False)
        self.state = self._fresh_state()
        self._log(f"initialized weights from {path}: {stats['used']} tensors "
              f"loaded, {stats['missing']} missing (kept init), "
              f"{stats['unexpected']} unexpected (ignored), "
              f"{stats['shape']} shape mismatches", flush=True)
        return stats

    def resume(self, name='latest'):
        if not self.mesh.member:
            return self.start_epoch
        restored, epoch = ckpt.restore(self.output_dir, self.state, name)
        if restored is not None:
            self.start_epoch = epoch
        return self.start_epoch

    def _start_epoch(self, epoch):
        """Seed the step generator and the host dataset's samples for
        ``epoch`` and draw the shuffles of the epochs before it that this
        trainer has not drawn (after a resume), so that epoch ``e`` uses
        the (e+1)-th shuffle of the seed."""
        self.gen.manual_seed(int(np.random.SeedSequence(
            [self.seed, epoch]).generate_state(1)[0]))
        if hasattr(self.dataset, 'set_epoch'):
            self.dataset.set_epoch(epoch, self.seed)
        while self._shuffles_drawn < epoch:
            if self.device_data:
                self.data_rng.permutation(len(self.dataset))
            else:
                self.loader._indices()
            self._shuffles_drawn += 1
        self._shuffles_drawn = max(self._shuffles_drawn, epoch + 1)

    def _epoch_batches(self):
        """One epoch of batches on the device: the host loader's, or
        index payloads into the resident corpus (same shuffle and
        drop-last schedule as the DataLoader)."""
        if not self.device_data:
            to_dev = (batch_to_device_pair if self.takes_pair
                      else batch_to_device_single)
            for batch in self.loader:
                yield to_dev(batch, self.device)
            return
        idx = device_constant(self.data_rng.permutation(len(self.dataset)),
                              self.device, torch.int64)
        for s in range(0, len(idx) - self.batch_size + 1, self.batch_size):
            yield {'data': self.resident_data,
                   'idx': idx[s:s + self.batch_size]}

    def train(self, n_epochs=None, max_steps_per_epoch=None, log_every=10):
        tcfg = self.config.get('training', {})
        n_epochs = n_epochs or int(tcfg.get('n_epochs', 1))
        save_every = int(tcfg.get('save_every_n_epoch', 0) or 0)
        if not self.mesh.member:
            return None
        if self.mesh.size > 1:
            opt = self.state.optimizer
            replicate([self.state.params, list(self.module.buffers()),
                       opt.mu, opt.nu, opt.count, self.state.step],
                      self.mesh)
        step = 0
        for epoch in range(self.start_epoch, n_epochs):
            self._start_epoch(epoch)
            if self.lr_at_epoch is not None:
                self.state.lr = self.lr_at_epoch(epoch)
            epoch_losses, epoch_skips = [], []
            t_epoch = time.time()
            for i, dev_batch in enumerate(self._epoch_batches()):
                if max_steps_per_epoch and i >= max_steps_per_epoch:
                    break
                comps = self.train_step(self.state, dev_batch, self.gen)
                # kept on the device: a read here would make the host wait
                # for every step; they are read at log points and once an
                # epoch
                epoch_losses.append(comps['loss'])
                epoch_skips.append(comps['skipped_nonfinite'])
                if self.writer and step % log_every == 0:
                    for k, v in comps.items():
                        self.writer.add_scalar(
                            'batch/loss' if k == 'loss' else f'batch/{k}',
                            float(v), step)
                step += 1

            if epoch_losses:
                host_losses = torch.stack(epoch_losses).cpu().numpy()
                # the step's own flag also catches a finite loss with a
                # non-finite gradient
                host_skips = torch.stack(epoch_skips).cpu().numpy() > 0.5
                taken = ~host_skips & np.isfinite(host_losses)
                n_skipped = int(np.sum(~taken))
                mean_loss = (float(host_losses[taken].mean())
                             if taken.any() else float('nan'))
                if n_skipped:
                    self._log(f"epoch {epoch}: skipped {n_skipped} non-finite "
                          f"batch(es)", flush=True)
            else:
                mean_loss = float('nan')
            if self.writer:
                self.writer.add_scalar('epoch/train_loss', mean_loss, epoch)

            if self.val_loader is not None and epoch % self.val_every == 0:
                to_dev = (batch_to_device_pair if self.takes_pair
                          else batch_to_device_single)
                val_losses = [self.eval_step(self.state,
                                             to_dev(b, self.device))[0]
                              for b in self.val_loader]
                val_mean = (float(torch.stack(val_losses).mean())
                            if val_losses else float('nan'))
                if self.writer:
                    self.writer.add_scalar('validation_loss', val_mean, epoch)
                self._log(f"epoch {epoch}: validation loss {val_mean:.4f}",
                      flush=True)
            self._log(f"epoch {epoch}: loss {mean_loss:.4f} "
                  f"({time.time() - t_epoch:.1f}s)", flush=True)

            if save_every and (epoch + 1) % save_every == 0:
                self._save(f'e{epoch + 1}', epoch + 1)
        self._save('latest', n_epochs)
        return self.state

    def _save(self, name, epoch):
        """Rank 0 writes the checkpoint; every rank waits for it."""
        if self.main:
            ckpt.save(self.output_dir, self.state, name, epoch)
        barrier(self.mesh)
