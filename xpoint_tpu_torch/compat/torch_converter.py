"""Pretrained encoder weights under the reference's torch key names ->
the port's ``state_dict`` (the encoder half of
``xpoint_tpu/compat/torch_converter.py``).

The reference's names map straight to the port's; nothing goes through
flax. The key surgery is the reference's:
  * '__'-split renaming, 'module.' (DataParallel) and 'backbone.'
    (pretrained VSSM) prefixes stripped;
  * for VSSM, the legacy renames patch_embed.proj -> 0, patch_embed.norm
    -> 2, ln_1 -> norm, self_attention -> op;
  * Linear2d weights stored as (O, I, 1, 1) squeezed to (O, I);
  * SS2D's ``dt_projs_weight`` stored pre-shifted by -R^-0.5 (the port, as
    the JAX package, holds it unshifted);
  * Swin's ``qkv.weight`` (3C, C) becomes ``qkv_kernel`` (C, 3C); its
    relative-position buffers and any classification head are not read.
The full-model converter (``convert_torch_state_dict``,
``load_torch_checkpoint``) is not ported (ROADMAP.md Queue 1 item 8).
"""
import collections

import numpy as np
import torch


def normalize_torch_keys(state_dict, vssm_legacy=False):
    """The reference's key surgery, applied up front. The patch_embed /
    ln_1 legacy renames are VSSM's only: SwinV2's own patch_embed.proj keys
    keep their names."""
    out = collections.OrderedDict()
    for key, value in state_dict.items():
        k = key.split('__')[-1]
        if k.startswith('module.'):
            k = k[len('module.'):]
        if k.startswith('backbone.'):
            k = k[len('backbone.'):]
        if vssm_legacy:
            k = k.replace('patch_embed.proj.', 'patch_embed.0.')
            k = k.replace('patch_embed.norm.', 'patch_embed.2.')
            k = k.replace('.ln_1.', '.norm.')
            k = k.replace('.self_attention.', '.op.')
        out[k] = value
    return out


def _f32(v):
    return torch.as_tensor(np.asarray(v, np.float32))


class _Out:
    """Collects port entries ``prefix + name`` from reference keys."""

    def __init__(self, sd, prefix):
        self.sd, self.prefix, self.entries = sd, prefix, {}

    def get(self, key):
        return self.sd[key]

    def put(self, name, value):
        self.entries[self.prefix + name] = _f32(value)

    def copy(self, src, dst, names=('weight', 'bias')):
        """Entries ``dst.<n>`` from ``src.<n>``, in the same layout; a
        missing bias is left out."""
        for n in names:
            if n == 'bias' and f'{src}.bias' not in self.sd:
                continue
            self.put(f'{dst}.{n}', self.get(f'{src}.{n}'))

    def dense(self, src, dst):
        """A Linear (or a Linear2d stored as (O, I, 1, 1)) as (O, I)."""
        w = np.asarray(self.get(f'{src}.weight'), np.float32)
        self.put(f'{dst}.weight', w[:, :, 0, 0] if w.ndim == 4 else w)
        if f'{src}.bias' in self.sd:
            self.put(f'{dst}.bias', self.get(f'{src}.bias'))


def _convert_vssm(out, depths):
    """Reference VSSM (patch embed v2, downsample v3; the SS2D forward
    types the port builds) -> the port's VSSM."""
    out.copy('patch_embed.0', 'patch_embed_conv1')
    out.copy('patch_embed.2', 'patch_embed_norm1')
    out.copy('patch_embed.5', 'patch_embed_conv2')
    out.copy('patch_embed.7', 'patch_embed_norm2')
    for i, depth in enumerate(depths):
        for j in range(depth):
            bt, bp = f'layers.{i}.blocks.{j}', f'layers_{i}_blocks_{j}'
            op, pop = f'{bt}.op', f'{bp}.op'
            out.copy(f'{bt}.norm', f'{bp}.norm')
            out.dense(f'{op}.in_proj', f'{pop}.in_proj')
            if f'{op}.conv2d.weight' in out.sd:
                out.copy(f'{op}.conv2d', f'{pop}.conv2d')
            out.copy(op, pop, ('x_proj_weight',))
            # stored shifted by -R^-0.5
            dtw = np.asarray(out.get(f'{op}.dt_projs_weight'), np.float32)
            out.put(f'{pop}.dt_projs_weight', dtw + dtw.shape[-1] ** -0.5)
            out.copy(op, pop, ('dt_projs_bias', 'A_logs', 'Ds'))
            out.copy(f'{op}.out_norm', f'{pop}.out_norm')
            out.dense(f'{op}.out_proj', f'{pop}.out_proj')
            out.copy(f'{bt}.norm2', f'{bp}.norm2')
            out.dense(f'{bt}.mlp.fc1', f'{bp}.mlp.Dense_0')
            out.dense(f'{bt}.mlp.fc2', f'{bp}.mlp.Dense_1')
        if i < len(depths) - 1:
            out.copy(f'layers.{i}.downsample.1', f'layers_{i}_downsample_conv')
            out.copy(f'layers.{i}.downsample.3', f'layers_{i}_downsample_norm')


def _convert_swin(out, depths):
    """Reference SwinTransformerV2 -> the port's SwinTransformerV2."""
    out.copy('patch_embed.proj', 'patch_embed')
    out.copy('patch_embed.norm', 'patch_embed_norm')
    for i, depth in enumerate(depths):
        for j in range(depth):
            bt, bp = f'layers.{i}.blocks.{j}', f'layers_{i}_blocks_{j}'
            at, ap = f'{bt}.attn', f'{bp}.attn'
            out.copy(f'{bt}.norm1', f'{bp}.norm1')
            out.copy(f'{bt}.norm2', f'{bp}.norm2')
            out.copy(at, ap, ('logit_scale',))
            w = np.asarray(out.get(f'{at}.qkv.weight'), np.float32)
            out.put(f'{ap}.qkv_kernel', (w[:, :, 0, 0] if w.ndim == 4
                                         else w).T)
            if f'{at}.q_bias' in out.sd:
                out.copy(at, ap, ('q_bias', 'v_bias'))
            out.dense(f'{at}.cpb_mlp.0', f'{ap}.cpb_fc1')
            out.dense(f'{at}.cpb_mlp.2', f'{ap}.cpb_fc2')
            out.dense(f'{at}.proj', f'{ap}.proj')
            out.dense(f'{bt}.mlp.fc1', f'{bp}.mlp_fc1')
            out.dense(f'{bt}.mlp.fc2', f'{bp}.mlp_fc2')
        if i < len(depths) - 1:
            dt, dp = f'layers.{i}.downsample', f'layers_{i}_downsample'
            out.dense(f'{dt}.reduction', f'{dp}.reduction')
            out.copy(f'{dt}.norm', f'{dp}.norm')
    out.copy('norm', 'norm')


def convert_pretrained_encoder(state_dict, module):
    """A pretrained backbone's state_dict (reference names, tensors or
    numpy arrays) -> the port entries of ``module``'s encoder(s), fp32 on
    the CPU: the same weights for both encoders of a multispectral model.
    Keys the encoder does not read (a classification head, Swin's
    relative-position buffers) are ignored; a key it needs that is missing
    raises KeyError."""
    sd = normalize_torch_keys(
        {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else v)
         for k, v in state_dict.items()},
        vssm_legacy=(module.encoder_type == 'vmamba'))
    convert = {'vmamba': _convert_vssm,
               'swin': _convert_swin}.get(module.encoder_type)
    if convert is None:
        raise NotImplementedError(
            f"pretrained weights for the {module.encoder_type} encoder")
    names = (['encoder_optical', 'encoder_thermal'] if module.multispectral
             else ['encoder'])
    entries = {}
    for name in names:
        out = _Out(sd, f'{name}.')
        try:
            convert(out, getattr(module, name).depths)
        except KeyError as e:
            raise KeyError(f"pretrained encoder checkpoint missing key {e}")
        entries.update(out.entries)
    return entries


def load_pretrained_encoder(module, state_dict):
    """Load a pretrained backbone's weights into ``module``'s encoder(s) in
    place; every encoder entry must come from the checkpoint, with its
    shape. Returns the number of entries loaded."""
    entries = convert_pretrained_encoder(state_dict, module)
    target = module.state_dict()
    prefixes = tuple(f'{n}.' for n in ('encoder', 'encoder_optical',
                                       'encoder_thermal'))
    wanted = {k for k in target if k.startswith(prefixes)}
    if set(entries) != wanted:
        raise KeyError(f"pretrained encoder: entries the model lacks "
                       f"{sorted(set(entries) - wanted)}, entries the "
                       f"checkpoint lacks {sorted(wanted - set(entries))}")
    for k, v in entries.items():
        if tuple(v.shape) != tuple(target[k].shape):
            raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)} vs "
                             f"model {tuple(target[k].shape)}")
    module.load_state_dict(entries, strict=False)
    return len(entries)
