"""Reference XPoint checkpoints under the reference's torch key names ->
the port's ``state_dict`` (port of ``xpoint_tpu/compat/torch_converter.py``).

The reference's names map straight to the port's; nothing goes through
flax. The key surgery is the reference's:
  * '__'-split renaming, 'module.' (DataParallel) and 'backbone.'
    (pretrained VSSM) prefixes stripped;
  * for VSSM, the legacy renames patch_embed.proj -> 0, patch_embed.norm
    -> 2, ln_1 -> norm, self_attention -> op;
  * Linear2d weights stored as (O, I, 1, 1) squeezed to (O, I);
  * SS2D's ``dt_projs_weight`` stored pre-shifted by -R^-0.5 (the port, as
    the JAX package, holds it unshifted); an xv block (SS2Dv3, told by its
    missing ``x_proj_weight``) stores it plain, and an m0 block (SS2Dm0)
    has none; xv's ``oconv2d`` and the ``out_norm`` Sequentials of
    ``_oncnorm`` (LayerNorm at 0, depthwise conv at 2) and ``_ondwconv3``
    (depthwise conv at 1) map to ``oconv2d``, ``out_norm`` and
    ``out_norm_conv``;
  * Swin's ``qkv.weight`` (3C, C) becomes ``qkv_kernel`` (C, 3C); its
    relative-position buffers and any classification head are not read;
  * the CNN encoder and the heads are Sequentials (``XPoint.py:112-138,
    452-466``): encoder block b's convs at 9b+1 and 9b+5 with BatchNorms at
    9b+3 and 9b+7 (one conv, BN at 4b+1, 4b+3 without the double
    convolution), a head's conv3 at 1, BN at 3, conv1 at 4, final BN at 5;
    RegNet's convs at ``layer1.0`` / ``layer1.3``, BNs at ``layer1.1`` /
    ``layer1.4``, dense layers at ``fc.1`` / ``fc.4``.
A BatchNorm's running statistics go to ``running_mean`` / ``running_var``;
where the port holds a SpectralBatchNorm (``spectral_norm_stats``), the
reference's one set of statistics fills both spectra's slots. (The JAX
converter writes them under the plain BatchNorm's names, which such a flax
model does not read.)
"""
import collections

import numpy as np
import torch

from ..models.heads import SPECTRA
from ..models.regnet import RegNet


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
    """Collects port entries ``prefix + name`` from the reference keys
    ``src + key``."""

    def __init__(self, sd, prefix, src=''):
        self.sd, self.prefix, self.src, self.entries = sd, prefix, src, {}

    def has(self, key):
        return self.src + key in self.sd

    def get(self, key):
        return self.sd[self.src + key]

    def put(self, name, value):
        self.entries[self.prefix + name] = _f32(value)

    def copy(self, src, dst, names=('weight', 'bias')):
        """Entries ``dst.<n>`` from ``src.<n>``, in the same layout; a
        missing bias is left out."""
        for n in names:
            if n == 'bias' and not self.has(f'{src}.bias'):
                continue
            self.put(f'{dst}.{n}', self.get(f'{src}.{n}'))

    def dense(self, src, dst):
        """A Linear (or a Linear2d stored as (O, I, 1, 1)) as (O, I)."""
        w = np.asarray(self.get(f'{src}.weight'), np.float32)
        self.put(f'{dst}.weight', w[:, :, 0, 0] if w.ndim == 4 else w)
        if self.has(f'{src}.bias'):
            self.put(f'{dst}.bias', self.get(f'{src}.bias'))

    def bn(self, src, dst, bn_name):
        """A BatchNorm into the port's ``dst.<bn_name>``: BatchNorm_0 takes
        the running statistics as they are, SpectralBatchNorm_0 in both
        spectra's slots. An empty ``dst`` is the prefix itself."""
        dst = f'{dst}.{bn_name}' if dst else bn_name
        self.copy(src, dst)
        mean, var = self.get(f'{src}.running_mean'), self.get(
            f'{src}.running_var')
        if bn_name == 'SpectralBatchNorm_0':
            for s in SPECTRA:
                self.put(f'{dst}.mean_{s}', mean)
                self.put(f'{dst}.var_{s}', var)
        else:
            self.put(f'{dst}.running_mean', mean)
            self.put(f'{dst}.running_var', var)


def _convert_cnn_encoder(out, encoder):
    """Reference Sequential CNN encoder -> the port's CNNEncoder."""
    per_block = 2 if encoder.double_convolution else 1
    seq = k = 0
    for block in range(4):
        for _ in range(per_block):
            cbr = getattr(encoder, f'ConvBNRelu_{k}')
            out.copy(f'{seq + 1}', f'ConvBNRelu_{k}.Conv_0')
            out.bn(f'{seq + 3}', f'ConvBNRelu_{k}', cbr.bn_name)
            seq += 4
            k += 1
        if block < 3:
            seq += 1        # maxpool


def _convert_head(out, head_t, head):
    """Reference head Sequential -> the port's Head."""
    out.copy(f'{head_t}.1', 'ConvBNRelu_0.Conv_0')
    out.bn(f'{head_t}.3', 'ConvBNRelu_0', head.ConvBNRelu_0.bn_name)
    out.copy(f'{head_t}.4', 'Conv_0')
    if head.bn_name is not None:
        out.bn(f'{head_t}.5', '', head.bn_name)


def _convert_regnet(out):
    out.copy('layer1.0', 'conv1', ('weight',))
    out.bn('layer1.1', '', 'bn1')
    out.copy('layer1.3', 'conv2', ('weight',))
    out.bn('layer1.4', '', 'bn2')
    out.dense('fc.1', 'fc1')
    out.dense('fc.4', 'fc2')


def _convert_vssm(out, depths):
    """Reference VSSM (patch embed v2, downsample v3; the SS2D, SS2Dv3 and
    SS2Dm0 blocks) -> the port's VSSM."""
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
            if out.has(f'{op}.conv2d.weight'):
                out.copy(f'{op}.conv2d', f'{pop}.conv2d')
            is_xv = not out.has(f'{op}.x_proj_weight')
            if not is_xv:
                out.copy(op, pop, ('x_proj_weight',))
            if out.has(f'{op}.dt_projs_weight'):
                dtw = np.asarray(out.get(f'{op}.dt_projs_weight'), np.float32)
                # SS2D's is stored shifted by -R^-0.5, SS2Dv3's plain
                out.put(f'{pop}.dt_projs_weight',
                        dtw if is_xv else dtw + dtw.shape[-1] ** -0.5)
            out.copy(op, pop, ('dt_projs_bias', 'A_logs', 'Ds'))
            if out.has(f'{op}.oconv2d.weight'):
                out.copy(f'{op}.oconv2d', f'{pop}.oconv2d')
            if out.has(f'{op}.out_norm.weight'):
                out.copy(f'{op}.out_norm', f'{pop}.out_norm')
            elif out.has(f'{op}.out_norm.0.weight'):
                # _oncnorm: LayerNorm at 0, depthwise conv at 2
                out.copy(f'{op}.out_norm.0', f'{pop}.out_norm')
                out.copy(f'{op}.out_norm.2', f'{pop}.out_norm_conv',
                         ('weight',))
            elif out.has(f'{op}.out_norm.1.weight'):
                # _ondwconv3: depthwise conv at 1
                out.copy(f'{op}.out_norm.1', f'{pop}.out_norm_conv',
                         ('weight',))
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
            if out.has(f'{at}.q_bias'):
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


def _encoder_names(module):
    return (['encoder_optical', 'encoder_thermal'] if module.multispectral
            else ['encoder'])


def _convert_encoder(out, module, name):
    encoder = getattr(module, name)
    if module.encoder_type == 'cnn':
        _convert_cnn_encoder(out, encoder)
    elif module.encoder_type == 'vmamba':
        _convert_vssm(out, encoder.depths)
    else:
        _convert_swin(out, encoder.depths)


def _numpy_keys(state_dict, module):
    return normalize_torch_keys(
        {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else v)
         for k, v in state_dict.items()},
        vssm_legacy=(module.encoder_type == 'vmamba'))


def convert_pretrained_encoder(state_dict, module):
    """A pretrained backbone's state_dict (reference names, tensors or
    numpy arrays) -> the port entries of ``module``'s encoder(s), fp32 on
    the CPU: the same weights for both encoders of a multispectral model.
    A CNN backbone is the encoder's Sequential alone (keys ``<seq>.*``),
    BatchNorm statistics included. Keys the encoder does not read (a
    classification head, Swin's relative-position buffers) are ignored; a
    key it needs that is missing raises KeyError."""
    sd = _numpy_keys(state_dict, module)
    entries = {}
    for name in _encoder_names(module):
        out = _Out(sd, f'{name}.')
        try:
            _convert_encoder(out, module, name)
        except KeyError as e:
            raise KeyError(f"pretrained encoder checkpoint missing key {e}")
        entries.update(out.entries)
    return entries


def convert_torch_state_dict(state_dict, module):
    """A reference XPoint state_dict (reference names, tensors or numpy
    arrays) -> the port entries of ``module`` (built from the same model
    config), fp32 on the CPU: the encoder(s), the detector head, the
    descriptor head where the module has one, and RegNet's weights where
    the module has a RegNet and the checkpoint holds them. A key the module
    needs that is missing raises KeyError."""
    sd = _numpy_keys(state_dict, module)
    entries = {}
    for name in _encoder_names(module):
        out = _Out(sd, f'{name}.', f'{name}.')
        _convert_encoder(out, module, name)
        entries.update(out.entries)
    heads = [('detector_head_convolutions', 'detector_head')]
    if hasattr(module, 'descriptor_head'):
        heads.append(('descriptor_head_convolutions', 'descriptor_head'))
    for head_t, name in heads:
        out = _Out(sd, f'{name}.')
        _convert_head(out, head_t, getattr(module, name))
        entries.update(out.entries)
    if (isinstance(getattr(module, 'hm_regressor', None), RegNet)
            and 'hm_regressor.layer1.0.weight' in sd):
        out = _Out(sd, 'hm_regressor.', 'hm_regressor.')
        _convert_regnet(out)
        entries.update(out.entries)
    return entries


def unwrap_checkpoint(obj):
    """A loaded reference file -> its state_dict (the file's own, or the
    one under 'state_dict' or 'model')."""
    if isinstance(obj, dict) and 'state_dict' in obj:
        return obj['state_dict']
    if isinstance(obj, dict) and isinstance(obj.get('model'), dict):
        return obj['model']
    return obj


def is_reference_checkpoint(obj):
    """Whether a loaded file is a reference XPoint checkpoint: after the
    key surgery, one of its keys names the reference's detector head
    Sequential (``detector_head_convolutions.``), which no port
    state_dict has."""
    sd = unwrap_checkpoint(obj)
    return isinstance(sd, dict) and any(
        k.startswith('detector_head_convolutions.')
        for k in normalize_torch_keys(dict.fromkeys(sd)))


def load_torch_checkpoint(path, module):
    """``torch.load`` a reference ``.model`` file (a state_dict, or one
    under 'state_dict' or 'model') and convert it for ``module``."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    return convert_torch_state_dict(unwrap_checkpoint(sd), module)


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
