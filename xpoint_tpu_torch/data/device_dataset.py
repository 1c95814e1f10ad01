"""Device-resident training data: the whole corpus on the card (port of
``xpoint_tpu/data/device_dataset.py:28-187``).

The raw samples stay on the device; batch assembly (index gather, random
crop, random-pairs spectrum swap, homographic augmentation, keypoint maps,
RegNet input) runs there in the train step (``data/device_augment.py``),
so the host only launches work. Semantics follow the host path per op,
including its quirk that random_pairs does not swap the keypoints
(image_pair.py:224-233). Draws come from the ``torch.Generator`` passed in.
Over a data-parallel mesh (the JAX ``mesh``) every rank holds the whole
corpus and gets the global batch's indices; the crops, flips and
augmentation parameters are drawn for the global batch and sliced, and
each rank gathers, crops and warps only its own rows, so the ranks'
batches, concatenated, are the one-device batch.
"""
import numpy as np
import torch

from .device_augment import keypoint_map_from_coords, make_pair_augment


def load_resident_pair_data(dataset, device="cuda"):
    """Stack a pair dataset's raw samples into device tensors.

    ``dataset`` is anything with ``len()`` and the ``_load_images(i)`` ->
    (optical, thermal) / ``_load_keypoints(i)`` -> (K, 2) (row, col) array,
    or a list [optical, thermal] of them, or None, pair that
    ``ImagePairDataset`` has. Returns (data, meta): data holds
    optical/thermal (N, H0, W0) fp32 and, with keypoints,
    kp_coords_{o,t} (N, K, 2) fp32 and kp_valid_{o,t} (N, K) bool; meta
    holds n, shape (H0, W0) and k (0 without keypoints)."""
    n = len(dataset)
    opticals, thermals, kps_o, kps_t = [], [], [], []
    for i in range(n):
        optical, thermal = dataset._load_images(i)
        kp = dataset._load_keypoints(i)
        pair = kp if isinstance(kp, list) else [kp, kp]
        opticals.append(np.asarray(optical, np.float32))
        thermals.append(np.asarray(thermal, np.float32))
        kps_o.append(None if pair[0] is None
                     else np.asarray(pair[0], np.float32).reshape(-1, 2))
        kps_t.append(None if pair[1] is None
                     else np.asarray(pair[1], np.float32).reshape(-1, 2))

    H0, W0 = opticals[0].shape[:2]
    if any(o.shape[:2] != (H0, W0) for o in opticals + thermals):
        raise ValueError("device data requires equally-sized samples")
    T = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    data = {'optical': T(np.stack(opticals)), 'thermal': T(np.stack(thermals))}
    K = 0
    if kps_o[0] is not None:
        K = max(max(len(k) for k in kps_o), max(len(k) for k in kps_t), 1)
        for suffix, kp_list in (('o', kps_o), ('t', kps_t)):
            coords = np.zeros((n, K, 2), np.float32)
            valid = np.zeros((n, K), bool)
            for i, k in enumerate(kp_list):
                m = min(len(k), K)
                coords[i, :m] = k[:m]
                valid[i, :m] = True
            data[f'kp_coords_{suffix}'] = T(coords)
            data[f'kp_valid_{suffix}'] = T(valid)
    return data, {'n': n, 'shape': (H0, W0), 'k': K}


def make_resident_batch_fn(dataset_cfg, meta, hm_input=False, mesh=None):
    """batch_fn(gen, {'data', 'idx'}) -> the standard pair batch, for
    ``make_train_step(batch_fn=...)``. Crops are (height, width) rounded
    down to multiples of 32 (the whole image where <= 0). With ``mesh``,
    'idx' is the global batch and the batch returned this rank's rows of
    it (see the module docstring)."""
    mine = mesh.rows if mesh is not None else (lambda t: t)
    H0, W0 = meta['shape']
    h = (dataset_cfg['height'] // 32 * 32 if dataset_cfg['height'] > 0
         else H0)
    w = (dataset_cfg['width'] // 32 * 32 if dataset_cfg['width'] > 0 else W0)
    if h > H0 or w > W0:
        raise ValueError("requested crop exceeds image size")
    random_pairs = bool(dataset_cfg.get('random_pairs'))
    aug = dataset_cfg['augmentation']
    if aug['photometric'].get('enable'):
        raise NotImplementedError(
            "device_data supports homographic augmentation on the device; "
            "photometric augmentation runs on the host data path: disable "
            "it or use the host data path")
    hom = aug['homographic']
    augment = (make_pair_augment(
        (h, w), dict(hom.get('params') or {}),
        border_reflect=bool(hom.get('border_reflect', True)),
        valid_border_margin=int(hom.get('valid_border_margin', 0) or 0),
        mask_border=bool(hom.get('mask_border', True)),
        hm_input=hm_input, mesh=mesh) if hom.get('enable') else None)

    def batch_fn(gen, payload):
        data, idx = payload['data'], payload['idx']
        G = idx.shape[0]                                   # global batch
        dev = data['optical'].device

        # random crop (host _crop, image_pair.py:143-173)
        ih = mine(torch.randint(0, H0 - h + 1, (G,), generator=gen,
                                device=dev))
        iw = mine(torch.randint(0, W0 - w + 1, (G,), generator=gen,
                                device=dev))
        idx = mine(idx)
        B = idx.shape[0]
        opt = data['optical'][idx]                         # (B, H0, W0)
        th = data['thermal'][idx]
        rows = (ih[:, None] + torch.arange(h, device=dev))[:, :, None]
        cols = (iw[:, None] + torch.arange(w, device=dev))[:, None, :]
        bi = torch.arange(B, device=dev)[:, None, None]
        opt, th = opt[bi, rows, cols], th[bi, rows, cols]

        sides = {'optical': {}, 'thermal': {}}
        if meta['k']:
            shift = torch.stack([ih, iw], 1)[:, None, :].float()
            for side, suffix in (('optical', 'o'), ('thermal', 't')):
                kc = data[f'kp_coords_{suffix}'][idx] - shift
                kv = (data[f'kp_valid_{suffix}'][idx]
                      & (kc[..., 0] >= 0) & (kc[..., 0] < h)
                      & (kc[..., 1] >= 0) & (kc[..., 1] < w))
                sides[side]['keypoint_coords'] = kc
                sides[side]['keypoint_valid'] = kv

        # random_pairs: independent coin flips per side; keypoints are
        # deliberately NOT swapped (host-path parity, a reference quirk)
        opt_is_optical = torch.ones(B, dtype=torch.bool, device=dev)
        th_is_optical = torch.zeros(B, dtype=torch.bool, device=dev)
        if random_pairs:
            b1 = mine(torch.rand(G, generator=gen, device=dev)) < 0.5
            b2 = mine(torch.rand(G, generator=gen, device=dev)) < 0.5
            opt, th = (torch.where(b1[:, None, None], th, opt),
                       torch.where(b2[:, None, None], opt, th))
            opt_is_optical, th_is_optical = ~b1, b2

        eye = torch.eye(3, device=dev).expand(B, 3, 3)
        ones = torch.ones(B, h, w, device=dev)
        batch = {
            'optical': {'image': opt[..., None], 'valid_mask': ones,
                        'homography': eye,
                        'is_optical': opt_is_optical[:, None],
                        **sides['optical']},
            'thermal': {'image': th[..., None], 'valid_mask': ones,
                        'homography': eye,
                        'is_optical': th_is_optical[:, None],
                        **sides['thermal']},
        }
        if augment is not None:
            batch = augment(gen, batch)
        # keypoint coords not consumed by the augmentation -> maps
        for side in ('optical', 'thermal'):
            if 'keypoint_coords' in batch[side]:
                batch[side]['keypoints'] = keypoint_map_from_coords(
                    batch[side].pop('keypoint_coords'),
                    batch[side].pop('keypoint_valid'), (h, w))
        return batch

    return batch_fn
