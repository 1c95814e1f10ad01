"""A seeded synthetic pair corpus (no training data is in the repository)."""
import numpy as np


class SyntheticPairs:
    """A seeded synthetic corpus with the ImagePairDataset surface: the
    loading pair the resident-corpus loader reads (``_load_images`` /
    ``_load_keypoints``) and the sample access the label export reads
    (``__getitem__`` / ``get_name``). Smooth random optical images, the
    thermal side a seeded contrast-inverting transform of them, and seeded
    keypoint coordinates (row, col): ``n_pairs`` pairs at ``size``^2 with
    ``n_kp`` keypoints each."""

    def __init__(self, n_pairs=32, size=320, n_kp=256, seed=0):
        rng = np.random.default_rng(seed)
        base = rng.uniform(size=(n_pairs, size // 8, size // 8)).astype(
            np.float32)
        opt = np.kron(base, np.ones((8, 8), np.float32))   # blocky shapes
        opt += 0.1 * rng.normal(size=opt.shape).astype(np.float32)
        self.optical = np.clip(opt, 0, 1)
        self.thermal = np.clip(1.0 - self.optical ** 1.5 + 0.05 * rng.normal(
            size=opt.shape).astype(np.float32), 0, 1)
        self.kps = rng.uniform(0, size, size=(n_pairs, n_kp, 2)).astype(
            np.float32)

    def __len__(self):
        return len(self.optical)

    def _load_images(self, i):
        return self.optical[i], self.thermal[i]

    def _load_keypoints(self, i):
        return self.kps[i]

    def __getitem__(self, i):
        """{'optical': {'image' (H, W, 1)}, 'thermal': {'image'}}."""
        return {'optical': {'image': self.optical[i][..., None]},
                'thermal': {'image': self.thermal[i][..., None]}}

    def get_name(self, i):
        return f"synthetic_{i:05d}"
