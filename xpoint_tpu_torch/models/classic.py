"""The classical detector / descriptor baselines behind the model interface
(the port's own copy of ``xpoint_tpu/models/classic.py``): cv2 SIFT / SURF
(with a lower-threshold second instance when too few keypoints), the LGHD
log-Gabor descriptor and RIFT2, each giving sparse prob / desc maps (1.0 at
a keypoint's pixel, its descriptor planted there). They run on the host in
numpy and cv2, as in the JAX package; ``eval.infer.ClassicInference`` moves
their maps to the device for NMS, descriptor sampling and matching. SURF
needs opencv-contrib (``cv2.xfeatures2d``) and raises RuntimeError without
it.
"""
import copy

import cv2
import numpy as np

from ..utils import dict_update


DEFAULT_CONFIG = {
    'method': 'SURF',
    'prob_smoothing': False,
    'smoothing_kernel_size': 5,
    'min_keypoints': 100,
    'image_H': 512,
    'image_W': 640,
    'takes_pair': False,
}


def _gaussian_kernel(size, sigma=None):
    if sigma is None:
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    g = np.arange(size) - (size - 1) / 2.0
    gx, gy = np.meshgrid(g, g)
    k = np.exp(-(gx ** 2 + gy ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


class ClassicDetectors:
    def __init__(self, config=None):
        self.config = dict_update(copy.deepcopy(DEFAULT_CONFIG), config or {})
        method = self.config['method']
        if method == 'SURF':
            if not hasattr(cv2, 'xfeatures2d'):
                raise RuntimeError('SURF requires opencv-contrib (xfeatures2d)')
            self.method = cv2.xfeatures2d.SURF_create(1500)
            self.method_2 = cv2.xfeatures2d.SURF_create(300)
        elif method == 'SIFT':
            self.method = cv2.SIFT_create(1000)
            self.method_2 = cv2.SIFT_create(1500)
        elif method == 'LGHD':
            self.method = LGHD(self.config['image_H'], self.config['image_W'])
            self.method_2 = self.method
        elif method == 'RIFT2':
            from .rift2 import RIFT2
            self.method = RIFT2()
            self.method_2 = self.method
        else:
            raise ValueError(f'Unknown alignment method: {method}')

        self.kernel = None
        if self.config['prob_smoothing']:
            ks = self.config['smoothing_kernel_size']
            if ks % 2 == 0:
                raise ValueError('smoothing_kernel_size needs to be uneven')
            self.kernel = _gaussian_kernel(ks)

    def __call__(self, data):
        """data['image']: (1, H, W, 1) float [0,1] -> {'prob' (1,H,W),
        'desc' (1,H,W,D)} numpy, sparse maps."""
        image = np.asarray(data['image'])
        assert image.shape[0] == 1 and image.ndim == 4
        img_np = (image[0, ..., 0] * 255.0).astype(np.uint8)

        keypoints, descriptors = self.method.detectAndCompute(img_np, None)
        if len(keypoints) < self.config['min_keypoints']:
            keypoints, descriptors = self.method_2.detectAndCompute(img_np, None)

        H, W = img_np.shape
        prob = np.zeros((1, H, W), np.float32)
        if len(keypoints) > 0:
            D = descriptors.shape[1]
            desc = np.zeros((1, H, W, D), np.float32)
            for kp, des in zip(keypoints, descriptors):
                pt = kp.pt if hasattr(kp, 'pt') else kp
                idx = np.array(pt[::-1]).round().astype(int)
                idx[0] = np.clip(idx[0], 0, H - 1)
                idx[1] = np.clip(idx[1], 0, W - 1)
                prob[0, idx[0], idx[1]] = 1.0
                desc[0, idx[0], idx[1]] = des
            if self.kernel is not None:
                pad = (self.kernel.shape[0] - 1) // 2
                p = np.pad(prob[0], pad, mode='reflect')
                prob[0] = cv2.filter2D(p, -1, self.kernel)[pad:-pad, pad:-pad]
        else:
            desc = np.zeros((1, H, W, 1), np.float32)
        return {'prob': prob, 'desc': desc}

    def takes_pair(self):
        return self.config['takes_pair']


class LGHD:
    """Log-Gabor Histogram Descriptor (reference ClassicDetectors.py:114-236):
    FAST keypoints + histograms of the per-pixel argmax log-Gabor orientation
    over 4x4 subpatches at each scale."""

    def __init__(self, H, W, patch_size=40, n_scales=4, n_angles=6,
                 min_wavelength=3, multiplier=1.6, sigma_onf=0.75,
                 cutoff=0.5, g=3):
        if patch_size % 4:
            raise ValueError('patch size must be a multiple of 4')
        self.filter_bank = self._filter_bank(H, W, n_scales, n_angles,
                                             min_wavelength, multiplier,
                                             sigma_onf)
        self.half = patch_size // 2
        self.fourth = patch_size // 4
        self.n_scales = n_scales
        self.n_angles = n_angles

    @staticmethod
    def _lowpass(H, W, cutoff=0.45, n=15):
        x, y = np.meshgrid(np.linspace(-0.5, 0.5, W), np.linspace(-0.5, 0.5, H))
        radius = np.fft.ifftshift(np.sqrt(x ** 2 + y ** 2))
        return 1.0 / (1.0 + (radius / cutoff) ** (2 * n))

    def _filter_bank(self, H, W, n_scales, n_angles, min_wl, mult, sigma_onf):
        x, y = np.meshgrid(np.linspace(-0.5, 0.5, W), np.linspace(-0.5, 0.5, H))
        radius = np.fft.ifftshift(np.sqrt(x ** 2 + y ** 2))
        theta = np.fft.ifftshift(np.arctan2(-y, x))
        sintheta, costheta = np.sin(theta), np.cos(theta)
        lp = self._lowpass(H, W)
        radius[0, 0] = 1.0
        bank = np.zeros((n_scales * n_angles, H, W))
        for sc in range(n_scales):
            wavelength = min_wl * mult ** sc
            lg = np.exp(-(np.log(radius * wavelength)) ** 2
                        / (2 * np.log(sigma_onf) ** 2)) * lp
            lg[0, 0] = 0.0
            for o in range(n_angles):
                angle = o * np.pi / n_angles
                ds = sintheta * np.cos(angle) - costheta * np.sin(angle)
                dc = costheta * np.cos(angle) + sintheta * np.sin(angle)
                dtheta = np.minimum(np.abs(np.arctan2(ds, dc)) * n_angles * 0.5,
                                    np.pi)
                spread = (np.cos(dtheta) + 1) / 2
                bank[sc * n_angles + o] = lg * spread
        return bank

    def detectAndCompute(self, image, mask=None):
        del mask
        H, W = image.shape
        if (H, W) != self.filter_bank.shape[1:]:
            self.filter_bank = self._filter_bank(H, W, self.n_scales,
                                                 self.n_angles, 3, 1.6, 0.75)
        img_fft = np.fft.fft2(image.astype(np.float64))
        eo_mag = np.abs(np.fft.ifft2(self.filter_bank * img_fft[None]))

        fast = cv2.FastFeatureDetector_create()
        keypoints = fast.detect(image, None)

        valid = np.ones(len(keypoints), bool)
        descs = np.zeros((len(keypoints), 16 * self.n_scales * self.n_angles))
        for i, kp in enumerate(keypoints):
            pos = np.array(kp.pt[::-1]).round().astype(int)
            lo, hi = pos - self.half, pos + self.half
            if np.any(lo < 0) or hi[0] > H or hi[1] > W:
                valid[i] = False
                continue
            patch = eo_mag[:, lo[0]:hi[0], lo[1]:hi[1]]
            desc = np.zeros((self.n_scales, 4, 4, self.n_angles))
            for s in range(self.n_scales):
                max_idx = np.argmax(
                    patch[s * self.n_angles:(s + 1) * self.n_angles], axis=0)
                for j in range(4):
                    for k in range(4):
                        mini = max_idx[j * self.fourth:(j + 1) * self.fourth,
                                       k * self.fourth:(k + 1) * self.fourth]
                        desc[s, j, k] = np.bincount(mini.ravel(),
                                                    minlength=self.n_angles)
            descs[i] = desc.ravel()
        keypoints = [kp for kp, v in zip(keypoints, valid) if v]
        return keypoints, descs[valid]
