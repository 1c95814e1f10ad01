"""RIFT2: the radiation-variation-insensitive feature transform, on the
host in numpy and cv2 (the port's own copy of ``xpoint_tpu/models/rift2.py``,
which the JAX package also runs on the host):
  * Kovesi phase congruency (log-Gabor bank, noise-compensated energy,
    sigmoid frequency-spread weighting, moment maps),
  * FAST keypoints on the normalized maximum-moment map (top npt by
    response),
  * gradient-histogram main orientations (up to 6 per keypoint, smoothed
    hist + parabola peak interpolation),
  * MIM (maximum index map over `no` orientations of summed log-Gabor
    magnitudes) -> rotated-patch 6x6 spatial histogram descriptor,
    216-d L2-normalized.

A benchmark baseline behind ``ClassicDetectors(method='RIFT2')``: its sparse
maps go to the device for NMS, descriptor sampling and matching.
"""
import cv2
import numpy as np


# --------------------------------------------------------------------------
# Phase congruency (Kovesi's PC2, vectorized numpy)
# --------------------------------------------------------------------------

def _lowpassfilter(shape, cutoff=0.45, n=15):
    H, W = shape
    x, y = np.meshgrid(np.linspace(-0.5, 0.5, W), np.linspace(-0.5, 0.5, H))
    radius = np.fft.ifftshift(np.sqrt(x ** 2 + y ** 2))
    return 1.0 / (1.0 + (radius / cutoff) ** (2 * n))


def _filter_grids(shape):
    H, W = shape
    x, y = np.meshgrid(np.linspace(-0.5, 0.5, W), np.linspace(-0.5, 0.5, H))
    radius = np.fft.ifftshift(np.sqrt(x ** 2 + y ** 2))
    theta = np.fft.ifftshift(np.arctan2(-y, x))
    radius[0, 0] = 1.0
    return radius, theta


def phasecong(im, nscale=4, norient=6, minWaveLength=3, mult=1.6,
              sigmaOnf=0.75, k=1.0, cutOff=0.5, g=3.0, noiseMethod=-1):
    """Phase congruency of a grayscale image.

    Returns (M, m, ori, ft, PC, EO, T):
        M/m: max/min moment maps; ori: orientation (deg); ft: feature phase;
        PC: list of per-orientation phase congruency; EO: complex filter
        responses shaped (norient, nscale, H, W); T: noise thresholds.
    """
    im = np.asarray(im, np.float64)
    H, W = im.shape
    imfft = np.fft.fft2(im)
    epsilon = 1e-4

    radius, theta = _filter_grids((H, W))
    sintheta, costheta = np.sin(theta), np.cos(theta)
    lp = _lowpassfilter((H, W))

    # log-Gabor radial components
    loggabor = []
    for s in range(nscale):
        wavelength = minWaveLength * mult ** s
        fo = 1.0 / wavelength
        lg = np.exp(-(np.log(radius / fo)) ** 2 / (2 * np.log(sigmaOnf) ** 2))
        lg *= lp
        lg[0, 0] = 0.0
        loggabor.append(lg)

    # angular spreads
    spreads = []
    for o in range(norient):
        angl = o * np.pi / norient
        ds = sintheta * np.cos(angl) - costheta * np.sin(angl)
        dc = costheta * np.cos(angl) + sintheta * np.sin(angl)
        dtheta = np.abs(np.arctan2(ds, dc))
        dtheta = np.minimum(dtheta * norient / 2, np.pi)
        spreads.append((np.cos(dtheta) + 1) / 2)

    EO = np.zeros((norient, nscale, H, W), np.complex128)
    PC = []
    T_list = []
    EnergyV = np.zeros((H, W, 3))
    pcSum = np.zeros((H, W))

    covx2 = np.zeros((H, W))
    covy2 = np.zeros((H, W))
    covxy = np.zeros((H, W))

    for o in range(norient):
        sumE = np.zeros((H, W))
        sumO = np.zeros((H, W))
        sumAn = np.zeros((H, W))
        maxAn = np.zeros((H, W))
        tau = None
        for s in range(nscale):
            eo = np.fft.ifft2(imfft * loggabor[s] * spreads[o])
            EO[o, s] = eo
            An = np.abs(eo)
            sumAn += An
            sumE += np.real(eo)
            sumO += np.imag(eo)
            if s == 0:
                if noiseMethod == -1:
                    tau = np.median(An) / np.sqrt(np.log(4))
                maxAn = An
            else:
                maxAn = np.maximum(maxAn, An)

        XEnergy = np.sqrt(sumE ** 2 + sumO ** 2) + epsilon
        MeanE = sumE / XEnergy
        MeanO = sumO / XEnergy
        Energy = np.zeros((H, W))
        for s in range(nscale):
            E, O = np.real(EO[o, s]), np.imag(EO[o, s])
            Energy += E * MeanE + O * MeanO - np.abs(E * MeanO - O * MeanE)

        # noise threshold from the smallest-scale amplitude distribution
        totalTau = tau * (1 - (1 / mult) ** nscale) / (1 - 1 / mult)
        EstNoiseEnergyMean = totalTau * np.sqrt(np.pi / 2)
        EstNoiseEnergySigma = totalTau * np.sqrt((4 - np.pi) / 2)
        T = EstNoiseEnergyMean + k * EstNoiseEnergySigma
        T_list.append(T)
        Energy = np.maximum(Energy - T, 0)

        # frequency-spread weighting
        width = (sumAn / (maxAn + epsilon) - 1) / (nscale - 1)
        weight = 1.0 / (1 + np.exp(g * (cutOff - width)))

        pc_o = weight * Energy / sumAn
        PC.append(pc_o)
        pcSum += pc_o

        angl = o * np.pi / norient
        covx = pc_o * np.cos(angl)
        covy = pc_o * np.sin(angl)
        covx2 += covx ** 2
        covy2 += covy ** 2
        covxy += covx * covy

        EnergyV[:, :, 0] += sumE
        EnergyV[:, :, 1] += np.cos(angl) * sumO
        EnergyV[:, :, 2] += np.sin(angl) * sumO

    covx2 /= norient / 2
    covy2 /= norient / 2
    covxy *= 4 / norient
    denom = np.sqrt(covxy ** 2 + (covx2 - covy2) ** 2) + epsilon
    M = (covy2 + covx2 + denom) / 2
    m = (covy2 + covx2 - denom) / 2

    ori = np.degrees(np.arctan2(EnergyV[:, :, 2], EnergyV[:, :, 1])) % 180
    OddV = np.sqrt(EnergyV[:, :, 1] ** 2 + EnergyV[:, :, 2] ** 2)
    ft = np.arctan2(EnergyV[:, :, 0], OddV)

    return M, m, ori, ft, PC, EO, T_list


# --------------------------------------------------------------------------
# RIFT2
# --------------------------------------------------------------------------

DEFAULT_CONFIG = {
    'nscale': 4, 'norient': 6, 'npt': 1000,
    'minWaveLength': 3, 'mult': 1.6, 'sigmaOnf': 0.75, 'g': 3, 'k': 1,
    'patchsize': 96, 'no': 6, 'nbin': 6, 'is_ori': 1, 'ori_peak_ratio': 0.8,
}


class RIFT2:
    def __init__(self, config_file=None, **params):
        self.config = dict(DEFAULT_CONFIG)
        if config_file:
            import yaml
            with open(config_file) as f:
                self.config.update(yaml.safe_load(f) or {})
        self.config.update(params)

    # ---- detection on the maximum-moment map ----
    def feature_detection(self, im):
        cfg = self.config
        M, _, _, _, _, EO, _ = phasecong(
            im, nscale=cfg['nscale'], norient=cfg['norient'],
            minWaveLength=cfg['minWaveLength'], mult=cfg['mult'],
            sigmaOnf=cfg['sigmaOnf'], g=cfg['g'], k=cfg['k'])
        M = (M - M.min()) / max(M.max() - M.min(), 1e-12)
        m_image = (M * 255).astype(np.uint8)

        fast = cv2.FastFeatureDetector_create(threshold=1,
                                              nonmaxSuppression=True)
        keypoints = fast.detect(m_image, None)
        keypoints = sorted(keypoints, key=lambda kp: kp.response,
                           reverse=True)[:cfg['npt']]
        kpts = np.array([kp.pt for kp in keypoints]).T \
            if keypoints else np.zeros((2, 0))
        # EO transposed to (scale, orient, H, W) like the reference (:51)
        return kpts, M, np.transpose(EO, (1, 0, 2, 3))

    # ---- main orientation from gradient histograms ----
    def compute_orientation(self, key, im):
        cfg = self.config
        if key.shape[1] == 0:
            return np.zeros((3, 0))
        sobel = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float64)
        gx = cv2.filter2D(im, -1, sobel, borderType=cv2.BORDER_REPLICATE)
        gy = cv2.filter2D(im, -1, sobel.T, borderType=cv2.BORDER_REPLICATE)
        grad = np.sqrt(gx ** 2 + gy ** 2)
        ang = np.degrees(np.arctan2(gy, gx)) % 360

        r = int(round(cfg['patchsize']))
        n = 24
        out = []
        for k in range(key.shape[1]):
            x, y = int(round(key[0, k])), int(round(key[1, k]))
            x1, y1 = max(1, x - r // 2), max(1, y - r // 2)
            x2 = min(x + r // 2, im.shape[1] - 1)
            y2 = min(y + r // 2, im.shape[0] - 1)
            if y2 - y1 != r or x2 - x1 != r:
                continue
            if cfg['is_ori'] == 1:
                for angle in self._orientation_peaks(
                        x, y, grad, ang, r, n, cfg['ori_peak_ratio']):
                    out.append([x, y, angle])
            else:
                out.append([x, y, 0.0])
        if not out:
            return np.zeros((3, 0))
        kpts = np.array(out).T
        return kpts[:, kpts[0] != 0]

    @staticmethod
    def _orientation_peaks(x, y, grad, ang, patchsize, n, peak_ratio):
        radius = patchsize / 2
        sigma = radius / 3
        x1 = max(0, int(x - radius))
        x2 = min(grad.shape[1], int(x + radius) + 1)
        y1 = max(0, int(y - radius))
        y2 = min(grad.shape[0], int(y + radius) + 1)
        sub_g = grad[y1:y2, x1:x2]
        sub_a = ang[y1:y2, x1:x2]
        X, Y = np.meshgrid(np.arange(x1, x2) - x, np.arange(y1, y2) - y)
        w = sub_g * np.exp(-(X ** 2 + Y ** 2) / (2 * sigma ** 2))
        # elliptical support (reference uses a MORPH_ELLIPSE mask)
        se = cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
                                       (int(patchsize + 1), int(patchsize + 1)))
        w = w * se[:w.shape[0], :w.shape[1]]

        bins = np.round(sub_a * n / 360).astype(int) % n
        raw = np.bincount(bins.ravel(), weights=w.ravel(), minlength=n)
        # [1 4 6 4 1]/16 circular smoothing
        hist = (np.roll(raw, 2) + np.roll(raw, -2)) / 16 \
            + 4 * (np.roll(raw, 1) + np.roll(raw, -1)) / 16 + raw * 6 / 16

        mag_thr = hist.max() * peak_ratio
        angles = []
        for kk in range(n):
            k1, k2 = (kk - 1) % n, (kk + 1) % n
            if hist[kk] > hist[k1] and hist[kk] > hist[k2] and hist[kk] > mag_thr:
                b = kk - 1 + 0.5 * (hist[k1] - hist[k2]) / \
                    (hist[k1] + hist[k2] - 2 * hist[kk])
                b = b % n
                angles.append((360.0 / n) * b)
        return angles

    # ---- MIM descriptor ----
    def feature_description(self, img_hw, eo, kpts):
        cfg = self.config
        no, nbin = cfg['no'], cfg['nbin']
        H, W = img_hw
        CS = np.zeros((H, W, no))
        for j in range(no):
            for i in range(cfg['nscale']):
                CS[:, :, j] += np.abs(eo[i][j])
        MIM = np.argmax(CS, axis=2) + 1          # 1-based like MATLAB

        n = kpts.shape[1]
        descs = np.zeros((no * no * nbin, n))
        r = cfg['patchsize']
        for k in range(n):
            x, y, angdeg = kpts[0, k], kpts[1, k], kpts[2, k]
            patch = self._rotated_patch(MIM.astype(np.float32), x, y,
                                        r // 2, angdeg)
            patch = cv2.resize(patch, (r + 1, r + 1),
                               interpolation=cv2.INTER_LINEAR)
            h, _ = np.histogram(patch, bins=np.arange(1, no + 2))
            idx = int(np.argmax(h))
            patch_rot = patch - idx
            patch_rot[patch_rot < 1] += no

            ys, xs = patch_rot.shape
            histo = np.zeros((no, no, nbin))
            for j in range(no):
                for i in range(no):
                    clip = patch_rot[round(j * ys / no):round((j + 1) * ys / no),
                                     round(i * xs / no):round((i + 1) * xs / no)]
                    histo[j, i] = np.histogram(clip,
                                               bins=np.arange(1, nbin + 2))[0]
            v = histo.ravel()
            norm = np.linalg.norm(v)
            descs[:, k] = v / norm if norm > 0 else v
        return descs

    @staticmethod
    def _rotated_patch(img, x, y, s, angle_deg):
        """Bilinear sample of a (2s+1)^2 patch rotated by angle around (x, y)."""
        h, w = img.shape
        x = int(np.clip(round(x), 0, w - 1))
        y = int(np.clip(round(y), 0, h - 1))
        s = int(round(s))
        t = np.deg2rad(angle_deg)
        size = 2 * s + 1
        xg, yg = np.meshgrid(np.arange(-s, s + 1), np.arange(-s, s + 1))
        R = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
        pts = R @ np.vstack([xg.ravel(), yg.ravel()])
        xr, yr = pts[0] + x, pts[1] + y
        xf = np.floor(xr).astype(int)
        yf = np.floor(yr).astype(int)
        xp, yp = xr - xf, yr - yf
        valid = (xf >= 0) & (xf <= w - 2) & (yf >= 0) & (yf <= h - 2)
        patch = np.zeros(size * size, np.float32)
        xf_v, yf_v, xp_v, yp_v = xf[valid], yf[valid], xp[valid], yp[valid]
        patch[valid] = ((1 - yp_v) * (xp_v * img[yf_v, xf_v + 1]
                                      + (1 - xp_v) * img[yf_v, xf_v])
                        + yp_v * (xp_v * img[yf_v + 1, xf_v + 1]
                                  + (1 - xp_v) * img[yf_v + 1, xf_v]))
        return patch.reshape(size, size)

    # ---- public API ----
    def detectAndCompute(self, image, mask=None):
        del mask
        if image.ndim == 3:
            image = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
        key, M, eo = self.feature_detection(image)
        kpts = self.compute_orientation(key, M)
        des = self.feature_description(image.shape, eo, kpts)
        kp = [cv2.KeyPoint(x=float(p[0]), y=float(p[1]), size=1)
              for p in kpts.T]
        return kp, des.T.astype(np.float32)

    def process_features(self, img1, img2):
        kp1, des1 = self.detectAndCompute(img1)
        kp2, des2 = self.detectAndCompute(img2)
        return kp1, des1, kp2, des2

    def __call__(self, img1, img2):
        return self.process_features(img1, img2)
