"""Photometric augmentation primitives on the host (numpy and cv2; own copy
of ``xpoint_tpu/data/photometric.py``): six primitives on float grayscale
images in [0, 1].

The JAX package draws from the global ``np.random`` stream; each primitive
here takes the ``np.random.RandomState`` to draw from as its second
argument, in the same order, so a RandomState seeded as the global stream
was gives the same image.
"""
import cv2
import numpy as np

augmentations = [
    'additive_gaussian_noise',
    'additive_speckle_noise',
    'random_brightness',
    'random_contrast',
    'additive_shade',
    'motion_blur',
]


def additive_gaussian_noise(image, rng, stddev_range=(0.0, 0.06)):
    stddev = rng.uniform(*stddev_range)
    image = image + rng.normal(0.0, stddev, image.shape)
    return np.clip(image, 0.0, 1.0)


def additive_speckle_noise(image, rng, prob_range=(0.0, 0.005)):
    prob = rng.uniform(*prob_range)
    sample = rng.uniform(size=image.shape)
    image = image.copy()
    image[sample < prob] = 0.0
    image[sample > (1.0 - prob)] = 1.0
    return image


def random_brightness(image, rng, max_abs_change=0.2):
    delta = rng.uniform(-max_abs_change, max_abs_change)
    return np.clip(image + delta, 0.0, 1.0)


def random_contrast(image, rng, strength_range=(0.5, 1.5)):
    mean = image.mean()
    strength = rng.uniform(*strength_range)
    return np.clip((image - mean) * strength + mean, 0.0, 1.0)


def additive_shade(image, rng, nb_ellipses=20, transparency_range=(-0.5, 0.8),
                   kernel_size_range=(250, 350)):
    min_dim = min(image.shape[:2]) / 4
    mask = np.zeros(image.shape[:2], np.float32)
    for _ in range(nb_ellipses):
        ax = int(max(rng.rand() * min_dim, min_dim / 5))
        ay = int(max(rng.rand() * min_dim, min_dim / 5))
        max_rad = max(ax, ay)
        x = rng.randint(max_rad, image.shape[1] - max_rad)
        y = rng.randint(max_rad, image.shape[0] - max_rad)
        angle = rng.rand() * 90
        cv2.ellipse(mask, (x, y), (ax, ay), angle, 0, 360, 1.0, -1)
    transparency = rng.uniform(*transparency_range)
    kernel_size = rng.randint(*kernel_size_range)
    if kernel_size % 2 == 0:
        kernel_size += 1
    mask = cv2.GaussianBlur(mask, (kernel_size, kernel_size), 0)
    return np.clip(image * (1 - transparency * mask), 0.0, 1.0)


def motion_blur(image, rng, max_kernel_size=10):
    mode = rng.choice(['h', 'v', 'diag_down', 'diag_up'])
    ksize = rng.randint(0, (max_kernel_size + 1) // 2) * 2 + 1
    center = (ksize - 1) // 2
    kernel = np.zeros((ksize, ksize))
    if mode == 'h':
        kernel[center, :] = 1.0
    elif mode == 'v':
        kernel[:, center] = 1.0
    elif mode == 'diag_down':
        kernel = np.eye(ksize)
    else:
        kernel = np.flip(np.eye(ksize), 0)
    var = ksize * ksize / 16.0
    grid = np.repeat(np.arange(ksize)[:, None], ksize, axis=-1)
    gaussian = np.exp(-(np.square(grid - center) + np.square(grid.T - center))
                      / (2.0 * var))
    kernel *= gaussian
    kernel /= kernel.sum()
    return cv2.filter2D(image, -1, kernel)
