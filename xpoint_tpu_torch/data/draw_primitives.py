"""Synthetic-shape generators with exact corner ground truth (own copy of
``xpoint_tpu/data/draw_primitives.py``).

Host-side numpy/cv2: images are float grayscale in [0, 1], every generator
draws into ``img`` in place and returns an (n, 2) int array of interest
points in (x, y) order. The JAX package draws from the global ``np.random``
and ``random`` streams; every generator here takes them as arguments,
``rng`` (a ``np.random.RandomState``) and ``py_rng`` (a ``random.Random``),
and draws in the same order, so generators seeded as the global streams
were give the same image and points.
"""
import math

import cv2
import numpy as np


def _random_color(py_rng, background_color, min_contrast=0.13):
    """Grayscale value contrasting with the background by >= min_contrast."""
    color = py_rng.random()
    if abs(color - background_color) < min_contrast:
        color = (color + 0.5) % 1.0
    return color


def _different_color(py_rng, previous_colors, min_contrast=0.13,
                     max_count=20):
    color = py_rng.random()
    for _ in range(max_count):
        if not np.any(np.abs(np.asarray(previous_colors) - color)
                      < min_contrast):
            break
        color = py_rng.random()
    return color


def keep_points_inside(points, size):
    """Keep (x, y) points inside an image of shape ``size`` = (H, W)."""
    if len(points) == 0:
        return points
    mask = ((points[:, 0] >= 0) & (points[:, 0] < size[1])
            & (points[:, 1] >= 0) & (points[:, 1] < size[0]))
    return points[mask]


def _ccw(a, b, c):
    return ((c[:, 1] - a[:, 1]) * (b[:, 0] - a[:, 0])
            > (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))


def _segments_intersect(seg, segments):
    """True if segment ``seg`` (x1, y1, x2, y2) crosses any row of
    ``segments``."""
    if len(segments) == 0:
        return False
    a, b = seg[:2][None], seg[2:][None]
    c, d = segments[:, :2], segments[:, 2:]
    return bool(np.any((_ccw(a, c, d) != _ccw(b, c, d))
                       & (_ccw(a, b, c) != _ccw(a, b, d))))


def generate_background(rng, py_rng, shape=(240, 320), nb_blobs=100,
                        min_rad_ratio=0.01, max_rad_ratio=0.05,
                        min_kernel_size=50, max_kernel_size=300,
                        min_contrast=0.13):
    """Random thresholded noise + contrasting blobs, box-blurred."""
    img = rng.rand(shape[0], shape[1])
    dim = max(shape)
    cv2.threshold(img, py_rng.random(), 1.0, cv2.THRESH_BINARY, img)
    background_color = float(np.mean(img))
    for _ in range(nb_blobs):
        center = (rng.randint(shape[1]), rng.randint(shape[0]))
        radius = py_rng.randint(int(dim * min_rad_ratio),
                                int(dim * max_rad_ratio))
        cv2.circle(img, center, radius,
                   _random_color(py_rng, background_color, min_contrast), -1)
    ks = py_rng.randint(min_kernel_size, max_kernel_size)
    cv2.blur(img, (ks, ks), img)
    return img.astype(np.float32)


def draw_lines(img, rng, py_rng, nb_lines=10, min_contrast=0.13):
    """Random non-crossing segments; keypoints = endpoints."""
    num_lines = py_rng.randint(1, nb_lines)
    segments = np.empty((0, 4), dtype=int)
    points = np.empty((0, 2), dtype=int)
    background_color = float(np.mean(img))
    min_dim = min(img.shape)
    for _ in range(num_lines):
        x1, y1 = rng.randint(img.shape[1]), rng.randint(img.shape[0])
        x2, y2 = rng.randint(img.shape[1]), rng.randint(img.shape[0])
        seg = np.array([x1, y1, x2, y2])
        if _segments_intersect(seg, segments):
            continue
        segments = np.concatenate([segments, seg[None]], 0)
        col = _random_color(py_rng, background_color, min_contrast)
        thickness = py_rng.randint(max(int(min_dim * 0.01), 1),
                                   max(int(min_dim * 0.02), 2))
        cv2.line(img, (x1, y1), (x2, y2), col, thickness)
        points = np.concatenate([points, [[x1, y1], [x2, y2]]], 0)
    return points


def draw_polygon(img, rng, py_rng, max_sides=8, min_contrast=0.13):
    """One random convex-ish polygon; keypoints = vertices."""
    num_corners = py_rng.randint(3, max_sides)
    min_dim = min(img.shape[0], img.shape[1])
    rad = max(py_rng.random() * min_dim / 2, min_dim / 10)
    x = py_rng.randint(int(rad), img.shape[1] - int(rad))
    y = py_rng.randint(int(rad), img.shape[0] - int(rad))

    # sample angles on a circle, draw vertices at random radii
    slices = np.linspace(0, 2 * math.pi, num_corners + 1)
    angles = [slices[i] + py_rng.random() * (slices[i + 1] - slices[i])
              for i in range(num_corners)]
    points = np.array([[int(x + max(py_rng.random(), 0.4) * rad * math.cos(a)),
                        int(y + max(py_rng.random(), 0.4) * rad * math.sin(a))]
                       for a in angles])

    # filter sharp corners (same idea as the reference: keep angle > 60 deg)
    corners = points.reshape(-1, 2)
    n = len(corners)
    keep = []
    for i in range(n):
        v1 = corners[(i - 1) % n] - corners[i]
        v2 = corners[(i + 1) % n] - corners[i]
        norm = np.linalg.norm(v1) * np.linalg.norm(v2)
        if norm < 1e-6:
            continue
        ang = math.acos(np.clip(np.dot(v1, v2) / norm, -1, 1))
        if ang > math.pi / 3:
            keep.append(i)
    if len(keep) < 3:
        return np.empty((0, 2), dtype=int)
    corners = corners[keep]

    background_color = float(np.mean(img))
    col = _random_color(py_rng, background_color, min_contrast)
    cv2.fillPoly(img, [corners.reshape(-1, 1, 2)], col)
    return corners


def draw_multiple_polygons(img, rng, py_rng, max_sides=8, nb_polygons=30,
                           kernel_boundaries=(50, 100), min_contrast=0.13):
    """Several non-overlapping polygons with shaded background fills."""
    segments = np.empty((0, 4), dtype=int)
    centers, rads = [], []
    points = np.empty((0, 2), dtype=int)
    background_color = float(np.mean(img))
    for _ in range(nb_polygons):
        num_corners = py_rng.randint(3, max_sides)
        min_dim = min(img.shape[0], img.shape[1])
        rad = max(py_rng.random() * min_dim / 2, min_dim / 10)
        x = py_rng.randint(int(rad), img.shape[1] - int(rad))
        y = py_rng.randint(int(rad), img.shape[0] - int(rad))

        # reject overlaps with previous polygons
        center = np.array([x, y])
        if any(np.linalg.norm(center - c) < rad + r
               for c, r in zip(centers, rads)):
            continue

        slices = np.linspace(0, 2 * math.pi, num_corners + 1)
        angles = [slices[i] + py_rng.random() * (slices[i + 1] - slices[i])
                  for i in range(num_corners)]
        corners = np.array(
            [[int(x + max(py_rng.random(), 0.4) * rad * math.cos(a)),
              int(y + max(py_rng.random(), 0.4) * rad * math.sin(a))]
             for a in angles])

        new_segments = np.stack([
            np.concatenate([corners[i], corners[(i + 1) % num_corners]])
            for i in range(num_corners)])
        if any(_segments_intersect(s, segments) for s in new_segments):
            continue
        segments = np.concatenate([segments, new_segments], 0)
        centers.append(center)
        rads.append(rad)

        col = _random_color(py_rng, background_color, min_contrast)
        cv2.fillPoly(img, [corners.reshape(-1, 1, 2)], col)
        points = np.concatenate([points, corners], 0)
    return points


def draw_ellipses(img, rng, py_rng, nb_ellipses=20, min_contrast=0.13):
    """Non-overlapping ellipses — NO keypoints (smooth contours)."""
    centers, rads = [], []
    min_dim = min(img.shape[0], img.shape[1]) / 4
    background_color = float(np.mean(img))
    for _ in range(nb_ellipses):
        ax = int(max(py_rng.random() * min_dim, min_dim / 5))
        ay = int(max(py_rng.random() * min_dim, min_dim / 5))
        max_rad = max(ax, ay)
        x = py_rng.randint(max_rad, img.shape[1] - max_rad)
        y = py_rng.randint(max_rad, img.shape[0] - max_rad)
        center = np.array([x, y])
        if any(np.linalg.norm(center - c) < max_rad + r
               for c, r in zip(centers, rads)):
            continue
        centers.append(center)
        rads.append(max_rad)
        col = _random_color(py_rng, background_color, min_contrast)
        angle = py_rng.random() * 90
        cv2.ellipse(img, (x, y), (ax, ay), angle, 0, 360, col, -1)
    return np.empty((0, 2), dtype=int)


def draw_star(img, rng, py_rng, nb_branches=6, min_contrast=0.13):
    """Star of segments from a center; keypoints = center + tips."""
    num_branches = py_rng.randint(3, nb_branches)
    min_dim = min(img.shape[0], img.shape[1])
    thickness = py_rng.randint(max(int(min_dim * 0.01), 1),
                               max(int(min_dim * 0.02), 2))
    rad = max(py_rng.random() * min_dim / 2, min_dim / 5)
    x = py_rng.randint(int(rad), img.shape[1] - int(rad))
    y = py_rng.randint(int(rad), img.shape[0] - int(rad))
    slices = np.linspace(0, 2 * math.pi, num_branches + 1)
    angles = [slices[i] + py_rng.random() * (slices[i + 1] - slices[i])
              for i in range(num_branches)]
    points = np.array([[int(x + max(py_rng.random(), 0.3) * rad * math.cos(a)),
                        int(y + max(py_rng.random(), 0.3) * rad * math.sin(a))]
                       for a in angles])
    points = np.concatenate([[[x, y]], points], 0)
    background_color = float(np.mean(img))
    for i in range(1, num_branches + 1):
        col = _random_color(py_rng, background_color, min_contrast)
        cv2.line(img, (x, y), (points[i][0], points[i][1]), col, thickness)
    return points


def draw_checkerboard(img, rng, py_rng, max_rows=7, max_cols=7,
                      transform_params=(0.05, 0.15), min_contrast=0.13):
    """Perspective-warped checkerboard; keypoints = warped grid crossings."""
    background_color = float(np.mean(img))
    rows = py_rng.randint(3, max_rows)
    cols = py_rng.randint(3, max_cols)
    s = min((img.shape[1] - 1) // cols, (img.shape[0] - 1) // rows)
    n_pts = (rows + 1) * (cols + 1)
    x_coord = np.tile(np.arange(cols + 1), rows + 1).reshape(n_pts, 1)
    y_coord = np.repeat(np.arange(rows + 1), cols + 1).reshape(n_pts, 1)
    points = s * np.concatenate([x_coord, y_coord], axis=1)

    # random affine + perspective warp of the grid
    alpha_aff = py_rng.uniform(-math.pi / 6, math.pi / 6)
    center = np.mean(points, axis=0)
    scale = 1.0 + py_rng.uniform(*transform_params)
    rot = np.array([[math.cos(alpha_aff), -math.sin(alpha_aff)],
                    [math.sin(alpha_aff), math.cos(alpha_aff)]]) / scale
    warped = (points - center) @ rot.T + center
    # perspective-ish shear
    shear = py_rng.uniform(-0.2, 0.2)
    warped[:, 0] += shear * (warped[:, 1] - center[1])
    # translate into the image
    warped += np.array([
        py_rng.randint(0, max(img.shape[1] - int(warped[:, 0].max()), 1)),
        py_rng.randint(0, max(img.shape[0] - int(warped[:, 1].max()), 1))])
    warped = warped.astype(int)

    # fill cells with random colors
    colors = np.zeros((rows * cols,), dtype=np.float32)
    for i in range(rows):
        for j in range(cols):
            idx = i * cols + j
            colors[idx] = _different_color(py_rng, colors[max(0, idx - 1):idx]
                                           if idx > 0 else [background_color],
                                           min_contrast)
            corner_ids = [i * (cols + 1) + j, i * (cols + 1) + j + 1,
                          (i + 1) * (cols + 1) + j + 1,
                          (i + 1) * (cols + 1) + j]
            cv2.fillConvexPoly(img, warped[corner_ids].reshape(-1, 1, 2),
                               float(colors[idx]))
    return keep_points_inside(warped, img.shape[:2])


def draw_stripes(img, rng, py_rng, max_nb_cols=13, min_width_ratio=0.04,
                 transform_params=(0.05, 0.15), min_contrast=0.13):
    """Warped vertical stripes; keypoints = stripe boundary corners."""
    background_color = float(np.mean(img))
    board_size = (int(img.shape[0] * (1 + py_rng.uniform(*transform_params))),
                  int(img.shape[1] * (1 + py_rng.uniform(*transform_params))))
    nb_cols = py_rng.randint(5, max_nb_cols)
    min_width = int(board_size[1] * min_width_ratio)
    xs = np.sort(rng.randint(0, board_size[1], nb_cols - 1))
    xs = np.concatenate([[0], xs, [board_size[1] - 1]])
    # enforce min width by dropping close columns
    keep = [0]
    for i in range(1, len(xs)):
        if xs[i] - xs[keep[-1]] >= min_width:
            keep.append(i)
    xs = xs[keep]

    top = np.stack([xs, np.zeros_like(xs)], 1)
    bottom = np.stack([xs, np.full_like(xs, board_size[0] - 1)], 1)
    points = np.concatenate([top, bottom], 0).astype(np.float64)

    # global affine jitter
    alpha = py_rng.uniform(-math.pi / 12, math.pi / 12)
    center = points.mean(0)
    rot = np.array([[math.cos(alpha), -math.sin(alpha)],
                    [math.sin(alpha), math.cos(alpha)]])
    points = (points - center) @ rot.T + center
    points += np.array([
        py_rng.randint(-board_size[1] // 8, board_size[1] // 8),
        py_rng.randint(-board_size[0] // 8, board_size[0] // 8)])
    points = points.astype(int)

    n = len(xs)
    color = _random_color(py_rng, background_color, min_contrast)
    for i in range(n - 1):
        color = (color + 0.25 + 0.5 * py_rng.random()) % 1.0
        poly = np.array([points[i], points[i + 1], points[n + i + 1],
                         points[n + i]])
        cv2.fillConvexPoly(img, poly.reshape(-1, 1, 2), color)
    return keep_points_inside(points, img.shape[:2])


def draw_cube(img, rng, py_rng, min_size_ratio=0.2, min_angle_rot=math.pi / 10,
              scale_interval=(0.4, 0.6), trans_interval=(0.5, 0.2),
              min_contrast=0.13):
    """A 3D cube projected with random rotation; keypoints = the 7 visible
    vertices (hidden back corner excluded)."""
    background_color = float(np.mean(img))
    min_dim = min(img.shape[:2])
    min_side = min_dim * min_size_ratio
    lx = min_side + py_rng.random() * 2 * min_dim / 3
    ly = min_side + py_rng.random() * 2 * min_dim / 3
    lz = min_side + py_rng.random() * 2 * min_dim / 3
    cube = np.array([[0, 0, 0], [lx, 0, 0], [0, ly, 0], [lx, ly, 0],
                     [0, 0, lz], [lx, 0, lz], [0, ly, lz], [lx, ly, lz]])
    rot_angles = [py_rng.uniform(min_angle_rot, math.pi / 3)
                  * (1 if py_rng.random() > 0.5 else -1) for _ in range(3)]
    cx, sx = math.cos(rot_angles[0]), math.sin(rot_angles[0])
    cy, sy = math.cos(rot_angles[1]), math.sin(rot_angles[1])
    cz, sz = math.cos(rot_angles[2]), math.sin(rot_angles[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    cube = cube @ (rx @ ry @ rz).T
    scale = (np.array([py_rng.uniform(*scale_interval)] * 3) * min_dim
             / max(lx, ly, lz))
    cube *= scale
    lo, hi = (trans_interval[0] - trans_interval[1],
              trans_interval[0] + trans_interval[1])
    cube += np.array([py_rng.uniform(lo, hi) * img.shape[1],
                      py_rng.uniform(lo, hi) * img.shape[0], 0.0])
    pts2d = cube[:, :2].astype(int)

    # vertex 0 is the hidden back corner after this construction; draw the
    # three faces meeting at vertex 7
    faces = np.array([[7, 3, 1, 5], [7, 5, 4, 6], [7, 6, 2, 3]])
    col_face = _random_color(py_rng, background_color, min_contrast)
    for i in range(3):
        col = (col_face + 0.15 * i) % 1.0
        cv2.fillPoly(img, [pts2d[faces[i]].reshape(-1, 1, 2)], col)
    thickness = max(py_rng.randint(int(min_dim * 0.003),
                                   int(min_dim * 0.015)), 1)
    for f in faces:
        for j in range(4):
            cv2.line(img, tuple(pts2d[f[j]]), tuple(pts2d[f[(j + 1) % 4]]),
                     0.0, thickness)
    points = pts2d[1:]                      # all vertices except hidden 0
    return keep_points_inside(points, img.shape[:2])


def gaussian_noise(img, rng, py_rng, min_contrast=0.13):
    """Pure noise image — no keypoints."""
    img[:] = rng.rand(*img.shape)
    return np.empty((0, 2), dtype=int)
