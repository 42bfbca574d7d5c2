"""Synthetic per-uid fixtures for the tests and the smoke run: a copy of
``drawingspinup_tpu/utils/synthetic.py`` (``tests/test_torch_recon.py``
pins its files to the original's)."""
from __future__ import annotations

import numpy as np

from drawingspinup_torch.core.contract import UidPaths
from drawingspinup_torch.core.io import write_image


def write_sphere_mv(root, uid, size=64, radius=0.45):
    """Render analytic sphere views into the mv/ contract layout."""
    from drawingspinup_torch.render.cameras import (
        opengl_to_opencv, ortho_ray_grid, rays_to_world, view_matrices,
        w2c_opengl,
    )
    paths = UidPaths(str(root), uid)
    views = ["front", "front_right", "right", "back", "left", "front_left"]
    c2ws, w2cs = view_matrices(views)
    origins, dirs = ortho_ray_grid(size, size)
    front_w2c = opengl_to_opencv(w2c_opengl("front"))
    gl2cv = np.array([1.0, -1.0, -1.0], np.float32)
    for view, c2w, w2c in zip(views, c2ws, w2cs):
        ro, rd = rays_to_world(origins.reshape(-1, 3), dirs.reshape(-1, 3),
                               c2w)
        b = np.sum(ro * rd, -1)
        c = np.sum(ro * ro, -1) - radius ** 2
        disc = b * b - c
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0))
        p = ro + t[:, None] * rd
        n_world = p / radius
        color = np.clip(0.5 + 0.5 * n_world, 0, 1)
        color = np.where(hit[:, None], color, 0).reshape(size, size, 3)
        # normals are stored in the FRONT view camera system as images:
        # n_front_cam_cv = R_front_w2c @ n_world, then cv→gl flip, →[0,1]
        n_cam = n_world @ front_w2c[:3, :3].T
        n_gl = n_cam * gl2cv
        nimg = np.where(hit[:, None], n_gl * 0.5 + 0.5, 0.5)
        nimg = nimg.reshape(size, size, 3)
        mask = hit.reshape(size, size).astype(np.float32)
        write_image(paths.mv("color", view), color)
        write_image(paths.mv("normal", view), np.where(mask[..., None] > 0,
                                                       nimg, 0.0))
        write_image(paths.mv("mask", view), mask)
    # front drawing mask for carving/thinning
    m = np.asarray(
        np.hypot(*np.mgrid[-1:1:size * 1j, -1:1:size * 1j]) < radius * 2,
        np.float32)
    write_image(paths.mask, m)
    return paths
