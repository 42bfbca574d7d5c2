"""Fixed orbit cameras + orthographic rays.

A copy of ``drawingspinup_tpu/render/cameras.py`` (numpy only);
``tests/test_torch_recon.py`` pins it bit-equal to the original.

The reference ships nine 3×4 OpenGL world→cam matrices as txt files
(``mvdiffusion/data/fixed_poses/nine_views``; loaded by
``instant_nsr/datasets/ortho.py:54-97``). Those cameras are an orbit in the
z-up world at elevation 0 (except ``top``), azimuth per view; the four
cardinal views sit at distance 1.3 and the four diagonal views at the
CORNERS of the ±1.3 square (distance 1.3·√2) — synthesized analytically
instead of shipping data files, pinned against the txt files by
``tests/test_reference_parity.py::TestOrthoPoseOracle``.

Conventions:
  * OpenGL camera: x right, y up, z backward (camera looks along −z).
  * OpenCV camera: x right, y down, z forward. gl→cv flips y and z rows.
  * azimuth: 0 = front (camera on −y axis), grows toward +x (right view 90°).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

CAMERA_DISTANCE = 1.3
VIEW_AZIMUTHS_DEG: Dict[str, float] = {
    "front": 0.0,
    "front_right": 45.0,
    "right": 90.0,
    "back_right": 135.0,
    "back": 180.0,
    "back_left": 225.0,
    "left": 270.0,
    "front_left": 315.0,
}


def w2c_opengl(view: str, distance: float = CAMERA_DISTANCE) -> np.ndarray:
    """3×4 world→cam matrix in OpenGL convention for a named orbit view
    (matches the reference's fixed_poses txt files)."""
    if view == "top":
        # camera above, looking down −z(world); world +y becomes camera up
        r = np.array([[1.0, 0.0, 0.0],
                      [0.0, 1.0, 0.0],
                      [0.0, 0.0, 1.0]], np.float32)
        c = np.array([0.0, 0.0, distance], np.float32)
    else:
        a = np.deg2rad(VIEW_AZIMUTHS_DEG[view])
        sa, ca = np.sin(a), np.cos(a)
        x_cam = np.array([ca, sa, 0.0], np.float32)       # right
        y_cam = np.array([0.0, 0.0, 1.0], np.float32)     # up = world z
        z_cam = np.array([sa, -ca, 0.0], np.float32)      # backward
        r = np.stack([x_cam, y_cam, z_cam])
        # the reference's fixed_poses place the four diagonal cameras at the
        # CORNERS of the ±distance square (per-component ±d, i.e. range
        # d·√2), not on the circle of radius d — verified against the
        # instant_nsr/datasets/fixed_poses txt files (t_z 1.8385 = 1.3·√2
        # for front_right/front_left/back_right/back_left, 1.3 elsewhere).
        # Irrelevant for the ortho PROJECTION, but it shifts where t=0 sits
        # on each ray and thus keeps depth/t conventions bit-compatible.
        if VIEW_AZIMUTHS_DEG[view] % 90.0 == 45.0:
            c = distance * np.sqrt(2.0, dtype=np.float32) * z_cam
        else:
            c = distance * z_cam
    t = -r @ c
    return np.concatenate([r, t[:, None]], axis=1).astype(np.float32)


def opengl_to_opencv(rt: np.ndarray) -> np.ndarray:
    """Flip y and z camera rows (reference RT_opengl2opencv, ortho.py:31-38)."""
    flip = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    return np.concatenate([flip @ rt[:3, :3], (flip @ rt[:3, 3])[:, None]],
                          axis=1)


def invert_rt(rt: np.ndarray) -> np.ndarray:
    """3×4 [R|t] inverse → cam2world (reference inv_RT)."""
    r, t = rt[:3, :3], rt[:3, 3]
    return np.concatenate([r.T, (-r.T @ t)[:, None]], axis=1).astype(np.float32)


def view_matrices(views: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (c2w (V,3,4), w2c (V,3,4)) in OpenCV convention."""
    w2cs = np.stack([opengl_to_opencv(w2c_opengl(v)) for v in views])
    c2ws = np.stack([invert_rt(m) for m in w2cs])
    return c2ws, w2cs


def ortho_ray_grid(w: int, h: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel camera-space ortho ray (origins, dirs), both (H, W, 3):
    origins on the image plane in [-1,1]², dirs = +z (OpenCV forward).
    Matches reference get_ortho_ray_directions_origins (ray_utils.py:20-38)."""
    i, j = np.meshgrid(np.arange(w, dtype=np.float32) + 0.5,
                       np.arange(h, dtype=np.float32) + 0.5, indexing="xy")
    origins = np.stack([(i / w - 0.5) * 2, (j / h - 0.5) * 2,
                        np.zeros_like(i)], axis=-1)
    dirs = np.stack([np.zeros_like(i), np.zeros_like(i),
                     np.ones_like(i)], axis=-1)
    return origins.astype(np.float32), dirs.astype(np.float32)


def rays_to_world(origins: np.ndarray, dirs: np.ndarray,
                  c2w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate/translate camera-space ortho rays into world space
    (reference get_ortho_rays, ray_utils.py:41-58). Shapes (..., 3), c2w
    broadcastable (..., 3, 4)."""
    r = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    rays_d = np.einsum("...ij,...j->...i", r, dirs)
    rays_o = np.einsum("...ij,...j->...i", r, origins) + t
    return rays_o, rays_d
