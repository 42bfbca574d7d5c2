"""Stage-2b data: the per-uid multi-view set for the NSR trainer and the
front carving mask (counterpart of ``stage2_recon.py:56-125`` of the JAX
package).

Conventions of ``instant_nsr/datasets/ortho.py``: per-uid view fallbacks,
normals moved to world space through the front view, masks binarised at
127, the front mask rotated 90° clockwise for isosurface carving.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from drawingspinup_torch.core.contract import UidPaths
from drawingspinup_torch.core.io import read_image
from drawingspinup_torch.render.cameras import (
    opengl_to_opencv, view_matrices, w2c_opengl,
)

TWO_VIEW_UIDS = {"025dc91b146d4f57bd114e07165ff7bd",
                 "b03fed9c34f64114a62c7a963fa804e5",
                 "e91d8a6d3aa444f9b10f3a14a6e0a287"}
FOUR_VIEW_UIDS = {"b32e37e2f0354f569ea9265d753891f7",
                  "b718c3fb937a416b9fe49ff984a1504e",
                  "d12bed5708ed42f2b615b7911c0291fa",
                  "d2f443e21595431f9f2cd580f291f51b"}
SIX_VIEWS = ["front", "front_right", "right", "back", "left", "front_left"]


def views_for_uid(uid: str) -> List[str]:
    if uid in TWO_VIEW_UIDS:
        return ["front", "back"]
    if uid in FOUR_VIEW_UIDS:
        return ["front", "front_right", "back", "front_left"]
    return SIX_VIEWS


def load_ortho_arrays(paths: UidPaths, im_size: int = 1024
                      ) -> Dict[str, np.ndarray]:
    """The views' images (V,H,W,3), world normals (V,H,W,3), binary masks
    (V,H,W), view weights (V,) and c2w (V,3,4), as f32 numpy."""
    views = views_for_uid(paths.uid)
    c2ws, _ = view_matrices(views)
    front_w2c = opengl_to_opencv(w2c_opengl("front"))
    rot_front_c2w = front_w2c[:3, :3].T
    gl2cv = np.array([1.0, -1.0, -1.0], np.float32)

    images, normals, masks = [], [], []
    for view in views:
        color = read_image(paths.mv("color", view))[..., :3]
        normal_img = read_image(paths.mv("normal", view))[..., :3]
        mask = read_image(paths.mv("mask", view))[..., 0]
        if color.shape[0] != im_size:
            from PIL import Image

            def rs(a, mode):
                img = Image.fromarray(
                    (np.clip(a, 0, 1) * 255).astype(np.uint8))
                return np.asarray(img.resize((im_size, im_size), mode),
                                  np.float32) / 255.0
            color = rs(color, Image.LANCZOS)
            normal_img = rs(normal_img, Image.LANCZOS)
            mask = rs(mask[..., None].repeat(3, -1), Image.NEAREST)[..., 0]
        normal = normal_img * 2.0 - 1.0
        m = mask > (127 / 255)
        normal[~m] = 0.0
        normal_world = (normal * gl2cv[None, None, :]) @ rot_front_c2w.T
        images.append(color)
        normals.append(normal_world)
        masks.append(m.astype(np.float32))
    return {"images": np.stack(images).astype(np.float32),
            "normals": np.stack(normals).astype(np.float32),
            "masks": np.stack(masks).astype(np.float32),
            "view_weights": np.ones((len(views),), np.float32),
            "c2w": np.asarray(c2ws, np.float32)}


def load_ortho_data(paths: UidPaths, im_size: int = 1024,
                    hull_trange: bool = True, radius: float = 1.0,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """The trainer's data on ``device``: ``load_ortho_arrays`` as tensors,
    the visual-hull ``t_range`` (V,H,W,2) when ``hull_trange``, and the
    packed per-pixel target table ``pixels``."""
    from drawingspinup_torch.render.hull import hull_t_ranges
    from drawingspinup_torch.train.nsr import pack_pixels

    data = {k: torch.from_numpy(v).to(device)
            for k, v in load_ortho_arrays(paths, im_size).items()}
    if hull_trange:
        data["t_range"] = hull_t_ranges(data["masks"], data["c2w"], radius)
    data["pixels"] = pack_pixels(data)
    return data


def load_front_mask(paths: UidPaths) -> Optional[np.ndarray]:
    """char/mask.png rotated 90° clockwise: the [x, z]-indexed carving
    mask."""
    if not os.path.exists(paths.mask):
        return None
    m = read_image(paths.mask)[..., 0]
    return np.rot90(m, k=-1).copy()
