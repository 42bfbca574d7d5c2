"""Stage-3 frame loading for inference (numpy; counterpart of
``drawingspinup_tpu/pipelines/stage3_data.py``, which imports jax at the
top, so these are copies; ``tests/test_torch_stage3.py`` pins each to its
original). Keyframe pairs and patch sampling come with stage-3 training."""
from __future__ import annotations

import os

import numpy as np

from drawingspinup_torch.core.io import read_image_u8


def normalize(img: np.ndarray) -> np.ndarray:
    """[0,1] → [-1,1] (transforms.Normalize(0.5, 0.5))."""
    return img * 2.0 - 1.0


def overlap_edge_on_img(edge: np.ndarray, rgba: np.ndarray) -> np.ndarray:
    """Black out edge pixels (edge<1.0 treated as edge) and set their
    alpha."""
    out = rgba.copy()
    em = edge[..., 0] < 1.0 if edge.ndim == 3 else edge < 1.0
    out[em, 0:3] = 0.0
    out[em, 3] = 1.0
    return out


def load_full_frame_u8(action_dir: str, fname: str, use_edge: bool,
                       pre_dir: str = "color",
                       use_pos: bool = True) -> np.ndarray:
    """u8 source stack (H, W, 7): rgba(4) | edge(1) | pos_xy(2); the
    feature math runs on the device (``train/gan.py::generate_full_rgba``)."""
    rgba = read_image_u8(os.path.join(action_dir, pre_dir, fname))
    h, w = rgba.shape[:2]
    if rgba.shape[-1] == 3:
        rgba = np.concatenate(
            [rgba, np.full((h, w, 1), 255, np.uint8)], -1)
    if use_edge:
        edge = read_image_u8(
            os.path.join(action_dir, "edge", fname))[..., :1]
    else:
        edge = np.full((h, w, 1), 255, np.uint8)   # 255 = "no edge here"
    pos_path = os.path.join(action_dir, "pos", fname)
    if os.path.exists(pos_path):
        pos = read_image_u8(pos_path)[..., 0:2]
    elif use_pos:
        # a missing render pass is an error, not silently-zero features
        raise FileNotFoundError(
            f"pos pass missing for u8 full-frame features: {pos_path}")
    else:
        pos = np.zeros((h, w, 2), np.uint8)   # unused by the consumer
    return np.concatenate([rgba, edge, pos], axis=-1)
