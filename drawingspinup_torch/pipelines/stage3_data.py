"""Stage-3 data: full-frame and keyframe-pair loading (numpy), and patch
sampling on the device (counterpart of
``drawingspinup_tpu/pipelines/stage3_data.py``, which imports jax at the
top, so the numpy helpers are copies; ``tests/test_torch_stage3.py`` and
``tests/test_torch_train.py`` pin each to its original).

The keyframe tensors live on the device; each train step cuts its batch of
patches there from random valid midpoints, with no host→device traffic.
The JAX package pads the midpoint list to 16384-row buckets so that every
uid shares one compiled program; PyTorch compiles nothing, so the list is
kept at its real length, and an empty mask samples midpoint (0, 0), as
the JAX package's ``n_valid = max(n_real, 1)`` does.
"""
from __future__ import annotations

import os
from typing import Dict, NamedTuple, Union

import numpy as np
import torch

from drawingspinup_torch.core.io import read_image, read_image_u8


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


def overlap_rotated(rgba: np.ndarray) -> np.ndarray:
    """Composite a 90°-clockwise-rotated copy under the image (reference
    overlap_img)."""
    rot = np.rot90(rgba, k=-1).copy()
    a1 = rgba[..., 3:4]
    a2 = rot[..., 3:4]
    rgb = a1 * rgba[..., :3] + a2 * rot[..., :3] * (1 - a1)
    alpha = a1 + a2 * (1 - a1)
    return np.concatenate([rgb, alpha], axis=-1)


def cat_with_rotated(rgba: np.ndarray) -> np.ndarray:
    """[img | rotated-overlap(img)] side by side (reference cat_img)."""
    return np.concatenate([rgba, overlap_rotated(rgba)], axis=1)


def cat_mask_with_rotated(mask: np.ndarray) -> np.ndarray:
    rot = np.rot90(mask, k=-1).copy()
    return np.concatenate([mask, np.maximum(mask, rot)], axis=1)


class KeyframePair(NamedTuple):
    """A training pair on the host (numpy)."""
    pre: np.ndarray         # (H, W, C) f32 normalized input features
    post: np.ndarray        # (H, W, 3) f32 normalized target
    mask: np.ndarray        # (H, W) f32 [0,1]
    valid_yx: np.ndarray    # (n_real, 2) int32 valid midpoints


def load_keyframe_pair(action_dir: str, pre_dir: str, post_path: str,
                       use_mask: bool = True, use_pos: bool = True,
                       use_edge: bool = False,
                       frame: str = "0001.png") -> KeyframePair:
    """Rendered keyframe (pre) against the character drawing (post, with
    the render's alpha, on white), both normalized to [-1, 1]; in edge mode
    each is doubled side by side with its rotated overlap."""
    pre_rgba = read_image(os.path.join(action_dir, pre_dir, frame))
    if pre_rgba.shape[-1] == 3:
        pre_rgba = np.concatenate(
            [pre_rgba, np.ones_like(pre_rgba[..., :1])], axis=-1)
    mask = pre_rgba[..., 3]
    post = read_image(post_path)
    if post.shape[-1] == 3:
        post = np.concatenate([post, np.ones_like(post[..., :1])], axis=-1)
    if post.shape[:2] != mask.shape:
        # the drawing and the render share 512² in the reference; when the
        # render grew, the drawing is resized to match
        from PIL import Image
        a = (np.clip(post, 0, 1) * 255).astype(np.uint8)
        post = np.asarray(Image.fromarray(a).resize(
            (mask.shape[1], mask.shape[0]), Image.LANCZOS),
            np.float32) / 255.0
    post = post.copy()
    post[..., 3] = mask  # replace_alpha

    pos = None
    if use_pos:
        # the pos PNG's real alpha: the edge augmentation alpha-composites
        # the rotated copy
        pos = read_image(os.path.join(action_dir, "pos", frame))
        if pos.shape[-1] == 3:
            pos = np.concatenate([pos, np.ones_like(pos[..., :1])], -1)
    if use_edge:
        edge = read_image(os.path.join(action_dir, "edge", frame))
        pre_rgba = overlap_edge_on_img(edge, pre_rgba)
        pre_rgba = cat_with_rotated(pre_rgba)
        mask = cat_mask_with_rotated(mask)
        post = cat_with_rotated(post)
        if pos is not None:
            pos = cat_with_rotated(pos)
    if pos is not None:
        pos = pos[..., :3]

    post_rgb = post[..., :3] * post[..., 3:4] + (1.0 - post[..., 3:4])

    feats = [normalize(pre_rgba[..., :3])]
    if use_mask:
        feats.append(mask[..., None])
    if use_pos:
        feats.append(normalize(pos[..., 0:2]))
    pre = np.concatenate(feats, axis=-1)

    # valid midpoints: mask dilated by MaxFilter(7) → radius 3
    from scipy import ndimage
    valid = ndimage.maximum_filter(mask, size=7) > 0
    ys, xs = np.nonzero(valid)
    return KeyframePair(
        pre=pre.astype(np.float32),
        post=normalize(post_rgb).astype(np.float32),
        mask=mask.astype(np.float32),
        valid_yx=np.stack([ys, xs], axis=1).astype(np.int32))


class KeyframeData(NamedTuple):
    """A training pair on the device."""
    pre: torch.Tensor       # (H, W, C) f32
    post: torch.Tensor      # (H, W, 3) f32
    mask: torch.Tensor      # (H, W) f32
    valid_yx: torch.Tensor  # (n_valid, 2) int64 midpoints
    n_valid: int            # max(n_real, 1)


def keyframe_data(pair: KeyframePair,
                  device: Union[str, torch.device]) -> KeyframeData:
    """Move a pair to ``device``; an empty midpoint list becomes [(0, 0)]."""
    yx = pair.valid_yx if len(pair.valid_yx) else np.zeros((1, 2), np.int32)
    return KeyframeData(
        pre=torch.from_numpy(pair.pre).to(device),
        post=torch.from_numpy(pair.post).to(device),
        mask=torch.from_numpy(pair.mask).to(device),
        valid_yx=torch.from_numpy(yx.astype(np.int64)).to(device),
        n_valid=len(yx))


def _cut(img: torch.Tensor, mids: torch.Tensor, size: int) -> torch.Tensor:
    """(B, size, size, C) windows of the (H, W, C) ``img`` centered at the
    (B, 2) ``mids``: rows y − size//2 … y − size//2 + size − 1, zero outside
    the image (the JAX ``_cut``'s padded dynamic slice)."""
    h, w = img.shape[0], img.shape[1]
    off = torch.arange(size, device=img.device) - size // 2
    rows = mids[:, 0:1] + off                       # (B, size)
    cols = mids[:, 1:2] + off
    inside = (((rows >= 0) & (rows < h))[:, :, None]
              & ((cols >= 0) & (cols < w))[:, None, :])
    patch = img[rows.clamp(0, h - 1)[:, :, None],
                cols.clamp(0, w - 1)[:, None, :]]
    return torch.where(inside[..., None], patch, 0.0)


def cut_patches(data: KeyframeData, mids: torch.Tensor, mids_r: torch.Tensor,
                size: int) -> Dict[str, torch.Tensor]:
    """pre/post/mask patches at ``mids`` and a ground-truth patch (and its
    mask) at the independent ``mids_r`` for the discriminator."""
    mask3 = data.mask[..., None]
    return {
        "pre": _cut(data.pre, mids, size),
        "post": _cut(data.post, mids, size),
        "pre_mask": _cut(mask3, mids, size),
        "already": _cut(data.post, mids_r, size),
        "already_mask": _cut(mask3, mids_r, size),
    }


def sample_patches(data: KeyframeData, generator: torch.Generator,
                   batch: int, size: int) -> Dict[str, torch.Tensor]:
    """A random patch batch: two index draws from ``generator`` (a
    ``torch.Generator`` on the data's device), then ``cut_patches``."""
    dev = data.valid_yx.device
    i1 = torch.randint(0, data.n_valid, (batch,), generator=generator,
                       device=dev)
    i2 = torch.randint(0, data.n_valid, (batch,), generator=generator,
                       device=dev)
    return cut_patches(data, data.valid_yx[i1], data.valid_yx[i2], size)


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
