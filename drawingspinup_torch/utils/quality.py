"""Image, mesh and GIF fidelity metrics for per-stage output comparison
(counterpart of ``drawingspinup_tpu/utils/quality.py``).

PSNR, SSIM, the mesh chamfer and the GIF frame metrics are numpy, scipy
and PIL code, copied from the JAX package so that the judge runs where it
is not installed; ``tests/test_torch_fidelity.py`` pins each copy to its
original. The perceptual distance runs the port's ``PerceptualVGG19`` in
f32 on the given device: real VGG19 weights from an npz
(``scripts/export_vgg19_npz.py``'s layout, ``vgg_npz`` or
``$DSU_VGG19_NPZ``), else fixed random features drawn from ``VGG_SEED`` by
a CPU generator, so that every device reports the same numbers; the random
features are recorded as a degraded weight.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from drawingspinup_torch.core import weights_policy
from drawingspinup_torch.core.io import read_image, read_obj

VGG_SEED = 12345
# images per VGG forward: about 4 M pixels (4 pairs of 1024² images)
BATCH_PIXELS = 1 << 22

_VGG: Dict[Tuple[str, Optional[str]], torch.nn.Module] = {}


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val ** 2 / mse))


def ssim(a: np.ndarray, b: np.ndarray, max_val: float = 1.0,
         sigma: float = 1.5) -> float:
    """Mean SSIM with a gaussian window (grayscale or per-channel mean)."""
    from scipy import ndimage

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        return float(np.mean([ssim(a[..., c], b[..., c], max_val, sigma)
                              for c in range(a.shape[-1])]))
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_a = ndimage.gaussian_filter(a, sigma)
    mu_b = ndimage.gaussian_filter(b, sigma)
    va = ndimage.gaussian_filter(a * a, sigma) - mu_a ** 2
    vb = ndimage.gaussian_filter(b * b, sigma) - mu_b ** 2
    cov = ndimage.gaussian_filter(a * b, sigma) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) \
        / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))
    return float(s.mean())


def perceptual_model(device, vgg_npz: Optional[str] = None
                     ) -> torch.nn.Module:
    """The VGG19 prefix on ``device`` in f32, built once per process for
    each device and weights file: the npz of ``vgg_npz`` (else
    ``$DSU_VGG19_NPZ``) or the fixed random features."""
    from drawingspinup_torch.models.generator_j import (
        PerceptualVGG19, load_vgg_weights_npz,
    )
    npz = vgg_npz or os.environ.get("DSU_VGG19_NPZ") or None
    if not npz:
        weights_policy.report_degraded(
            "fidelity-vgg19",
            "perceptual distance on FIXED RANDOM VGG features (no VGG19 "
            "weights: pass --vgg-npz or set DSU_VGG19_NPZ to an npz from "
            "scripts/export_vgg19_npz.py); compare its values only with "
            "reports of the same package")
    key = (str(torch.device(device)), npz)
    if key not in _VGG:
        vgg = PerceptualVGG19(
            generator=torch.Generator().manual_seed(VGG_SEED))
        if npz:
            load_vgg_weights_npz(vgg, npz)
        _VGG[key] = vgg.to(device).eval().requires_grad_(False)
    return _VGG[key]


@torch.inference_mode()
def perceptual_distances(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                         vgg_npz: Optional[str] = None, device="cuda"
                         ) -> List[float]:
    """For each pair of (H, W, 3) images in [0, 1], the mean squared
    distance of their VGG19 prefix features (all three maps, as JAX's
    flattened concatenation). Pairs of one shape share forwards of up to
    ``BATCH_PIXELS`` pixels."""
    model = perceptual_model(device, vgg_npz)
    out: List[Optional[float]] = [None] * len(pairs)
    by_shape: Dict[tuple, List[int]] = {}
    for i, (a, b) in enumerate(pairs):
        by_shape.setdefault(np.shape(a), []).append(i)
    for shape, idx in by_shape.items():
        step = max(1, BATCH_PIXELS // int(np.prod(shape[:2])))
        for lo in range(0, len(idx), step):
            chunk = idx[lo:lo + step]
            x = np.stack([pairs[i][0] for i in chunk]
                         + [pairs[i][1] for i in chunk])
            x = torch.from_numpy(x.astype(np.float32)).to(device) * 2 - 1
            n = len(chunk)
            sq = torch.zeros(n, dtype=torch.float64, device=device)
            count = 0
            for f in model(x):
                d = (f[:n] - f[n:]).double()
                sq += (d * d).flatten(1).sum(1)
                count += f[0].numel()
            for i, v in zip(chunk, (sq / count).tolist()):
                out[i] = float(v)
    return out


def perceptual_distance(a: np.ndarray, b: np.ndarray,
                        vgg_npz: Optional[str] = None,
                        device="cuda") -> float:
    """Mean squared distance of (random- or real-) VGG19 prefix features.
    Inputs (H, W, 3) in [0, 1]."""
    return perceptual_distances([(a, b)], vgg_npz, device)[0]


def chamfer_distance(va: np.ndarray, vb: np.ndarray,
                     n_sample: int = 20000, seed: int = 0) -> float:
    """Symmetric point-set chamfer (mean of both nearest-neighbor means)
    over vertex samples. Units = mesh units (the pipeline's meshes live in
    the [-0.5, 0.5]³ export box, render/mesh_post.py)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)

    def sample(v):
        if len(v) > n_sample:
            v = v[rng.choice(len(v), n_sample, replace=False)]
        return np.asarray(v, np.float64)

    sa, sb = sample(va), sample(vb)
    d_ab = cKDTree(sb).query(sa, k=1)[0]
    d_ba = cKDTree(sa).query(sb, k=1)[0]
    return float(d_ab.mean() + d_ba.mean()) / 2.0


def compare_mesh(path_a: str, path_b: str, n_sample: int = 20000) -> dict:
    """Compare two OBJ meshes: symmetric chamfer over vertices + vertex-color
    MSE matched by nearest neighbor (vertex counts/orders need not agree)."""
    from scipy.spatial import cKDTree

    va, fa, ca = read_obj(path_a)
    vb, fb, cb = read_obj(path_b)
    out = {"n_verts": (int(len(va)), int(len(vb))),
           "n_faces": (int(len(fa)), int(len(fb))),
           "chamfer": chamfer_distance(va, vb, n_sample=n_sample)}
    if ca is not None and cb is not None:
        idx = cKDTree(vb).query(va, k=1)[1]
        out["color_mse"] = float(np.mean((ca - cb[idx]) ** 2))
    return out


def read_gif_frames(path: str) -> list:
    """GIF → list of (H, W, 3) float [0,1] frames (full-frame composites,
    honoring disposal)."""
    from PIL import Image

    frames = []
    with Image.open(path) as im:
        try:
            while True:
                frames.append(np.asarray(im.convert("RGB"), np.float32) / 255.0)
                im.seek(im.tell() + 1)
        except EOFError:
            pass
    return frames


def compare_gif(path_a: str, path_b: str) -> dict:
    """Frame-by-frame PSNR/SSIM over the common frame prefix."""
    fa, fb = read_gif_frames(path_a), read_gif_frames(path_b)
    n = min(len(fa), len(fb))
    per = [{"psnr": psnr(fa[i], fb[i]), "ssim": ssim(fa[i], fb[i])}
           for i in range(n)]
    agg = {}
    if per:
        agg = {k: sum(p[k] for p in per) / n for k in ("psnr", "ssim")}
    return {"n_frames": (len(fa), len(fb)), "frames": per, "aggregate": agg}


def _rgb(path: str) -> np.ndarray:
    a = read_image(path)[..., :3]
    if a.shape[-1] < 3:   # grayscale / LA (e.g. masks) → 3-ch for VGG
        a = np.repeat(a[..., :1], 3, axis=-1)
    return a


def compare_stage_outputs(dir_a: str, dir_b: str,
                          vgg_npz: Optional[str] = None,
                          device="cuda") -> dict:
    """Compare every same-named PNG in two stage-output directories: PSNR
    and SSIM on the host, the perceptual distances of the directory's pairs
    batched on ``device``."""
    out, pairs = {}, []
    for name in sorted(os.listdir(dir_a)):
        if not name.endswith(".png"):
            continue
        pb = os.path.join(dir_b, name)
        if not os.path.exists(pb):
            out[name] = {"missing": True}
            continue
        a, b = _rgb(os.path.join(dir_a, name)), _rgb(pb)
        out[name] = {"psnr": psnr(a, b), "ssim": ssim(a, b)}
        pairs.append((name, a, b))
    dists = perceptual_distances([(a, b) for _, a, b in pairs], vgg_npz,
                                 device) if pairs else []
    for (name, _, _), d in zip(pairs, dists):
        out[name]["perceptual"] = d
    return out
