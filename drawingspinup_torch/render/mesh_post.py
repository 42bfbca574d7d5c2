"""Mesh post-processing of the stage-2b export: decimation, axis swap,
Laplacian smoothing, color back-projection, shear, OBJ (numpy, scipy and
the native library).

A copy of the parts of ``drawingspinup_tpu/render/mesh_post.py`` that the
production export runs without thinning; ``tests/test_torch_recon.py`` pins
``save_mesh`` by equal OBJ bytes. Thinning (``thinning_processing``, which
needs ``ops/skeleton.py``'s skeletonization) and the UV atlas are not
ported yet: ``save_mesh`` raises for them (``ROADMAP.md`` queue 1).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from drawingspinup_torch import native
from drawingspinup_torch.ops import skeleton as sk


def remesh(verts: np.ndarray, faces: np.ndarray,
           face_count: int) -> Tuple[np.ndarray, np.ndarray]:
    """Quadric decimation to ≤ face_count, with the short-edge pre-pass."""
    return native.decimate(verts, faces, face_count)


def axis_swap_y_up(verts: np.ndarray) -> np.ndarray:
    """x:right y:back z:up → x:right y:up z:front."""
    out = np.empty_like(verts)
    out[:, 0] = verts[:, 0]
    out[:, 1] = verts[:, 2]
    out[:, 2] = -verts[:, 1]
    return out


def uniform_laplacian(n_verts: int, faces: np.ndarray) -> sp.csr_matrix:
    """Symmetric uniform graph Laplacian L = D − A."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.unique(np.sort(e, axis=1), axis=0)
    i = np.concatenate([e[:, 0], e[:, 1]])
    j = np.concatenate([e[:, 1], e[:, 0]])
    a = sp.coo_matrix((np.ones(len(i)), (i, j)),
                      shape=(n_verts, n_verts)).tocsr()
    d = sp.diags(np.asarray(a.sum(axis=1)).ravel())
    return (d - a).tocsr()


def laplacian_smooth(verts: np.ndarray, faces: np.ndarray, lamb: float = 2.0,
                     iterations: int = 5) -> np.ndarray:
    """Implicit Laplacian smoothing: per iteration solve (I + λ·L_norm) v' = v."""
    n = len(verts)
    L = uniform_laplacian(n, faces)
    deg = L.diagonal()
    dinv = sp.diags(1.0 / np.maximum(deg, 1))
    ln = dinv @ L
    A = (sp.eye(n) + lamb * ln).tocsc()
    solve = spla.factorized(A)
    v = verts.astype(np.float64)
    for _ in range(iterations):
        v = np.column_stack([solve(v[:, k]) for k in range(3)])
    return v.astype(np.float32)


def color_projection(verts: np.ndarray, faces: np.ndarray,
                     front_color: np.ndarray, back_color: np.ndarray,
                     front_mask: Optional[np.ndarray],
                     res: int = 2048) -> np.ndarray:
    """Project the front/back mv images onto front-/back-visible vertices
    (visibility by ±z raycast), fill the rest by inverse-distance KNN in xy."""
    n = len(verts)
    colors = np.zeros((n, 4), np.float32)

    pix_scale = res - 1
    pv = verts.copy()
    pvx = (pv[:, 0] + 0.5) * pix_scale
    pvy = (-pv[:, 1] + 0.5) * pix_scale
    raster_verts = np.stack([pvx, pvy, pv[:, 2]], axis=1).astype(np.float32)
    depth, fid, _ = native.rasterize(raster_verts, faces, res, res, z_mode=1)
    render_mask = (fid >= 0).astype(np.uint8) * 255
    if front_mask is None:
        fm = render_mask
    else:
        fm = (np.asarray(front_mask) > 0.5).astype(np.uint8) * 255
        if fm.shape[0] != res:
            fm = _resize_nearest(fm, res)
    m_front = np.minimum(render_mask, fm)
    m_front = sk.erode(m_front, 19)

    fc = _ensure_res(front_color, res)
    bc = _ensure_res(back_color, res)

    _, blocked_f = native.raycast_z(verts, faces,
                                    verts + np.asarray([0, 0, 1e-4]), +1)
    vis_front = blocked_f < 0
    px = np.stack([pvx, pvy], axis=1)
    samp = sk.bilinear_sample(np.dstack([fc, m_front[..., None] / 255.0]), px)
    take = vis_front & (samp[:, 3] > 0)
    colors[take, :3] = samp[take, :3]
    colors[take, 3] = 1.0

    _, blocked_b = native.raycast_z(verts, faces,
                                    verts + np.asarray([0, 0, -1e-4]), -1)
    vis_back = (blocked_b < 0) & (colors[:, 3] == 0)
    m_back = np.ascontiguousarray(m_front[:, ::-1])
    pxb = np.stack([(0.5 - pv[:, 0]) * pix_scale, pvy], axis=1)
    sampb = sk.bilinear_sample(np.dstack([bc, m_back[..., None] / 255.0]), pxb)
    takeb = vis_back & (sampb[:, 3] > 0)
    colors[takeb, :3] = sampb[takeb, :3]
    colors[takeb, 3] = 1.0

    known = colors[:, 3] > 0
    if known.any() and (~known).any():
        from scipy.spatial import cKDTree
        tree = cKDTree(verts[known][:, 0:2])
        k = min(8, known.sum())
        dist, idx = tree.query(verts[~known][:, 0:2], k)
        if k == 1:
            dist, idx = dist[:, None], idx[:, None]
        w = 1.0 / (dist + 1e-6)
        w /= w.sum(axis=1, keepdims=True)
        colors[~known, :3] = np.einsum("nkc,nk->nc",
                                       colors[known][:, :3][idx], w)
    return colors[:, :3]


def _ensure_res(img: np.ndarray, res: int) -> np.ndarray:
    if img.shape[0] == res:
        return np.asarray(img, np.float32)
    from PIL import Image
    a = np.clip(np.asarray(img, np.float32) * 255, 0, 255).astype(np.uint8)
    return np.asarray(Image.fromarray(a).resize((res, res), Image.LANCZOS),
                      np.float32) / 255.0


def _resize_nearest(img: np.ndarray, res: int) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.fromarray(img).resize((res, res), Image.NEAREST))


def shear_transformation(verts: np.ndarray) -> np.ndarray:
    """Undo the character's lean: PCA on (y, z), shear z by the principal
    axis slope."""
    data = verts[:, 1:3]
    data = data - data.mean(axis=0)
    h = data.T @ data
    vecs, vals, _ = np.linalg.svd(h)
    order = np.argsort(vals)[::-1]
    vecs = vecs[:, order]
    a = -vecs[1, 0] / vecs[0, 0]
    out = verts.copy()
    out[:, 2] += a * out[:, 1]
    return out


def save_mesh(path: str, verts: np.ndarray, faces: np.ndarray,
              vert_colors: Optional[np.ndarray] = None,
              front_mask: Optional[np.ndarray] = None,
              front_color: Optional[np.ndarray] = None,
              back_color: Optional[np.ndarray] = None,
              thinning: bool = False, thinning_type: str = "double",
              smoothing: bool = True, color_back_projection: bool = True,
              shearing: bool = True, ortho_scale: float = 1.35,
              export_uv: bool = False) -> str:
    """verts·0.5 → y-up → [smooth] → [color back-projection | nearest
    colors] → [shear] → ×ortho_scale → OBJ with vertex colors."""
    from drawingspinup_torch.core.io import write_obj

    if thinning:
        raise NotImplementedError(
            "save_mesh(thinning=True): thin-part flattening is not ported "
            "yet (ROADMAP.md queue 1)")
    if export_uv:
        raise NotImplementedError(
            "save_mesh(export_uv=True): the UV atlas is not ported yet "
            "(ROADMAP.md queue 1)")
    v = axis_swap_y_up(verts * 0.5)
    v_old = v
    if smoothing:
        v = laplacian_smooth(v, faces)
    if color_back_projection and front_color is not None:
        vert_colors = color_projection(v, faces, front_color,
                                       back_color if back_color is not None
                                       else front_color[:, ::-1],
                                       front_mask)
    elif vert_colors is not None and smoothing:
        from scipy.spatial import cKDTree
        _, idx = cKDTree(v_old).query(v, 1)
        vert_colors = vert_colors[idx]
    if shearing:
        v = shear_transformation(v)
    write_obj(path, v * ortho_scale, faces, vertex_colors=vert_colors)
    return path
