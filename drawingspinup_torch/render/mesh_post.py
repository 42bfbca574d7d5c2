"""Mesh post-processing of the stage-2b export: decimation, axis swap,
thin-part flattening, Laplacian smoothing, color back-projection, shear,
OBJ with vertex colors or a UV atlas (numpy, scipy and the native library).

A copy of ``drawingspinup_tpu/render/mesh_post.py``:
  verts·0.5 → y-up → [thinning] → [smooth] → [color back-projection |
  nearest colors] → [shear] → ×ortho_scale → OBJ (vertex colors or UV
  atlas). The biharmonic thinning solve is a scipy cotan-Laplacian system
  equivalent to ``igl.harmonic(v, f, b, bc, 2)``; the atlas replaces
  xatlas. ``tests/test_torch_recon.py`` and ``tests/test_torch_mesh_post.py``
  pin every function to the original by equal arrays or OBJ bytes.
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


def cotan_laplacian(verts: np.ndarray, faces: np.ndarray
                    ) -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """Returns (L, M): cotangent-weight Laplacian (negative semidefinite
    convention: L = −(D − W)) and barycentric lumped mass matrix."""
    v = verts.astype(np.float64)
    n = len(v)
    i0, i1, i2 = faces[:, 0], faces[:, 1], faces[:, 2]
    e0 = v[i2] - v[i1]  # opposite vertex 0
    e1 = v[i0] - v[i2]
    e2 = v[i1] - v[i0]
    # cotangent at each corner = dot / |cross| of adjacent edges
    def cot(a, b):
        cr = np.cross(a, b)
        return np.einsum("ij,ij->i", a, b) / np.maximum(
            np.linalg.norm(cr, axis=1), 1e-12)

    c0 = cot(-e1, e2)   # angle at vertex 0 between edges to v1, v2
    c1 = cot(-e2, e0)
    c2 = cot(-e0, e1)
    ii = np.concatenate([i1, i2, i2, i0, i0, i1])
    jj = np.concatenate([i2, i1, i0, i2, i1, i0])
    ww = 0.5 * np.concatenate([c0, c0, c1, c1, c2, c2])
    W = sp.coo_matrix((ww, (ii, jj)), shape=(n, n)).tocsr()
    L = W - sp.diags(np.asarray(W.sum(axis=1)).ravel())
    # lumped mass: 1/3 of incident triangle areas
    area = 0.5 * np.linalg.norm(np.cross(e2, -e1), axis=1)
    m = np.zeros(n)
    for k, idx in enumerate((i0, i1, i2)):
        np.add.at(m, idx, area / 3.0)
    M = sp.diags(np.maximum(m, 1e-12))
    return L.tocsr(), M.tocsr()


def harmonic_deformation(verts: np.ndarray, faces: np.ndarray,
                         b: np.ndarray, bc: np.ndarray,
                         k: int = 2) -> np.ndarray:
    """Solve min dᵀQd s.t. d[b] = bc with Q = L M⁻¹ L (k=2 biharmonic) or
    Q = −L (k=1) — functional equivalent of ``igl.harmonic``."""
    L, M = cotan_laplacian(verts, faces)
    minv = sp.diags(1.0 / M.diagonal())
    Q = (L @ minv @ L) if k == 2 else (-L)
    n = len(verts)
    is_b = np.zeros(n, bool)
    is_b[b] = True
    free = np.nonzero(~is_b)[0]
    d = np.zeros((n, bc.shape[1]), np.float64)
    d[b] = bc
    if len(free) == 0:
        return d.astype(np.float32)
    Qff = Q[free][:, free].tocsc()
    Qfb = Q[free][:, b]
    rhs = -Qfb @ bc
    solve = spla.factorized(Qff)
    for c in range(bc.shape[1]):
        d[free, c] = solve(np.asarray(rhs[:, c]).ravel())
    return d.astype(np.float32)


def thinning_processing(verts: np.ndarray, faces: np.ndarray,
                        front_mask: np.ndarray, thinning_type: str = "double",
                        theta_1: float = 11, theta_2: float = 6,
                        r: int = 11) -> np.ndarray:
    """Thin-part flattening: skeletonize the drawing mask, find thin strokes
    (distance ≤ θ₂), compute per-vertex z-offsets toward the target thickness
    via ±z raycasts, and propagate smoothly by biharmonic deformation."""
    mask = (np.asarray(front_mask) > 0).astype(np.uint8) * 255
    res = mask.shape[0]
    min_thickness = 1.0 / res

    distance = sk.distance_transform_l2(mask)
    skel = sk.skeletonize(mask)

    # vertices in thick regions stay fixed
    xy = verts[:, 0:2].copy()
    xy[:, 1] *= -1
    pix = (xy + 0.5) * (res - 1)
    vert_dist = sk.bilinear_sample(distance, pix)
    fix_mask = vert_dist >= theta_1

    mov = ((skel > 0) & (distance <= theta_2)).astype(np.uint8) * 255
    mov = sk.remove_intersections(mov, skel, r)
    mov = sk.dilate(mov, 1)

    coords = np.argwhere(mov > 0).astype(np.float32)     # (row, col)
    if len(coords) == 0:
        return verts
    thin_xy = np.stack([coords[:, 1], -coords[:, 0]], axis=1) / (res - 1)
    thin_xy[:, 0] -= 0.5
    thin_xy[:, 1] += 0.5
    # target half-thickness from the stroke's 2D distance value
    pix2 = np.stack([coords[:, 1], coords[:, 0]], axis=1)
    coord_dists = sk.bilinear_sample(distance, pix2) / res

    offset_values, offset_mask = _offsets_from_raycast(
        verts, faces, thin_xy, coord_dists, min_thickness, thinning_type)

    constrained = np.nonzero(fix_mask | offset_mask)[0]
    bc = offset_values[constrained]
    d = harmonic_deformation(verts, faces, constrained, bc, k=2)
    return verts + d


def _offsets_from_raycast(verts, faces, thin_xy, coord_dists, min_thickness,
                          ttype):
    """Vectorized equivalent of the reference's per-stroke-pixel raycast loop
    (thinning_utils.py:96-198): find front/back faces under each thin-stroke
    pixel, then per-vertex thickness via ±z raycasts."""
    offset_values = np.zeros_like(verts)
    offset_mask = np.zeros(len(verts), bool)

    # front & back face under each thin pixel (cast from z=+1 downward)
    q = np.concatenate([thin_xy, np.full((len(thin_xy), 1), 1.0, np.float32)],
                       axis=1).astype(np.float32)
    _, front_face = native.raycast_z(verts, faces, q, -1)
    # farthest hit: cast from below upward, take first hit from z=-1
    q2 = q.copy()
    q2[:, 2] = -1.0
    _, back_face = native.raycast_z(verts, faces, q2, +1)

    # per-vertex thickness: distance to farthest surface along −z / +z
    # (one sweep per direction; the returned face id doubles as hit flag)
    vz_front, f_front = native.raycast_z(
        verts, faces, verts + np.asarray([0, 0, -1e-5]), -1)
    vz_back, f_back = native.raycast_z(
        verts, faces, verts + np.asarray([0, 0, 1e-5]), +1)
    hit_front = f_front >= 0
    hit_back = f_back >= 0

    def apply(face_ids, side):
        for fi, cd in zip(face_ids, coord_dists):
            if fi < 0:
                continue
            target = max(min_thickness, cd * 2.0)
            for vi in faces[fi]:
                if offset_mask[vi]:
                    continue
                if side == "front":
                    if not hit_front[vi]:
                        continue
                    dist = verts[vi, 2] - vz_front[vi]
                    if target < dist < 0.06:
                        delta = (dist - target) * (0.5 if ttype == "double" else 1.0)
                        offset_values[vi, 2] -= delta
                        offset_mask[vi] = True
                else:
                    if not hit_back[vi]:
                        continue
                    dist = vz_back[vi] - verts[vi, 2]
                    if target < dist < 0.06:
                        delta = (dist - target) * (0.5 if ttype == "double" else 1.0)
                        offset_values[vi, 2] += delta
                        offset_mask[vi] = True

    if ttype in ("double", "front"):
        apply(front_face, "front")
    if ttype == "front":
        for fi in back_face:
            if fi >= 0:
                offset_mask[faces[fi]] = True  # pin back side
    if ttype in ("double", "back"):
        apply(back_face, "back")
    if ttype == "back":
        for fi in front_face:
            if fi >= 0:
                offset_mask[faces[fi]] = True
    return offset_values, offset_mask


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
    """verts·0.5 → y-up → [thinning] → [smooth] → [color back-projection |
    nearest colors] → [shear] → ×ortho_scale → OBJ with vertex colors, or
    the atlas's remapped mesh, UVs and texture with ``export_uv``."""
    from drawingspinup_torch.core.io import write_obj

    v = axis_swap_y_up(verts * 0.5)
    v_old = v
    if thinning and front_mask is not None:
        v = thinning_processing(v, faces, front_mask, thinning_type)
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
    v = v * ortho_scale
    if export_uv and vert_colors is not None:
        v2, f2, uvs, tex = uv_atlas(v, faces, vert_colors)
        write_obj(path, v2, f2, uvs=uvs, texture_png=tex)
    else:
        write_obj(path, v, faces, vertex_colors=vert_colors)
    return path


def _face_charts(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Chart id per face: faces bucketed by dominant normal axis (6 box
    directions), then connected components (shared-edge adjacency) within
    each bucket. Returns (F,) int chart labels."""
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    n = np.cross(e1, e2)
    axis = np.abs(n).argmax(axis=1)
    sign = np.take_along_axis(n, axis[:, None], 1)[:, 0] >= 0
    bucket = axis * 2 + sign.astype(np.int64)             # 0..5

    parent = np.arange(len(faces))

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    # edge (sorted vertex pair) → list of incident faces
    edges = np.sort(np.stack([faces[:, [0, 1]], faces[:, [1, 2]],
                              faces[:, [2, 0]]], axis=1).reshape(-1, 2),
                    axis=1)
    face_of_edge = np.repeat(np.arange(len(faces)), 3)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    edges, face_of_edge = edges[order], face_of_edge[order]
    same = np.all(edges[1:] == edges[:-1], axis=1)
    for a, b in zip(face_of_edge[:-1][same], face_of_edge[1:][same]):
        if bucket[a] == bucket[b]:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra
    return np.asarray([find(i) for i in range(len(faces))])


def uv_atlas(verts: np.ndarray, faces: np.ndarray, vert_colors: np.ndarray,
             tex_res: int = 1024
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Chart-based UV unwrap + baked vertex-color texture — the xatlas
    replacement for the reference's optional textured export
    (``coloring_utils.py:151-167``).

    Like ``xatlas.parametrize``, vertices are split at chart borders
    (vmapping semantics) and the return is the REMAPPED mesh:
    (verts2 (V2,3), faces2 (F,3), uvs (V2,2), texture (R,R,3)).

    Pipeline: dominant-normal-axis box buckets → connected components →
    per-chart planar projection onto the axis plane (world-uniform texel
    density) → shelf packing with a texel gutter (charts provably disjoint
    in the atlas — the round-3 planar projection overlapped charts for any
    non-height-field mesh) → per-texel colors via the native z-buffer
    rasterizer in UV space, depth = distance along the chart's projection
    axis so a chart that folds over itself keeps the front sheet → edge
    dilation into the gutter so bilinear samplers don't bleed background."""
    chart_of_face = _face_charts(verts, faces)
    chart_ids = np.unique(chart_of_face)
    uv_axes = [(1, 2), (0, 2), (0, 1)]

    charts = []           # (vids, local_uv(world units), depth, w, h)
    for cid in chart_ids:
        cf = faces[chart_of_face == cid]
        vids = np.unique(cf)
        local = np.searchsorted(vids, cf)
        pts = verts[vids]
        e1 = verts[cf[:, 1]] - verts[cf[:, 0]]
        e2 = verts[cf[:, 2]] - verts[cf[:, 0]]
        n = np.cross(e1, e2).sum(0)
        a = int(np.abs(n).argmax())
        s = 1.0 if n[a] >= 0 else -1.0
        ua, va = uv_axes[a]
        uv = np.stack([pts[:, ua] * s, pts[:, va]], axis=1)  # sign keeps
        uv = uv - uv.min(0)                                  # handedness
        depth = pts[:, a] * s                # larger = outward-facing sheet
        w, h = np.maximum(uv.max(0), 1e-6)
        charts.append({"vids": vids, "faces_local": local, "uv": uv,
                       "depth": depth, "w": float(w), "h": float(h)})

    # shelf packing at a world→atlas scale found by shrink-and-retry
    gutter = 4.0 / tex_res
    total_area = sum(c["w"] * c["h"] for c in charts)
    scale = np.sqrt(0.6 / max(total_area, 1e-12))
    for _ in range(40):
        x = y = row_h = 0.0
        placed = []
        ok = True
        for c in sorted(charts, key=lambda c: -c["h"]):
            w, h = c["w"] * scale, c["h"] * scale
            if x + w + gutter > 1.0 and x > 0.0:
                x, y, row_h = 0.0, y + row_h + gutter, 0.0
            if y + h + gutter > 1.0 or w + gutter > 1.0:
                ok = False
                break
            placed.append((c, x, y))
            x += w + gutter
            row_h = max(row_h, h)
        if ok:
            break
        scale *= 0.92
    assert ok, "uv_atlas packing failed to converge"

    verts2, uvs2, faces2, off = [], [], [], 0
    for c, x, y in placed:
        verts2.append(verts[c["vids"]])
        uvs2.append(c["uv"] * scale + np.asarray([x, y], np.float32))
        faces2.append(c["faces_local"] + off)
        off += len(c["vids"])
    depths = np.concatenate([charts_entry["depth"]
                             for charts_entry, _, _ in placed])
    verts2 = np.concatenate(verts2).astype(np.float32)
    uvs2 = np.concatenate(uvs2).astype(np.float32)
    faces2 = np.concatenate(faces2).astype(np.int64)

    # bake: rasterize in UV pixel space, z = per-chart outward depth
    px = np.stack([uvs2[:, 0] * (tex_res - 1),
                   (1 - uvs2[:, 1]) * (tex_res - 1),
                   depths], axis=1).astype(np.float32)
    _, fid, bary = native.rasterize(px, faces2, tex_res, tex_res, z_mode=1)
    tex = np.zeros((tex_res, tex_res, 3), np.float32)
    hit = fid >= 0
    colors2 = vert_colors[np.concatenate([c["vids"] for c, _, _ in placed])]
    fc = colors2[faces2[fid[hit]]]                        # (K, 3, 3)
    tex[hit] = np.einsum("kjc,kj->kc", fc, bary[hit])

    # gutter dilation: grow chart colors outward so bilinear/mip samplers
    # never mix in the black background at chart seams
    filled = hit.copy()
    for _ in range(4):
        if filled.all():
            break
        grow = np.zeros_like(tex)
        cnt = np.zeros(filled.shape, np.float32)
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            shifted = np.roll(filled, (dy, dx), (0, 1))
            vals = np.roll(tex, (dy, dx), (0, 1))
            m = shifted & ~filled
            grow[m] += vals[m]
            cnt[m] += 1.0
        newly = cnt > 0
        tex[newly] = grow[newly] / cnt[newly][:, None]
        filled |= newly
    return verts2, faces2, uvs2, tex
