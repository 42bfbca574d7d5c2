"""Seeded inputs of the stage-2b cell: one synthetic character as stage 2a
would hand it to the reconstruction, six orthographic views of colour,
normal and mask written in the per-uid ``mv/`` layout.

The character is an analytic signed-distance union of ellipsoids (a body
and a head) and capsules (two arms and two legs), its parts moved a little
and the whole turned about the vertical axis by the seed. Each view is
sphere-traced on the device from the cameras the caller gives (the
program's six DrawingSpinUp poses): the colour of the part hit, shaded by
its normal, on white; the normal from the SDF's gradient, stored in the
caller's frame as ``n · 0.5 + 0.5`` (0 off the character); the mask. The
same seed gives the same views; every seed gives the same sizes. Nothing
here imports the program.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from benchmark import inputs

LIGHT = (-0.3, -0.6, 0.75)
MARCH_STEPS = 160
HIT = 1e-3


def character(seed: int) -> Dict[str, np.ndarray]:
    """The seed's character in world units (z up, facing −y): ellipsoid
    centres and radii, capsule ends and radii, a colour a part, and the
    turn about z."""
    r = np.random.default_rng(inputs.stream(seed, 30))

    def j(scale, n=3):
        return r.uniform(-scale, scale, n)

    ell_c = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.52]]) + j(0.03, (2, 3))
    ell_r = np.array([[0.22, 0.15, 0.33], [0.17, 0.16, 0.18]]) \
        * r.uniform(0.9, 1.1, (2, 3))
    cap_a = np.array([[0.2, 0.0, 0.25], [-0.2, 0.0, 0.25],
                      [0.1, 0.0, -0.3], [-0.1, 0.0, -0.3]])
    cap_b = np.array([[0.58, 0.0, 0.0], [-0.58, 0.0, 0.0],
                      [0.17, 0.0, -0.82], [-0.17, 0.0, -0.82]]) \
        + j(0.08, (4, 3))
    cap_r = np.array([0.06, 0.06, 0.08, 0.08]) * r.uniform(0.85, 1.15, 4)
    turn = r.uniform(-0.5, 0.5)
    colours = r.uniform(0.15, 0.95, (6, 3))
    return {"ell_c": ell_c, "ell_r": ell_r, "cap_a": cap_a, "cap_b": cap_b,
            "cap_r": cap_r, "turn": np.array(turn), "colours": colours}


def _parts(p: torch.Tensor, ch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The distance (N, 6) of the points to each part, in the character's
    own frame (the points turned back by the character's turn)."""
    c, s = torch.cos(-ch["turn"]), torch.sin(-ch["turn"])
    x = torch.stack([c * p[:, 0] - s * p[:, 1], s * p[:, 0] + c * p[:, 1],
                     p[:, 2]], -1)
    q = (x[:, None] - ch["ell_c"]) / ch["ell_r"]             # (N, 2, 3)
    k0 = torch.linalg.norm(q, dim=-1)
    k1 = torch.linalg.norm(q / ch["ell_r"], dim=-1)
    ell = k0 * (k0 - 1.0) / k1.clamp(min=1e-9)
    ab = ch["cap_b"] - ch["cap_a"]                           # (4, 3)
    ap = x[:, None] - ch["cap_a"]                            # (N, 4, 3)
    h = ((ap * ab).sum(-1) / (ab * ab).sum(-1)).clamp(0.0, 1.0)
    cap = torch.linalg.norm(ap - h[..., None] * ab, dim=-1) - ch["cap_r"]
    return torch.cat([ell, cap], dim=-1)


def sdf(p: torch.Tensor, ch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return _parts(p, ch).amin(-1)


def render(seed: int, c2ws: np.ndarray, to_stored: np.ndarray, size: int,
           device) -> Dict[str, np.ndarray]:
    """The views (V, size, size, ·) as u8: ``color`` RGB, ``normal`` RGB in
    the frame ``to_stored`` (3, 3) maps world normals to, ``mask``. c2ws
    (V, 3, 4): orthographic cameras looking down their +z over the image
    plane [-1, 1]²."""
    ch = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
          for k, v in character(seed).items()}
    m = torch.as_tensor(to_stored, dtype=torch.float32, device=device)
    light = torch.tensor(LIGHT, device=device)
    light = light / light.norm()
    ax = (torch.arange(size, device=device, dtype=torch.float32) + 0.5) \
        / size * 2.0 - 1.0
    gy, gx = torch.meshgrid(ax, ax, indexing="ij")
    origins = torch.stack([gx, gy, torch.zeros_like(gx)], -1).reshape(-1, 3)
    out = {"color": [], "normal": [], "mask": []}
    for c2w in torch.as_tensor(c2ws, dtype=torch.float32, device=device):
        d = c2w[:, 2] / c2w[:, 2].norm()
        o = origins @ c2w[:, :3].T + c2w[:, 3]
        # march from where the ray enters the scene's cube [-1, 1]³
        inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
        t0, t1 = (-1.0 - o) * inv, (1.0 - o) * inv
        t = torch.minimum(t0, t1).amax(-1).clamp(min=0.0)
        far = torch.maximum(t0, t1).amin(-1)
        for _ in range(MARCH_STEPS):
            t = t + 0.9 * sdf(o + t[:, None] * d, ch).clamp(min=0.0)
        p = o + t[:, None] * d
        parts = _parts(p, ch)
        hit = (parts.amin(-1) < HIT) & (t < far)
        e = 1e-4
        grad = torch.stack([sdf(p + e * ax_, ch) - sdf(p - e * ax_, ch)
                            for ax_ in torch.eye(3, device=device)], -1)
        n = grad / grad.norm(dim=-1, keepdim=True).clamp(min=1e-9)
        base = ch["colours"][parts.argmin(-1)]
        shade = 0.55 + 0.45 * (n @ light).clamp(min=0.0)
        color = torch.where(hit[:, None], base * shade[:, None],
                            torch.ones_like(base))
        normal = torch.where(hit[:, None], (n @ m.T) * 0.5 + 0.5,
                             torch.zeros_like(n))
        for k, v in (("color", color), ("normal", normal),
                     ("mask", hit[:, None].float().expand(-1, 3))):
            out[k].append(torch.floor(v.reshape(size, size, 3).clamp(0, 1)
                                      * 255 + 0.5).to(torch.uint8))
    return {k: torch.stack(v).cpu().numpy() for k, v in out.items()}


def write_views(paths, views: Sequence[str], images: Dict[str, np.ndarray]
                ) -> None:
    """The views' PNGs at ``paths.mv(kind, view)`` (a ``UidPaths``)."""
    for kind, stack in images.items():
        for view, img in zip(views, stack):
            inputs.write_png(paths.mv(kind, view),
                             img[..., 0] if kind == "mask" else img)
