"""Plain PyTorch NeuS training step on a multiresolution hash grid, in
float32: the step of ``neus-ortho.yaml`` from given parameters, Adam
moments, update count, schedule step, random draws and number of active
levels, to its loss terms, its gradients and the updated parameters.

Written for the benchmark from NeuS (Wang et al., NeurIPS 2021,
arXiv:2106.10689), the multiresolution hash encoding of Instant-NGP
(Müller et al., SIGGRAPH 2022, arXiv:2201.05989) and instant-nsr-pl's
``neus_ortho`` system as DrawingSpinUp configures it
(``2_charactor_reconstructor/configs/neuralangelo-ortho-wmask.yaml``),
with the step the port states in ``drawingspinup_torch/train/nsr.py``;
imports nothing of the port. The encoding is index arithmetic and gathers,
the SDF's spatial gradient ``torch.autograd.grad(create_graph=True)``, the
parameters' gradients autograd's. Bf16 tables and moments enter as their
f32 values. Matmuls and cuDNN run without TF32.

Departures from the published NeuS and instant-nsr-pl, each the port's:
- 2048 rays a step at fixed count (the published trainer grows the count
  toward a sample budget), 32 stratified samples inside the visual hull's
  per-pixel range and 32 inverse-CDF samples from the coarse pass's
  weights (the published one marches up to 1024 samples through an
  occupancy grid);
- the grid's levels at resolution floor(base · scale^l) over [0, 1]³
  (contracted from the scene's cube), stored dense where (N+1)³ rows fit
  the table, hashed otherwise; on a dense level the base corner is clipped
  to N−1 and the weights taken from it; the progressive band zeroes the
  levels from ``current_level(step)`` on;
- analytic position gradients where the yaml's ``grad_type`` says
  ``finite_difference`` (here by autograd; the contraction's clip counts
  with the slope of the linear map, as the port's closed form counts it);
- the radiance MLP fed the SDF features and the normal, not the view
  direction;
- the losses of the ortho system: ranked RGB (0.8 kept), geo-aware ranked
  normal (0.8), ranked mask BCE (0.9), eikonal, sparsity, 3D normal
  smoothness of 2048 probe points and their copies moved by 1e-2 ·
  normal noise (the ranked RGB L1 term, weighted 0, is left out);
- optax's ``adamw`` per group (b1 0.9, b2 0.99, eps 1e-15, no decay; a
  constant learning rate for 500 steps, then exponential to a tenth at
  ``max_steps``), bias-corrected with the update count; a leaf without a
  gradient (a locked level) is left as it is.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PRIMES = (1, 2654435761, 805459861)
# the weighted loss terms, by the name of the unweighted term and its weight
TERMS = (("loss_rgb_mse", "lambda_rgb_mse"), ("loss_normal", "lambda_normal"),
         ("loss_eikonal", "lambda_eikonal"), ("loss_mask", "lambda_mask"),
         ("loss_sparsity", "lambda_sparsity"),
         ("loss_3d_normal_smooth", "lambda_3d_normal_smooth"))


# ---------------------------------------------------------------------------
# the hash grid
# ---------------------------------------------------------------------------

def resolutions(grid: Dict) -> List[int]:
    ls = np.arange(grid["n_levels"])
    return [int(r) for r in np.floor(grid["base_resolution"]
                                     * grid["per_level_scale"] ** ls)
            .astype(np.int32)]


def is_dense(grid: Dict, res: int) -> bool:
    return (res + 1) ** 3 <= 1 << grid["log2_hashmap_size"]


def current_level(grid: Dict, step: int) -> int:
    return min(grid["start_level"] + max(step - grid["start_step"], 0)
               // grid["update_steps"], grid["n_levels"])


def corners(u: torch.Tensor, res: int, dense: bool, cell_rows: bool,
            table_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows (8, P) of the 8 cell corners of the points u (P, 3) in
    [0, 1] on one level, x fastest, and their trilinear weights (8, P)."""
    f = u * res
    base = torch.floor(f.detach()).long()
    wide = dense and cell_rows
    if wide:
        base = base.clamp(0, res - 1)
    w = f - base.to(f.dtype)                              # (P, 3)
    rows, weights = [], []
    for c in range(8):
        off = torch.tensor([c & 1, (c >> 1) & 1, c >> 2], device=u.device)
        corner = base + off
        if not wide:
            corner = corner.clamp(0, res)
        x, y, z = corner.unbind(-1)
        if dense:
            rows.append(x + (res + 1) * (y + (res + 1) * z))
        else:
            rows.append(((x * PRIMES[0]) ^ (y * PRIMES[1])
                         ^ (z * PRIMES[2])) & (table_size - 1))
        weights.append(torch.where(off.bool(), w, 1.0 - w).prod(dim=-1))
    return torch.stack(rows), torch.stack(weights)


def _level(table: torch.Tensor, u: torch.Tensor, res: int, dense: bool,
           grid: Dict) -> torch.Tensor:
    """One level's trilinear interpolation of the 8 corner rows: (P, F)."""
    rows, weights = corners(u, res, dense, grid["dense_cell_rows"],
                            1 << grid["log2_hashmap_size"])
    return (table[rows] * weights[..., None]).sum(0)


def encode(tables: List[torch.Tensor], x: torch.Tensor, cfg: Dict,
           n_active: int) -> torch.Tensor:
    """World points (P, 3) → the contracted xyz (·2 − 1) and every level's
    features, zeros from level ``n_active`` on: (P, 3 + L·F)."""
    grid, r = cfg["grid"], cfg["radius"]
    lin = (x + r) / (2 * r)
    u = lin + (lin.clamp(0.0, 1.0) - lin).detach()     # clipped, slope 1/2r
    feats = [u * 2.0 - 1.0] if grid["include_xyz"] else []
    nf = grid["n_features_per_level"]
    for lvl, res in enumerate(resolutions(grid)):
        if lvl < n_active:
            feats.append(_level(tables[lvl], u, res, is_dense(grid, res),
                                grid))
        else:
            feats.append(x.new_zeros((x.shape[0], nf)))
    return torch.cat(feats, dim=-1)


# ---------------------------------------------------------------------------
# the fields
# ---------------------------------------------------------------------------

def mlp(layers: List[Dict[str, torch.Tensor]], h: torch.Tensor,
        spec: Dict) -> torch.Tensor:
    """A vanilla MLP, weights (in, out); weight-normed columns
    w·g/(‖w‖+1e-12); softplus(100h)/100 between layers where sphere-
    initialised, ReLU otherwise; a sigmoid out where asked."""
    for i, layer in enumerate(layers):
        w = layer["w"]
        if spec.get("weight_norm"):
            w = w * (layer["g"] / (torch.linalg.norm(w, dim=0) + 1e-12))
        h = h @ w + layer["b"]
        if i < len(layers) - 1:
            h = F.softplus(100.0 * h) / 100.0 if spec.get("sphere_init") \
                else F.relu(h)
    if spec.get("output_activation") == "sigmoid":
        h = torch.sigmoid(h)
    return h


def sdf_field(params: Dict, x: torch.Tensor, cfg: Dict, n_active: int
              ) -> torch.Tensor:
    """(P, feature_dim): the SDF in channel 0, then the features."""
    enc = encode(params["geometry"]["table"], x, cfg, n_active)
    return mlp(params["geometry"]["mlp"]["layers"], enc, cfg["sdf_mlp"])


def inv_s(params: Dict) -> torch.Tensor:
    return torch.exp(params["variance"]["variance"] * 10.0).clamp(1e-6, 1e6)


# ---------------------------------------------------------------------------
# rays and samples
# ---------------------------------------------------------------------------

def ortho_rays(data: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The drawn pixels' world rays: camera-space origins at the pixel
    centres of the [-1, 1]² image plane, direction +z, through c2w."""
    _, h, w = data["masks"].shape
    vi, yi, xi = draws["vi"], draws["yi"], draws["xi"]
    ox = ((xi.float() + 0.5) / w - 0.5) * 2.0
    oy = ((yi.float() + 0.5) / h - 0.5) * 2.0
    origins = torch.stack([ox, oy, torch.zeros_like(ox)], dim=-1)
    c2w = data["c2w"][vi]
    rays_d = c2w[:, :, 2]
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True
                                        ).clamp(min=1e-9)
    rays_o = (c2w[:, :, :3] @ origins[:, :, None])[..., 0] + c2w[:, :, 3]
    return rays_o, rays_d


def box_hit(rays_o: torch.Tensor, rays_d: torch.Tensor, r: float
            ) -> torch.Tensor:
    """1 where the ray meets the cube [-r, r]³, else 0 (slab test)."""
    d = torch.where(rays_d.abs() < 1e-9,
                    torch.sign(rays_d) * 1e-9 + 1e-10, rays_d)
    t0, t1 = (-r - rays_o) / d, (r - rays_o) / d
    near = torch.minimum(t0, t1).amax(-1).clamp(min=0.0)
    far = torch.maximum(t0, t1).amin(-1)
    return (far > near).float()


def stratified(near: torch.Tensor, far: torch.Tensor, n: int,
               jitter: torch.Tensor) -> torch.Tensor:
    u = (torch.arange(n, device=near.device) + 0.5) / n + (jitter - 0.5) / n
    return near[:, None] + (far - near)[:, None] * u


def resample(t: torch.Tensor, weights: torch.Tensor, n: int,
             jitter: torch.Tensor) -> torch.Tensor:
    """n inverse-CDF samples a ray from the bins' weights (+1e-5), linear
    between the bin positions t."""
    w = weights + 1e-5
    pdf = w / w.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)],
                    dim=-1)
    u = ((torch.arange(n, device=t.device) + 0.5) / n
         + (jitter - 0.5) / n).clamp(0.0, 1.0 - 1e-6)
    s = t.shape[-1]
    # the count of cdf entries ≤ u
    idx = (cdf[:, None, :] <= u[:, :, None]).sum(-1).clamp(1, s)
    below, above = idx - 1, idx.clamp(max=s - 1)
    c_b, c_a = cdf.gather(-1, below), cdf.gather(-1, idx)
    t_b, t_a = t.gather(-1, below), t.gather(-1, above)
    denom = torch.where(c_a - c_b < 1e-8, torch.ones_like(c_a), c_a - c_b)
    return t_b + (u - c_b) / denom * (t_a - t_b)


def section_alpha(sdf: torch.Tensor, dist: torch.Tensor, s: torch.Tensor,
                  cos: Optional[torch.Tensor] = None,
                  anneal: float = 1.0) -> torch.Tensor:
    """NeuS's discrete opacity of a section from the SDF at its middle:
    without ``cos`` the SDF's slope along the ray is taken as −1 (the
    coarse pass), with it the annealed cosine of ray and normal."""
    if cos is None:
        half = dist * 0.5
    else:
        slope = -(F.relu(-cos * 0.5 + 0.5) * (1.0 - anneal)
                  + F.relu(-cos) * anneal)
        half = -slope * dist * 0.5
    prev = torch.sigmoid((sdf + half) * s)
    nxt = torch.sigmoid((sdf - half) * s)
    return ((prev - nxt + 1e-5) / (prev + 1e-5)).clamp(0.0, 1.0)


def composite_weights(alpha: torch.Tensor) -> torch.Tensor:
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    return alpha * trans


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1) / (torch.linalg.norm(a, dim=-1)
                              * torch.linalg.norm(b, dim=-1)).clamp(min=1e-6)


def ranked(err: torch.Tensor, ratio: float,
           mask: Optional[torch.Tensor] = None,
           weights: Optional[torch.Tensor] = None,
           mean: bool = True) -> torch.Tensor:
    """The lowest ``ratio`` share of the (masked) errors, each times its
    weight, summed, over the count kept where ``mean``."""
    if mask is not None:
        err = torch.where(mask, err, torch.full_like(err, float("inf")))
        n = mask.float().sum()
    else:
        n = torch.tensor(float(err.shape[0]), device=err.device)
    k = torch.floor(ratio * n)
    srt, order = torch.sort(err, stable=True)
    keep = torch.arange(err.shape[0], device=err.device) < k
    srt = torch.where(keep, srt, torch.zeros_like(srt))
    if weights is not None:
        srt = srt * weights[order]
    return srt.sum() / k.clamp(min=1.0) if mean else srt.sum()


def losses(cfg: Dict, out: Dict[str, torch.Tensor],
           target: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The unweighted loss terms of the ortho system."""
    lw = cfg["loss"]
    cos = _cos(out["rays_d"], target["normal"])
    cos = torch.where(cos > -0.1, torch.zeros_like(cos), cos)
    mask = (target["mask"] > 0) & (cos < -0.1)
    rgb_err = ((out["rgb"] - target["rgb"]) ** 2).sum(-1)
    normal_err = 1.0 - _cos(out["normal"], target["normal"])
    gw = torch.exp(cos.abs())
    normal_err = normal_err * gw / gw.sum()
    opacity = out["opacity"].clamp(1e-3, 1 - 1e-3)
    m = target["mask"]
    bce = -(m * torch.log(opacity) + (1.0 - m) * torch.log(1.0 - opacity))
    return {
        "loss_rgb_mse": ranked(rgb_err, lw["rgb_p_ratio"], mask),
        "loss_normal": ranked(normal_err, lw["normal_p_ratio"], mask,
                              target["view_weights"], mean=False),
        "loss_eikonal": ((torch.linalg.norm(out["grad"], dim=-1) - 1.0)
                         ** 2).mean(),
        "loss_mask": ranked(bce, lw["mask_p_ratio"],
                            weights=target["view_weights"]),
        "loss_sparsity": torch.exp(-lw["sparsity_scale"]
                                   * out["probe_sdf"].abs()).mean(),
        "loss_3d_normal_smooth": (out["probe_grad"]
                                  - out["perturbed_grad"]).abs().mean(),
    }


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def forward(cfg: Dict, params: Dict, data: Dict[str, torch.Tensor],
            draws: Dict[str, torch.Tensor], step: int, n_active: int
            ) -> Dict[str, torch.Tensor]:
    """The step's unweighted loss terms from ``params`` (a tree of f32
    leaves that require grad)."""
    r, nc, nfine = cfg["radius"], cfg["n_coarse"], cfg["n_fine"]
    rays_o, rays_d = ortho_rays(data, draws)
    vi, yi, xi = draws["vi"], draws["yi"], draws["xi"]
    target = {"rgb": data["images"][vi, yi, xi],
              "normal": data["normals"][vi, yi, xi],
              "mask": data["masks"][vi, yi, xi],
              "view_weights": data["view_weights"][vi]}
    t_range = data["t_range"][vi, yi, xi]
    near, far = t_range[:, 0], t_range[:, 1]
    far = torch.maximum(far, near + 1e-4)
    hit = box_hit(rays_o, rays_d, r)
    s = inv_s(params)
    anneal = float(min(np.float32(1.0), np.float32(step)
                       / np.float32(cfg["cos_anneal_end"]))) \
        if cfg["cos_anneal_end"] else 1.0

    with torch.no_grad():
        t_c = stratified(near, far, nc, draws["strat"])
        pos_c = rays_o[:, None] + rays_d[:, None] * t_c[..., None]
        sdf_c = sdf_field(params, pos_c.reshape(-1, 3), cfg, n_active)[:, 0]
        w_c = section_alpha(sdf_c.reshape(t_c.shape),
                            ((far - near) / nc)[:, None], s)
        t_f = resample(t_c, w_c, nfine, draws["pdf"])
        t = torch.sort(torch.cat([t_c, t_f], -1), -1).values
        dist = torch.diff(t, dim=-1)
        dist = torch.cat([dist, dist[:, -1:]], dim=-1)
        pos = rays_o[:, None] + rays_d[:, None] * t[..., None]

    probe = draws["probe_pts"]
    pts = torch.cat([pos.reshape(-1, 3), probe,
                     probe + draws["probe_noise"] * 1e-2]).requires_grad_()
    field = sdf_field(params, pts, cfg, n_active)
    sdf_all = field[:, 0]
    grad_all, = torch.autograd.grad(sdf_all.sum(), pts, create_graph=True)
    n_main, n_probe = pos.shape[0] * pos.shape[1], probe.shape[0]
    sdf = sdf_all[:n_main].reshape(t.shape)
    grad = grad_all[:n_main].reshape(t.shape + (3,))
    normal = grad / torch.linalg.norm(grad, dim=-1, keepdim=True
                                      ).clamp(min=1e-9)
    cos = (rays_d[:, None] * normal).sum(-1)
    alpha = section_alpha(sdf, dist, s, cos, anneal) * hit[:, None]
    rgb = mlp(params["texture"]["mlp"]["layers"],
              torch.cat([field[:n_main], normal.reshape(-1, 3)], -1),
              cfg["radiance_mlp"]).reshape(t.shape + (3,))
    weights = composite_weights(alpha)
    comp_n = (weights[..., None] * normal).sum(1)
    out = {"rays_d": rays_d,
           "rgb": (weights[..., None] * rgb).sum(1),
           "normal": comp_n / torch.linalg.norm(comp_n, dim=-1, keepdim=True
                                                ).clamp(min=1e-9),
           "opacity": weights.sum(1),
           "grad": grad.reshape(-1, 3),
           "probe_sdf": sdf_all[n_main:n_main + n_probe],
           "probe_grad": grad_all[n_main:n_main + n_probe],
           "perturbed_grad": grad_all[n_main + n_probe:]}
    return losses(cfg, out, target)


def learning_rate(cfg: Dict, base: float, count: int) -> torch.Tensor:
    opt = cfg["optimizer"]
    if count < opt["constant_steps"]:
        return torch.tensor(base, dtype=torch.float32)
    gamma = opt["lr_decay_target"] ** (
        1.0 / max(cfg["max_steps"] - opt["constant_steps"], 1))
    return torch.tensor(base, dtype=torch.float32) * torch.tensor(
        gamma, dtype=torch.float32) ** float(count - opt["constant_steps"])


def _tree(flat: Dict[str, torch.Tensor]) -> Dict:
    """Dotted leaf names ("geometry.table.0", "texture.mlp.layers.1.w")
    → the nested tree, lists where a key is a number."""
    tree: Dict = {}
    for name, v in flat.items():
        node, keys = tree, name.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def train_step(cfg: Dict, params: Dict[str, torch.Tensor],
               mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor],
               count: int, step: int, n_active: int,
               data: Dict[str, torch.Tensor],
               draws: Dict[str, torch.Tensor]) -> Dict:
    """One step. ``params``, ``mu``, ``nu``: f32 tensors by dotted leaf
    name; ``draws``: vi, yi, xi (R,), strat (R, n_coarse), pdf (R, n_fine),
    probe_pts and probe_noise (n_random_pts, 3); ``data``: images,
    normals (V, H, W, 3), masks (V, H, W), t_range (V, H, W, 2),
    view_weights (V,), c2w (V, 3, 4). Returns the weighted loss terms
    (floats), the gradients, and the parameters and moments after the
    update (f32, by leaf name)."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        leaves = {k: v.detach().float().clone().requires_grad_()
                  for k, v in params.items()}
        terms = forward(cfg, _tree(leaves), data, draws, step, n_active)
        lw = cfg["loss"]
        total = sum(terms[t] * lw[w] for t, w in TERMS)
        total.backward()
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = was
    opt = cfg["optimizer"]
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    bc1 = 1 - torch.tensor(b1) ** (count + 1)
    bc2 = 1 - torch.tensor(b2) ** (count + 1)
    grads, new, new_mu, new_nu = {}, {}, {}, {}
    with torch.no_grad():
        for name, p in leaves.items():
            if p.grad is None:
                new[name] = p.detach()
                continue
            g = grads[name] = p.grad
            lr = learning_rate(cfg, opt["lr_" + name.split(".")[0]], count)
            m = g * (1 - b1) + mu[name].float() * b1
            v = g * g * (1 - b2) + nu[name].float() * b2
            upd = (m / bc1.to(g.device)) / (
                torch.sqrt(v / bc2.to(g.device)) + eps)
            new[name] = p.detach() - lr.to(g.device) * upd
            new_mu[name], new_nu[name] = m, v
    return {"terms": {t: float(terms[t].detach()) * lw[w] for t, w in TERMS},
            "grads": grads, "params": new, "mu": new_mu, "nu": new_nu}
