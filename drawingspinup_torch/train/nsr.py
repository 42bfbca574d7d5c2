"""NSR (NeuS) reconstruction trainer (counterpart of
``drawingspinup_tpu/train/nsr.py``): ray sampling, two-pass rendering, the
loss set and optax's AdamW, one eager step at a time.

What differs from JAX, by design of the port:
  * The random draws of a step (view/y/x pixels, stratified jitter, pdf
    jitter, probe points and probe noise) are an explicit ``Draws``; the
    training loop makes them with a ``torch.Generator``, the parity tests
    hand in JAX's.
  * The coarse pass runs under ``torch.no_grad()`` (JAX ``stop_gradient``).
  * Only analytic field gradients: JAX's ``grad_type`` option is dropped,
    since recon never sets it (``nsr_config_from_yaml`` does not read the
    yaml's ``finite_difference``).
  * Per-pixel targets live packed in one (V·H·W, 12) f32 table; one
    launch of the fused pixel-ray kernel (``kernels/pixel_rays.py``) fetches
    a step's rows and builds its rays.
  * The optimizer is optax's ``adamw`` as ``make_optimizer`` configures it,
    written out: b1 0.9, b2 0.99, eps 1e-15, no weight decay, an f32 first
    moment, the second moment in the parameter's dtype (bf16 for bf16
    tables), updates added in f32 and cast to the parameter's dtype, and a
    per-group constant-then-exponential learning rate.

Spans of ``core/profiling.py``: ``nsr.step`` (the step's unit, opened by
``train_step``) ⊃ ``nsr.rays`` (the pixel-ray fetch), ``nsr.coarse`` (the
no-grad coarse pass and the resampling), ``nsr.fine`` (the full evaluation
with gradients and the compositing), ``nsr.loss``, ``nsr.backward`` and
``nsr.update`` (the written-out Adam); counter ``nsr.band.<n>``, one a step
at ``n`` active levels.
"""
from __future__ import annotations

import dataclasses
from typing import (
    Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple,
)

import numpy as np
import torch

from drawingspinup_torch.core import profiling
from drawingspinup_torch.kernels import pixel_rays
from drawingspinup_torch.models.fields import (
    RadianceConfig, SDFFieldConfig, init_radiance, init_sdf_field,
    init_variance, inv_s, radiance_forward, sdf_forward,
    sdf_with_grad_analytic,
)
from drawingspinup_torch.models.hashgrid import progressive_mask
from drawingspinup_torch.render import neus
from drawingspinup_torch.train import losses as L

GROUPS = ("geometry", "texture", "variance")


@dataclasses.dataclass(frozen=True)
class LossWeights:
    lambda_rgb_mse: float = 0.5
    lambda_rgb_l1: float = 0.0
    lambda_mask: float = 1.0
    lambda_eikonal: float = 0.2
    lambda_normal: float = 1.0
    lambda_3d_normal_smooth: float = 1.0
    lambda_sparsity: float = 0.5
    sparsity_scale: float = 100.0
    geo_aware: bool = True
    rgb_p_ratio: float = 0.8
    normal_p_ratio: float = 0.8
    mask_p_ratio: float = 0.9


@dataclasses.dataclass(frozen=True)
class NSRConfig:
    radius: float = 1.0
    sdf: SDFFieldConfig = SDFFieldConfig()
    radiance: RadianceConfig = RadianceConfig()
    variance_init: float = 0.3
    cos_anneal_end: int = 20000
    train_num_rays: int = 2048
    n_coarse: int = 64
    n_fine: int = 64
    n_random_pts: int = 2048
    randomized: bool = True
    hull_trange: bool = True
    loss: LossWeights = LossWeights()
    max_steps: int = 3000
    constant_steps: int = 500
    lr_geometry: float = 1e-3
    lr_texture: float = 1e-2
    lr_variance: float = 1e-3
    lr_decay_target: float = 0.1
    ray_chunk: int = 4096

    @property
    def n_samples(self) -> int:
        return self.n_coarse + self.n_fine


def init_params(cfg: NSRConfig, generator: torch.Generator,
                device="cpu") -> Dict[str, Any]:
    """Seeded parameters with JAX's layout and init distributions; every
    leaf requires grad."""
    params = {"geometry": init_sdf_field(cfg.sdf, generator, device),
              "texture": init_radiance(cfg.radiance, generator, device),
              "variance": init_variance(cfg.variance_init, device)}
    for _, t in named_leaves(params):
        t.requires_grad_(True)
    return params


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """Dotted names and leaves of a params tree, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


# ---------------------------------------------------------------------------
# optimizer: optax.multi_transform of three adamw, written out
# ---------------------------------------------------------------------------

def learning_rate(cfg: NSRConfig, base_lr: float, count: int) -> torch.Tensor:
    """The constant-then-exponential schedule at update ``count``, in f32 as
    JAX evaluates it."""
    decay_steps = max(cfg.max_steps - cfg.constant_steps, 1)
    gamma = cfg.lr_decay_target ** (1.0 / decay_steps)
    s = torch.tensor(float(count), dtype=torch.float32)
    if s < cfg.constant_steps:
        return torch.tensor(base_lr, dtype=torch.float32)
    e = torch.clamp(s - cfg.constant_steps, min=0.0)
    return torch.tensor(base_lr, dtype=torch.float32) * \
        torch.tensor(gamma, dtype=torch.float32) ** e


@dataclasses.dataclass
class OptState:
    """Adam moments by leaf name (mu f32, nu in the leaf's dtype) and the
    shared update count."""
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0


class NSROptimizer:
    """optax ``adamw(schedule(lr), b1=0.9, b2=0.99, eps=1e-15,
    weight_decay=0, mu_dtype=f32)`` per group (geometry, texture,
    variance), as ``jnp``'s dtype rules run it."""
    b1, b2, eps = 0.9, 0.99, 1e-15

    def __init__(self, cfg: NSRConfig):
        self.cfg = cfg
        self.base_lr = {"geometry": cfg.lr_geometry,
                        "texture": cfg.lr_texture,
                        "variance": cfg.lr_variance}

    def init(self, params) -> OptState:
        mu, nu = {}, {}
        for name, p in named_leaves(params):
            mu[name] = torch.zeros_like(p, dtype=torch.float32,
                                        requires_grad=False)
            nu[name] = torch.zeros_like(p, requires_grad=False)
        return OptState(mu, nu, 0)

    @torch.no_grad()
    def step(self, params, state: OptState) -> None:
        """Apply one update from the leaves' ``.grad`` in place. A leaf
        without a gradient (a locked hash level) is left as it is: its
        moments are zero and its update would be exactly zero."""
        count_inc = state.count + 1
        lrs = {g: -learning_rate(self.cfg, lr, state.count)
               for g, lr in self.base_lr.items()}
        f32 = torch.float32
        bc1 = 1 - torch.tensor(self.b1, dtype=f32) ** count_inc
        bc2 = 1 - torch.tensor(self.b2, dtype=f32) ** count_inc
        for name, p in named_leaves(params):
            g = p.grad
            if g is None:
                continue
            pd = p.dtype
            # python scalars are weakly typed in JAX: they take the
            # array's dtype
            mu = g * torch.tensor(1 - self.b1, dtype=pd) \
                + state.mu[name] * self.b1
            nu = (g * g) * torch.tensor(1 - self.b2, dtype=pd) \
                + state.nu[name] * torch.tensor(self.b2, dtype=pd)
            mu_hat = mu / bc1
            nu_hat = nu / bc2.to(pd)
            upd = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            p.copy_((p.float() + lrs[name.split(".")[0]] * upd).to(pd))
            state.mu[name] = mu
            state.nu[name] = nu
        state.count = count_inc


def make_optimizer(cfg: NSRConfig) -> NSROptimizer:
    return NSROptimizer(cfg)


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Any]
    opt_state: OptState
    step: int = 0


def init_state(cfg: NSRConfig, seed: int, device="cpu") -> TrainState:
    g = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, g, device)
    return TrainState(params, make_optimizer(cfg).init(params), 0)


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------

class Draws(NamedTuple):
    """One step's random numbers: pixel indices (R,) int64, stratified and
    pdf jitter (R, n_coarse) / (R, n_fine) uniform [0, 1), probe points
    (n_random_pts, 3) uniform [-1, 1) and their standard-normal noise."""
    vi: torch.Tensor
    yi: torch.Tensor
    xi: torch.Tensor
    strat: torch.Tensor
    pdf: torch.Tensor
    probe_pts: torch.Tensor
    probe_noise: torch.Tensor


def make_draws(cfg: NSRConfig, n_views: int, h: int, w: int,
               generator: torch.Generator, device) -> Draws:
    r = cfg.train_num_rays

    def ints(hi):
        return torch.randint(0, hi, (r,), generator=generator, device=device)

    def uni(shape):
        return torch.rand(shape, generator=generator, device=device)

    return Draws(ints(n_views), ints(h), ints(w), uni((r, cfg.n_coarse)),
                 uni((r, cfg.n_fine)), uni((cfg.n_random_pts, 3)) * 2 - 1,
                 torch.randn((cfg.n_random_pts, 3), generator=generator,
                             device=device))


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _occ_alpha(sdf, step_size, s):
    prev_cdf = torch.sigmoid((sdf + step_size * 0.5) * s)
    next_cdf = torch.sigmoid((sdf - step_size * 0.5) * s)
    return ((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).clamp(0.0, 1.0)


def _cos_anneal(cfg: NSRConfig, step: int) -> float:
    if cfg.cos_anneal_end == 0:
        return 1.0
    return float(min(np.float32(1.0),
                     np.float32(step) / np.float32(cfg.cos_anneal_end)))


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree.detach()


def render_rays(cfg: NSRConfig, params, rays_o: torch.Tensor,
                rays_d: torch.Tensor, draws: Optional[Draws], step: int,
                train: bool, n_active: Optional[int] = None,
                t_range: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """rays (R, 3) → composited rgb/normal/opacity/depth (+ training aux).
    Coarse stratified pass (sdf only, no grad) → inverse-CDF resampling →
    one full eval with analytic gradients over the sorted union;
    in training the probe points ride along in that eval."""
    dev = rays_o.device
    level_mask = progressive_mask(cfg.sdf.grid, step, dev)
    s = inv_s(params["variance"])
    cos_anneal = _cos_anneal(cfg, step)
    jitter = train and cfg.randomized and draws is not None

    t_near, t_far = neus.aabb_intersect(rays_o, rays_d, cfg.radius)
    hit = (t_far > t_near).to(rays_o.dtype)
    if t_range is not None:
        t_near, t_far = t_range[:, 0], t_range[:, 1]
    t_far = torch.maximum(t_far, t_near + 1e-4)

    with profiling.span("nsr.coarse"), torch.no_grad():
        t_c = neus.stratified_samples(t_near, t_far, cfg.n_coarse,
                                      draws.strat if jitter else None)
        pos_c = rays_o[:, None, :] + rays_d[:, None, :] * t_c[..., None]
        step_c = (t_far - t_near)[:, None] / cfg.n_coarse
        sdf_c, _ = sdf_forward(cfg.sdf, _detached(params["geometry"]),
                               pos_c.reshape(-1, 3), level_mask, n_active)
        w_c = _occ_alpha(sdf_c.reshape(t_c.shape), step_c, s.detach())
        t_f = neus.sample_pdf(t_c, w_c, cfg.n_fine,
                              draws.pdf if jitter else None)
        t_all = torch.sort(torch.cat([t_c, t_f], dim=-1), dim=-1).values
        dists = torch.diff(t_all, dim=-1)
        dists = torch.cat([dists, dists[..., -1:]], dim=-1)
        pos = rays_o[:, None, :] + rays_d[:, None, :] * t_all[..., None]

    with profiling.span("nsr.fine"):
        n_main = pos.shape[0] * pos.shape[1]
        if train:
            probe = draws.probe_pts
            eval_pts = torch.cat([pos.reshape(-1, 3), probe,
                                  probe + draws.probe_noise * 1e-2], dim=0)
        else:
            eval_pts = pos.reshape(-1, 3)
        sdf_all, grad_all, feat_all = sdf_with_grad_analytic(
            cfg.sdf, params["geometry"], eval_pts, level_mask, n_active)
        S = cfg.n_samples
        sdf = sdf_all[:n_main].reshape(-1, S)
        grad_flat = grad_all[:n_main]
        grad = grad_flat.reshape(-1, S, 3)
        feature = feat_all[:n_main]
        normal = grad / torch.clamp(
            torch.linalg.norm(grad, dim=-1, keepdim=True), min=1e-9)
        dirs = rays_d[:, None, :].expand(pos.shape)

        alpha = neus.neus_alpha(sdf, normal, dirs, dists, s, cos_anneal)
        alpha = alpha * hit[:, None]
        rgb = radiance_forward(cfg.radiance, params["texture"],
                               feature.reshape(-1, S, feature.shape[-1]),
                               dirs, normal)
        comp = neus.composite(alpha, {"rgb": rgb, "normal": normal,
                                      "depth": t_all[..., None]})
        cn = comp["comp_normal"]
        out = {
            "comp_rgb": comp["comp_rgb"],
            "comp_normal": cn / torch.clamp(
                torch.linalg.norm(cn, dim=-1, keepdim=True), min=1e-9),
            "opacity": comp["opacity"],
            "depth": comp["comp_depth"],
            "inv_s": s,
            "num_samples": (alpha.detach() > 1e-4).sum(),
        }
        if train:
            n_r = cfg.n_random_pts
            out.update({
                "sdf_samples": sdf.reshape(-1),
                "sdf_grad_samples": grad_flat,
                "weights": comp["weights"].reshape(-1),
                "random_sdf": sdf_all[n_main:n_main + n_r],
                "random_sdf_grad": grad_all[n_main:n_main + n_r],
                "normal_perturb": grad_all[n_main + n_r:],
            })
        return out


# ---------------------------------------------------------------------------
# pixel sampling + losses
# ---------------------------------------------------------------------------

PIXEL_COLUMNS = 12       # rgb 3, normal 3, mask 1, t_range 2, pad 3


def pack_pixels(data: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The per-pixel targets as one (V·H·W, 12) f32 table: 48-byte rows for
    the pixel-ray kernel."""
    v, h, w = data["masks"].shape
    cols = [data["images"], data["normals"], data["masks"][..., None]]
    if "t_range" in data:
        cols.append(data["t_range"])
    table = torch.cat(cols, dim=-1).reshape(v * h * w, -1).float()
    return torch.nn.functional.pad(
        table, (0, PIXEL_COLUMNS - table.shape[1])).contiguous()


def sample_pixel_rays(data: Dict[str, torch.Tensor], draws: Draws):
    """The drawn (view, y, x) pixels → world ortho rays and per-pixel
    targets. data: images (V,H,W,3), normals (V,H,W,3), masks (V,H,W),
    view_weights (V,), c2w (V,3,4), optional t_range (V,H,W,2), and
    ``pixels`` (``pack_pixels``). One launch of the fused pixel-ray kernel
    on the card (``kernels/pixel_rays.py``), its plain twin on the CPU."""
    v, h, w = data["masks"].shape
    rays_o, rays_d, px, vw = pixel_rays.sample(
        data["c2w"], data["view_weights"], data["pixels"], h, w, draws.vi,
        draws.yi, draws.xi)
    targets = {"rgb": px[:, 0:3], "normal": px[:, 3:6], "mask": px[:, 6],
               "view_weights": vw}
    if "t_range" in data:
        targets["t_range"] = px[:, 7:9]
    return rays_o, rays_d, targets


def compute_losses(cfg: NSRConfig, out: Dict[str, torch.Tensor],
                   targets: Dict[str, torch.Tensor]):
    lw = cfg.loss
    cos = L.cosine_similarity(out["rays_d"], targets["normal"])
    cos = torch.where(cos > -0.1, torch.zeros_like(cos), cos)
    mask = (targets["mask"] > 0) & (cos < -0.1)

    rgb_err = ((out["comp_rgb"] - targets["rgb"]) ** 2).sum(dim=-1)
    loss_rgb_mse = L.ranking_loss(rgb_err, lw.rgb_p_ratio, mask=mask)
    rgb_l1 = (out["comp_rgb"] - targets["rgb"]).abs().sum(dim=-1)
    loss_rgb_l1 = L.ranking_loss(rgb_l1, lw.rgb_p_ratio, mask=mask)

    normal_err = 1.0 - L.cosine_similarity(out["comp_normal"],
                                           targets["normal"])
    if lw.geo_aware:
        gw = torch.exp(cos.abs())
        normal_err = normal_err * gw / gw.sum()
        loss_normal = L.ranking_loss(normal_err, lw.normal_p_ratio, mask=mask,
                                     extra_weights=targets["view_weights"],
                                     reduction="sum")
    else:
        loss_normal = L.ranking_loss(normal_err, lw.normal_p_ratio, mask=mask,
                                     extra_weights=targets["view_weights"])

    loss_eik = L.eikonal_loss(out["sdf_grad_samples"])
    opacity = out["opacity"][..., 0].clamp(1e-3, 1 - 1e-3)
    mask_err = L.binary_cross_entropy(opacity,
                                      targets["mask"].to(torch.float32))
    loss_mask = L.ranking_loss(mask_err, lw.mask_p_ratio,
                               extra_weights=targets["view_weights"])
    loss_sparse = L.sparsity_loss(out["random_sdf"], lw.sparsity_scale)
    loss_smooth = L.normal_smooth_loss(out["random_sdf_grad"],
                                       out["normal_perturb"])

    total = (loss_rgb_mse * lw.lambda_rgb_mse
             + loss_rgb_l1 * lw.lambda_rgb_l1
             + loss_normal * lw.lambda_normal
             + loss_eik * lw.lambda_eikonal
             + loss_mask * lw.lambda_mask
             + loss_sparse * lw.lambda_sparsity
             + loss_smooth * lw.lambda_3d_normal_smooth)
    logs = {"loss": total, "loss_rgb_mse": loss_rgb_mse,
            "loss_normal": loss_normal, "loss_eikonal": loss_eik,
            "loss_mask": loss_mask, "loss_sparsity": loss_sparse,
            "loss_3d_normal_smooth": loss_smooth, "inv_s": out["inv_s"],
            "num_samples": out["num_samples"].to(torch.float32)}
    return total, logs


def loss_and_grads(cfg: NSRConfig, state: TrainState,
                   data: Dict[str, torch.Tensor], draws: Draws,
                   n_active: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Forward and backward of one step: the leaves' ``.grad`` hold the
    step's gradients (None for locked levels); returns the detached logs."""
    with profiling.span("nsr.rays"):
        rays_o, rays_d, targets = sample_pixel_rays(data, draws)
    t_range = targets.pop("t_range", None)
    for _, p in named_leaves(state.params):
        p.grad = None
    out = render_rays(cfg, state.params, rays_o, rays_d, draws, state.step,
                      train=True, n_active=n_active, t_range=t_range)
    out["rays_d"] = rays_d
    with profiling.span("nsr.loss"):
        loss, logs = compute_losses(cfg, out, targets)
    with profiling.span("nsr.backward"):
        loss.backward()
    return {k: v.detach() for k, v in logs.items()}


def train_step(cfg: NSRConfig, opt: NSROptimizer, state: TrainState,
               data: Dict[str, torch.Tensor], draws: Draws,
               n_active: Optional[int] = None,
               reduce: Optional[Callable[[List[Optional[torch.Tensor]]],
                                         None]] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimization step, in place on ``state``; returns the logs as
    device tensors (read them only when logging: a read synchronises).

    reduce: between the backward and the update, called once on the
    leaves' gradients (None for locked levels) followed by the logs, to
    average them in place over data-parallel ranks
    (``train/nsr_parallel.py``)."""
    band = cfg.sdf.grid.current_level(state.step) if n_active is None \
        else n_active
    profiling.count(f"nsr.band.{band}")
    with profiling.span("nsr.step", unit=True):
        logs = loss_and_grads(cfg, state, data, draws, n_active)
        if reduce is not None:
            reduce([p.grad for _, p in named_leaves(state.params)]
                   + list(logs.values()))
        with profiling.span("nsr.update"):
            opt.step(state.params, state.opt_state)
    state.step += 1
    return logs


@torch.no_grad()
def render_image(cfg: NSRConfig, params, c2w: np.ndarray, h: int, w: int,
                 step: int = 10 ** 9, device="cpu") -> Dict[str, np.ndarray]:
    """Full-frame eval render in ray chunks."""
    from drawingspinup_torch.render.cameras import (
        ortho_ray_grid, rays_to_world,
    )
    origins, dirs = ortho_ray_grid(w, h)
    rays_o, rays_d = rays_to_world(origins.reshape(-1, 3),
                                   dirs.reshape(-1, 3), np.asarray(c2w))
    keys = ("comp_rgb", "comp_normal", "opacity", "depth")
    chunks: List[Dict[str, np.ndarray]] = []
    for i in range(0, rays_o.shape[0], cfg.ray_chunk):
        ro = torch.from_numpy(np.ascontiguousarray(
            rays_o[i:i + cfg.ray_chunk], np.float32)).to(device)
        rd = torch.from_numpy(np.ascontiguousarray(
            rays_d[i:i + cfg.ray_chunk], np.float32)).to(device)
        out = render_rays(cfg, params, ro, rd, None, step, train=False)
        chunks.append({k: out[k].cpu().numpy() for k in keys})
    return {k: np.concatenate([c[k] for c in chunks]).reshape(h, w, -1)
            for k in keys}
