"""Stage 2b: NSR reconstruction of one uid, training loop and export
(counterpart of ``drawingspinup_tpu/pipelines/stage2_recon.py``: ``recon_uid``,
``export_name``, ``nsr_config_from_yaml``).

mv/{color,normal,mask}/<view>.png → NeuS training (progressive hash-grid
band: ``n_active = current_level(step)`` per step) → one params checkpoint
at ``max_steps`` under ``mesh/ckpt/``, written before the export → the
export, by the chain JAX takes at that resolution (``stage2_export.py``) →
thinning, smoothing, color back-projection, shear →
``mesh/it{N}-mc{R}-f{F}[_c]_r[_t][_s][_cbp].obj``.

A finished uid resumes from its checkpoint and re-exports. The data part
lives in ``stage2_data.py`` and the export in ``stage2_export.py``.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict

import numpy as np
import torch

from drawingspinup_torch.core import checkpoint as ckpt
from drawingspinup_torch.core.config import Config
from drawingspinup_torch.core.contract import UidPaths
from drawingspinup_torch.core.io import read_image
from drawingspinup_torch.models.fields import (
    MLPConfig, RadianceConfig, SDFFieldConfig,
)
from drawingspinup_torch.models.hashgrid import HashGridConfig
from drawingspinup_torch.pipelines import stage2_data, stage2_export
from drawingspinup_torch.render import mesh_post
from drawingspinup_torch.train import nsr

# Timings and counts of the last ``recon_uid`` run in this process: ms per
# step of each band phase (host synchronised at the phase boundaries), the
# export's parts in seconds, the export's field evaluations, and the logged
# (step, loss, loss_mask, inv_s).
LAST_STATS: Dict[str, Any] = {}


def export_name(max_steps: int, mc_res: int, face_count: int, cutting: bool,
                remeshing: bool, thinning: bool, smoothing: bool,
                color_bp: bool) -> str:
    """The reference's OBJ name (neus_ortho.py:182-200)."""
    name = f"it{max_steps}-mc{mc_res}-f{face_count}"
    if cutting:
        name += "_c"
    if remeshing:
        name += "_r"
    if thinning:
        name += "_t"
    if smoothing:
        name += "_s"
    name += "_cbp" if color_bp else ""
    return name


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _host_params(params):
    if isinstance(params, dict):
        return {k: _host_params(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_host_params(v) for v in params]
    return params.detach().cpu()


def _restore_params(state: nsr.TrainState, saved) -> None:
    with torch.no_grad():
        for (name, p), (name2, s) in zip(nsr.named_leaves(state.params),
                                         nsr.named_leaves(saved)):
            if name != name2 or p.shape != s.shape:
                raise ValueError(f"checkpoint leaf {name2} {tuple(s.shape)} "
                                 f"does not fit {name} {tuple(p.shape)}")
            p.copy_(s)


def recon_uid(root: str, uid: str, cfg: nsr.NSRConfig, *,
              mc_resolution: int = 512, face_count: int = 50000,
              thinning: bool = False, thinning_type: str = "double",
              smoothing: bool = True,
              shearing: bool = True, color_back_projection: bool = True,
              ortho_scale: float = 1.35, front_cutting: bool = True,
              seed: int = 123456, im_size: int = 1024, log_every: int = 100,
              export_uv: bool = False, device="cuda") -> str:
    """Train NeuS on one uid's mv/ set and export the post-processed mesh;
    returns the OBJ's path."""
    device = torch.device(device)
    t_entry = time.time()
    paths = UidPaths(root, uid)
    data = stage2_data.load_ortho_data(paths, im_size=im_size,
                                       hull_trange=cfg.hull_trange,
                                       radius=cfg.radius, device=device)
    front_mask = stage2_data.load_front_mask(paths)
    _sync(device)
    t_data = time.time() - t_entry

    opt = nsr.make_optimizer(cfg)
    state = nsr.init_state(cfg, seed, device)
    ckpt_root = os.path.join(paths.mesh_dir, "ckpt")
    start_step = 0
    latest = ckpt.latest_step(ckpt_root)
    if latest is not None and latest <= cfg.max_steps:
        # the one save happens at max_steps: a resume re-exports
        saved = ckpt.restore(os.path.join(ckpt_root, f"step_{latest}.pt"))
        _restore_params(state, saved["params"])
        state.step = start_step = latest
        print(f"[recon {uid}] resumed from step {latest}")

    gen = torch.Generator(device=device).manual_seed(seed + 1)
    v, h, w = data["masks"].shape
    if start_step < cfg.max_steps:              # keep the draw stream aligned
        for _ in range(start_step):
            nsr.make_draws(cfg, v, h, w, gen, device)
    phase_ms: Dict[int, float] = {}
    history = []                      # (step, loss, loss_mask, inv_s)
    t0 = t_phase = time.time()
    phase_start = start_step
    for step in range(start_step, cfg.max_steps):
        n_active = cfg.sdf.grid.current_level(step)
        draws = nsr.make_draws(cfg, v, h, w, gen, device)
        logs = nsr.train_step(cfg, opt, state, data, draws, n_active=n_active)
        if log_every and step % log_every == 0:
            loss, mask, s = (float(logs[k])
                             for k in ("loss", "loss_mask", "inv_s"))
            history.append((step, loss, mask, s))
            print(f"[recon {uid}] step {step}: loss={loss:.4f} "
                  f"mask={mask:.4f} inv_s={s:.1f}")
        last = step + 1 == cfg.max_steps
        if last or cfg.sdf.grid.current_level(step + 1) != n_active:
            _sync(device)
            now = time.time()
            phase_ms[n_active] = 1e3 * (now - t_phase) / (step + 1
                                                          - phase_start)
            t_phase, phase_start = now, step + 1
    _sync(device)
    train_time = time.time() - t0

    t0 = time.time()
    if cfg.max_steps > start_step:
        ckpt.save(os.path.join(ckpt_root, f"step_{cfg.max_steps}.pt"),
                  {"params": _host_params(state.params)})
    t_ckpt = time.time() - t0

    verts, faces, times = stage2_export.export_mesh(
        cfg, state.params, mc_resolution, cfg.max_steps, device,
        front_mask=front_mask if front_cutting else None,
        face_count=face_count)

    front_color = read_image(paths.mv("color", "front"))[..., :3] \
        if color_back_projection else None
    back_color = read_image(paths.mv("color", "back"))[..., :3] \
        if color_back_projection else None
    drawing_mask = read_image(paths.mask)[..., 0] \
        if os.path.exists(paths.mask) else None
    name = export_name(cfg.max_steps, mc_resolution, face_count,
                       front_cutting, True, thinning, smoothing,
                       color_back_projection)
    out_path = os.path.join(paths.mesh_dir, name + ".obj")

    vert_colors = None
    if not color_back_projection:
        # albedo from the radiance field, band frozen at the final step
        from drawingspinup_torch.models.fields import (
            radiance_forward, sdf_with_grad,
        )
        from drawingspinup_torch.models.hashgrid import progressive_mask
        with torch.no_grad():
            mask = progressive_mask(cfg.sdf.grid, cfg.max_steps, device)
            _, grad, feat = sdf_with_grad(
                cfg.sdf, state.params["geometry"],
                torch.as_tensor(verts, dtype=torch.float32, device=device),
                1e-3, mask)
            n = grad / torch.clamp(torch.linalg.norm(grad, dim=-1,
                                                     keepdim=True), min=1e-9)
            vert_colors = radiance_forward(
                cfg.radiance, state.params["texture"], feat, -n,
                n).cpu().numpy()
    t0 = time.time()
    mesh_post.save_mesh(
        out_path, verts, faces, vert_colors=vert_colors,
        front_mask=drawing_mask, front_color=front_color,
        back_color=back_color, thinning=thinning,
        thinning_type=thinning_type, smoothing=smoothing,
        color_back_projection=color_back_projection, shearing=shearing,
        ortho_scale=ortho_scale, export_uv=export_uv)
    times["save"] = time.time() - t0
    LAST_STATS.clear()
    LAST_STATS.update({"phase_ms": phase_ms, "export": times,
                       "log": history, "train_s": train_time, "data_s": t_data,
                       "ckpt_s": t_ckpt, "steps": cfg.max_steps - start_step})
    phases = ", ".join(f"{k} levels {ms:.2f} ms/step"
                       for k, ms in phase_ms.items())
    parts = "  ".join(f"{k} {v:.2f}s" for k, v in times.items()
                      if isinstance(v, float))
    print(f"[recon {uid}] trained {cfg.max_steps} steps in {train_time:.1f}s "
          f"→ {out_path}\n"
          f"[recon {uid}] phases: data+hull {t_data:.1f}s  ckpt {t_ckpt:.1f}s"
          f"  {times['chain']} export: {parts}  "
          f"({phases or 'no training'})")
    return out_path


def nsr_config_from_yaml(cfg: Config) -> nsr.NSRConfig:
    """Map the reference neuralangelo-ortho-wmask.yaml knobs → NSRConfig
    (as the JAX package: ``grad_type`` is never read, so recon runs the
    analytic gradients)."""
    m = cfg.get("model", Config())
    geo = m.get("geometry", Config())
    enc = geo.get("xyz_encoding_config", Config())
    mlp = geo.get("mlp_network_config", Config())
    tex = m.get("texture", Config())
    tmlp = tex.get("mlp_network_config", Config())
    loss = cfg.get("system", Config()).get("loss", Config())
    trainer = cfg.get("trainer", Config())
    optp = cfg.get("system", Config()).get("optimizer", Config()) \
        .get("params", Config())

    grid = HashGridConfig(
        n_levels=enc.get("n_levels", 10),
        n_features_per_level=enc.get("n_features_per_level", 2),
        log2_hashmap_size=enc.get("log2_hashmap_size", 19),
        base_resolution=enc.get("base_resolution", 32),
        per_level_scale=enc.get("per_level_scale", 1.3195079107728942),
        include_xyz=enc.get("include_xyz", True),
        start_level=enc.get("start_level", 4),
        start_step=enc.get("start_step", 0),
        update_steps=enc.get("update_steps", 1000),
        table_dtype=enc.get("table_dtype", "float32"),
        compute_dtype=enc.get("compute_dtype", "float32"),
        dense_max_rows=int(enc.get("dense_max_rows", 0)),
    )
    sdf = SDFFieldConfig(
        radius=m.get("radius", 1.0),
        feature_dim=geo.get("feature_dim", 13),
        grid=grid,
        mlp=MLPConfig(n_neurons=mlp.get("n_neurons", 64),
                      n_hidden_layers=mlp.get("n_hidden_layers", 1),
                      sphere_init=mlp.get("sphere_init", True),
                      sphere_init_radius=mlp.get("sphere_init_radius", 0.5),
                      weight_norm=mlp.get("weight_norm", True)),
    )
    radiance = RadianceConfig(
        input_feature_dim=tex.get("input_feature_dim",
                                  geo.get("feature_dim", 13) + 3),
        mlp=MLPConfig(n_neurons=tmlp.get("n_neurons", 64),
                      n_hidden_layers=tmlp.get("n_hidden_layers", 2),
                      output_activation="sigmoid"),
    )
    lw = nsr.LossWeights(
        lambda_rgb_mse=loss.get("lambda_rgb_mse", 0.5),
        lambda_rgb_l1=loss.get("lambda_rgb_l1", 0.0),
        lambda_mask=loss.get("lambda_mask", 1.0),
        lambda_eikonal=loss.get("lambda_eikonal", 0.2),
        lambda_normal=loss.get("lambda_normal", 1.0),
        lambda_3d_normal_smooth=loss.get("lambda_3d_normal_smooth", 1.0),
        lambda_sparsity=loss.get("lambda_sparsity", 0.5),
        sparsity_scale=loss.get("sparsity_scale", 100.0),
        geo_aware=loss.get("geo_aware", True),
        rgb_p_ratio=loss.get("rgb_p_ratio", 0.8),
        normal_p_ratio=loss.get("normal_p_ratio", 0.8),
        mask_p_ratio=loss.get("mask_p_ratio", 0.9),
    )
    return nsr.NSRConfig(
        radius=m.get("radius", 1.0),
        sdf=sdf, radiance=radiance,
        variance_init=m.get("variance", Config()).get("init_val", 0.3),
        cos_anneal_end=m.get("cos_anneal_end", 20000),
        train_num_rays=m.get("train_num_rays_fixed", 2048),
        n_coarse=m.get("n_coarse", 64),
        n_fine=m.get("n_fine", 64),
        hull_trange=m.get("hull_trange", True),
        randomized=m.get("randomized", True),
        loss=lw,
        max_steps=trainer.get("max_steps", 3000),
        constant_steps=cfg.get("system", Config()).get("constant_steps", 500),
        lr_geometry=optp.get("geometry", Config()).get("lr", 1e-3),
        lr_texture=optp.get("texture", Config()).get("lr", 1e-2),
        lr_variance=optp.get("variance", Config()).get("lr", 1e-3),
        ray_chunk=m.get("ray_chunk", 4096),
    )
