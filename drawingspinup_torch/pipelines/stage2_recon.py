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

Spans of ``core/profiling.py``: ``recon.data`` (views and hull to the
device), ``recon.train`` ⊃ ``recon.band`` (one a band phase: the steps
at one ``current_level``, the card waited for at its ends), ``recon.ckpt``
and the export's ``export.*``; counter ``recon.step``, one a training
step.
"""
from __future__ import annotations

import functools
import os
from concurrent.futures import Future
from typing import Callable, Dict, Iterator, Tuple, Union

import numpy as np
import torch

from drawingspinup_torch.core import checkpoint as ckpt
from drawingspinup_torch.core import profiling
from drawingspinup_torch.core.config import Config
from drawingspinup_torch.core.contract import UidPaths
from drawingspinup_torch.core.io import read_image
from drawingspinup_torch.models.fields import (
    MLPConfig, RadianceConfig, SDFFieldConfig,
)
from drawingspinup_torch.models.hashgrid import HashGridConfig
from drawingspinup_torch.parallel import mesh
from drawingspinup_torch.pipelines import stage2_data, stage2_export
from drawingspinup_torch.render import mesh_post
from drawingspinup_torch.train import nsr, nsr_parallel


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


def band_phases(grid: HashGridConfig, start: int, stop: int
                ) -> Iterator[Tuple[int, int, int]]:
    """The training steps ``start`` to ``stop`` by band phase: (active
    levels, first step, end step) of each run of steps at one
    ``current_level``."""
    first = start
    for step in range(start, stop):
        n_active = grid.current_level(step)
        if step + 1 == stop or grid.current_level(step + 1) != n_active:
            yield n_active, first, step + 1
            first = step + 1


def _last(name: str) -> float:
    """The seconds of the span ``name`` that closed last."""
    return profiling.timings()[name]["last_s"]


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
              export_uv: bool = False, device="cuda",
              tail_executor=None) -> Union[str, Future]:
    """Train NeuS on one uid's mv/ set and export the post-processed mesh;
    returns the OBJ's path.

    In a process group of more than one rank the step is data-parallel
    (``train/nsr_parallel.py``, rank r's draws from
    ``mesh.rank_seed(seed + 1)``): the resume decision is rank 0's, rank 0
    alone writes the checkpoint and the OBJ, and every rank returns its
    path.

    tail_executor: a ``concurrent.futures.Executor``, as JAX's. With
    ``color_back_projection`` the export's host half (march, remesh,
    thinning, ``save_mesh``) reads nothing on the device, so it is
    submitted there and a ``Future[str]`` is returned (rank 0's; the other
    ranks return the path): a multi-uid caller overlaps it with the next
    uid's training. The field and the masks it reads are on the host by
    then."""
    device = torch.device(device)
    paths = UidPaths(root, uid)
    with profiling.span("recon.data", sync=True):
        data = stage2_data.load_ortho_data(paths, im_size=im_size,
                                           hull_trange=cfg.hull_trange,
                                           radius=cfg.radius, device=device)
        front_mask = stage2_data.load_front_mask(paths)
    t_data = _last("recon.data")

    opt = nsr.make_optimizer(cfg)
    state = nsr.init_state(cfg, seed, device)
    ckpt_root = os.path.join(paths.mesh_dir, "ckpt")
    start_step = 0
    latest = mesh.broadcast(ckpt.latest_step(ckpt_root))   # rank 0's
    if latest is not None and latest <= cfg.max_steps:
        # the one save happens at max_steps: a resume re-exports
        saved = ckpt.restore(os.path.join(ckpt_root, f"step_{latest}.pt"))
        _restore_params(state, saved["params"])
        state.step = start_step = latest
        mesh.print_main(f"[recon {uid}] resumed from step {latest}")

    # data parallel over the ranks of the process group, when it has more
    # than one: each rank draws its own shard of the rays
    world = mesh.world_size()
    if world > 1:
        step_fn = nsr_parallel.production_train_step(cfg, opt)
        draw_cfg = step_fn.draw_cfg
        mesh.print_main(f"[recon {uid}] data-parallel over {world} ranks")
    else:
        step_fn, draw_cfg = functools.partial(nsr.train_step, cfg, opt), cfg
    gen = torch.Generator(device=device).manual_seed(mesh.rank_seed(seed + 1))
    v, h, w = data["masks"].shape
    if start_step < cfg.max_steps:              # keep the draw stream aligned
        for _ in range(start_step):
            nsr.make_draws(draw_cfg, v, h, w, gen, device)
    phase_ms: Dict[int, float] = {}
    with profiling.span("recon.train", sync=True):
        for n_active, first, end in band_phases(cfg.sdf.grid, start_step,
                                                cfg.max_steps):
            with profiling.span("recon.band", sync=True):
                for step in range(first, end):
                    draws = nsr.make_draws(draw_cfg, v, h, w, gen, device)
                    logs = step_fn(state, data, draws, n_active=n_active)
                    profiling.count("recon.step")
                    if log_every and step % log_every == 0:
                        loss, mask, s = (float(logs[k]) for k in
                                         ("loss", "loss_mask", "inv_s"))
                        mesh.print_main(
                            f"[recon {uid}] step {step}: loss={loss:.4f} "
                            f"mask={mask:.4f} inv_s={s:.1f}")
            phase_ms[n_active] = 1e3 * _last("recon.band") / (end - first)
    train_time = _last("recon.train")
    # the checkpoint, the export and the OBJ are rank 0's; the other ranks
    # wait for its path (for the export's device half, when its host half
    # is deferred to ``tail_executor``)
    defer = tail_executor is not None and color_back_projection
    deferred: Dict[str, Callable[[], str]] = {}

    def save_and_export() -> str:
        with profiling.span("recon.ckpt"):
            if cfg.max_steps > start_step:
                ckpt.save(os.path.join(ckpt_root,
                                       f"step_{cfg.max_steps}.pt"),
                          {"params": _host_params(state.params)})
        t_ckpt = _last("recon.ckpt")

        crop = front_mask if front_cutting else None
        field = stage2_export.export_field(cfg, state.params, mc_resolution,
                                           cfg.max_steps, device, crop)
        dev_parts, host_parts = stage2_export.PARTS[field["chain"]]
        # read on this thread: a deferred tail runs beside the next uid's
        # spans
        parts = {k: _last(f"export.{k}") for k in dev_parts}
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

        def host_tail() -> str:
            verts, faces = stage2_export.export_host(field, mc_resolution,
                                                     crop, face_count)
            vert_colors = None
            if not color_back_projection:
                # albedo from the radiance field, band frozen at the final
                # step (on the device: this branch never runs deferred)
                from drawingspinup_torch.models.fields import (
                    radiance_forward, sdf_with_grad,
                )
                from drawingspinup_torch.models.hashgrid import (
                    progressive_mask,
                )
                with torch.no_grad():
                    mask = progressive_mask(cfg.sdf.grid, cfg.max_steps,
                                            device)
                    _, grad, feat = sdf_with_grad(
                        cfg.sdf, state.params["geometry"],
                        torch.as_tensor(verts, dtype=torch.float32,
                                        device=device), 1e-3, mask)
                    n = grad / torch.clamp(torch.linalg.norm(
                        grad, dim=-1, keepdim=True), min=1e-9)
                    vert_colors = radiance_forward(
                        cfg.radiance, state.params["texture"], feat, -n,
                        n).cpu().numpy()
            with profiling.span("export.save"):
                mesh_post.save_mesh(
                    out_path, verts, faces, vert_colors=vert_colors,
                    front_mask=drawing_mask, front_color=front_color,
                    back_color=back_color, thinning=thinning,
                    thinning_type=thinning_type, smoothing=smoothing,
                    color_back_projection=color_back_projection,
                    shearing=shearing, ortho_scale=ortho_scale,
                    export_uv=export_uv)
            parts.update({k: _last(f"export.{k}")
                          for k in (*host_parts, "save")})
            phases = ", ".join(f"{k} levels {ms:.2f} ms/step"
                               for k, ms in phase_ms.items())
            secs = "  ".join(f"{k} {v:.2f}s" for k, v in parts.items())
            print(f"[recon {uid}] trained {cfg.max_steps} steps in "
                  f"{train_time:.1f}s → {out_path}\n"
                  f"[recon {uid}] phases: data+hull {t_data:.1f}s  ckpt "
                  f"{t_ckpt:.1f}s  {field['chain']} export: {secs}  "
                  f"({phases or 'no training'})")
            return out_path

        if defer:
            deferred["tail"] = host_tail
            return out_path
        return host_tail()

    out_path = mesh.on_main(save_and_export)
    if "tail" in deferred:                      # rank 0 only
        return tail_executor.submit(deferred["tail"])
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
