"""Stage-3 orchestration: train and test the style translator per uid
(counterpart of ``drawingspinup_tpu/pipelines/stage3_translate.py``).

  stage 1: GeneratorJ_RIC on (color ⊕ mask ⊕ pos.xy), target =
           char/ffc_resnet_inpainted.png, 3 epochs, results → res_stage1_*;
  stage 2: GeneratorJ on the stage-1 results with the edge overlay, target =
           char/texture_with_bg.png, 2 epochs, results → res_stage2_*.
  An epoch = n_valid_pixels / batch_size batches; full-image eval and
  checkpoint every log_interval batches and at the end (model_99999).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Dict, List, Optional, Tuple, Union

import torch
import yaml

from drawingspinup_torch.core import device as device_setup
from drawingspinup_torch.core import profiling
from drawingspinup_torch.core.contract import UidPaths
from drawingspinup_torch.core.io import write_image
from drawingspinup_torch.parallel import mesh
from drawingspinup_torch.pipelines import stage3_data
from drawingspinup_torch.train import gan, gan_parallel

FINAL_STEP = 99999


def stage_settings(stage: int, use_mask: bool = True, use_pos: bool = True):
    """Per-stage wiring (reference config_stage{1,2}.yaml + train CLIs)."""
    if stage == 1:
        return dict(generator="GeneratorJ_RIC", pre_dir="color",
                    post_name="ffc_resnet_inpainted", epochs=3,
                    use_edge=False, use_mask=use_mask, use_pos=use_pos)
    return dict(generator="GeneratorJ", pre_dir=None,  # filled from stage-1
                post_name="texture_with_bg", epochs=2,
                use_edge=True, use_mask=use_mask, use_pos=use_pos)


def log_name_for(stage: int, use_mask: bool, use_pos: bool) -> str:
    name = f"logs_stage{stage}"
    if use_mask:
        name += "_mask"
    if use_pos:
        name += "_pos"
    return name


def res_dir_name(stage: int, use_mask: bool, use_pos: bool) -> str:
    return log_name_for(stage, use_mask, use_pos).replace("logs", "res")


def _input_channels(use_mask: bool, use_pos: bool) -> int:
    return 3 + (1 if use_mask else 0) + (2 if use_pos else 0)


_CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "configs")
DEFAULT_STAGE_CFGS = {
    1: os.path.join(_CONFIGS, "config_stage1.yaml"),
    2: os.path.join(_CONFIGS, "config_stage2.yaml"),
}


def gan_config_from_yaml(path: str, use_mask: bool = True,
                         use_pos: bool = True, **overrides
                         ) -> Tuple[gan.GANConfig, Dict[str, Optional[str]]]:
    """A reference-format stage-3 yaml (generator / opt_generator /
    discriminator / perception_loss / trainer blocks under ``job``) →
    (GANConfig, {pre_dir, post_name, root_dir}); ``overrides`` replace
    GANConfig fields (``compute_dtype=...``), as JAX's.

    The yaml's ``input_channels`` is the RGB count; the mask and pos
    channels come from the flags, as the reference train CLIs add them."""
    with open(path) as f:
        y = yaml.safe_load(f) or {}
    job = y.get("job", y)
    g = job.get("generator", {})
    ga = g.get("args", {})
    og = job.get("opt_generator", {}).get("args", {})
    d = job.get("discriminator", {}).get("args", {})
    pl = job.get("perception_loss", {})
    tr = job.get("trainer", {})
    cfg = gan.GANConfig(
        generator=g.get("type", "GeneratorJ_RIC"),
        filters=tuple(ga.get("filters", (32, 64, 128, 128, 128, 64))),
        resnet_blocks=ga.get("resnet_blocks", 7),
        tanh=ga.get("tanh", True),
        append_smoothers=ga.get("append_smoothers", True),
        input_channels=int(ga.get("input_channels", 3))
        + (1 if use_mask else 0) + (2 if use_pos else 0),
        disc_filters=d.get("num_filters", 12),
        disc_layers=d.get("n_layers", 2),
        lr=og.get("lr", 4e-4),
        weight_decay=og.get("weight_decay", 1e-5),
        batch_size=tr.get("batch_size", 40),
        patch_size=tr.get("patch_size", 32),
        reconstruction_weight=tr.get("reconstruction_weight", 4.0),
        perception_weight=pl.get("weight", 6.0),
        adversarial_weight=tr.get("adversarial_weight", 0.5),
        log_interval=tr.get("log_interval", 1000),
        epochs=tr.get("epochs", 3),
        use_image_loss=tr.get("use_image_loss", True),
    )
    extras = {"pre_dir": tr.get("pre_dir"), "post_name": tr.get("post_name"),
              "root_dir": job.get("root_dir")}
    return dataclasses.replace(cfg, **overrides), extras


def make_config(stage: int, use_mask: bool = True, use_pos: bool = True,
                **overrides) -> gan.GANConfig:
    s = stage_settings(stage, use_mask, use_pos)
    return gan.GANConfig(
        generator=s["generator"],
        input_channels=_input_channels(use_mask, use_pos),
        epochs=s["epochs"],
        **overrides)


def pre_dir_for_stage(stage: int, use_mask: bool, use_pos: bool) -> str:
    if stage == 1:
        return "color"
    return res_dir_name(1, use_mask, use_pos)


def post_path_for_stage(paths: UidPaths, stage: int) -> str:
    if stage == 1:
        p = paths.inpainted
        if not os.path.exists(p):
            p = paths.texture_with_bg  # the reference's fallback
        return p
    return paths.texture_with_bg


_FRAME_CACHE_CAP = 512    # u8 frames (~1.8 MB each at 512²): bounds host RAM


def test_on_full_images(model: gan.Generator, render_root: str,
                        actions: List[str], res_name: str, use_mask: bool,
                        use_pos: bool, use_edge: bool, pre_dir: str,
                        frame_cache: Optional[dict] = None,
                        max_frames_per_action: Optional[int] = None
                        ) -> List[str]:
    """Stylize every frame (or the first ``max_frames_per_action``) of
    every action dir with ``model`` in eval mode, writing u8 RGBA PNGs
    under ``<action>/<res_name>/``; returns the written paths.

    frame_cache: a dict reused across the evals of one training run, whose
    input frames do not change between evals."""
    model.eval()
    written = []
    for action in actions:
        action_dir = os.path.join(render_root, action)
        src = os.path.join(action_dir, pre_dir)
        if not os.path.isdir(src):
            continue
        out_dir = os.path.join(action_dir, res_name)
        os.makedirs(out_dir, exist_ok=True)
        fnames = sorted(f for f in os.listdir(src) if f.endswith(".png"))
        for fname in fnames[:max_frames_per_action]:
            key = (action, fname, pre_dir, use_edge, use_pos)
            x_u8 = None if frame_cache is None else frame_cache.get(key)
            if x_u8 is None:
                x_u8 = stage3_data.load_full_frame_u8(
                    action_dir, fname, use_edge, pre_dir=pre_dir,
                    use_pos=use_pos)
                if frame_cache is not None \
                        and len(frame_cache) < _FRAME_CACHE_CAP:
                    frame_cache[key] = x_u8
            rgba = gan.generate_full_rgba(model, x_u8, use_mask, use_pos,
                                          use_edge)
            out_path = os.path.join(out_dir, fname)
            write_image(out_path, rgba)
            written.append(out_path)
    return written


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_stage(root: str, uid: str, stage: int, use_mask: bool = True,
                use_pos: bool = True, seed: int = 0,
                cfg: Optional[gan.GANConfig] = None,
                max_batches: Optional[int] = None,
                device: Union[str, torch.device] = "cuda"
                ) -> gan.TrainState:
    """Train the stage's translator on the rest-pose keyframe of ``uid``:
    ``epochs · (n_valid // batch_size)`` steps, at most ``max_batches``; a
    checkpoint and an eval of ``eval_frame_limit`` frames per action every
    ``log_interval`` steps; then ``model_99999.pt`` and an eval of every
    frame of every action. The per-step losses go to
    ``<log dir>/train_losses.json``.

    In a process group of more than one rank the step is data-parallel
    (``train/gan_parallel.py``, rank r's patches drawn from
    ``mesh.rank_seed(seed + 1)``): rank 0 alone writes the checkpoints,
    the evals and the loss log, and every rank returns once it has."""
    paths = UidPaths(root, uid)
    s = stage_settings(stage, use_mask, use_pos)
    cfg = cfg or make_config(stage, use_mask, use_pos)
    dev = device_setup.setup(device)
    render_root = paths.render_dir
    pre_dir = pre_dir_for_stage(stage, use_mask, use_pos)
    rest_dir = os.path.join(render_root, "rest_pose")
    if not os.path.isdir(rest_dir):
        rest_dir = os.path.join(render_root, "rest_rotate")
    data = stage3_data.keyframe_data(stage3_data.load_keyframe_pair(
        rest_dir, pre_dir, post_path_for_stage(paths, stage),
        use_mask=use_mask, use_pos=use_pos, use_edge=s["use_edge"]), dev)

    log_dir = os.path.join(paths.mesh_dir,
                           log_name_for(stage, use_mask, use_pos))
    if mesh.is_main():
        os.makedirs(log_dir, exist_ok=True)
    res_name = res_dir_name(stage, use_mask, use_pos)
    actions = sorted(d for d in os.listdir(render_root)
                     if os.path.isdir(os.path.join(render_root, d)))

    state = gan.init_state(cfg, dev, seed)
    total = cfg.epochs * max(data.n_valid // cfg.batch_size, 1)
    if max_batches is not None:
        total = min(total, max_batches)
    # data parallel over the ranks of the process group, when it has more
    # than one: each rank cuts its own share of the patch batch
    world = mesh.world_size()
    if world > 1:
        step_fn = gan_parallel.production_train_step(cfg)
        mesh.print_main(f"[stage{stage} {uid}] patch-dp over {world} ranks")
    else:
        step_fn = functools.partial(gan.train_step, cfg)
    generator = torch.Generator(device=dev).manual_seed(
        mesh.rank_seed(seed + 1))
    # losses stay on the device and are read at log_interval and at the end
    losses = torch.zeros((total, len(gan.LOSS_NAMES)), device=dev)
    evaluate = functools.partial(
        test_on_full_images, state.gen, render_root, actions, res_name,
        use_mask, use_pos, s["use_edge"], pre_dir, frame_cache={})
    ckpt0, eval0 = profiling.total("stage3.ckpt"), profiling.total(
        "stage3.eval")
    with profiling.span("stage3.train"):
        for b in range(total):
            logs = step_fn(state, data, generator)
            losses[b] = torch.stack([logs[k] for k in gan.LOSS_NAMES])
            # checkpoints, evals and the loss log are rank 0's; the other
            # ranks go on to the next step's all-reduce and wait there
            if (b + 1) % cfg.log_interval == 0 and mesh.is_main():
                d_loss, g_loss = losses[b, :2].tolist()   # syncs the host
                print(f"[stage{stage} {uid}] batch {b + 1}/{total} "
                      f"g={g_loss:.4f} d={d_loss:.4f}")
                with profiling.span("stage3.ckpt"):
                    gan.save_checkpoint(log_dir, state.gen, b + 1)
                with profiling.span("stage3.eval"):
                    evaluate(max_frames_per_action=cfg.eval_frame_limit)
        _sync(dev)

        def finish() -> None:
            with profiling.span("stage3.ckpt"):
                gan.save_checkpoint(log_dir, state.gen, FINAL_STEP)
            with profiling.span("stage3.eval"):
                evaluate()
            with open(os.path.join(log_dir, "train_losses.json"), "w") as f:
                json.dump(dict(zip(gan.LOSS_NAMES, losses.T.tolist())), f)

        mesh.on_main(finish)
    wall = profiling.timings()["stage3.train"]["last_s"]
    t_ckpt = profiling.total("stage3.ckpt") - ckpt0
    t_eval = profiling.total("stage3.eval") - eval0
    steps_wall = wall - t_eval - t_ckpt
    mesh.print_main(f"[stage{stage} {uid}] {total} batches in {wall:.1f}s "
                    f"(steps {steps_wall:.1f}s = "
                    f"{1e3 * steps_wall / max(total, 1):.1f} ms/step, eval "
                    f"{t_eval:.1f}s, ckpt {t_ckpt:.1f}s)")
    return state


def test_stage(root: str, uid: str, stage: int, use_mask: bool = True,
               use_pos: bool = True, model_id: int = FINAL_STEP,
               cfg: Optional[gan.GANConfig] = None,
               device: Union[str, torch.device] = "cuda") -> List[str]:
    """Load ``logs_stage{stage}_*/model_{model_id:05d}.pt`` and stylize
    every action of ``uid`` on ``device``."""
    paths = UidPaths(root, uid)
    s = stage_settings(stage, use_mask, use_pos)
    cfg = cfg or make_config(stage, use_mask, use_pos)
    dev = device_setup.setup(device)
    log_dir = os.path.join(paths.mesh_dir,
                           log_name_for(stage, use_mask, use_pos))
    model = gan.load_checkpoint(log_dir, gan.build_generator(cfg, dev),
                                model_id)
    render_root = paths.render_dir
    actions = sorted(d for d in os.listdir(render_root)
                     if os.path.isdir(os.path.join(render_root, d)))
    return test_on_full_images(
        model, render_root, actions,
        res_dir_name(stage, use_mask, use_pos), use_mask, use_pos,
        s["use_edge"], pre_dir_for_stage(stage, use_mask, use_pos))
