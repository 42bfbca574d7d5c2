"""Stage-3 serving: run a trained style translator over every frame of
every action of a uid (counterpart of
``drawingspinup_tpu/pipelines/stage3_translate.py``; training comes with
the backward RIC conv kernel).

  stage 1: GeneratorJ_RIC on (color ⊕ mask ⊕ pos.xy) → res_stage1_*;
  stage 2: GeneratorJ on the stage-1 results with the edge overlay →
           res_stage2_*.
"""
from __future__ import annotations

import os
from typing import List, Optional, Union

import torch

from drawingspinup_torch.core import device as device_setup
from drawingspinup_torch.core.contract import UidPaths
from drawingspinup_torch.core.io import write_image
from drawingspinup_torch.pipelines import stage3_data
from drawingspinup_torch.train import gan

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


def test_on_full_images(model: gan.Generator, render_root: str,
                        actions: List[str], res_name: str, use_mask: bool,
                        use_pos: bool, use_edge: bool, pre_dir: str
                        ) -> List[str]:
    """Stylize every frame of every action dir, writing u8 RGBA PNGs under
    ``<action>/<res_name>/``; returns the written paths."""
    written = []
    for action in actions:
        action_dir = os.path.join(render_root, action)
        src = os.path.join(action_dir, pre_dir)
        if not os.path.isdir(src):
            continue
        out_dir = os.path.join(action_dir, res_name)
        os.makedirs(out_dir, exist_ok=True)
        for fname in sorted(f for f in os.listdir(src) if f.endswith(".png")):
            x_u8 = stage3_data.load_full_frame_u8(
                action_dir, fname, use_edge, pre_dir=pre_dir, use_pos=use_pos)
            rgba = gan.generate_full_rgba(model, x_u8, use_mask, use_pos,
                                          use_edge)
            out_path = os.path.join(out_dir, fname)
            write_image(out_path, rgba)
            written.append(out_path)
    return written


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
