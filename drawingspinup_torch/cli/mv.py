"""Stage-2a CLI: multi-view generation for one uid, on the GPU.

``python -m drawingspinup_torch.cli.mv --uid <uid> --root <root>
[--config <yaml>] [--ckpt <wonder3d_dir>] [--steps 75] [--guidance 1.0]
[--seed N] [--size 256] [--out-size 1024] [--tiny] [--device cuda|cpu]``:
the flags of ``drawingspinup_tpu/cli/mv.py`` plus ``--device``. The
reference-format yaml (default: the packaged
``configs/mvdiffusion-joint-ortho-6views.yaml``) supplies the defaults.

Weights: ``--ckpt`` (or the yaml's ``pretrained_model_name_or_path``) names
a local diffusers-layout Wonder3D directory (``unet/``, ``vae/``,
``image_encoder/``), loaded strictly. Without one the weights are drawn
from ``--seed`` on the device, with a warning. ``--tiny`` runs a small
UNet, VAE and CLIP for tests.

Under ``python -m torch.distributed.run --nproc-per-node N`` the denoise
loop's 12-image batch is split over the largest divisor of 12 that is at
most N ranks, one rank a GPU (``pipelines/stage2_mv.py::batch_split``),
and rank 0 decodes and writes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from drawingspinup_torch.core.config import load_config

DEFAULT_CFG = os.path.join(os.path.dirname(__file__), "..", "configs",
                           "mvdiffusion-joint-ortho-6views.yaml")


def main(argv=None) -> int:
    from drawingspinup_torch.models.unet_mv2d import UNetMVConfig
    from drawingspinup_torch.models.vae import VAEConfig
    from drawingspinup_torch.parallel import mesh
    from drawingspinup_torch.pipelines import stage2_mv as mv

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=DEFAULT_CFG)
    ap.add_argument("--uid", required=True)
    ap.add_argument("--root", default=None)
    ap.add_argument("--ckpt", default=None,
                    help="local diffusers-layout Wonder3D checkpoint dir")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--guidance", type=float, default=None,
                    help="classifier-free guidance scale (!= 1.0 doubles "
                         "the UNet batch of each step)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--out-size", type=int, default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="small UNet/VAE/CLIP for smoke tests")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = mesh.entry_device(args.device)

    ycfg = load_config(args.config)
    pvk = ycfg.get("pipe_validation_kwargs", {})
    vds = ycfg.get("validation_dataset", {})
    root = args.root or ycfg.get("data_root")
    ckpt = args.ckpt or ycfg.get("pretrained_model_name_or_path")
    steps = args.steps if args.steps is not None \
        else int(pvk.get("num_inference_steps", 75))
    seed = args.seed if args.seed is not None else int(ycfg.get("seed", 42))
    size = args.size if args.size is not None \
        else int(vds.get("img_wh", [256, 256])[0])
    out_size = args.out_size if args.out_size is not None \
        else int(ycfg.get("resolution", [1024, 1024])[0])
    guidance = args.guidance if args.guidance is not None \
        else float(pvk.get("guidance_scale", 1.0))

    kw = {}
    if args.tiny:
        kw["unet"] = UNetMVConfig(block_out_channels=(32, 64, 64, 64),
                                  attention_heads=4, cross_attention_dim=32)
        kw["vae"] = VAEConfig(block_out_channels=(8, 8, 8, 8),
                              layers_per_block=1)
    cfg = mv.MVPipelineConfig(num_inference_steps=steps, image_size=size,
                              out_size=out_size,
                              eta=float(pvk.get("eta", 1.0)),
                              guidance_scale=guidance, **kw)
    if ckpt:
        pipe = mv.load_pretrained(cfg, ckpt, device)
    else:
        mesh.print_main(f"WARNING: no --ckpt given — running with random "
                        f"weights drawn from seed {seed}", file=sys.stderr)
        pipe = mv.MVPipeline.init_random(cfg, seed, device)
    written = mv.generate_uid(root, args.uid, pipe, seed=seed)
    mesh.print_main(json.dumps({"written": len(written)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
