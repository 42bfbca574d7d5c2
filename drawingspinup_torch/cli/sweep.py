"""Full-pipeline batch CLI: drawing → GIF for every uid of a list, on the GPU.

``python -m drawingspinup_torch.cli.sweep --root <preprocessed> --uids
u.json [--stages stage1,mv,recon,render,train_style,gif] [--shard 0/4]
[--device cuda|cpu] [--allow-degraded-weights]``

Each stage runs the port's single-uid CLIs in process (``stage_functions``);
a failure is isolated to its uid and logged to ``<root>/sweep_log.jsonl``
(``pipelines/sweep.py``). The flags of ``drawingspinup_tpu/cli/sweep.py``,
plus ``--device``. ``--pin-chip k`` restricts the process to GPU ``k``
(``CUDA_VISIBLE_DEVICES``, set before CUDA initialises), for one sweep
process per GPU with ``--shard k/n``. ``--mode latency`` (every uid over
all local GPUs) is not ported: with more than one visible GPU it raises,
with one it runs the single-GPU path. JAX's prewarm thread and its
``TPU_*`` variables work around TPU program loads and have no counterpart.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, Sequence

from drawingspinup_torch.pipelines.sweep import STAGES


def stage_functions(root: str, device: str = "cuda", *,
                    predict_args: Sequence[str] = (),
                    recon_overrides: Sequence[str] = (),
                    train_args: Sequence[Sequence[str]] = ((), ()),
                    allow_degraded: bool = False
                    ) -> Dict[str, Callable[[str], None]]:
    """``{stage: fn(uid)}`` for every stage of ``STAGES``, each calling the
    port's CLIs on ``device``. ``predict_args`` go before the predict CLI's
    flags (its config path and overrides), ``recon_overrides`` after the
    recon CLI's, ``train_args[k]`` after the stage-(k+1) training CLI's."""
    dev = ["--device", str(device)]
    degraded = ["--allow-degraded-weights"] if allow_degraded else []

    def stage1(uid):
        from drawingspinup_torch.cli import predict
        predict.main([*predict_args, "--uid", uid, "--root", root, *dev])

    def mv(uid):
        from drawingspinup_torch.cli import mv as mv_cli
        mv_cli.main(["--uid", uid, "--root", root, *dev])

    def recon(uid):
        from drawingspinup_torch.cli import recon as recon_cli
        recon_cli.main(["--uid", uid, "--root", root, *dev, *recon_overrides])

    def render(uid):
        from drawingspinup_torch.cli import run_render
        args = ["--uid", uid, "--data_dir", root, *dev]
        run_render.main(args)
        run_render.main(args + ["--test"])

    def train_style(uid):
        from drawingspinup_torch.cli import train_stage1, train_stage2
        args = ["--uid", uid, "--root", root, *dev, *degraded]
        train_stage1.main(args + list(train_args[0]))
        train_stage2.main(args + list(train_args[1]))

    def test_style(uid):
        from drawingspinup_torch.cli import test_stage1, test_stage2
        args = ["--uid", uid, "--root", root, *dev]
        test_stage1.main(args)
        test_stage2.main(args)

    def gif(uid):
        from drawingspinup_torch.cli import gif_writer
        gif_writer.main(["--uid", uid, "--root", root])

    fns = {"stage1": stage1, "mv": mv, "recon": recon, "render": render,
           "train_style": train_style, "test_style": test_style, "gif": gif}
    return {s: fns[s] for s in STAGES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True)
    ap.add_argument("--uids", required=True)
    ap.add_argument("--stages",
                    default="stage1,mv,recon,render,train_style,gif")
    ap.add_argument("--shard", default="0/1", help="index/num_shards")
    ap.add_argument("--mode", choices=("throughput", "latency"),
                    default=None,
                    help="'throughput': one sweep process per GPU over a "
                         "shard of the uids (--pin-chip k --shard k/n); "
                         "'latency': every uid over all local GPUs (not "
                         "ported: raises with more than one visible GPU)")
    ap.add_argument("--pin-chip", type=int, default=None,
                    help="restrict this process to GPU k "
                         "(CUDA_VISIBLE_DEVICES, set before CUDA starts)")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--recon-overrides", nargs="*", default=[])
    ap.add_argument("--allow-degraded-weights", action="store_true",
                    help="run even when real pretrained weights (VGG19 "
                         "perceptual, ...) are missing; by default a "
                         "production sweep FAILS rather than silently "
                         "training with random features")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mode == "throughput" and args.pin_chip is None:
        ap.error("--mode throughput requires --pin-chip k (one sweep "
                 "process per GPU, --shard k/n)")
    if args.mode == "latency" and args.pin_chip is not None:
        ap.error("--mode latency uses all local GPUs per uid; drop "
                 "--pin-chip")
    if args.pin_chip is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = str(args.pin_chip)

    import torch

    from drawingspinup_torch.core import device as device_setup
    from drawingspinup_torch.core import weights_policy
    from drawingspinup_torch.pipelines import sweep as sweep_mod

    device = device_setup.setup(args.device)
    if args.mode == "latency" and device.type == "cuda" \
            and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"--mode latency over {torch.cuda.device_count()} GPUs: one uid "
            f"data-parallel across GPUs is not ported (ROADMAP.md queue 1, "
            f"multi-GPU); use --mode throughput --pin-chip k --shard k/n")
    stages = args.stages.split(",")
    unknown = sorted(set(stages) - set(STAGES))
    if unknown:
        ap.error(f"unknown stages {unknown}; choose from {', '.join(STAGES)}")

    weights_policy.set_strict(not args.allow_degraded_weights)
    try:
        if "train_style" in stages:
            from drawingspinup_torch.pipelines import stage3_translate as st
            from drawingspinup_torch.train import gan
            cfg, _ = st.gan_config_from_yaml(st.DEFAULT_STAGE_CFGS[1])
            gan.resolve_vgg_npz(cfg)  # fail fast in strict mode
        fns = stage_functions(args.root, str(device),
                              recon_overrides=args.recon_overrides,
                              allow_degraded=args.allow_degraded_weights)
        shard_index, num_shards = (int(x) for x in args.shard.split("/"))
        result = sweep_mod.run_sweep(args.root, args.uids,
                                     {s: fns[s] for s in stages},
                                     shard_index=shard_index,
                                     num_shards=num_shards,
                                     resume=not args.no_resume)
    finally:
        weights_policy.set_strict(False)
    print(json.dumps({k: len(v) for k, v in result.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
