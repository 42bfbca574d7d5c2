"""Stage-3 CLI — train the stage-1 style translator for one uid (PyTorch
port of ``drawingspinup_tpu/cli/train_stage1.py``: the same flags, plus
``--device`` and ``--seed``)."""
from __future__ import annotations

import argparse


def run(stage: int, argv=None, description: str = __doc__) -> int:
    """Parse the training flags and train ``stage``; shared by both
    training CLIs."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--uid", required=True)
    ap.add_argument("--root", default=None)
    ap.add_argument("--config", default=None,
                    help=f"reference-format config_stage{stage}.yaml "
                         "(default: packaged copy)")
    ap.add_argument("--no_mask", action="store_true")
    ap.add_argument("--no_pos", action="store_true")
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--allow-degraded-weights", action="store_true",
                    help="train even without real VGG19 perceptual "
                         "weights (random-feature loss); by default "
                         "production training FAILS without them")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from drawingspinup_torch.core import weights_policy
    from drawingspinup_torch.pipelines import stage3_translate as st
    from drawingspinup_torch.train import gan

    # strict for this run only: library calls after it stay permissive
    weights_policy.set_strict(not args.allow_degraded_weights)
    try:
        use_mask, use_pos = not args.no_mask, not args.no_pos
        cfg, extras = st.gan_config_from_yaml(
            args.config or st.DEFAULT_STAGE_CFGS[stage],
            use_mask=use_mask, use_pos=use_pos)
        gan.resolve_vgg_npz(cfg)  # fail fast in strict mode
        st.train_stage(args.root or extras["root_dir"], args.uid, stage,
                       use_mask=use_mask, use_pos=use_pos, seed=args.seed,
                       cfg=cfg, max_batches=args.max_batches,
                       device=args.device)
    finally:
        weights_policy.set_strict(False)
    return 0


def main(argv=None) -> int:
    return run(1, argv)


if __name__ == "__main__":
    raise SystemExit(main())
