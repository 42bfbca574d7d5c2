"""Stage-1 training CLI: train the FFC ResNet contour remover on rendered
BiCar data, on the GPU (the port of ``drawingspinup_tpu/cli/train_lama.py``).

``python -m drawingspinup_torch.cli.train_lama --data-root <root>
--uid-json <uids.json> [--out experiments/lama] [--steps 3600]
[--batch-size 8] [--size 512] [--adversarial-weight 0.0]
[--render <obj_root>] [--render-limit N] [--device cuda|cpu] [--seed 0]``

``--render`` first renders the training data (``rgba.png`` and six
``contour_<k>.png`` per uid) from ``<obj_root>/<uid>/model.obj`` or
``<obj_root>/<uid>.obj`` (``render/bicar.py``). Training runs
``train/lama.py`` at ``LamaTrainConfig``'s widths on ``--size`` crops of
``--size · 572 / 512`` loads; ``--seed`` draws the initial weights and the
data (both 0 by default, as in JAX). ``--adversarial-weight > 0`` raises
(``train/lama.py``). The generator's ``state_dict`` (upstream LaMa's
names) is written to ``<out>/step_<steps>.pt``, which ``cli/predict.py``
loads as ``pretrained.path``. The losses are printed every 100 steps, the
data and step times (``core/profiling.py``) at the end, on stderr.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    import torch

    from drawingspinup_torch.core import checkpoint as ckpt
    from drawingspinup_torch.core import device as device_setup
    from drawingspinup_torch.core import profiling
    from drawingspinup_torch.pipelines.stage1_data import BiCarDataset
    from drawingspinup_torch.train import lama

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-root", required=True,
                    help="rendered BiCar data root (rgba + contour pngs)")
    ap.add_argument("--uid-json", required=True)
    ap.add_argument("--out", default="experiments/lama")
    ap.add_argument("--steps", type=int, default=3600)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--adversarial-weight", type=float, default=0.0)
    ap.add_argument("--render", default=None,
                    help="OBJ model root: render training data first")
    ap.add_argument("--render-limit", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = device_setup.setup(args.device)

    if args.render:
        from drawingspinup_torch.render.bicar import batch_render
        with profiling.span("train_lama/render"):
            done = batch_render(args.render, args.data_root, args.uid_json,
                                limit=args.render_limit)
        print(f"rendered {len(done)} objects", file=sys.stderr)

    cfg = lama.LamaTrainConfig(batch_size=args.batch_size, steps=args.steps,
                               adversarial_weight=args.adversarial_weight)
    ds = BiCarDataset(args.data_root, args.uid_json, "train",
                      seed=args.seed, crop_size=args.size,
                      load_size=int(args.size * 572 / 512))
    state = lama.init_state(cfg, torch.Generator().manual_seed(args.seed),
                            size=args.size, device=device)
    batches = ds.batches(cfg.batch_size)
    for step in range(cfg.steps):
        with profiling.span("train_lama/data"):
            batch = next(batches)
        with profiling.span("train_lama/step", sync=True):
            state, logs = lama.train_step(cfg, state, batch)
        if step % 100 == 0:
            print(f"step {step}: g={float(logs['g_loss']):.4f} "
                  f"bce={float(logs['bce']):.4f}", file=sys.stderr)
    out = os.path.join(args.out, f"step_{cfg.steps}{ckpt.SUFFIX}")
    ckpt.save(out, state.generator.state_dict())
    print(profiling.report("train_lama/"), file=sys.stderr)
    print(json.dumps({"saved": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
