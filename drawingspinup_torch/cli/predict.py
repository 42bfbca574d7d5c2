"""Stage-1 CLI: contour removal over a uid list, on the GPU.

``python -m drawingspinup_torch.cli.predict [config.yaml] [key=value ...]
[--uid <uid>] [--root <root>] [--batch-size 8] [--size 512]
[--device cuda|cpu] [--seed N]``: the flags and config knobs of
``drawingspinup_tpu/cli/predict.py`` (``indir``, ``uid_json``,
``generator.*``, ``pretrained.*``) plus ``--device`` and ``--seed``.

The generator is ``generator.kind``'s: LaMa's FFC ResNet
(``configs/lama-fourier.yaml``, the default) or pix2pixHD's
GlobalGenerator (``configs/lama-regular.yaml``).

Weights: ``pretrained.path`` (joined with ``pretrained.generator_checkpoint``
when set) names a torch ``.ckpt``/``.pth``/``.pt`` holding the generator's
``state_dict`` (under a ``state_dict`` key, or at the top level) with
upstream LaMa's names, as ``cli/train_lama.py`` writes it; it loads
strictly, its BN ``num_batches_tracked`` counters dropped. A directory (an
orbax checkpoint of the JAX package) raises: convert it with
``utils/jax_params.py::ffc_params`` (or ``pix2pixhd_params``) and
``torch.save``. With no checkpoint the weights are drawn from ``--seed``
(default: the config's ``seed``) by an explicit ``torch.Generator`` on the
CPU, so every device gets the same weights.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

from drawingspinup_torch.core.config import Config, load_config
from drawingspinup_torch.core.contract import load_uid_list
from drawingspinup_torch.models.ffc import BatchNorm2d
from drawingspinup_torch.pipelines import stage1

DEFAULT_CFG = os.path.join(os.path.dirname(__file__), "..", "configs",
                           "lama-fourier.yaml")


@torch.no_grad()
def seeded_init(model: torch.nn.Module, seed: int) -> None:
    """Normal conv and transposed-conv weights of std sqrt(2 / fan-in)
    (He), zero biases, identity batch norm, all drawn on the CPU from
    ``seed``."""
    g = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w[0].numel() if isinstance(m, torch.nn.Conv2d) \
                else w.shape[0] * w[0, 0].numel()
            w.copy_(torch.randn(w.shape, generator=g) * math.sqrt(2 / fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm2d):
            m.weight.fill_(1)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1)


def load_weights(model: torch.nn.Module, cfg: Config, seed: int) -> None:
    """The configured checkpoint into ``model`` (strict), or the seeded
    init when none is configured."""
    pre = cfg.get("pretrained", Config())
    path, name = pre.get("path"), pre.get("generator_checkpoint")
    path = os.path.join(path, name) if path and name else path
    if path and os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an orbax checkpoint of the "
                         "JAX package); convert it with "
                         "drawingspinup_torch.utils.jax_params.ffc_params (or "
                         "pix2pixhd_params) and torch.save")
    if path:
        state = torch.load(path, map_location="cpu")
        if isinstance(state, dict) and "state_dict" in state:
            state = state["state_dict"]
        model.load_state_dict(
            {k: v for k, v in state.items()
             if not k.endswith("num_batches_tracked")}, strict=True)
        return
    print(f"predict: no pretrained checkpoint configured; generator weights "
          f"drawn from seed {seed}", file=sys.stderr)
    seeded_init(model, seed)


def main(argv=None) -> int:
    from drawingspinup_torch.core import device as device_setup

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", nargs="?", default=DEFAULT_CFG)
    ap.add_argument("overrides", nargs="*", help="key.path=value overrides")
    ap.add_argument("--uid", default=None)
    ap.add_argument("--root", default=None, help="dataset root (indir)")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)
    device = device_setup.setup(args.device)

    cfg = load_config(args.config, args.overrides)
    root = args.root or cfg.get("indir")
    uids = [args.uid] if args.uid else load_uid_list(cfg.get("uid_json"))
    model = stage1.build_generator(cfg)
    load_weights(model, cfg,
                 cfg.get("seed", 0) if args.seed is None else args.seed)
    written = stage1.predict_uids(root, uids, model.to(device),
                                  batch_size=min(args.batch_size, len(uids)),
                                  size=args.size)
    print(json.dumps({"written": written}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
