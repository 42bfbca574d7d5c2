"""Stage 1, contour removal: the port of
``drawingspinup_tpu/pipelines/stage1.py``.

Per uid, as the reference's ``1_lama_contour_remover/predict.py`` does:
``char/texture.png`` (RGBA, composited on white) + its alpha → the 4-channel
input → the FFC ResNet's contour probability → threshold 0.2 → inpaint
mask = contour ∪ background → Telea inpainting, radius 3 →
``char/ffc_resnet_inpainted.png`` (RGB + the input's alpha).

The forward runs batched on the model's device; thresholding and the
Telea fill (``native/inpaint.cc``) run on the host. As in JAX, the host
work of one batch overlaps the next batch's forward: batch k's forward is
enqueued with the copy of its probabilities into pinned host memory and an
event behind it, then batch k+1's forward, and only then does the host
wait on k's event and threshold, fill and write batch k. The JAX module's
padding of the last batch to a fixed size serves its one compiled program
and is not needed here.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from drawingspinup_torch.core import profiling
from drawingspinup_torch.core.config import Config
from drawingspinup_torch.core.contract import UidPaths
from drawingspinup_torch.core.io import read_image, write_image
from drawingspinup_torch.models.ffc import FFCResNetGenerator
from drawingspinup_torch.models.pix2pixhd import GlobalGenerator
from drawingspinup_torch.ops.image import resize
from drawingspinup_torch.ops.inpaint import telea_inpaint

CONTOUR_THRESHOLD = 0.2  # the reference's predict.py
INPAINT_RADIUS = 3       # the reference's predict.py

def build_generator(cfg: Optional[Config] = None
                    ) -> Union[FFCResNetGenerator, GlobalGenerator]:
    """The generator of a reference-style config's ``generator`` subtree,
    on the CPU in eval mode, by ``generator.kind`` as the reference's
    ``make_generator`` dispatches: ``ffc_resnet``
    (``configs/lama-fourier.yaml``) or ``pix2pixhd_global``
    (``configs/lama-regular.yaml``)."""
    g = (cfg or Config()).get("generator", Config())
    kind = g.get("kind", "ffc_resnet")
    if kind == "pix2pixhd_global":
        return GlobalGenerator(
            input_nc=g.get("input_nc", 4),
            output_nc=g.get("output_nc", 1),
            ngf=g.get("ngf", 64),
            n_downsampling=g.get("n_downsampling", 3),
            n_blocks=g.get("n_blocks", 9),
            conv_kind=g.get("conv_kind", "default"),
            out_act=g.get("add_out_act", "sigmoid"),
        ).eval()
    if kind != "ffc_resnet":
        raise ValueError(f"unsupported stage-1 generator kind: {kind!r}")
    init = g.get("init_conv_kwargs", {})
    down = g.get("downsample_conv_kwargs", {})
    return FFCResNetGenerator(
        input_nc=g.get("input_nc", 4),
        output_nc=g.get("output_nc", 1),
        ngf=g.get("ngf", 64),
        n_downsampling=g.get("n_downsampling", 3),
        n_blocks=g.get("n_blocks", 9),
        init_ratio_gin=init.get("ratio_gin", 0.0),
        init_ratio_gout=init.get("ratio_gout", 0.0),
        down_ratio_gin=down.get("ratio_gin", 0.0),
        down_ratio_gout=down.get("ratio_gout", 0.0),
        resnet_ratio=g.get("resnet_conv_kwargs", {}).get("ratio_gin", 0.75),
        enable_lfu=init.get("enable_lfu", False),
        add_out_act=g.get("add_out_act", "sigmoid"),
    ).eval()


def load_input(paths: UidPaths, size: int = 512
               ) -> Tuple[np.ndarray, np.ndarray]:
    """texture.png → (rgb on white, alpha mask), both (size, size, ·)
    float32 (the reference's InpaintingDrawingsDataset)."""
    img = read_image(paths.texture)
    if img.shape[-1] == 4:
        alpha = img[..., 3:4]
        rgb = img[..., :3] * alpha + (1.0 - alpha)
    else:
        rgb = img[..., :3]
        alpha = read_image(paths.mask)[..., :1]
    if rgb.shape[:2] != (size, size):
        rgb = resize(torch.from_numpy(rgb), (size, size)).numpy()
        alpha = resize(torch.from_numpy(alpha), (size, size)).numpy()
    return rgb.astype(np.float32), alpha.astype(np.float32)


def postprocess_one(rgb: np.ndarray, alpha: np.ndarray,
                    contour_prob: np.ndarray) -> np.ndarray:
    """Threshold, Telea inpaint and reattach alpha (host side): inpaint
    region = predicted contour (> 0.2) ∪ background (alpha < 0.5), the
    reference's ``np.maximum(predicted, 255 - alpha)``."""
    contour = contour_prob[..., 0] > CONTOUR_THRESHOLD
    background = alpha[..., 0] < 0.5
    inpaint_mask = (contour | background).astype(np.uint8)
    filled = telea_inpaint(rgb, inpaint_mask, radius=INPAINT_RADIUS)
    return np.concatenate([np.clip(filled, 0, 1), alpha], axis=-1)


@torch.inference_mode()
def dispatch_probs(model: torch.nn.Module, rgbs: np.ndarray,
                   alphas: np.ndarray
                   ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
    """Enqueue one forward of (B, H, W, 3) rgb and (B, H, W, 1) alpha on the
    model's device and the copy of its (B, H, W, 1) contour probabilities
    into pinned host memory; returns (the host tensor, the event recorded
    after the copy). On the CPU the forward has run when this returns and
    the event is None."""
    dev = next(model.parameters()).device
    x = torch.from_numpy(np.concatenate([rgbs, alphas], axis=-1))
    x = x.to(dev).permute(0, 3, 1, 2).contiguous()
    probs = model(x).permute(0, 2, 3, 1).float()
    if dev.type != "cuda":
        return probs, None
    host = torch.empty(probs.shape, dtype=probs.dtype, pin_memory=True)
    host.copy_(probs, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def collect_probs(flight: Tuple[torch.Tensor, Optional[torch.cuda.Event]]
                  ) -> np.ndarray:
    """Wait for ``dispatch_probs``'s copy and return the probabilities."""
    host, done = flight
    if done is not None:
        done.synchronize()
    return host.numpy()


def predict_uids(root: str, uids: Sequence[str], model: torch.nn.Module,
                 batch_size: int = 8, size: int = 512,
                 save_name: str = "ffc_resnet") -> List[str]:
    """Contour removal for a list of uids, ``batch_size`` drawings per
    forward; returns the written paths. Batch k+1's forward is enqueued
    before batch k is post-processed on the host. Spans: ``stage1.predict``
    around the call, ``stage1.post`` around a batch's host work (threshold,
    Telea, PNG write); counter ``stage1.drawing``, one a PNG written."""
    written: List[str] = []

    def drain(flight) -> None:
        items, pending = flight
        probs = collect_probs(pending)
        with profiling.span("stage1.post"):
            for (paths, rgb, alpha), prob in zip(items, probs):
                out_path = os.path.join(paths.char_dir,
                                        f"{save_name}_inpainted.png")
                write_image(out_path, postprocess_one(rgb, alpha, prob))
                written.append(out_path)
                profiling.count("stage1.drawing")

    with profiling.span("stage1.predict"):
        in_flight = None
        for i in range(0, len(uids), batch_size):
            batch = [UidPaths(root, uid) for uid in uids[i:i + batch_size]]
            items = [(paths, *load_input(paths, size)) for paths in batch]
            nxt = (items, dispatch_probs(
                model, np.stack([it[1] for it in items]),
                np.stack([it[2] for it in items])))
            if in_flight is not None:
                drain(in_flight)
            in_flight = nxt
        if in_flight is not None:
            drain(in_flight)
    return written
