"""Plain PyTorch stage-3 training: the keyframe pair's features and valid
midpoints from the raw u8 images, the seeded patch draw, one GAN step (a D
update, then a G update against the updated D) and optax's ``adamw`` (every
leaf decays, moments move for a leaf without a gradient too), in float32.

Written for the benchmark from the published trainer (DrawingSpinUp,
``3_style_translator``) with the step the port states in
``drawingspinup_torch/train/gan.py`` and ``pipelines/stage3_data.py`` at
commit 87d0b89; imports nothing of the port.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import models

LOSS_NAMES = ("d_loss", "g_loss", "image_loss", "perception_loss",
              "adversarial_loss")
BUFFERS = ("running_mean", "running_var")


def _rot(x: torch.Tensor) -> torch.Tensor:
    """90° clockwise (numpy's ``rot90(k=-1)``) of an (H, W, ...) image."""
    return torch.rot90(x, k=-1, dims=(0, 1))


def _cat_rotated(rgba: torch.Tensor) -> torch.Tensor:
    """[image | the image over its rotated copy], side by side."""
    rot = _rot(rgba)
    a1, a2 = rgba[..., 3:4], rot[..., 3:4]
    rgb = a1 * rgba[..., :3] + a2 * rot[..., :3] * (1 - a1)
    over = torch.cat([rgb, a1 + a2 * (1 - a1)], dim=-1)
    return torch.cat([rgba, over], dim=1)


def _rgba(u8: torch.Tensor) -> torch.Tensor:
    """u8 (H, W, 3|4) → f32 RGBA in [0, 1], opaque where there is no
    alpha."""
    f = u8.to(torch.float32) / 255.0
    if f.shape[-1] == 3:
        f = torch.cat([f, torch.ones_like(f[..., :1])], dim=-1)
    return f


def keyframe(images: Dict[str, torch.Tensor], cfg: Dict) -> Dict:
    """The training pair from the keyframe's u8 images on the device
    (``color`` RGBA, ``pos`` RGB, ``post`` RGBA, ``edge`` gray where the
    configuration uses edges): input features, target, mask and the valid
    midpoints (the mask dilated by a 7×7 max, in row-major order)."""
    pre = _rgba(images["color"])
    mask = pre[..., 3].clone()
    post = _rgba(images["post"]).clone()
    post[..., 3] = mask
    pos = _rgba(images["pos"])
    if cfg["use_edge"]:
        edge = images["edge"].to(torch.float32) / 255.0
        em = (edge[..., 0] if edge.dim() == 3 else edge) < 1.0
        pre = pre.clone()
        pre[em, 0:3] = 0.0
        pre[em, 3] = 1.0
        pre = _cat_rotated(pre)
        mask = torch.cat([mask, torch.maximum(mask, _rot(mask))], dim=1)
        post = _cat_rotated(post)
        pos = _cat_rotated(pos)
    post_rgb = post[..., :3] * post[..., 3:4] + (1.0 - post[..., 3:4])
    feats = [pre[..., :3] * 2.0 - 1.0]
    if cfg["use_mask"]:
        feats.append(mask[..., None])
    if cfg["use_pos"]:
        feats.append(pos[..., 0:2] * 2.0 - 1.0)
    valid = F.max_pool2d(mask[None, None], 7, 1, 3)[0, 0] > 0
    yx = torch.nonzero(valid)
    if len(yx) == 0:
        yx = torch.zeros((1, 2), dtype=torch.int64, device=mask.device)
    return {"pre": torch.cat(feats, dim=-1), "post": post_rgb * 2.0 - 1.0,
            "mask": mask, "valid_yx": yx}


def _cut(img: torch.Tensor, mids: torch.Tensor, size: int) -> torch.Tensor:
    """size × size windows of (H, W, C) ``img`` with their rows and columns
    from ``mid − size//2``, zero outside the image."""
    h, w = img.shape[0], img.shape[1]
    out = img.new_zeros((len(mids), size, size, img.shape[2]))
    for b, (y, x) in enumerate(mids.tolist()):
        y0, x0 = y - size // 2, x - size // 2
        ys, xs = max(y0, 0), max(x0, 0)
        ye, xe = min(y0 + size, h), min(x0 + size, w)
        out[b, ys - y0:ye - y0, xs - x0:xe - x0] = img[ys:ye, xs:xe]
    return out


def patches(data: Dict, gen: torch.Generator, batch: int,
            size: int) -> Dict[str, torch.Tensor]:
    """Two index draws from ``gen`` (midpoints for the pair, and for the
    discriminator's real patch), then the windows."""
    yx, n = data["valid_yx"], len(data["valid_yx"])
    i1 = torch.randint(0, n, (batch,), generator=gen, device=yx.device)
    i2 = torch.randint(0, n, (batch,), generator=gen, device=yx.device)
    mids, mids_r = yx[i1], yx[i2]
    mask3 = data["mask"][..., None]
    return {"pre": _cut(data["pre"], mids, size),
            "post": _cut(data["post"], mids, size),
            "pre_mask": _cut(mask3, mids, size),
            "already": _cut(data["post"], mids_r, size),
            "already_mask": _cut(mask3, mids_r, size)}


class AdamW:
    """optax ``adamw``: eps 1e-8, decoupled decay of every leaf."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: Dict):
        self.lr, self.wd = cfg["lr"], cfg["weight_decay"]
        self.b1, self.b2 = cfg["betas"]
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
                self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
                upd = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + 1e-8)
                p.copy_(p * (1 - self.lr * self.wd) - self.lr * upd)


def _leaves(weights: Dict[str, torch.Tensor]):
    """(trainable leaves as fresh tensors that take a gradient, buffers)."""
    params, buffers = {}, {}
    for k, v in weights.items():
        t = v.detach().clone().to(torch.float32)
        if k.rsplit(".", 1)[-1] in BUFFERS:
            buffers[k] = t
        else:
            params[k] = t.requires_grad_(True)
    return params, buffers


def _grads(loss: torch.Tensor, params: Dict[str, torch.Tensor]
           ) -> Dict[str, torch.Tensor]:
    keys = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in keys],
                             allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g
            for k, g in zip(keys, gs)}


def train_steps(weights: Dict[str, Dict[str, torch.Tensor]], data: Dict,
                cfg: Dict, patch_seed: int, steps: int
                ) -> Tuple[List[Dict[str, float]], Dict[str, torch.Tensor],
                           Dict[str, torch.Tensor]]:
    """``steps`` GAN steps from ``weights`` ({"gen", "disc", "vgg"}) on
    patches drawn from a generator seeded ``patch_seed`` on the data's
    device. Returns each step's losses, the first step's gradient of every
    G and D leaf (keys "gen.<name>", "disc.<name>"), and every leaf after
    the last step."""
    models.plain_f32()
    dev = data["pre"].device
    gen_p, gen_b = _leaves(weights["gen"])
    disc_p, _ = _leaves(weights["disc"])
    vgg_p = {k: v.to(torch.float32) for k, v in weights["vgg"].items()}
    g_opt, d_opt = AdamW(gen_p, cfg), AdamW(disc_p, cfg)
    rng = torch.Generator(device=dev).manual_seed(patch_seed)
    losses, first = [], {}
    for s in range(steps):
        b = patches(data, rng, cfg["batch_size"], cfg["patch_size"])
        fake = models.generator({**gen_p, **gen_b}, b["pre"], cfg, True)
        fl = models.discriminator(disc_p, fake.detach() * b["pre_mask"], cfg)
        tl = models.discriminator(disc_p, b["already"] * b["already_mask"],
                                  cfg)
        d_loss = fl.square().mean() + (tl - 1.0).square().mean()
        d_grads = _grads(d_loss, disc_p)
        d_opt.step(disc_p, d_grads)

        disc_fixed = {k: v.detach() for k, v in disc_p.items()}
        image_loss = (fake - b["post"]).abs().mean()
        f_fake = models.vgg_taps(vgg_p, fake)
        with torch.no_grad():
            f_real = models.vgg_taps(vgg_p, b["post"])
        sq = sum((a - r).square().sum() for a, r in zip(f_fake, f_real))
        perception_loss = sq / sum(a.numel() for a in f_fake)
        fl = models.discriminator(disc_fixed, fake * b["pre_mask"], cfg)
        adversarial_loss = (fl - 1.0).square().mean()
        g_loss = (cfg["reconstruction_weight"] * image_loss
                  + cfg["perception_weight"] * perception_loss
                  + cfg["adversarial_weight"] * adversarial_loss)
        g_grads = _grads(g_loss, gen_p)
        g_opt.step(gen_p, g_grads)
        losses.append({k: float(v.detach()) for k, v in zip(LOSS_NAMES, (
            d_loss, g_loss, image_loss, perception_loss,
            adversarial_loss))})
        if s == 0:
            first = {**{f"gen.{k}": v for k, v in g_grads.items()},
                     **{f"disc.{k}": v for k, v in d_grads.items()}}
    after = {**{f"gen.{k}": v.detach() for k, v in gen_p.items()},
             **{f"disc.{k}": v.detach() for k, v in disc_p.items()}}
    return losses, first, after
