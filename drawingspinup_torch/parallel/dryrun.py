"""The multi-GPU dry run (counterpart of ``__graft_entry__.py``).

``dryrun_multichip(n)`` runs, on each of the n ranks of the process group,
the four parts of JAX's ``dryrun_multichip`` at its shapes and with its
assertions, and prints one ``dryrun_multichip[...] ... ok`` line a part on
rank 0:

  * the FFC generator's training step over a ``(dp, tp)`` mesh (tp 2 when
    n is even, else 1): the batch over ``dp``, every output-feature axis
    that JAX's rule shards over ``tp`` (``parallel/tp.py``); the loss
    falls over two steps;
  * NSR ray-dp through ``train/nsr_parallel.py::production_train_step``;
  * stage 2a's batch split through ``pipelines/stage2_mv.py`` (more than
    one rank takes a share);
  * GAN patch-dp through ``train/gan_parallel.py::production_train_step``.

``entry(device)`` is the full-width generator and a 512² zero input.

Run it on the card with one rank a GPU (NCCL)::

    torchrun --nproc-per-node N -m drawingspinup_torch.parallel.dryrun

or with N ranks spawned here over gloo, e.g. on the CPU::

    python -m drawingspinup_torch.parallel.dryrun --ranks 2 --device cpu

(``--device cuda:0 --backend gloo`` puts every spawned rank on one card.)
A world size that does not fit raises; the backend is the one asked for
or the device's (NCCL for CUDA, gloo for the CPU), never another.
"""
from __future__ import annotations

import argparse
import math
import multiprocessing
import os
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from drawingspinup_torch.models.ffc import (
    ConcatTupleLayer, FFCBnAct, FFCResnetBlock, FFCResNetGenerator,
)
from drawingspinup_torch.parallel import mesh as mesh_mod
from drawingspinup_torch.parallel import tp as tp_mod
from drawingspinup_torch.parallel.mesh import Mesh

JOIN_S = 600            # a spawned rank still running then fails the run
DRYRUN_FFC = dict(ngf=16, n_downsampling=2, n_blocks=2, resnet_ratio=0.75,
                  enable_lfu=False)
LR = 1e-3


def seeded_generator(seed: int = 0, **kwargs) -> FFCResNetGenerator:
    """An FFC generator (LaMa's full width unless ``kwargs`` say otherwise)
    with flax's initialisers drawn from ``seed`` on the CPU."""
    from drawingspinup_torch.train.lama import init_weights

    model = FFCResNetGenerator(**kwargs)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model


def entry(device="cuda") -> Tuple[FFCResNetGenerator, torch.Tensor]:
    """The full-width generator (lama-fourier: ngf 64, 9 blocks), seeded,
    in eval mode, and a (1, 4, 512, 512) zero input, on ``device``."""
    model = seeded_generator().to(device).eval()
    return model, torch.zeros(1, 4, 512, 512, device=device)


def dryrun_loss(out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The dry run's mean of ``-(y·log(out + 1e-6) + (1 − y)·log(1 − out +
    1e-6))``."""
    eps = 1e-6
    return torch.mean(-(y * torch.log(out + eps)
                        + (1 - y) * torch.log(1 - out + eps)))


def ffc_tp_train_step(model: FFCResNetGenerator, opt: torch.optim.Optimizer,
                      x: torch.Tensor, y: torch.Tensor,
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One train-mode step of the dry run's loss on this rank's rows ``x``
    (N, 4, H, W), ``y`` (N, 1, H, W) → the loss of the global batch. Over
    ``dp`` every gradient is averaged, sharded and replicated ones alike (a
    replicated gradient is the same on every tp rank and is not summed
    over ``tp``); then ``opt`` (``train/lama.py::make_optimizer``: optax's
    adam) updates this rank's shards. Without a mesh, or at one dp rank, it
    is the plain step."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = dryrun_loss(model(x), y)
    loss.backward()
    loss = loss.detach().clone()
    if mesh is not None and mesh.dp > 1:
        mesh_mod.all_mean_([p.grad for p in model.parameters()],
                           group=mesh.dp_group)
        mesh_mod.all_mean_([loss], group=mesh.dp_group)
    opt.step()
    return loss


def dp_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the global batch's rows."""
    n = t.shape[0] // mesh.dp
    return t[mesh.dp_index * n:(mesh.dp_index + 1) * n]


def predicted_traffic(model: FFCResNetGenerator, batch: int, size: int,
                      tp: int, dp: int = 1, element_bytes: int = 4
                      ) -> Dict[str, int]:
    """Each rank's collectives of one ``ffc_tp_train_step`` (forward and
    backward, as ``tp.TRAFFIC`` counts them: a gather the bytes of the
    gathered tensor, an all-reduce those of the reduced one), from the
    generator's widths, this rank's ``batch`` rows of ``size``² and the
    mesh: the prediction the traffic counted in a run is held to. Covers
    the generator without the local Fourier unit and ``out_ffc``."""
    layers = list(model.model)
    if any(isinstance(m, FFCBnAct) and m.ffc.in_widths[1] for m in layers) \
            or any(getattr(m, "enable_lfu", False)
                   or getattr(m, "inline", False) for m in model.modules()):
        raise NotImplementedError("a generator with a global stream before "
                                  "its blocks, the local Fourier unit or "
                                  "out_ffc")
    out = {"gathers": 0, "gather_bytes": 0, "all_reduces": 0,
           "all_reduce_bytes": 0}

    def event(kind: str, *shape: int) -> None:
        out[kind + "s"] += 1
        out[kind + "_bytes"] += math.prod(shape) * element_bytes

    def sharded(width: int) -> bool:
        return tp > 1 and tp_mod.shards(width, tp)

    def bn(width: int) -> None:
        """A batch norm's sums over the global batch, forward and back."""
        if dp > 1:
            own = width // tp if sharded(width) else width
            event("all_reduce", 2, own)
            event("all_reduce", 2, own)

    def feed(width: int, is_sharded: bool, outs: Sequence[int], h: int,
             w: int, grad: bool = True) -> None:
        """A stream of ``width`` channels into layers of widths ``outs``:
        gathered if sharded, its gradient all-reduced if a layer is."""
        if is_sharded:
            event("gather", batch, width, h, w)
        if grad and any(sharded(o) for o in outs):
            event("all_reduce", batch, width, h, w)

    h = size
    stream = [(layers[1].ffc.in_widths[0], False)]
    for i, layer in enumerate(layers):
        if isinstance(layer, FFCBnAct):             # the stem, the downs
            (cin, is_sh), = stream
            widths = [c for c in layer.out_widths if c]
            feed(cin, is_sh, widths, h, h, grad=i > 1)  # not the input's
            h //= layer.ffc.convl2l.stride[0]
            stream = [(c, sharded(c)) for c in widths]
            for c in widths:
                bn(c)
        elif isinstance(layer, FFCResnetBlock):
            for conv in (layer.conv1, layer.conv2):
                cl, cg = conv.ffc.in_widths
                half = conv.ffc.convg2g.conv2.in_channels
                wf = h // 2 + 1
                feed(cl, sharded(cl), [cl, cg], h, h)
                feed(cg, sharded(cg), [cl, half], h, h)
                bn(half)
                feed(2 * half, sharded(half), [2 * half], h, wf)
                bn(2 * half)
                cut = sharded(2 * half) and (2 * half // tp) % 2 == 1
                if cut:                             # a pair across ranks
                    event("gather", batch, 2 * half, h, wf)
                fu_sharded = sharded(2 * half) and not cut
                if fu_sharded != sharded(half):     # the add's scatter
                    event("gather", batch, half, h, h)
                feed(half, sharded(half) or fu_sharded, [cg], h, h)
                bn(cl)
                bn(cg)
            stream = [(c, sharded(c)) for c in layer.out_widths]
        elif isinstance(layer, ConcatTupleLayer):
            for c, is_sh in stream:
                if is_sh:
                    event("gather", batch, c, h, h)
            stream = [(sum(c for c, _ in stream), False)]
        elif isinstance(layer, torch.nn.ConvTranspose2d):
            (cin, is_sh), = stream
            feed(cin, is_sh, [layer.out_channels], h, h)
            h *= 2
            stream = [(layer.out_channels, sharded(layer.out_channels))]
            bn(layer.out_channels)
        elif isinstance(layer, torch.nn.Conv2d):    # the head
            (cin, is_sh), = stream
            feed(cin, is_sh, [layer.out_channels], h, h)
            if sharded(layer.out_channels):
                event("gather", batch, layer.out_channels, h, h)
    return out


def _ffc_part(device, world: int) -> None:
    from drawingspinup_torch.train.lama import make_optimizer

    tp = 2 if world % 2 == 0 else 1
    mesh = mesh_mod.make_mesh(world // tp, tp)
    model = seeded_generator(**DRYRUN_FFC).to(device)
    batch = 2 * mesh.dp
    x = np.random.default_rng(0).random((batch, 32, 32, 4)).astype(
        np.float32)
    y = (np.random.default_rng(1).random((batch, 32, 32, 1)) > 0.5
         ).astype(np.float32)
    x, y = (dp_rows(torch.from_numpy(a).permute(0, 3, 1, 2).to(device), mesh)
            for a in (x, y))
    tp_mod.shard_params_tp(model, mesh)
    opt = make_optimizer(model, LR)
    loss = float(ffc_tp_train_step(model, opt, x, y, mesh))
    assert np.isfinite(loss), f"non-finite loss {loss}"
    loss2 = float(ffc_tp_train_step(model, opt, x, y, mesh))
    assert loss2 < loss, f"ffc dp×tp loss did not decrease: {loss}→{loss2}"
    mesh_mod.print_main(
        f"dryrun_multichip[ffc dp×tp]: mesh={{'dp': {mesh.dp}, 'tp': "
        f"{mesh.tp}}} loss={loss:.4f}→{loss2:.4f} ok", flush=True)


def _nsr_part(device, world: int) -> None:
    from drawingspinup_torch.models.fields import (
        MLPConfig, RadianceConfig, SDFFieldConfig,
    )
    from drawingspinup_torch.models.hashgrid import HashGridConfig
    from drawingspinup_torch.train import nsr, nsr_parallel
    from drawingspinup_torch.utils.synthetic import sphere_dataset

    cfg = nsr.NSRConfig(
        sdf=SDFFieldConfig(
            grid=HashGridConfig(n_levels=4, log2_hashmap_size=12,
                                base_resolution=4, per_level_scale=1.5,
                                start_level=4, update_steps=100),
            mlp=MLPConfig(n_neurons=32, n_hidden_layers=1, sphere_init=True,
                          weight_norm=True)),
        radiance=RadianceConfig(mlp=MLPConfig(n_neurons=32,
                                              n_hidden_layers=1,
                                              output_activation="sigmoid")),
        train_num_rays=16 * world, n_coarse=16, n_fine=16,
        n_random_pts=64, max_steps=10, constant_steps=4, cos_anneal_end=10)
    data = sphere_dataset(n_views=2, size=16, radius=0.3, hull=True,
                          scene_radius=cfg.radius, device=device)
    opt = nsr.make_optimizer(cfg)
    state = nsr.init_state(cfg, 3, device)
    step = nsr_parallel.production_train_step(cfg, opt)
    gen = torch.Generator(device=device).manual_seed(mesh_mod.rank_seed(4))
    v, h, w = data["masks"].shape

    def one() -> float:
        draws = nsr.make_draws(step.draw_cfg, v, h, w, gen, device)
        return float(step(state, data, draws)["loss"])

    loss = one()
    assert np.isfinite(loss), f"non-finite NSR loss {loss}"
    t0 = time.perf_counter()
    later = [one() for _ in range(3)]
    dt = time.perf_counter() - t0
    assert min(later) < loss, \
        f"nsr ray-dp loss did not decrease: {loss} → {later}"
    mesh_mod.print_main(
        f"dryrun_multichip[nsr ray-dp production]: mesh={{'dp': {world}, "
        f"'tp': 1}} loss={loss:.4f}→{later[-1]:.4f} dp{world} "
        f"{3 / dt:.1f} steps/s ok", flush=True)


def _mv_part(device, world: int) -> None:
    from drawingspinup_torch.models.unet_mv2d import UNetMVConfig
    from drawingspinup_torch.pipelines import stage2_mv as mv

    cfg = mv.MVPipelineConfig(
        unet=UNetMVConfig(block_out_channels=(32, 64, 64, 64),
                          attention_heads=4, cross_attention_dim=32),
        num_inference_steps=2, image_size=64, out_size=64)
    pipe = mv.MVPipeline.init_random(cfg, 5, device)
    img = np.random.default_rng(6).random((64, 64, 3)).astype(np.float32)
    normals, colors = pipe(img)
    assert normals.shape[0] == 6 and colors.shape[0] == 6
    assert np.isfinite(normals).all() and np.isfinite(colors).all()
    dp = mesh_mod.mv_split(2 * len(normals), world)
    mesh_mod.print_main(f"dryrun_multichip[mv batch-dp]: dp={dp} "
                        f"out={tuple(normals.shape)} ok", flush=True)
    assert dp > 1, "mv sampling did not shard the batch"


def _gan_part(device, world: int) -> None:
    from drawingspinup_torch.pipelines.stage3_data import KeyframeData
    from drawingspinup_torch.train import gan, gan_parallel

    cfg = gan.GANConfig(generator="GeneratorJ", input_channels=3,
                        batch_size=2 * world, patch_size=16)
    rng = np.random.default_rng(7)
    size = 64

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    data = KeyframeData(
        pre=dev(rng.random((size, size, 3))),
        post=dev(rng.random((size, size, 3))),
        mask=dev(rng.random((size, size)) > 0.3),
        valid_yx=dev(rng.integers(8, size - 8, (64, 2)), torch.int64),
        n_valid=64)
    state = gan.init_state(cfg, device, 8)
    step = gan_parallel.production_train_step(cfg)
    gen = torch.Generator(device=device).manual_seed(mesh_mod.rank_seed(9))
    g_loss = float(step(state, data, gen)["g_loss"])
    assert np.isfinite(g_loss), f"non-finite GAN loss {g_loss}"
    later = [float(step(state, data, gen)["g_loss"]) for _ in range(3)]
    assert min(later) < g_loss, \
        f"gan patch-dp g_loss did not decrease: {g_loss} → {later}"
    mesh_mod.print_main(
        f"dryrun_multichip[gan patch-dp]: mesh={{'dp': {world}, 'tp': 1}} "
        f"g_loss={g_loss:.4f}→{later[-1]:.4f} ok", flush=True)


def dryrun_multichip(n: int, device=None) -> None:
    """The dry run's four parts on this rank of a process group of ``n``
    ranks (joined by the caller); ``device``: this rank's (default
    ``cuda:{LOCAL_RANK}``). Raises when the group has another size."""
    if mesh_mod.world_size() != n:
        raise ValueError(f"dryrun_multichip({n}) in a process group of "
                         f"{mesh_mod.world_size()} ranks")
    device = torch.device(device or f"cuda:{os.environ.get('LOCAL_RANK', 0)}")
    for part in (_ffc_part, _nsr_part, _mv_part, _gan_part):
        part(device, n)


def _rank(rank: int, world: int, store: str, device: str,
          backend: Optional[str]) -> None:
    """A spawned rank: join the group through the file store, run."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    _, _, dev = mesh_mod.init_dp(device, backend=backend,
                                 init_method=f"file://{store}")
    try:
        dryrun_multichip(world, dev)
    finally:
        dist.destroy_process_group()


def spawn(ranks: int, device: str, backend: Optional[str]) -> int:
    """Run the dry run on ``ranks`` spawned processes → 0, or 1 when a
    rank failed or was still running after JOIN_S seconds."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank, args=(r, ranks, store, device,
                                                 backend))
                 for r in range(ranks)]
        for p in procs:
            p.start()
        end = time.time() + JOIN_S
        for p in procs:
            p.join(max(end - time.time(), 0))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if hung or codes != [0] * ranks:
        print(f"dryrun: rank exit codes {codes}"
              f"{' (killed after the timeout)' if hung else ''}",
              file=sys.stderr)
        return 1
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m drawingspinup_torch.parallel.dryrun",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="spawn this many ranks here (default: the ranks "
                         "torchrun started)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (one card a rank), cuda:<i> (every rank on "
                         "that card) or cpu")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: NCCL for CUDA, gloo for the CPU")
    args = ap.parse_args(argv)
    if args.ranks is not None:
        return spawn(args.ranks, args.device, args.backend)
    _, world, dev = mesh_mod.init_dp(args.device, backend=args.backend)
    try:
        dryrun_multichip(world, dev)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
