"""The ranks of ``tests/test_torch_parallel.py`` (and of
``tests/test_torch_mv_split.py`` and ``tests/test_torch_tp.py``): one
spawned process a rank, importing torch, the port and
``chip_smoke.forbid_writes`` (no JAX, so that a rank starts in seconds),
joined over gloo through a ``FileStore`` in the test's directory, with
one torch thread.

``run(task, rank, world, tmp)`` waits for the task's inputs at
``<tmp>/in_<task>.pt`` (the test starts the ranks first, so that they
import torch while it computes JAX's side, and then writes them), runs
``TASKS[kind]`` where ``kind`` is the task's name up to its first ``-``,
and writes what the rank saw to ``<tmp>/out_<task>_<rank>.pt``.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import os
import time
from typing import Any, Dict

import torch
import torch.distributed as dist

from chip_smoke import forbid_writes
from drawingspinup_torch.core import profiling
from drawingspinup_torch.parallel import mesh
from drawingspinup_torch.pipelines import sweep as sweep_mod
from drawingspinup_torch.train import gan, gan_parallel, nsr, nsr_parallel


def _named(params) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in nsr.named_leaves(params)}


def _nsr_state(inputs: Dict[str, Any], params=None) -> nsr.TrainState:
    return nsr.TrainState(
        copy.deepcopy(inputs["params"] if params is None else params),
        nsr.OptState(copy.deepcopy(inputs["mu"]),
                     copy.deepcopy(inputs["nu"]), inputs["count"]),
        inputs["step"])


def nsr_task(inputs: Dict[str, Any], rank: int, world: int) -> Dict:
    """One NSR dp step on this rank's draws; with ``ref_cfg``, also this
    rank's gradients of the same draws under that config (f32 compute on
    the tables as f32), averaged over the ranks."""
    cfg = inputs["cfg"]
    state = _nsr_state(inputs)
    step = nsr_parallel.make_train_step_dp(cfg, nsr.make_optimizer(cfg),
                                           world)
    draws = inputs["draws"][rank]
    assert draws.vi.shape[0] == step.rays_per_rank
    logs = step(state, inputs["data"], draws, n_active=inputs["n_active"])
    out = {"logs": {k: float(v) for k, v in logs.items()},
           "grads": {n: None if p.grad is None else p.grad.clone()
                     for n, p in nsr.named_leaves(state.params)},
           "params": _named(state.params),
           "mu": state.opt_state.mu, "nu": state.opt_state.nu,
           "count": state.opt_state.count}
    if inputs.get("ref_cfg") is not None:
        ref = copy.deepcopy(inputs["params"])
        ref["geometry"]["table"] = [
            x.detach().float().requires_grad_(True)
            for x in ref["geometry"]["table"]]
        rs = _nsr_state(inputs, ref)
        nsr.loss_and_grads(inputs["ref_cfg"], rs, inputs["data"], draws,
                           n_active=inputs["n_active"])
        mesh.all_mean_([p.grad for _, p in nsr.named_leaves(rs.params)])
        out["ref_grads"] = {n: None if p.grad is None else p.grad.clone()
                            for n, p in nsr.named_leaves(rs.params)}
    return out


def _gan_state(cfg: gan.GANConfig, dicts: Dict[str, Any]) -> gan.TrainState:
    state = gan.init_state(cfg, "cpu")
    for name in ("gen", "disc", "vgg"):
        getattr(state, name).load_state_dict(dicts[name])
    return state


def _gan_out(state: gan.TrainState, logs) -> Dict:
    return {"logs": {k: float(v) for k, v in logs.items()},
            "gen": {k: v.clone() for k, v in state.gen.state_dict().items()},
            "disc": {k: v.clone()
                     for k, v in state.disc.state_dict().items()},
            "exp_avg": {k: state.g_opt.state[p]["exp_avg"].clone()
                        for k, p in state.gen.named_parameters()}}


def gan_task(inputs: Dict[str, Any], rank: int, world: int) -> Dict:
    """One stage-3 dp step on this rank's patch batch."""
    cfg = inputs["cfg"]
    state = _gan_state(cfg, inputs["state"])
    step = gan_parallel.make_train_step_dp(cfg, world)
    batch = inputs["batches"][rank]
    assert batch["pre"].shape[0] == step.per_rank
    return _gan_out(state, step.on_batch(state, batch))


def world1_task(inputs: Dict[str, Any], rank: int, world: int) -> Dict:
    """At world size 1: two plain steps and two dp steps of each training
    from one state on the same draws → whether every parameter, moment,
    buffer and log is bit-identical."""
    same: Dict[str, bool] = {}
    cfg = inputs["nsr_cfg"]
    data = inputs["data"]
    runs = []
    for dp in (False, True):
        state = _nsr_state(inputs)
        opt = nsr.make_optimizer(cfg)
        fn = nsr_parallel.make_train_step_dp(cfg, opt, world) if dp \
            else functools.partial(nsr.train_step, cfg, opt)
        logs = [fn(state, data, d, n_active=inputs["n_active"])
                for d in inputs["draws"]]
        runs.append((_named(state.params), state.opt_state, logs))
    (p0, o0, l0), (p1, o1, l1) = runs
    same["nsr_params"] = all(torch.equal(p0[n], p1[n]) for n in p0)
    same["nsr_moments"] = all(torch.equal(o0.mu[n], o1.mu[n])
                              and torch.equal(o0.nu[n], o1.nu[n])
                              for n in o0.mu)
    same["nsr_logs"] = all(torch.equal(a[k], b[k])
                           for a, b in zip(l0, l1) for k in a)
    gcfg = inputs["gan_cfg"]
    runs = []
    for dp in (False, True):
        state = _gan_state(gcfg, inputs["gan_state"])
        fn = gan_parallel.make_train_step_dp(gcfg, world).on_batch if dp \
            else functools.partial(gan.train_step_on_batch, gcfg)
        logs = [fn(state, b) for b in inputs["batches"]]
        runs.append(_gan_out(state, logs[-1]))
    a, b = runs
    for part in ("gen", "disc", "exp_avg"):
        same[f"gan_{part}"] = all(torch.equal(a[part][k], b[part][k])
                                  for k in a[part])
    same["gan_logs"] = a["logs"] == b["logs"]
    return {"same": same}


def sweep_task(inputs: Dict[str, Any], rank: int, world: int) -> Dict:
    """``run_sweep`` of recon and train_style over the ranks through the
    stage CLIs, then the same sweep resumed and the recon CLI resumed; on
    ranks other than 0 every write under the root raises. The recon steps
    are the counter ``recon.step``'s, its losses every NSR step's."""
    from drawingspinup_torch.cli import recon as recon_cli
    from drawingspinup_torch.cli import sweep as sweep_cli

    root = inputs["root"]
    attempts = forbid_writes(root) if rank else []
    seen: Dict[str, Any] = {}
    losses = []

    def spy(module, name: str, key: str, index: int):
        fn = getattr(module, name)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            seen[key] = args[index]
            out = fn(*args, **kwargs)
            if key == "nsr":
                losses.append(tuple(float(out[k]) for k in
                                    ("loss", "loss_mask", "inv_s")))
            return out
        setattr(module, name, wrapped)

    spy(nsr, "train_step", "nsr", 2)
    spy(gan, "train_step_on_batch", "gan", 1)
    fns = sweep_cli.stage_functions(
        root, "cpu", recon_overrides=inputs["recon_overrides"],
        train_args=inputs["train_args"], allow_degraded=True)
    stages = {s: fns[s] for s in ("recon", "train_style")}
    steps = profiling.counters()["recon.step"]
    out: Dict[str, Any] = {"first": sweep_mod.run_sweep(
        root, inputs["uids"], stages)}
    out["recon_params"] = _named(seen["nsr"].params)
    out["recon_stats"] = {
        "steps": profiling.counters()["recon.step"] - steps,
        "world": mesh.world_size(), "log": list(losses)}
    gstate = seen["gan"]
    out["gan"] = {k: v.clone() for k, v in gstate.gen.state_dict().items()}
    out["gan"].update({f"disc.{k}": v.clone()
                       for k, v in gstate.disc.state_dict().items()})
    out["resumed_sweep"] = sweep_mod.run_sweep(root, inputs["uids"], stages)
    seen.clear()
    steps = profiling.counters()["recon.step"]
    recon_cli.main(["--uid", inputs["uid"], "--root", root, "--device",
                    "cpu", *inputs["recon_overrides"]])
    out["resumed_recon_steps"] = profiling.counters()["recon.step"] - steps
    out["resumed_recon_trained"] = "nsr" in seen
    out["attempts"] = attempts
    return out


def mv_task(inputs: Dict[str, Any], rank: int, world: int) -> Dict:
    """The stage-2a pipeline with the batch split over the ranks, on the
    weights and draws of ``inputs``: every rank's gathered latents and the
    images ``__call__`` returns (rank 0's, decoded). A config keyed
    ``(weights, ...)`` loads the UNet tensors ``unet_over[weights]`` over
    ``state``; a config computing in float64 gets its modules in
    float64."""
    from drawingspinup_torch.pipelines import stage2_mv

    out: Dict[str, Any] = {}
    for name, cfg in inputs["cfgs"].items():
        mods = stage2_mv.build_modules(cfg, "cpu")
        for mod, part in zip(mods, ("unet", "vae", "clip")):
            sd = inputs["state"][part]
            if part == "unet":
                sd = {**sd, **inputs["unet_over"].get(name[0], {})}
            mod.load_state_dict(sd, strict=True)
            if cfg.compute_dtype == "float64":
                mod.double()
        pipe = stage2_mv.MVPipeline(cfg, *mods)
        seen = []
        denoise = pipe.denoise

        def recorded(*args, **kwargs):
            seen.append(denoise(*args, **kwargs))
            return seen[-1]

        pipe.denoise = recorded
        images = pipe(inputs["image"], noises=inputs["noises"])
        out[name] = {"latents": seen[0], "images": images}
    return out


def tp_task(inputs: Dict[str, Any], rank: int, world: int) -> Dict:
    """Two steps of ``parallel/dryrun.py::ffc_tp_train_step`` on the
    ``(dp, tp)`` mesh of ``inputs`` for each case (generator kwargs, full
    float64 state, the global batch): the losses, the gathered state and
    Adam moments, the two zero-gradient biases after step 1, each conv's
    output channels in the first forward, this rank's parameter count and
    its replicated parameters, and step 1's collectives."""
    from drawingspinup_torch.models.ffc import FFCResNetGenerator
    from drawingspinup_torch.parallel import dryrun, tp
    from drawingspinup_torch.train.lama import make_optimizer

    m = mesh.make_mesh(inputs["dp"], inputs["tp"])
    out = {}
    for case in inputs["cases"]:
        model = FFCResNetGenerator(**case["kw"]).double()
        axes = tp.shard_params_tp(model, m)
        tp.load_full(model, case["state"], axes, m)
        opt = make_optimizer(model, dryrun.LR)
        x, y = (dryrun.dp_rows(case[k], m) for k in ("x", "y"))
        channels: Dict[str, int] = {}

        def record(name):
            def hook(mod, args, o):
                channels.setdefault(name, o.shape[1])
            return hook

        hooks = [mod.register_forward_hook(record(name))
                 for name, mod in model.named_modules()
                 if isinstance(mod, (torch.nn.Conv2d,
                                     torch.nn.ConvTranspose2d))]
        tp.reset_traffic()
        losses = [float(dryrun.ffc_tp_train_step(model, opt, x, y, m))]
        traffic = dict(tp.TRAFFIC)
        for h in hooks:
            h.remove()
        params = dict(model.named_parameters())
        bias1 = tp.gather_named({k: params[k] for k in case["zero_grad"]},
                                axes, m)
        losses.append(float(dryrun.ffc_tp_train_step(model, opt, x, y, m)))
        moments = {k: tp.gather_named(
            {n: opt.state[p][k] for n, p in params.items()}, axes, m)
            for k in ("exp_avg", "exp_avg_sq")}
        out[case["name"]] = {
            "losses": losses, "state": tp.gather_full(model, axes, m),
            "mu": moments["exp_avg"], "nu": moments["exp_avg_sq"],
            "bias1": bias1, "channels": channels, "traffic": traffic,
            "n_params": sum(p.numel() for p in params.values()),
            "replicated": {n: p.detach().clone() for n, p in params.items()
                           if axes[n] is None},
            "steps": [float(opt.state[p]["step"]) for p in params.values()]}
    return out


def mv_float64(patch, decoded: list) -> None:
    """Through ``patch`` (``setattr`` or a monkeypatch's): the mv CLI's
    seeded pipeline computing in float64 (the same weights, cast), and its
    ``decode_u8`` appending each float image, scaled to u8 steps before
    the floor (``x·255 + 0.5``), to ``decoded``."""
    from drawingspinup_torch.ops.image import resize
    from drawingspinup_torch.pipelines import stage2_mv

    init_random = stage2_mv.MVPipeline.init_random
    decode_u8 = stage2_mv.MVPipeline.decode_u8

    def init64(cfg, seed=0, device="cuda"):
        pipe = init_random(cfg, seed, device)
        return stage2_mv.MVPipeline(
            dataclasses.replace(cfg, compute_dtype="float64"),
            *(m.double() for m in (pipe.unet, pipe.vae, pipe.clip)))

    def recorded(self, latents):
        out = self.cfg.out_size
        img = torch.clamp(resize(self.decode(latents), (out, out)), 0.0, 1.0)
        decoded.append((img * 255.0 + 0.5).cpu().numpy())
        return decode_u8(self, latents)

    patch(stage2_mv.MVPipeline, "init_random", staticmethod(init64))
    patch(stage2_mv.MVPipeline, "decode_u8", recorded)


def mvcli_task(inputs: Dict[str, Any], rank: int, world: int) -> Dict:
    """The mv CLI over the ranks (in float64 with ``inputs["float64"]``:
    ``mv_float64``); on ranks other than 0 every write under the root
    raises. ``dp``: the ranks of the split; ``wrote``: the uids this rank
    wrote (its ``mv.write`` spans)."""
    from drawingspinup_torch.cli import mv as mv_cli
    from drawingspinup_torch.core.contract import VIEWS

    decoded: list = []
    if inputs.get("float64"):
        mv_float64(setattr, decoded)
    attempts = forbid_writes(inputs["root"]) if rank else []
    assert mv_cli.main(inputs["argv"]) == 0
    wrote = profiling.timings().get("mv.write", {}).get("count", 0)
    return {"attempts": attempts, "dp": mesh.mv_split(2 * len(VIEWS), world),
            "wrote": wrote, "decoded": decoded}


TASKS = {"nsr": nsr_task, "gan": gan_task, "world1": world1_task,
         "sweep": sweep_task, "mv": mv_task, "mvcli": mvcli_task,
         "tp": tp_task}


def run(task: str, rank: int, world: int, tmp: str,
        wait_s: float = 240.0) -> None:
    """Join the group, wait up to ``wait_s`` for the inputs (the test may
    write them after starting the ranks), run the task, save its output."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    mesh.init_dp("cpu", init_method=f"file://{tmp}/store_{task}")
    try:
        path = os.path.join(tmp, f"in_{task}.pt")
        end = time.time() + wait_s
        while not os.path.exists(path):
            if time.time() > end:
                raise TimeoutError(f"no inputs at {path}")
            time.sleep(0.05)
        inputs = torch.load(path, weights_only=False)
        out = TASKS[task.split("-")[0]](inputs, rank, world)
        torch.save(out, os.path.join(tmp, f"out_{task}_{rank}.pt"))
    finally:
        dist.destroy_process_group()
