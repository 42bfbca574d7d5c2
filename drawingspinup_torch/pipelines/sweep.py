"""Batch sweep: drawing → GIF for every uid of a list (counterpart of
``drawingspinup_tpu/pipelines/sweep.py``).

Per-uid stage chains with continue-on-error (a failed stage logs its
traceback and skips that uid's remaining stages; the other uids go on), a
JSONL run log (``sweep_log.jsonl`` under the root: one record per stage
run, with its seconds and the degraded-weights components, one ``FAILED``
record per failure, one ``done`` record per finished uid), resume (a stage
whose outputs exist is skipped) and sharding of the uid list
(``shard_index/num_shards``, one process per GPU).

JAX's retry of a stage after a transient device error (``_transient``)
works around a remote TPU worker that restarts under load; a CUDA device
has no such worker, so a stage that fails is logged and not retried.
"""
from __future__ import annotations

import functools
import os
import time
import traceback
from typing import Callable, Dict, List, Optional

from drawingspinup_torch.core import weights_policy
from drawingspinup_torch.core.contract import UidPaths, load_uid_list
from drawingspinup_torch.core.metrics import MetricsLogger
from drawingspinup_torch.parallel import mesh

STAGES = ("stage1", "mv", "recon", "render", "train_style", "test_style",
          "gif")
# the stages that run on every rank in latency mode: the data-parallel
# trainings, and stage 2a's batch split (JAX's ``_mv_batch_sharding``)
DP_STAGES = ("mv", "recon", "train_style")


def _final_checkpoint(log_dir: str) -> str:
    from drawingspinup_torch.pipelines.stage3_translate import FINAL_STEP
    from drawingspinup_torch.train.gan import checkpoint_path
    return checkpoint_path(log_dir, FINAL_STEP)


def stage_done(paths: UidPaths, stage: str) -> bool:
    """Whether ``stage``'s outputs for the uid exist (JAX's rule; a
    finished style training is the port's own final checkpoint,
    ``model_99999.pt``)."""
    if stage == "stage1":
        return os.path.exists(paths.inpainted)
    if stage == "mv":
        return os.path.exists(paths.mv("color", "front"))
    if stage == "recon":
        return os.path.isdir(paths.mesh_dir) and any(
            f.endswith(".obj") for f in os.listdir(paths.mesh_dir))
    if stage == "render":
        return os.path.isdir(os.path.join(paths.render_dir, "rest_pose"))
    if stage == "train_style":
        if not os.path.isdir(paths.mesh_dir):
            return False
        done = set()
        for d in os.listdir(paths.mesh_dir):
            for k in (1, 2):
                if d.startswith(f"logs_stage{k}") and os.path.exists(
                        _final_checkpoint(os.path.join(paths.mesh_dir, d))):
                    done.add(k)
        return done == {1, 2}
    if stage == "test_style":
        # every action dir carries a non-empty res_stage* output dir
        if not os.path.isdir(paths.render_dir):
            return False
        actions = [d for d in os.listdir(paths.render_dir)
                   if os.path.isdir(os.path.join(paths.render_dir, d))]
        if not actions:
            return False
        for a in actions:
            adir = os.path.join(paths.render_dir, a)
            res = [d for d in os.listdir(adir) if d.startswith("res_stage")
                   and os.listdir(os.path.join(adir, d))]
            if not res:
                return False
        return True
    if stage == "gif":
        return os.path.isdir(paths.gif_dir) and bool(os.listdir(paths.gif_dir))
    return False


def run_sweep(root: str, uid_json: str,
              stage_fns: Dict[str, Callable[[str], None]],
              shard_index: int = 0, num_shards: int = 1,
              resume: bool = True,
              log_path: Optional[str] = None,
              stage_major: bool = True) -> Dict[str, List[str]]:
    """Run the per-uid stage functions ``{stage: fn(uid)}``, in their
    order, over a shard of the uid list → {"ok": uids, "failed": uids}.

    ``stage_major`` runs every uid through a stage before the next stage
    (the reference's CLI order, and JAX's default); otherwise each uid runs
    its whole chain before the next uid.

    In a process group of more than one rank (``--mode latency`` under
    torchrun) every rank calls this alike: the ``DP_STAGES`` run on every
    rank (their trainings are data-parallel), the other stages on rank 0
    while the others wait. Rank 0 decides what is done and keeps the log;
    a stage that failed on any rank fails the uid on every rank. A fault
    that only one rank meets inside a data-parallel step leaves the others
    in its all-reduce until the process group's timeout."""
    uids = load_uid_list(uid_json)[shard_index::num_shards]
    logger = MetricsLogger(log_path or os.path.join(
        root, "sweep_log.jsonl")) if mesh.is_main() else None
    skip: Dict[str, str] = {}          # uid -> failed stage
    t_uid = {uid: 0.0 for uid in uids}

    def log(**record) -> None:
        if logger is not None:
            logger.log(**record)

    def run_one(uid: str, stage: str, fn) -> None:
        if resume and mesh.broadcast(stage_done(UidPaths(root, uid), stage)):
            return
        st = time.time()
        error, trace = None, ""
        try:
            if stage in DP_STAGES:
                fn(uid)
            else:
                mesh.on_main(functools.partial(fn, uid))
        except Exception as e:
            error, trace = e, traceback.format_exc()[-2000:]
        if mesh.any_rank(error is not None):
            skip[uid] = stage
            msg = str(error) if error is not None else "failed on a rank"
            log(uid=uid, stage="FAILED", error=msg, traceback=trace)
            mesh.print_main(f"[sweep] {uid} FAILED at {stage}: {msg}")
            return
        degraded = sorted({d["component"]
                           for d in weights_policy.degradations()})
        extra = {"degraded_weights": degraded} if degraded else {}
        log(uid=uid, stage=stage, seconds=time.time() - st, **extra)
        t_uid[uid] += time.time() - st

    if stage_major:
        for stage, fn in stage_fns.items():
            for uid in uids:
                if uid not in skip:
                    run_one(uid, stage, fn)
            mesh.print_main(f"[sweep {shard_index}/{num_shards}] stage "
                            f"{stage} done ({len(skip)} failed)")
    else:
        for i, uid in enumerate(uids):
            for stage, fn in stage_fns.items():
                if uid in skip:
                    break
                run_one(uid, stage, fn)
            mesh.print_main(f"[sweep {shard_index}/{num_shards}] "
                            f"{i + 1}/{len(uids)} done ({len(skip)} failed)")

    ok = [u for u in uids if u not in skip]
    for uid in ok:
        log(uid=uid, stage="done", seconds=t_uid[uid])
    return {"ok": ok, "failed": [u for u in uids if u in skip]}
