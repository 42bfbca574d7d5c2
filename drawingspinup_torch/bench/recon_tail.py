"""The recon CLI's multi-uid tail, measured: ``recon_uid`` over two uids
in series and with each export tail (march, remesh, thinning,
``save_mesh``) on a one-worker thread beside the next uid's training, as
``cli/recon.py`` runs a uid list.

Two sphere uids at production widths (six 1024² views, the export at
mc512 with 50 000 faces, the second uid thinned), the yaml's training
with ``trainer.max_steps`` cut to ``--steps``. Turns alternate in pairs
(serial, overlapped; then overlapped, serial; ...), each on a fresh copy
of the inputs, so a drift of the host's clock falls on both modes alike.
Per turn: the wall seconds, each uid's tail seconds (``export_host``'s
start to ``save_mesh``'s end), how much of the first uid's tail ran
beside the second uid's ``recon_uid`` call, and each uid's ms a training
step (host clock). Every turn's OBJs must be byte-equal.

    python -m drawingspinup_torch.bench.recon_tail --steps 1000 --pairs 3 \\
        [--out result.json] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Sequence

UIDS = ("tail0", "tail1")
RADII = (0.45, 0.38)
SIZE = 1024                 # the views' size, as in production
MC, FACES = 512, 50000      # the export's grid and faces (the yaml's)


def recon_cfg(steps: int, overrides: Sequence[str] = ()):
    """(the yaml, its NSRConfig) of the recon CLI's default config with
    ``trainer.max_steps=steps`` and ``overrides``."""
    from drawingspinup_torch.cli import recon as recon_cli
    from drawingspinup_torch.core.config import load_config
    from drawingspinup_torch.pipelines import stage2_recon

    ycfg = load_config(recon_cli.DEFAULT_CFG,
                       [*overrides, f"trainer.max_steps={steps}"])
    return ycfg, stage2_recon.nsr_config_from_yaml(ycfg)


def write_inputs(root: str, uids: Sequence[str] = UIDS,
                 size: int = SIZE) -> None:
    """Each uid's drawing and six sphere views (radius ``RADII[i]``)."""
    from drawingspinup_torch.utils.synthetic import (
        write_drawing_uid, write_sphere_mv,
    )

    for uid, radius in zip(uids, RADII):
        write_drawing_uid(root, uid, size=size)
        write_sphere_mv(root, uid, size=size, radius=radius)


def copy_inputs(src: str, dst: str, uids: Sequence[str]) -> str:
    """``dst`` holding ``src``'s uids' drawings and views, no meshes."""
    for uid in uids:
        for part in ("char", "mv"):
            shutil.copytree(os.path.join(src, uid, part),
                            os.path.join(dst, uid, part))
    return dst


def run_turn(root: str, uids: Sequence[str], ycfg, cfg, device,
             overlapped: bool, *, mc: int = MC, faces: int = FACES,
             im_size: int = SIZE) -> Dict:
    """``recon_uid`` over ``uids`` (the last one thinned) in ``root``,
    with the tails on a one-worker thread when ``overlapped`` →
    {wall, step_ms, tail_s, hidden_s, futures, objs (bytes), paths}."""
    import torch

    from drawingspinup_torch.core import profiling
    from drawingspinup_torch.pipelines import stage2_export, stage2_recon
    from drawingspinup_torch.render import mesh_post

    spans: Dict[str, List[float]] = {"start": [], "end": []}
    export_host, save_mesh = stage2_export.export_host, mesh_post.save_mesh

    def host_start(*args, **kwargs):
        spans["start"].append(time.time())
        return export_host(*args, **kwargs)

    def save_end(path, *args, **kwargs):
        out = save_mesh(path, *args, **kwargs)
        spans["end"].append(time.time())
        return out

    cuda = torch.device(device).type == "cuda"
    executor = ThreadPoolExecutor(max_workers=1) if overlapped else None
    stage2_export.export_host, mesh_post.save_mesh = host_start, save_end
    try:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.time()
        outs, step_ms, calls = [], [], []
        for uid in uids:
            tc = time.time()
            steps0 = profiling.counters()["recon.step"]
            outs.append(stage2_recon.recon_uid(
                root, uid, cfg, device=device, tail_executor=executor,
                mc_resolution=mc, face_count=faces,
                thinning=uid == uids[-1], seed=ycfg.get("seed", 123456),
                im_size=im_size))
            calls.append((tc, time.time()))
            train = profiling.timings()["recon.train"]["last_s"]
            steps = profiling.counters()["recon.step"] - steps0
            step_ms.append(1e3 * train / max(steps, 1))
        paths = [o.result() if isinstance(o, Future) else o for o in outs]
        if cuda:
            torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        if executor is not None:
            executor.shutdown(wait=True)
        stage2_export.export_host, mesh_post.save_mesh = export_host, \
            save_mesh
    objs = []
    for p in paths:
        with open(p, "rb") as f:
            objs.append(f.read())
    (s1, *_), (e1, *_) = spans["start"], spans["end"]
    nxt = calls[1] if len(calls) > 1 else calls[0]
    return {"wall": wall, "step_ms": step_ms,
            "tail_s": [e - s for s, e in zip(spans["start"], spans["end"])],
            "hidden_s": max(0.0, min(e1, nxt[1]) - max(s1, nxt[0]))
            if len(calls) > 1 else 0.0,
            "futures": sum(isinstance(o, Future) for o in outs),
            "objs": objs, "paths": paths}


def measure(steps: int, pairs: int, device, work: str) -> Dict:
    """``pairs`` pairs of turns, alternating which mode goes first →
    each turn's numbers (OBJ bytes left out) and the per-pair saving."""
    src = os.path.join(work, "inputs")
    write_inputs(src)
    ycfg, cfg = recon_cfg(steps)
    turns = []
    for p in range(pairs):
        order = (False, True) if p % 2 == 0 else (True, False)
        pair = {}
        for overlapped in order:
            name = f"{'overlapped' if overlapped else 'serial'}_{p}"
            root = copy_inputs(src, os.path.join(work, name), UIDS)
            t = run_turn(root, UIDS, ycfg, cfg, device, overlapped)
            pair[overlapped] = t
            turns.append({"turn": name, **{k: v for k, v in t.items()
                                            if k not in ("objs", "paths")}})
            shutil.rmtree(root)
        if p == 0:
            objs = pair[False]["objs"]
        for t in pair.values():
            if t["objs"] != objs:
                raise AssertionError(f"pair {p}: the OBJs differ between "
                                     f"turns")
            if t["futures"] != (2 if t is pair[True] else 0):
                raise AssertionError(f"pair {p}: {t['futures']} futures")
    saved = [a["wall"] - b["wall"] for a, b in
             zip(turns[0::2], turns[1::2])]
    saved = [s if turns[2 * i]["turn"].startswith("serial") else -s
             for i, s in enumerate(saved)]
    return {"steps": steps, "pairs": pairs, "turns": turns,
            "saved_s": saved, "objs_equal": True}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as work:
        res = measure(args.steps, args.pairs, args.device, work)
    for t in res["turns"]:
        print(f"{t['turn']}: wall {t['wall']:.2f} s, tails "
              f"{', '.join(f'{s:.2f}' for s in t['tail_s'])} s, first tail "
              f"beside the second uid {t['hidden_s']:.2f} s, ms a step "
              f"{', '.join(f'{s:.2f}' for s in t['step_ms'])}")
    print(f"saved by the overlap, per pair (s): "
          f"{', '.join(f'{s:+.2f}' for s in res['saved_s'])}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({"steps": res["steps"], "saved_s": res["saved_s"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
