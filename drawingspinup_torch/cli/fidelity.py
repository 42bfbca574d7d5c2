"""Per-stage fidelity report: one tree of per-uid outputs against another
(counterpart of ``drawingspinup_tpu/cli/fidelity.py``)::

    python -m drawingspinup_torch.cli.fidelity --ours A --theirs B \\
        --uid U [--vgg-npz vgg19_features.npz] [--out report.json] \\
        [--device cuda|cpu]

Compares every stage boundary of the per-uid contract that exists on both
sides — char/*.png, mv/{color,normal,mask}/*, blender_render/<action>/
res_stage*/*, the recon mesh OBJs (symmetric chamfer + nearest-neighbour
vertex-colour MSE) and the GIFs (frame-by-frame PSNR/SSIM) — and prints
the JSON report of JAX's CLI: per-file metrics, per-stage aggregates, and
``degraded_weights`` when the perceptual distance ran on random VGG
features. The VGG runs on ``--device`` (``cuda`` unless the caller asks
for the CPU); PSNR, SSIM, the chamfer and the GIF metrics run on the host.
``--vgg-npz`` (or ``$DSU_VGG19_NPZ``) gives the perceptual distance real
VGG19 weights.
"""
from __future__ import annotations

import argparse
import json
import math
import os

STAGE_METRICS = ("psnr", "ssim", "perceptual")


def _stage_dirs(root: str, uid: str):
    """(stage name, directory) pairs of the per-uid contract."""
    from drawingspinup_torch.core.contract import UidPaths
    p = UidPaths(root, uid)
    pairs = [("stage1_char", p.char_dir)]
    for sub in ("color", "normal", "mask"):
        pairs.append((f"stage2a_mv_{sub}", os.path.join(p.mv_dir, sub)))
    render = p.render_dir
    if os.path.isdir(render):
        for action in sorted(os.listdir(render)):
            adir = os.path.join(render, action)
            if not os.path.isdir(adir):
                continue
            for res in sorted(os.listdir(adir)):
                if res.startswith("res_stage"):
                    pairs.append((f"stage3_{action}_{res}",
                                  os.path.join(adir, res)))
    return pairs


def _same_named(dir_a: str, dir_b: str, ext: str, compare) -> dict:
    """``compare(a, b)`` for every ``ext`` file of ``dir_a``; a file
    missing from ``dir_b`` is reported as missing."""
    out = {}
    for name in sorted(os.listdir(dir_a)):
        if not name.endswith(ext):
            continue
        pb = os.path.join(dir_b, name)
        out[name] = (compare(os.path.join(dir_a, name), pb)
                     if os.path.exists(pb) else {"missing": True})
    return out


def sanitize(o):
    """inf/nan → strings: bare Infinity is not RFC JSON, and the
    exact-match case (PSNR = inf) is this tool's headline success."""
    if isinstance(o, dict):
        return {k: sanitize(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [sanitize(v) for v in o]
    if isinstance(o, float) and not math.isfinite(o):
        return "inf" if o > 0 else ("-inf" if o < 0 else "nan")
    return o


def build_report(ours: str, theirs: str, uid: str, device="cuda",
                 vgg_npz=None) -> dict:
    """The report of ``main`` as a dict (inf and nan not yet sanitised)."""
    from drawingspinup_torch.core import weights_policy
    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.utils.quality import (
        compare_gif, compare_mesh, compare_stage_outputs,
    )

    report = {}
    for stage, ours_dir in _stage_dirs(ours, uid):
        theirs_dir = ours_dir.replace(ours, theirs, 1)
        if not (os.path.isdir(ours_dir) and os.path.isdir(theirs_dir)):
            continue
        files = compare_stage_outputs(ours_dir, theirs_dir, vgg_npz, device)
        scored = [v for v in files.values() if "psnr" in v]
        agg = {}
        if scored:
            agg = {k: sum(v[k] for v in scored) / len(scored)
                   for k in STAGE_METRICS}
        report[stage] = {"files": files, "aggregate": agg,
                         "n": len(scored)}

    ours_p, theirs_p = UidPaths(ours, uid), UidPaths(theirs, uid)
    if os.path.isdir(ours_p.mesh_dir) and os.path.isdir(theirs_p.mesh_dir):
        meshes = _same_named(ours_p.mesh_dir, theirs_p.mesh_dir, ".obj",
                             compare_mesh)
        if meshes:
            report["stage2b_mesh"] = {"files": meshes}

    def gif(a, b):
        r = compare_gif(a, b)
        del r["frames"]      # keep the report compact; aggregate stays
        return r

    if os.path.isdir(ours_p.gif_dir) and os.path.isdir(theirs_p.gif_dir):
        gifs = _same_named(ours_p.gif_dir, theirs_p.gif_dir, ".gif", gif)
        if gifs:
            report["gif"] = {"files": gifs}

    # degraded-weights modes hit in this process (e.g. the random-VGG
    # perceptual distance): the report's honesty marker
    if weights_policy.degradations():
        report["degraded_weights"] = weights_policy.degradations()
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ours", required=True)
    ap.add_argument("--theirs", required=True)
    ap.add_argument("--uid", required=True)
    ap.add_argument("--vgg-npz", default=None,
                    help="real VGG19 weights (scripts/export_vgg19_npz.py) "
                         "for the perceptual metric; random features "
                         "otherwise (relative comparisons only)")
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from drawingspinup_torch.core.device import setup
    device = setup(args.device)
    report = build_report(args.ours, args.theirs, args.uid, device,
                          args.vgg_npz)
    text = json.dumps(sanitize(report), indent=2, default=float)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
