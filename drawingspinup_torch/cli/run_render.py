"""Stage-3 render CLI: the colour, position and edge passes of a rigged
uid, on the GPU.

``python -m drawingspinup_torch.cli.run_render --uid <uid> --data_dir <root>
[--test] [--device cuda|cpu]``: the flags of
``drawingspinup_tpu/cli/run_render.py`` plus ``--device``. Train mode
renders ``rest_pose``; test mode renders every other FBX under
``<uid>/mesh/fbx_files`` (``rest_rotate`` when there is none). Each action
goes to ``<uid>/mesh/blender_render/<action>/{color,pos,edge}/NNNN.png``;
jumping, zombie and rest_rotate turn the character 30° about the vertical
axis, as the reference's blender_animation.py does.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time

YAW_ACTIONS = {"jumping", "zombie", "rest_rotate"}
YAW_DEG = 30.0


def main(argv=None) -> int:
    from drawingspinup_torch.core import device as device_setup
    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.render.animation import render_animation

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_dir",
                    default="../dataset/AnimatedDrawings/preprocessed")
    ap.add_argument("--uid", required=True)
    ap.add_argument("--test", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_setup.setup(args.device)

    paths = UidPaths(args.data_dir, args.uid)
    meshes = sorted(glob.glob(os.path.join(paths.mesh_dir, "*.obj")))
    if not meshes:
        raise FileNotFoundError(f"no reconstructed OBJ under "
                                f"{paths.mesh_dir}")
    if not args.test:
        actions = ["rest_pose"]
    else:
        actions = [f[:-4] for f in sorted(os.listdir(paths.fbx_dir))
                   if f.endswith(".fbx") and f != "rest_pose.fbx"]
        actions = actions or ["rest_rotate"]

    stats = {}
    for action in actions:
        fbx_name = "rest_pose.fbx" if action in ("rest_pose", "rest_rotate") \
            else f"{action}.fbx"
        yaw = YAW_DEG if action in YAW_ACTIONS else 0.0
        t0 = time.time()
        info = render_animation(os.path.join(paths.fbx_dir, fbx_name),
                                meshes[0], paths.action_dir(action),
                                yaw_deg=yaw, device=device)
        n = max(info["frames"], 1)
        parts = ", ".join(f"{k} {v / n:.4f}"
                          for k, v in info["seconds"].items())
        print(f"{action}: {info['frames']} frames at {info['size']}px, "
              f"{(time.time() - t0) / n:.4f} s/frame ({parts} s/frame)")
        stats[action] = info
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
