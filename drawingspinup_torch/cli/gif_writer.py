"""Final CLI — assemble stylized frames into looping GIFs per action
(copy of ``drawingspinup_tpu/cli/gif_writer.py`` on the port's IO:
res_stage2_* preferred, res_stage1_* otherwise; 30 ms/frame, disposal 2)."""
from __future__ import annotations

import argparse
import json
import os


def _result_dir(action_dir: str):
    names = sorted(os.listdir(action_dir), reverse=True)
    for prefix in ("res_stage2", "res_stage1"):
        for cand in names:
            if cand.startswith(prefix):
                return cand
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--uid", required=True)
    ap.add_argument("--root", default="../dataset/AnimatedDrawings/preprocessed")
    ap.add_argument("--duration-ms", type=int, default=30)
    args = ap.parse_args(argv)

    from drawingspinup_torch.core.contract import UidPaths, list_actions
    from drawingspinup_torch.core.io import read_image, write_gif

    paths = UidPaths(args.root, args.uid)
    written = []
    for action in list_actions(paths):
        action_dir = paths.action_dir(action)
        res = _result_dir(action_dir)
        if res is None:
            continue
        frame_dir = os.path.join(action_dir, res)
        frames = [read_image(os.path.join(frame_dir, f))
                  for f in sorted(os.listdir(frame_dir))
                  if f.endswith(".png")]
        if not frames:
            continue
        out = []
        for fr in frames:       # composite on white for the GIF
            if fr.shape[-1] == 4:
                a = fr[..., 3:4]
                fr = fr[..., :3] * a + (1 - a)
            out.append(fr)
        gif_path = paths.gif(action)
        write_gif(gif_path, out, duration_ms=args.duration_ms)
        written.append(gif_path)
    print(json.dumps({"written": written}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
