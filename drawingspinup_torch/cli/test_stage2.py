"""Stage-3 CLI — run the trained stage-2 translator over all action frames
(PyTorch port of ``drawingspinup_tpu/cli/test_stage2.py``: the same flags,
plus ``--device``)."""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--uid", required=True)
    ap.add_argument("--root", default="../dataset/AnimatedDrawings/preprocessed")
    ap.add_argument("--no_mask", action="store_true")
    ap.add_argument("--no_pos", action="store_true")
    ap.add_argument("--model-id", type=int, default=99999)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    from drawingspinup_torch.pipelines import stage3_translate as st
    written = st.test_stage(args.root, args.uid, 2,
                            use_mask=not args.no_mask,
                            use_pos=not args.no_pos, model_id=args.model_id,
                            device=args.device)
    print(json.dumps({"written": len(written)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
