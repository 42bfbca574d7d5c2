"""Stage-2b CLI: NSR reconstruction per uid on the GPU.

``python -m drawingspinup_torch.cli.recon --uid <uid> --root <root>
[--config path.yaml] [--device cuda|cpu] [key=value ...]``; with no
``--uid`` it runs the uid list in sequence. Under
``python -m torch.distributed.run --nproc-per-node N`` each uid trains
data-parallel over the N GPUs, one rank a GPU, and rank 0 writes. A uid
on the thinning list (``dataset.thinning_uid_list_file``) is exported
with its thin parts flattened (``export.thinning``,
``export.thinning_type``). The flags and overrides of
``drawingspinup_tpu/cli/recon.py``, without ``--prewarm``.

With more than one uid, each uid's export tail (march, remesh, thinning,
``save_mesh`` on the host) runs in a one-worker thread beside the next
uid's training, as JAX's CLI runs it; a tail that raises puts its uid
under ``failed`` and the others finish. The last line is
``{"written": [paths], "failed": [uids]}`` (``failed`` only when some
failed), and the exit code is 1 when any did. Under torchrun the list is
rank 0's, and every rank exits alike. A failure in training propagates.
"""
from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import Future, ThreadPoolExecutor

from drawingspinup_torch.core.config import Config, load_config
from drawingspinup_torch.core.contract import load_uid_list
from drawingspinup_torch.pipelines import stage2_recon

DEFAULT_CFG = os.path.join(os.path.dirname(__file__), "..", "configs",
                           "neus-ortho.yaml")


def main(argv=None) -> int:
    from drawingspinup_torch.parallel import mesh

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=DEFAULT_CFG)
    ap.add_argument("--uid", default=None)
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    device = mesh.entry_device(args.device)

    cfg = load_config(args.config, args.overrides)
    root = args.root or cfg.dataset.data_root
    thin_file = cfg.dataset.get("thinning_uid_list_file")
    thinning_uids = set(load_uid_list(thin_file)) \
        if thin_file and os.path.exists(thin_file) else set()
    uids = [args.uid] if args.uid else load_uid_list(cfg.dataset.uid_list_file)

    nsr_cfg = stage2_recon.nsr_config_from_yaml(cfg)
    exp = cfg.get("export", Config())
    geo = cfg.get("model", Config()).get("geometry", Config())
    iso = geo.get("isosurface", Config())
    # multi-uid: each uid's export tail runs beside the next uid's training
    # and fails alone
    executor = ThreadPoolExecutor(max_workers=1) if len(uids) > 1 else None
    outs = []
    try:
        for uid in uids:
            outs.append(stage2_recon.recon_uid(
                root, uid, nsr_cfg, device=device, tail_executor=executor,
                mc_resolution=iso.get("resolution", 512),
                face_count=geo.get("face_count", 50000),
                thinning=bool(exp.get("thinning", True))
                and uid in thinning_uids,
                thinning_type=exp.get("thinning_type", "double"),
                smoothing=exp.get("smoothing", True),
                shearing=exp.get("shearing", True),
                color_back_projection=exp.get("color_back_projection", True),
                ortho_scale=exp.get("ortho_scale", 1.35),
                front_cutting=geo.get("front_cutting", True),
                seed=cfg.get("seed", 123456),
                im_size=cfg.dataset.get("imSize", [1024, 1024])[0],
                export_uv=exp.get("export_uv", False)))
    finally:
        if executor is not None:
            executor.shutdown(wait=True)
    written, failed = [], []
    for uid, out in zip(uids, outs):
        if isinstance(out, Future):
            try:
                written.append(out.result())
            except Exception as e:          # per-uid isolation, as JAX's
                failed.append(uid)
                print(f"[recon {uid}] export tail FAILED: {e}")
        else:
            written.append(out)
    written, failed = mesh.broadcast((written, failed))     # rank 0's
    mesh.print_main(json.dumps({"written": written,
                                **({"failed": failed} if failed else {})}))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
