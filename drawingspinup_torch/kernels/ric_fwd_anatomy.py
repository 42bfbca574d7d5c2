"""Where the RIC forward kernel's time goes on the card.

Builds ``csrc/ric_conv_fwd_gemm.cu`` four ways: whole, without the tap
sampling (``RIC_FWD_NO_SAMPLING``), without the tensor-core products
(``RIC_FWD_NO_PRODUCTS``) and without both, and times each at the RIC
layer shapes of a 512² GeneratorJ_RIC forward (device time: each call
queued behind a sleep kernel, median of 20). Without a part the outputs are
wrong; only the times are read. What is left without both parts is the
skeleton: the tap weights and halo copies, the B copies and the stage
hand-offs. Needs a CUDA device; run from the root of a checkout:

    python -m drawingspinup_torch.kernels.ric_fwd_anatomy
"""
from __future__ import annotations

import statistics
import subprocess

import torch

from drawingspinup_torch.kernels import _build
from drawingspinup_torch.kernels import ric_conv as rk
from drawingspinup_torch.models.ric_tables import ric_shifted_weights

# (H = W, C, O, launches per 512² GeneratorJ_RIC forward)
SHAPES = ((512, 6, 32, 1), (256, 32, 64, 1), (128, 64, 128, 1),
          (128, 128, 128, 14), (256, 256, 128, 1), (512, 192, 128, 1),
          (512, 166, 64, 1), (512, 64, 64, 1))
VARIANTS = {"whole": (), "no sampling": ("RIC_FWD_NO_SAMPLING",),
            "no products": ("RIC_FWD_NO_PRODUCTS",),
            "skeleton": ("RIC_FWD_NO_SAMPLING", "RIC_FWD_NO_PRODUCTS")}


def build(name: str, macros) -> object:
    from torch.utils.cpp_extension import load

    tag = name.replace(" ", "_")
    out = _build.BUILD_DIR.parent / "torch_kernels_anatomy" / tag
    out.mkdir(parents=True, exist_ok=True)
    return load(name=f"dsu_fwd_anatomy_{tag}",
                sources=[str(s) for s in _build.SOURCES],
                build_directory=str(out), extra_cflags=["-O2"],
                extra_cuda_cflags=["-O3", "-std=c++17",
                                   "-gencode=arch=compute_90a,code=sm_90a"]
                + [f"-D{m}" for m in macros], verbose=False)


def device_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ric_fwd_anatomy: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    inputs = []
    for k, (hw, c, o, _) in enumerate(SHAPES):
        g = torch.Generator(device="cuda").manual_seed(k)
        x = torch.randn((1, hw, hw, c), generator=g, device="cuda")
        wk = torch.randn((9, c, o), generator=g, device="cuda")
        swf = torch.from_numpy(ric_shifted_weights(hw, hw).copy()).cuda()
        inputs.append((x, wk, swf))
    rows = {}
    for name, macros in VARIANTS.items():
        _build._ext = build(name, macros)
        rows[name] = [device_ms(lambda a=a: rk.ric_conv_fwd(*a))
                      for a in inputs]
    _build._ext = None
    print(f"RIC forward, device ms per call and per 512² frame [{card}]")
    print("(H,C,O) x launches".ljust(26)
          + "".join(n.rjust(13) for n in VARIANTS))
    for i, (hw, c, o, n) in enumerate(SHAPES):
        print(f"({hw},{c},{o}) x{n}".ljust(26)
              + "".join(f"{rows[v][i]:13.4f}" for v in VARIANTS))
    print("frame".ljust(26) + "".join(
        f"{sum(s[3] * t for s, t in zip(SHAPES, rows[v])):13.3f}"
        for v in VARIANTS))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
