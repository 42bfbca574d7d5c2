"""The stage-2a cell cut to what a CPU test holds (the card runs it whole):
a 32-wide UNet of the published layout at 8² latents, a narrow VAE, the
port's small CLIP encoder for narrow UNets, 4 DDIM steps, 3 drawings. The
UNet computes in f32 here: at this width, with the benchmark's selective
attention (``mv_inputs.QK_SPREAD``), bf16 moves the noise by 10-40 %, where
at the published widths it moves it by 1-3 %."""
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "wonder3d_mv.uid"
with open(os.path.join(ROOT, "benchmark", "configs",
                       "wonder3d_mv.json")) as _f:
    _PUBLISHED = json.load(_f)
TINY_CONFIG = {
    "unet": {**_PUBLISHED["unet"], "block_out_channels": [32, 32, 32, 32],
             "attention_heads": 2, "cross_attention_dim": 32},
    "vae": {**_PUBLISHED["vae"], "block_out_channels": [64, 64, 64, 64],
            "layers_per_block": 1},
    "clip": {"image_size": 32, "patch_size": 8, "hidden_size": 64,
             "num_layers": 2, "num_heads": 4, "mlp_ratio": 4,
             "projection_dim": 32},
    "image_size": 64, "out_size": 96, "num_inference_steps": 4,
    "compute_dtype": "float32"}
TINY_MIX = {"distinct_drawings": 3, "checked_steps": 3}
