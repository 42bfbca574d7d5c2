"""Shared sizes of the benchmark's CPU tests: the cells' configurations
and mixes cut to what a test run holds (the card runs them whole)."""
import os
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY_CONFIG = {"frame_size": 64, "batch_size": 4, "patch_size": 16,
               "filters": [4, 8, 8, 8, 8, 4], "resnet_blocks": 1}
TINY_MIX = {"distinct_frames": 4, "warmup_frames": 1, "checked_frames": 3,
            "warmup_steps": 1}
SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold


@pytest.fixture
def run_tiny():
    """A whole run of a cell on the CPU at the tiny sizes, the look for a
    card skipped: the result line as a dict."""
    import torch

    from benchmark import harness

    torch.set_num_threads(2)

    def run(cell, seed=SEED, seconds=0.3, **kw):
        return harness.run(ROOT, cell, seed, seconds, False,
                           time.perf_counter(), device="cpu",
                           config_overrides=TINY_CONFIG,
                           mix_overrides=TINY_MIX, **kw)
    return run
