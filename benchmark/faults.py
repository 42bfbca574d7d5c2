"""Faults planted in the program's timed path, each a context manager that
patches one function of the port while it is open. The benchmark's own
runs plant none; ``readings.py`` reads them on the card and
``benchmark/tests/test_bench_control.py`` shows that each makes ``correct``
false:

- ``unchanged_state``: a training step that leaves the models and the
  optimizers as they were (its losses still computed);
- ``half_batch``: half of each patch batch left out, the step's means
  taken over the rest;
- ``altered_answer``: each served frame's RGB moved by one pixel where it
  is produced.
"""
from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(module, name: str, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def unchanged_state():
    from drawingspinup_torch.train import gan

    def make(orig):
        def step(cfg, state, batch, reduce=None):
            opts = (state.g_opt, state.d_opt)
            for o in opts:
                o.step = lambda *a, **k: None
            try:
                return orig(cfg, state, batch, reduce)
            finally:
                for o in opts:
                    del o.step
        return step
    return _patched(gan, "train_step_on_batch", make)


def half_batch():
    from drawingspinup_torch.train import gan

    def make(orig):
        def sample(data, generator, batch, size):
            out = orig(data, generator, batch, size)
            return {k: v[:batch // 2] for k, v in out.items()}
        return sample
    return _patched(gan, "sample_patches", make)


def altered_answer():
    from drawingspinup_torch.train import gan

    def make(orig):
        def generate(model, x_u8, *args):
            out = orig(model, x_u8, *args)
            out[..., :3] = np.roll(out[..., :3], 1, axis=1)
            return out
        return generate
    return _patched(gan, "generate_full_rgba", make)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
