"""Stage 2a's UNet call as a CUDA graph on the card (``pipelines/
stage2_mv.py::unet_noise``), on the ``mv`` CLI's tiny pipeline: replayed
denoise loops against eager ones, the tensors handed to the DDIM update,
the counters a uid, the attention cores' device time under a profiler, and
a weight changed in place.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_mv_graph_cuda.py

The eager reference is the same pipeline's loop with ``EAGER_CALLS`` set
past its steps, so that no call is captured: the same operations in the
same order, compared bit for bit."""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from drawingspinup_torch.core import profiling
from drawingspinup_torch.models.unet_mv2d import UNetMVConfig
from drawingspinup_torch.models.vae import VAEConfig
from drawingspinup_torch.ops import diffusion
from drawingspinup_torch.pipelines import stage2_mv as mv

STEPS = 6
CORES = 48                  # attention cores a call: 16 blocks × 3 folds
TINY = mv.MVPipelineConfig(
    unet=UNetMVConfig(block_out_channels=(32, 64, 64, 64),
                      attention_heads=4, cross_attention_dim=32),
    vae=VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1),
    image_size=64, out_size=64, num_inference_steps=STEPS)
COUNTED = ("mv.unet.call", "mv.attn.views", "mv.attn.domains",
           "mv.attn.cross", "mv.attn.launch")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    profiling.reset()
    mv._GRAPHS.clear()
    yield torch.device("cuda")
    mv._GRAPHS.clear()
    profiling.reset()


def _pipe(device, dtype="bfloat16"):
    return mv.MVPipeline.init_random(
        dataclasses.replace(TINY, compute_dtype=dtype), 5, device)


def _drawing(device):
    g = torch.Generator(device=device).manual_seed(1)
    return torch.rand((TINY.image_size, TINY.image_size, 3), generator=g,
                      device=device)


def _denoise(pipe, encoded, seed=3):
    return pipe.denoise(*encoded, generator=torch.Generator(
        device=pipe.device).manual_seed(seed))


def _eager(pipe, encoded, monkeypatch, seed=3):
    """The loop with every call eager; the graphs it warmed dropped."""
    with monkeypatch.context() as m:
        m.setattr(mv, "EAGER_CALLS", 10 ** 9)
        out = _denoise(pipe, encoded, seed)
    mv._GRAPHS.clear()
    return out


def _moved(before):
    c = profiling.counters()
    return {k: c[k] - before[k] for k in set(c) | set(before)
            if c[k] != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_replayed_denoise_equals_eager(cuda_device, dtype, monkeypatch):
    """A loop of two eager calls, a capture and replays, then a loop of
    replays alone: both bit-equal to the eager loop from the same
    generator, and not a trivial one."""
    pipe = _pipe(cuda_device, dtype)
    encoded = pipe.encode_image(_drawing(cuda_device))
    want = _eager(pipe, encoded, monkeypatch)
    first = _denoise(pipe, encoded)
    second = _denoise(pipe, encoded)
    c = profiling.counters()
    assert (c["mv.unet.graph.capture"], c["mv.unet.graph.replay"]) \
        == (1, 2 * STEPS - mv.EAGER_CALLS)
    assert torch.isfinite(want).all() and float(want.std()) > 0.1
    assert torch.equal(first, want) and torch.equal(second, want)
    other = _denoise(pipe, encoded, seed=4)
    assert not torch.equal(other, want)
    assert torch.equal(other, _eager(pipe, encoded, monkeypatch, seed=4))


@pytest.mark.cuda
def test_ddim_inputs_are_not_the_graphs_buffers(cuda_device, monkeypatch):
    """Every tensor handed to the DDIM update, and its result, still holds
    what it held then after the loop's later replays."""
    pipe = _pipe(cuda_device)
    encoded = pipe.encode_image(_drawing(cuda_device))
    _denoise(pipe, encoded)                     # warms up and captures
    kept = []
    step = diffusion.ddim_step

    def recorded(cfg, acp, eps, t, t_prev, sample, eta=0.0, noise=None):
        out = step(cfg, acp, eps, t, t_prev, sample, eta=eta, noise=noise)
        for x in (eps, sample, noise, out):
            kept.append((x, x.clone()))
        return out

    monkeypatch.setattr(diffusion, "ddim_step", recorded)
    _denoise(pipe, encoded)
    static = {ug.out.data_ptr() for g in mv._GRAPHS.values()
              for ug in g.values()} | {
        t.data_ptr() for g in mv._GRAPHS.values() for ug in g.values()
        for t in ug.inputs}
    assert len(kept) == 4 * STEPS
    assert all(x.data_ptr() not in static for x, _ in kept)
    assert all(torch.equal(x, copy) for x, copy in kept)


@pytest.mark.cuda
def test_a_uid_counts_as_an_eager_uid(cuda_device, monkeypatch):
    """A uid of replays moves ``mv.unet.call``, the folds and
    ``mv.attn.launch`` as an eager uid does, and counts a replay a step
    and no eager call; the warm-up uid counts its eager calls and the
    capture."""
    pipe = _pipe(cuda_device)
    image = _drawing(cuda_device)
    with monkeypatch.context() as m:
        m.setattr(mv, "EAGER_CALLS", 10 ** 9)
        before = profiling.counters()
        pipe.images_u8(image)
        eager = _moved(before)
    mv._GRAPHS.clear()
    assert eager["mv.unet.eager"] == STEPS
    assert eager["mv.attn.launch"] == CORES * STEPS
    before = profiling.counters()
    pipe.images_u8(image)
    warm = _moved(before)
    before = profiling.counters()
    pipe.images_u8(image)
    replayed = _moved(before)
    for k in COUNTED:
        assert warm[k] == replayed[k] == eager[k], k
    assert (warm["mv.unet.eager"], warm["mv.unet.graph.capture"],
            warm["mv.unet.graph.replay"]) \
        == (mv.EAGER_CALLS, 1, STEPS - mv.EAGER_CALLS)
    assert replayed["mv.unet.graph.replay"] == STEPS
    assert "mv.unet.eager" not in replayed


@pytest.mark.cuda
def test_replayed_steps_time_their_cores(cuda_device):
    """Under a profiler, a uid of replays carries, under each of its steps,
    one ``mv.attn`` record a core in the uid's unit, each with a positive
    device time, together within the uid's time on the card."""
    pipe = _pipe(cuda_device)
    image = _drawing(cuda_device)
    pipe.images_u8(image)                       # warms up and captures
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pipe.images_u8(image)
        end.record()
    assert profiling.counters()["mv.unet.graph.replay"] == STEPS
    recs = profiling.spans()
    (uid,) = [r for r in recs if r.name == "mv.uid"]
    steps = [r for r in recs if r.name == "mv.step"]
    attn = [r for r in recs if r.name == "mv.attn"]
    assert len(steps) == STEPS and len(attn) == CORES * STEPS
    for s in steps:
        assert sum(r.parent == s.id for r in attn) == CORES
    assert all(r.unit == uid.id for r in attn)
    times = profiling.device_times()
    got = [times[r.id] for r in attn]
    assert all(t > 0 for t in got)
    assert sum(got) < start.elapsed_time(end) * 1e-3


@pytest.mark.cuda
def test_replay_reads_weights_changed_in_place(cuda_device, monkeypatch):
    """After the capture, UNet weights changed in place are read by the
    next replay without a new capture: the loop equals the eager loop on
    the changed weights."""
    pipe = _pipe(cuda_device)
    encoded = pipe.encode_image(_drawing(cuda_device))
    before = _denoise(pipe, encoded)
    unet = pipe.unet_in(torch.bfloat16)      # made in inference mode
    with torch.inference_mode():
        unet.conv_out.weight.mul_(1.5)
        unet.conv_in.bias.add_(0.1)
    got = _denoise(pipe, encoded)
    assert profiling.counters()["mv.unet.graph.capture"] == 1
    assert not torch.equal(got, before)
    assert torch.equal(got, _eager(pipe, encoded, monkeypatch))
