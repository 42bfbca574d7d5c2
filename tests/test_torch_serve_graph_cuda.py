"""Frame serving's CUDA graph on the card (``train/gan.py::
generate_full_rgba``): replayed frames against eager ones, weights changed
in place and replaced, training mode, and the launch counters.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_serve_graph_cuda.py

The eager reference of a frame is ``gan.frame_rgba`` called directly, the
same operations as the eager path and as the graph: frames are compared
bit for bit."""
import numpy as np
import pytest
import torch

from drawingspinup_torch.core import profiling
from drawingspinup_torch.models.generator_j import BatchNorm
from drawingspinup_torch.train import gan

SIZE = 512
FLAGS = {"GeneratorJ_RIC": (True, True, False),
         "GeneratorJ": (True, True, True)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profiling.reset()
    yield torch.device("cuda")
    profiling.reset()


def _model(generator, dtype, device):
    """A full-width generator with spread batch-norm statistics and a
    head scaled down, so that tanh leaves most values unsaturated."""
    g = torch.Generator(device=device).manual_seed(7)
    model = gan.build_generator(gan.GANConfig(generator=generator,
                                              compute_dtype=dtype), device, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=g,
                                                     device=device))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g,
                                                       device=device))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g,
                                                     device=device))
        model.head.weight.mul_(0.05)
    return model


def _stacks(n, seed=0):
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 256, (n, SIZE, SIZE, 7), dtype=np.uint8)
    out[..., 4] = np.where(out[..., 4] > 64, 255, out[..., 4])  # edges
    return list(out)


def _eager(model, x_u8, flags):
    with torch.no_grad():
        return gan.frame_rgba(model, torch.from_numpy(x_u8).to("cuda"),
                              *flags).cpu().numpy()


def _counts():
    c = profiling.counters()
    return (c["serve.eager"], c["serve.graph.capture"],
            c["serve.graph.replay"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("generator", ["GeneratorJ_RIC", "GeneratorJ"])
def test_replayed_frames_equal_eager_frames(cuda_device, generator, dtype):
    """Two eager frames, a capture, then replays over distinct stacks and
    repeats: every frame bit-equal to its eager reference, and not a
    saturated one."""
    model = _model(generator, dtype, cuda_device)
    flags = FLAGS[generator]
    stacks = _stacks(4)
    want = [_eager(model, s, flags) for s in stacks]
    assert 0.2 < (want[0][..., :3] % 255 != 0).mean()
    order = [0, 1, 2, 3, 0, 2, 1]
    for i in order:
        got = gan.generate_full_rgba(model, stacks[i], *flags)
        assert np.array_equal(got, want[i]), (generator, dtype, i)
    assert _counts() == (2, 1, len(order) - 2)


@pytest.mark.cuda
def test_replay_reads_weights_changed_in_place(cuda_device):
    """After the capture, weights and running statistics changed in place
    (as AdamW and a training step's batch norms change them) are read by
    the next replay, without a new capture."""
    model = _model("GeneratorJ_RIC", "float32", cuda_device)
    flags = FLAGS["GeneratorJ_RIC"]
    s = _stacks(1)[0]
    for _ in range(3):
        gan.generate_full_rgba(model, s, *flags)
    with torch.no_grad():
        model.conv1.kernel.mul_(1.5)
        model.bn1.running_mean.add_(0.2)
        model.head.bias.add_(0.1)
    want = _eager(model, s, flags)
    got = gan.generate_full_rgba(model, s, *flags)
    assert np.array_equal(got, want)
    assert _counts() == (2, 1, 2)


@pytest.mark.cuda
def test_replaced_parameter_captures_again(cuda_device):
    """A parameter replaced by a new tensor is a new key: two eager frames,
    then a second capture, whose replays read the new tensor."""
    model = _model("GeneratorJ_RIC", "float32", cuda_device)
    flags = FLAGS["GeneratorJ_RIC"]
    s = _stacks(1)[0]
    for _ in range(4):
        gan.generate_full_rgba(model, s, *flags)
    assert _counts() == (2, 1, 2)
    model.head.bias = torch.nn.Parameter(model.head.bias.detach() + 0.1,
                                         requires_grad=False)
    want = _eager(model, s, flags)
    for _ in range(4):
        assert np.array_equal(gan.generate_full_rgba(model, s, *flags), want)
    assert _counts() == (4, 2, 4)


@pytest.mark.cuda
def test_training_mode_serves_eagerly(cuda_device):
    """A model in training mode serves every frame eagerly."""
    model = _model("GeneratorJ_RIC", "float32", cuda_device).train()
    s = _stacks(1)[0]
    for _ in range(4):
        gan.generate_full_rgba(model, s, *FLAGS["GeneratorJ_RIC"])
    assert _counts() == (4, 0, 0)
    assert profiling.counters()["ric.fwd.launch"] == 4 * 22


@pytest.mark.cuda
def test_replayed_frame_counts_its_launches(cuda_device):
    """``ric.fwd.launch`` counts 21 a served frame, eager, captured or
    replayed: a capture counts nothing, a replay what its capture saw."""
    model = _model("GeneratorJ_RIC", "float32", cuda_device)
    stacks = _stacks(2)
    flags = FLAGS["GeneratorJ_RIC"]
    for k in range(6):
        gan.generate_full_rgba(model, stacks[k % 2], *flags)
        assert profiling.counters()["ric.fwd.launch"] == 21 * (k + 1)
    assert _counts() == (2, 1, 4)
