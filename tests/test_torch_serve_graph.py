"""Frame serving's CUDA graph (``train/gan.py::generate_full_rgba``) on the
CPU: which frames run eagerly, and the graphs' key and cache.

A model on the CPU or in training mode serves every frame eagerly, with
the spans and counters of the eager path; ``_frame_graph``'s key and
cache are held here on a CPU model under a CUDA device's name (the key
reads only addresses, shapes and flags). The replays themselves need a
card: ``tests/test_torch_serve_graph_cuda.py``. No JAX here."""
import gc

import numpy as np
import pytest
import torch

from drawingspinup_torch.core import profiling
from drawingspinup_torch.models import generator_j
from drawingspinup_torch.train import gan

SMALL = dict(filters=(4, 8, 8, 8, 8, 4), batch_size=2, patch_size=16)
SERVE = ("serve.upload", "serve.forward", "serve.quantise", "serve.readback")
FLAGS = (True, True, False)
CUDA = torch.device("cuda")


@pytest.fixture(autouse=True)
def clean_registry():
    profiling.reset()
    yield
    profiling.reset()


def _model(generator="GeneratorJ_RIC"):
    return gan.build_generator(gan.GANConfig(generator=generator, **SMALL),
                               "cpu", torch.Generator().manual_seed(0))


def _stack(size, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (size, size, 7), dtype=np.uint8)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_cpu_and_training_mode_frames_run_eagerly(mode):
    """Every frame of a CPU model, in eval or training mode, is eager:
    ``serve.eager`` a frame, no capture or replay, one ``serve.frame`` unit
    a frame holding the four eager spans in order and its RIC forwards
    (21 in eval; 22 in training, where the smoothing branch runs); in eval
    the frames are ``frame_rgba``'s."""
    model = _model()
    if mode == "train":
        model.train()
    stacks = [_stack(16, s) for s in range(4)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        outs = [gan.generate_full_rgba(model, s, *FLAGS) for s in stacks]
    c = profiling.counters()
    assert c["serve.eager"] == 4
    assert c["serve.graph.capture"] == c["serve.graph.replay"] == 0
    assert c["ric.fwd.launch"] == 0
    assert model not in gan._GRAPHS
    recs = profiling.spans()
    units = [r for r in recs if r.name == "serve.frame"]
    assert len(units) == 4 and all(u.unit == u.id for u in units)
    for u in units:
        kids = sorted((r for r in recs if r.parent == u.id),
                      key=lambda r: r.start_ns)
        assert tuple(r.name for r in kids) == SERVE
        n_ric = sum(r.name == "ric.fwd" and r.unit == u.id for r in recs)
        assert n_ric == (21 if mode == "eval" else 22)
    if mode == "eval":
        with torch.no_grad():
            for s, out in zip(stacks, outs):
                want = gan.frame_rgba(model, torch.from_numpy(s), *FLAGS)
                assert np.array_equal(out, want.numpy())


def test_frame_features_are_the_host_stacks():
    """``full_frame_features`` is the copy to the device, then
    ``frame_features``; ``frame_rgba`` is the features, the model and
    ``quantise_rgba``."""
    model = _model("GeneratorJ")
    x_u8 = _stack(16, 5)
    x_u8[..., 4] = np.where(x_u8[..., 4] > 128, 255, x_u8[..., 4])
    for flags in [(True, True, True), (False, True, False),
                  (True, False, True)]:
        x, alpha = gan.full_frame_features(x_u8, *flags, "cpu")
        x2, alpha2 = gan.frame_features(torch.from_numpy(x_u8), *flags)
        assert torch.equal(x, x2) and torch.equal(alpha, alpha2)
        assert x.shape == (1, 16, 16, 3 + flags[0] + 2 * flags[1])
        if x.shape[-1] != 6:
            continue
        with torch.no_grad():
            got = gan.frame_rgba(model, torch.from_numpy(x_u8), *flags)
            want = gan.quantise_rgba(model(x)[0], alpha)
        assert torch.equal(got, want) and got.dtype == torch.uint8
        assert torch.equal(got[..., 3], torch.from_numpy(x_u8[..., 3]))


def test_frame_graph_warms_up_then_keeps_its_key():
    """Under a CUDA device's name: a key's first ``EAGER_FRAMES`` frames
    get no graph, then every frame gets the same one; a weight changed in
    place keeps it, while a replaced parameter, another stack shape or
    dtype, other flags or another compute dtype make a new key that warms
    up again; a training-mode model gets none."""
    model = _model()
    x = _stack(16, 0)

    def warm(*args):
        got = [gan._frame_graph(*args) for _ in range(gan.EAGER_FRAMES + 2)]
        assert got[:gan.EAGER_FRAMES] == [None] * gan.EAGER_FRAMES
        fg = got[gan.EAGER_FRAMES]
        assert isinstance(fg, gan._FrameGraph) and got[-1] is fg
        return fg

    fg = warm(model, x, FLAGS, CUDA)
    with torch.no_grad():
        model.head.weight.mul_(2.0)
        model.bn0.running_mean.add_(1.0)
    assert gan._frame_graph(model, x, FLAGS, CUDA) is fg
    model.head.bias = torch.nn.Parameter(model.head.bias.detach() + 1.0)
    fg2 = warm(model, x, FLAGS, CUDA)
    assert fg2 is not fg
    for other in [(model, _stack(8, 0), FLAGS, CUDA),
                  (model, x.astype(np.int16), FLAGS, CUDA),
                  (model, x, (True, True, True), CUDA),
                  (model, x, FLAGS, torch.device("cuda", 1))]:
        assert warm(*other) is not fg2
    model.dtype = torch.bfloat16
    assert warm(model, x, FLAGS, CUDA) is not fg2
    model.train()
    assert all(gan._frame_graph(model, x, FLAGS, CUDA) is None
               for _ in range(4))
    assert len(gan._GRAPHS[model]) == gan.GRAPHS_PER_MODEL


def test_frame_graphs_are_kept_per_model_and_freed_with_it():
    """At most ``GRAPHS_PER_MODEL`` keys a model, the least recently
    served dropped first (it warms up again when it comes back); a CPU
    device keeps nothing; freeing the model frees its graphs."""
    model = _model()
    xs = [_stack(s, 0) for s in (8, 12, 16)]

    def serve(x, n=1):
        return [gan._frame_graph(model, x, FLAGS, CUDA) for _ in range(n)]

    first = serve(xs[0], gan.EAGER_FRAMES + 1)[-1]
    serve(xs[1], gan.EAGER_FRAMES + 1)
    assert serve(xs[0]) == [first]          # xs[0] served last: xs[1] next
    serve(xs[2])
    assert len(gan._GRAPHS[model]) == gan.GRAPHS_PER_MODEL
    assert serve(xs[0]) == [first]
    assert serve(xs[1]) == [None]           # dropped: warms up again
    other = _model()
    assert gan._frame_graph(other, xs[0], FLAGS, torch.device("cpu")) is None
    assert other not in gan._GRAPHS
    n = len(gan._GRAPHS)
    del model, first
    gc.collect()
    assert len(gan._GRAPHS) == n - 1


def test_tables_read_holds_every_ric_table_a_forward_reads():
    """Inside ``tables_read`` a RIC forward lists the table of each of its
    21 RIC convs: ``_swf``'s own tensors, one per resolution."""
    model = _model()
    x, _ = gan.full_frame_features(_stack(16, 1), *FLAGS, "cpu")
    with torch.no_grad(), generator_j.tables_read() as read:
        model(x)
    assert len(read) == 21
    assert {t.shape[-1] for t in read} == {16, 8, 4}
    for t in read:
        h, w = t.shape[-2:]
        assert t is generator_j._swf(h, w, torch.device("cpu"),
                                     torch.float32)
    assert generator_j._READERS == []
    with torch.no_grad():
        model(x)
    assert len(read) == 21
