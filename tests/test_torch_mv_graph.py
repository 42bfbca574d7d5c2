"""Stage 2a's UNet call as a CUDA graph (``pipelines/stage2_mv.py::
unet_noise``) on the CPU: which calls run eagerly, the graphs' key and
cache, the counters a capture moves to its replays, and the profiler's
bookkeeping of the device-timed spans captured into a graph
(``core/profiling.py::capturing``, ``replayed``).

The CPU, float64, a split batch and grad mode call the UNet eagerly with
today's counters and spans. ``_unet_graph``'s key and cache are held here
on a CPU UNet under a CUDA device's name (the key reads only addresses,
shapes, dtypes and the device); the capture and the replay run here with
a stand-in graph and stand-in events, so that what they count and record
is checked without a card. The replays themselves:
``tests/test_torch_mv_graph_cuda.py``. No JAX here."""
import collections
import contextlib
import dataclasses
import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from drawingspinup_torch.core import profiling
from drawingspinup_torch.models.attention_mv import RowSplit
from drawingspinup_torch.models.unet_mv2d import UNetMVConfig
from drawingspinup_torch.models.vae import VAEConfig
from drawingspinup_torch.pipelines import stage2_mv as mv
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 3
CORES = 48                  # attention cores a call: 16 blocks × 3 folds
FOLDS = ("views", "domains", "cross")
CUDA = torch.device("cuda")
TINY = mv.MVPipelineConfig(
    unet=UNetMVConfig(block_out_channels=(32, 64, 64, 64),
                      attention_heads=4, cross_attention_dim=32),
    vae=VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1),
    image_size=64, out_size=64, num_inference_steps=STEPS,
    compute_dtype="float32")


@pytest.fixture(autouse=True)
def clean_registry():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def pipe():
    return mv.MVPipeline.init_random(TINY, 0, "cpu")


def _drawing():
    g = torch.Generator().manual_seed(1)
    return torch.rand((TINY.image_size, TINY.image_size, 3), generator=g)


def _args(batch=12, dtype=torch.float32):
    """One step's UNet inputs: latents ⊕ condition latents, a timestep,
    CLIP tokens and camera/task embeddings."""
    g = torch.Generator().manual_seed(2)
    h = TINY.image_size // 8
    cam = torch.as_tensor(mv.sincos(mv.camera_task_embeddings(
        list(mv.VIEWS))))
    return (torch.randn((batch, 8, h, h), generator=g).to(dtype),
            torch.tensor(500),
            torch.randn((batch, 1, 32), generator=g).to(dtype),
            cam.repeat(batch // 12, 1).to(dtype))


def _float64(pipe):
    unet, vae, clip = (pipe.unet.double(), pipe.vae.double(),
                       pipe.clip.double())
    return mv.MVPipeline(dataclasses.replace(TINY, compute_dtype="float64"),
                         unet, vae, clip)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cpu_uids_run_eagerly_with_todays_counters_and_spans(dtype):
    """A CPU uid, in f32 or float64: every UNet call eager (``mv.unet.eager``
    a step, no capture or replay, nothing cached), 48 cores a call, one
    ``mv.attn`` record each under its step, and the unit ``mv.uid`` over
    ``mv.encode``, a ``mv.step`` a step and ``mv.decode``."""
    pipe = mv.MVPipeline.init_random(TINY, 0, "cpu")
    if dtype == "float64":
        pipe = _float64(pipe)
    with profile(activities=[ProfilerActivity.CPU]):
        out = pipe.images_u8(_drawing().to(pipe.dtype), None,
                             torch.Generator().manual_seed(3))
    assert out.shape == (12, 64, 64, 3) and out.dtype == torch.uint8
    c = profiling.counters()
    assert c["mv.unet.eager"] == c["mv.unet.call"] == STEPS
    assert c["mv.unet.graph.capture"] == c["mv.unet.graph.replay"] == 0
    assert [c[f"mv.attn.{k}"] for k in FOLDS] == [16 * STEPS] * 3
    assert c["mv.attn.launch"] == 0
    assert pipe.unet_in(getattr(torch, dtype)) not in mv._GRAPHS
    recs = profiling.spans()
    (uid,) = [r for r in recs if r.name == "mv.uid"]
    assert all(r.unit == uid.id for r in recs)
    steps = {r.id for r in recs if r.name == "mv.step"}
    attn = [r for r in recs if r.name == "mv.attn"]
    assert len(steps) == STEPS and len(attn) == CORES * STEPS
    assert {r.parent for r in attn} == steps
    assert profiling.device_times() == {}


def test_split_and_grad_mode_calls_run_eagerly(pipe):
    """Under a CUDA device's name, a split batch and grad mode get no
    graph on any call and cache nothing; a grad-mode call through
    ``unet_noise`` is the eager call, counted ``mv.unet.eager``."""
    unet, args = pipe.unet, _args()
    w = mv.weights_key(unet)
    split = RowSplit(None, list(range(6)), list(range(12)), 12)
    with torch.no_grad():
        assert all(mv._unet_graph(unet, args, CUDA, split, w) is None
                   for _ in range(mv.EAGER_CALLS + 2))
    with torch.enable_grad():
        assert all(mv._unet_graph(unet, args, CUDA, None, w) is None
                   for _ in range(mv.EAGER_CALLS + 2))
        got = mv.unet_noise(unet, args, CUDA, None, w, torch.float32)
        want = unet(*args)
    assert unet not in mv._GRAPHS
    assert torch.equal(got, want)
    c = profiling.counters()
    assert c["mv.unet.eager"] == 1 and c["mv.unet.call"] == 2
    assert c["mv.unet.graph.capture"] == c["mv.unet.graph.replay"] == 0


@torch.no_grad()
def test_unet_graph_warms_up_then_keeps_its_key():
    """A key's first ``EAGER_CALLS`` calls get no graph, then every call
    gets the same one; a weight changed in place keeps it, while a
    replaced parameter, the doubled batch of guidance, another dtype or
    another device make a new key that warms up again."""
    unet = mv.build_modules(TINY, torch.device("cpu"))[0]
    args = _args()

    def warm(args, w, device=CUDA):
        got = [mv._unet_graph(unet, args, device, None, w)
               for _ in range(mv.EAGER_CALLS + 2)]
        assert got[:mv.EAGER_CALLS] == [None] * mv.EAGER_CALLS
        ug = got[mv.EAGER_CALLS]
        assert isinstance(ug, mv._UNetGraph) and got[-1] is ug
        return ug

    w = mv.weights_key(unet)
    ug = warm(args, w)
    unet.conv_out.weight.mul_(2.0)
    assert mv.weights_key(unet) == w
    assert mv._unet_graph(unet, args, CUDA, None, w) is ug
    unet.conv_out.bias = torch.nn.Parameter(unet.conv_out.bias + 1.0)
    w2 = mv.weights_key(unet)
    assert w2 != w
    ug2 = warm(args, w2)
    assert ug2 is not ug
    for other in [(_args(batch=24), w2),
                  (_args(dtype=torch.bfloat16), w2),
                  (args, w2, torch.device("cuda", 1))]:
        assert warm(*other) is not ug2
    assert len(mv._GRAPHS[unet]) == mv.GRAPHS_PER_UNET


def test_unet_graphs_are_kept_per_unet_and_freed_with_it():
    """At most ``GRAPHS_PER_UNET`` keys a UNet, the least recently used
    dropped first (it warms up again when it comes back); a CPU device
    keeps nothing; freeing the UNet frees its graphs."""
    unet = mv.build_modules(TINY, torch.device("cpu"))[0]
    w = mv.weights_key(unet)
    batches = [_args(batch=b) for b in (12, 24, 36)]

    def call(args, n=1):
        return [mv._unet_graph(unet, args, CUDA, None, w) for _ in range(n)]

    with torch.no_grad():
        first = call(batches[0], mv.EAGER_CALLS + 1)[-1]
        call(batches[1], mv.EAGER_CALLS + 1)
        assert call(batches[0]) == [first]      # batches[1] dropped next
        call(batches[2])
        assert len(mv._GRAPHS[unet]) == mv.GRAPHS_PER_UNET
        assert call(batches[0]) == [first]
        assert call(batches[1]) == [None]       # dropped: warms up again
        other = mv.build_modules(TINY, torch.device("cpu"))[0]
        assert mv._unet_graph(other, batches[0], torch.device("cpu"), None,
                              w) is None
    assert other not in mv._GRAPHS
    n = len(mv._GRAPHS)
    del unet, first
    gc.collect()
    assert len(mv._GRAPHS) == n - 1


class _Clock:
    """A stand-in for a CUDA timing event: the n-th made reads n ms."""
    made = 0

    def __init__(self):
        _Clock.made += 1
        self.at = _Clock.made

    def elapsed_time(self, end):
        return float(end.at - self.at)


class _Graph:
    """A stand-in for ``torch.cuda.CUDAGraph``: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def stand_ins(monkeypatch):
    """Captures without a card: ``torch.cuda.graph`` runs its block
    eagerly, the graph only counts replays, events are ``_Clock``s."""
    _Clock.made = 0
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    monkeypatch.setattr(profiling, "_graph_event", _Clock)

    def no_eager_event():
        raise AssertionError("an eager event inside a capture")

    monkeypatch.setattr(profiling, "_event", no_eager_event)


def test_capture_moves_its_counts_to_the_replays(pipe, stand_ins):
    """Two eager calls, a capture, then replays: ``mv.unet.call``, the
    folds and the cores count one call each, eager or replayed (a capture
    counts nothing); the capture lists its 48 cores' event pairs, 96
    events; a replay copies its inputs into the graph's, and returns a
    copy of the static noise cast to the dtype asked for."""
    unet, args = pipe.unet, _args()
    w = mv.weights_key(unet)
    calls = 5
    with torch.no_grad():
        for k in range(calls):
            a = (args[0] + k,) + args[1:]
            got = mv.unet_noise(unet, a, CUDA, None, w, torch.float64)
            assert got.dtype == torch.float64
            c = profiling.counters()
            assert c["mv.unet.call"] == k + 1
            assert [c[f"mv.attn.{f}"] for f in FOLDS] == [16 * (k + 1)] * 3
        ug = mv._GRAPHS[unet][next(iter(mv._GRAPHS[unet]))]
    c = profiling.counters()
    assert c["mv.unet.eager"] == mv.EAGER_CALLS
    assert c["mv.unet.graph.capture"] == 1
    assert c["mv.unet.graph.replay"] == ug.graph.replays \
        == calls - mv.EAGER_CALLS
    assert ug.launched == collections.Counter(
        {"mv.unet.call": 1, **{f"mv.attn.{f}": 16 for f in FOLDS}})
    assert [s[0] for s in ug.spans] == ["mv.attn"] * CORES
    assert _Clock.made == 2 * CORES
    assert all(torch.equal(s, x) for s, x in zip(ug.inputs, a))
    assert got.data_ptr() != ug.out.data_ptr()
    assert torch.equal(got, ug.out.double())
    assert profiling.timings()["mv.attn"]["count"] \
        == CORES * (mv.EAGER_CALLS + 1)


def test_replays_record_captured_spans_only_under_a_profiler(stand_ins):
    """Device spans opened inside ``capturing`` list their pairs (a record
    without events where a profiler records during the capture); a replay
    appends nothing without a profiler, and under one a record per span
    with the unit and parent open at the replay, whose seconds
    ``device_times`` returns; ``reset`` clears them."""
    with pytest.raises(RuntimeError):
        with profiling.capturing(), profiling.capturing():
            pass
    with profiling.capturing() as cap:
        for _ in range(2):
            with profiling.span("mv.attn", device=True):
                pass
        with profiling.span("host.only"):
            pass
    assert [n for n, _, _ in cap] == ["mv.attn", "mv.attn"]
    assert _Clock.made == 4
    with profiling.span("mv.attn", device=True):    # outside: no pair
        pass
    assert len(cap) == 2 and _Clock.made == 4
    profiling.replayed(cap, 0)
    assert profiling.spans() == [] and profiling.device_times() == {}

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("mv.uid", unit=True):
            for _ in range(2):
                with profiling.span("mv.step"):
                    profiling.replayed(cap, 123)
        with profiling.capturing() as cap2:
            with profiling.span("mv.attn", device=True):
                pass
    recs = profiling.spans()
    (uid,) = [r for r in recs if r.name == "mv.uid"]
    steps = [r for r in recs if r.name == "mv.step"]
    attn = [r for r in recs if r.name == "mv.attn"]
    assert len(attn) == 5 and len(cap2) == 1
    replayed, captured = attn[:4], attn[4]
    for step, pair in zip(steps, (replayed[:2], replayed[2:])):
        assert [r.parent for r in pair] == [step.id] * 2
        assert all(r.unit == uid.id and r.start_ns == 123
                   and r.end_ns >= r.start_ns for r in pair)
    times = profiling.device_times()
    assert times == {r.id: 1e-3 for r in replayed}
    assert captured.id not in times
    assert np.isclose(sum(times.values()), 4e-3)
    profiling.reset()
    assert profiling.device_times() == {}
