"""The stage-2a attention core (``kernels/mv_attention.py``): the bf16 flash
kernel (``kernels/csrc/mv_attention.cu``) against its plain version, and
the wrapper's dispatch.

Tests marked ``cuda`` need a CUDA device and skip without one; the file
imports no JAX, so they run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_mv_attention_kernel.py

The rest run on the CPU: the dispatch (CPU tensors and f32 or float64
inputs take the plain version and launch nothing), the wrapper's refusals
before any build, and an emulation of the kernel's arithmetic (key tiles,
online softmax in f32 on exp2, P rounded to bf16, ragged keys masked) in
plain PyTorch, held to the plain version by the same tolerance as the
kernel, which a planted slip in that arithmetic exceeds.

Tolerance, two limits, both held:
- ``output_ulps`` ≤ 2, in bf16 ulps of max |v| over the keys and width of
  each (row, head). Rounding P to bf16 moves an output by less than one
  such ulp, and each side's rounding of its output adds at most half of
  one (the reason is spelled out in ``output_ulps``).
- ``output_rel_l2`` ≤ 1e-2 over the whole output. Where thousands of keys
  share the weight a typical |out| is far below max |v|, so the first limit
  alone is loose there; the kernel's arithmetic reads ~2e-3 at the views
  fold (the emulation; the card's readings are in PERF.md), a dropped
  64-key tile or a wrong scale there 1e-1 and more.
"""
import collections
import json
import os
import subprocess
import sys

import pytest
import torch

from drawingspinup_torch.core import profiling
from drawingspinup_torch.kernels import _build
from drawingspinup_torch.kernels import mv_attention as mk
from drawingspinup_torch.models import attention_mv as am

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ULPS = 2.0
REL_L2 = 1e-2
VIEWS_FOLD = (2, 6144, 6144, 320)   # the cell's views fold at 32², d 40
HEADS = 8


def cell_cores():
    """The distinct (B, Sq, Sk, C) attention cores of one UNet call of the
    benchmark cell ``wonder3d_mv.uid`` (``benchmark/mv_work.py``): views,
    domains and cross folds at head dims 40, 80 and 160, the mid block's
    16 tokens among them."""
    from benchmark import mv_work

    with open(os.path.join(ROOT, "benchmark", "configs",
                           "wonder3d_mv.json")) as f:
        cfg = json.load(f)
    assert cfg["unet"]["attention_heads"] == HEADS
    return sorted({(a.b, a.sq, a.sk, a.c)
                   for a in mv_work.attention_cores(cfg)})


def qkv(b, sq, sk, c, seed=0, device="cpu", dtype=torch.bfloat16,
        spread=2.0):
    """q, k, v drawn from ``seed``; q at ``spread`` so that each query
    favours a few keys, as the cell's weights make it (``mv_inputs``)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(s, scale):
        return (scale * torch.randn((b, s, c), generator=g, device=device,
                                    dtype=torch.float32)).to(dtype)

    return draw(sq, spread), draw(sk, 1.0), draw(sk, 1.0)


def launches() -> int:
    return profiling.counters().get(mk.LAUNCHES, 0)


def flash_emulation(q, k, v, heads, bn, rescale=True, mask_from=None,
                    scale_dim=None, drop_tile=None):
    """The kernel's arithmetic in plain PyTorch: keys in tiles of ``bn``,
    scores in f32 scaled by log2(e)/√d, a running max and sum per row, P
    rounded to bf16 for P·V, the output normalised in f32 and rounded to
    q's dtype. Slips: ``rescale`` False drops the running rescale;
    ``mask_from`` masks keys from that index instead of from Sk;
    ``scale_dim`` scales by 1/√scale_dim instead of 1/√d; ``drop_tile``
    skips that key tile (-1: the last)."""
    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // heads

    def heads_of(t, s):
        return t.float().reshape(b, s, heads, d).transpose(1, 2)

    qf, kf, vf = heads_of(q, sq), heads_of(k, sk), heads_of(v, sk)
    scale = torch.tensor(1.4426950408889634 / (scale_dim or d) ** 0.5,
                         dtype=torch.float32)
    mx = torch.full((b, heads, sq, 1), -float("inf"))
    total = torch.zeros((b, heads, sq, 1))
    acc = torch.zeros((b, heads, sq, d))
    limit = sk if mask_from is None else mask_from
    tiles = range(0, sk, bn)
    dropped = None if drop_tile is None else tiles[drop_tile]
    for n0 in tiles:
        if n0 == dropped:
            continue
        kt, vt = kf[:, :, n0:n0 + bn], vf[:, :, n0:n0 + bn]
        s = qf @ kt.transpose(-1, -2)
        keys = torch.arange(n0, n0 + kt.shape[2])
        s = s.masked_fill(keys >= limit, -float("inf"))
        m = torch.maximum(mx, s.amax(-1, keepdim=True) * scale)
        alpha = torch.exp2(mx - m) if rescale else torch.ones_like(m)
        p = torch.exp2(s * scale - m)
        total = total * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vt
        mx = m
    out = (acc / total).transpose(1, 2).reshape(b, sq, c)
    return out.to(q.dtype)


# -- the CPU: dispatch, refusals, the emulated arithmetic -------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
def test_cpu_input_takes_plain_version_and_launches_nothing(dtype):
    q, k, v = qkv(2, 24, 40, 320, seed=1, dtype=dtype)
    n0 = launches()
    got = am.attention_core(q, k, v, HEADS)
    assert got.dtype == dtype
    assert torch.equal(got, mk.attention_reference(q, k, v, HEADS))
    assert launches() == n0 and _build._ext is None


def test_plain_version_is_the_upcast_core():
    """The plain version computes in f32 (float64 stays float64) and rounds
    only its output: on bf16 inputs it is the f32 core of the upcast
    tensors, cast back."""
    q, k, v = qkv(2, 16, 33, 160, seed=2)
    want = mk.attention_reference(q.float(), k.float(), v.float(), HEADS)
    assert torch.equal(mk.attention_reference(q, k, v, HEADS),
                       want.to(torch.bfloat16))


def test_importing_the_wrapper_builds_nothing():
    code = ("from drawingspinup_torch.models import attention_mv\n"
            "from drawingspinup_torch.kernels import _build, mv_attention\n"
            "assert _build._ext is None\n"
            "assert mv_attention.LAUNCHES == 'mv.attn.launch'\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr


@pytest.mark.parametrize("case", ["cpu", "dtype", "rank", "kv_shape",
                                  "head_dim", "heads", "row_stride",
                                  "offset", "c_stride", "requires_grad"])
def test_kernel_wrapper_refuses_before_build(case):
    """``mv_attention`` checks its inputs before it builds or launches
    anything; a CPU tensor is refused, never computed."""
    q, k, v = qkv(2, 16, 24, 320)
    heads = HEADS
    err = ValueError
    n0 = launches()
    if case == "dtype":
        q, err = q.half(), TypeError
    elif case == "rank":
        q, err = q[0], TypeError
    elif case == "kv_shape":
        v = v[:, :-1]
    elif case == "head_dim":
        heads = 5                                   # d = 64
    elif case == "heads":
        heads = 7                                   # C % heads ≠ 0
    elif case == "row_stride":
        kv = torch.zeros((2, 24, 324), dtype=torch.bfloat16)
        k = kv[..., :320]                           # row stride 324
    elif case == "offset":
        kv = torch.zeros((2, 24, 648), dtype=torch.bfloat16)
        k = kv[..., 4:324]                          # starts 8 bytes in
    elif case == "c_stride":
        k = torch.zeros((2, 24, 320, 2), dtype=torch.bfloat16)[..., 0]
    elif case == "requires_grad":                   # forward only
        v, err = v.requires_grad_(), RuntimeError
    with pytest.raises(err):
        mk.mv_attention(q, k, v, heads)
    assert launches() == n0 and _build._ext is None


def test_split_keys_pass_the_layout_checks():
    """The split path's keys, ``kv[..., :c]`` and ``kv[..., c:]`` of a
    gathered (rows, S, 2C) tensor, are strided views the kernel reads where
    they lie: they pass every check up to the device's."""
    kv = torch.zeros((3, 48, 640), dtype=torch.bfloat16)
    q = torch.zeros((3, 16, 320), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        mk.mv_attention(q, kv[..., :320], kv[..., 320:], HEADS)
    assert mk._strides("k", kv[..., 320:]) == (48 * 640, 640)
    assert mk._strides("k", torch.zeros((12, 1, 320),
                                        dtype=torch.bfloat16)) == (320, 0)


def test_grad_refusal_only_while_grad_is_enabled():
    """Inputs that require grad pass the grad check under ``no_grad`` and
    ``inference_mode``, as the UNet's callers run it; they meet the device
    check next."""
    q, k, v = qkv(2, 16, 24, 320)
    q.requires_grad_()
    for mode in (torch.no_grad, torch.inference_mode):
        with mode(), pytest.raises(ValueError, match="CUDA device"):
            mk.mv_attention(q, k, v, HEADS)


def test_cuda_half_is_refused_not_computed():
    """The dispatch sends only bf16 to the kernel, and f32/float64 to the
    plain version; another dtype on a CUDA device has no core. (Checked
    on a stand-in object: the dispatch reads only its device and dtype.)"""
    class Fake:
        device = torch.device("cuda")
        dtype = torch.float16

    with pytest.raises(TypeError, match="no core"):
        mk.attention(Fake(), Fake(), Fake(), HEADS)


def test_output_ulps_by_hand():
    v = torch.zeros((1, 3, 80))
    v[0, 1, 5] = 3.0               # head 0: max |v| 3, ulp 2⁻⁶
    v[0, 2, 50] = -0.75            # head 1: max |v| 0.75, ulp 2⁻⁸
    want = torch.zeros((1, 2, 80))
    got = want.clone()
    got[0, 1, 7] = 2 ** -6 * 1.5
    assert mk.output_ulps(got, want, v, 2) == 1.5
    got[0, 0, 41] = 2 ** -8 * 2.5
    assert mk.output_ulps(got, want, v, 2) == 2.5


@pytest.mark.parametrize("shape", [
    (2, 96, 96, 320),       # d 40, several 64-key tiles
    (1, 70, 130, 320),      # d 40, ragged queries and keys
    (3, 48, 1, 320),        # d 40, one key (cross)
    (2, 40, 96, 640),       # d 80
    (2, 33, 17, 640),       # d 80, ragged
    (2, 16, 96, 1280),      # d 160, the mid block's 16 tokens
    (6, 32, 32, 1280),      # d 160, the mid block's domains fold
    (2, 96, 96, 64),        # d 8, a narrow UNet's views fold
    (6, 33, 70, 128),       # d 16, ragged
    VIEWS_FOLD,             # 6144 keys: where the slips below are read
])
def test_emulated_kernel_within_tolerance_of_plain(shape):
    b, sq, sk, c = shape
    q, k, v = qkv(b, sq, sk, c, seed=sum(shape))
    bn = {8: 64, 16: 64, 40: 64, 80: 32, 160: 16}[c // HEADS]
    got = flash_emulation(q, k, v, HEADS, bn)
    want = mk.attention_reference(q, k, v, HEADS)
    assert mk.output_ulps(got, want, v, HEADS) <= ULPS
    assert mk.output_rel_l2(got, want) <= REL_L2


@pytest.mark.parametrize("slip", ["no_rescale", "mask_off_by_one",
                                  "padded_scale"])
def test_tolerance_catches_slips_in_the_arithmetic(slip):
    """A kernel that skipped the running rescale, let one key past Sk in,
    or scaled d = 40's scores by its padded depth of 48 reads beyond the
    tolerance."""
    b, sq, sk, c = 2, 64, 130, 320
    q, k, v = qkv(b, sq, sk, c, seed=7)
    want = mk.attention_reference(q, k, v, HEADS)
    if slip == "mask_off_by_one":
        # one more key than the core holds: row 130 of a longer K and V
        k2, v2 = qkv(b, sq, sk + 1, c, seed=8)[1:]
        k2[:, :sk], v2[:, :sk] = k, v
        got = flash_emulation(q, k2, v2, HEADS, 64, mask_from=sk + 1)
    elif slip == "no_rescale":
        got = flash_emulation(q, k, v, HEADS, 64, rescale=False)
    else:
        got = flash_emulation(q, k, v, HEADS, 64, scale_dim=48)
    assert mk.output_ulps(got, want, v, HEADS) > ULPS


@pytest.fixture(scope="module")
def views_fold():
    """q, k, v at the views fold and the plain version's output."""
    q, k, v = qkv(*VIEWS_FOLD, seed=sum(VIEWS_FOLD))
    return q, k, v, mk.attention_reference(q, k, v, HEADS)


@pytest.mark.parametrize("slip", ["drop_first_tile", "drop_last_tile",
                                  "padded_scale"])
def test_rel_l2_catches_slips_at_the_views_fold(slip, views_fold):
    """At 6144 keys each key weighs little, so the slips are read where
    most of a uid's work is: a kernel that skipped one 64-key tile (the
    first, which sets the running max, or the last, the ragged one's place)
    or scaled d = 40's scores by its padded depth of 48 reads beyond the
    relative-L2 limit."""
    q, k, v, want = views_fold
    kw = {"drop_first_tile": {"drop_tile": 0},
          "drop_last_tile": {"drop_tile": -1},
          "padded_scale": {"scale_dim": 48}}[slip]
    got = flash_emulation(q, k, v, HEADS, 64, **kw)
    assert mk.output_rel_l2(got, want) > 3 * REL_L2


def test_output_rel_l2_by_hand():
    want = torch.tensor([[[3.0, 4.0]]])
    assert mk.output_rel_l2(want, want) == 0.0
    assert mk.output_rel_l2(torch.tensor([[[3.0, 6.5]]]), want) == 0.5


def test_cell_cores_cover_every_head_dim_and_fold():
    cores = cell_cores()
    assert {c // HEADS for _, _, _, c in cores} == {40, 80, 160}
    assert set(mk.HEAD_DIMS) == {8, 16, 40, 80, 160}
    assert (2, 6144, 6144, 320) in cores        # the views fold at 32²
    assert (6, 2048, 2048, 320) in cores        # the domains fold at 32²
    assert (12, 16, 1, 1280) in cores           # cross at the mid block
    assert any(sk == 1 for _, _, sk, _ in cores)


def test_cell_cores_are_the_unets_own_calls():
    """The list the card tests and ``chip_smoke.py``'s phase 16a take is
    the UNet's own: one bf16 call of the yaml's UNet, built on the meta
    device (no storage, no arithmetic), calls ``attention_core`` at each
    listed core as often as ``mv_work`` lists it."""
    from benchmark import mv_work
    from drawingspinup_torch.core.contract import VIEWS
    from drawingspinup_torch.models.unet_mv2d import UNetMV2D
    from drawingspinup_torch.pipelines import stage2_mv as mv

    with open(os.path.join(ROOT, "benchmark", "configs",
                           "wonder3d_mv.json")) as f:
        listed = collections.Counter(
            (a.b, a.sq, a.sk, a.c)
            for a in mv_work.attention_cores(json.load(f)))
    cfg = mv.MVPipelineConfig()
    nv2, side = 2 * len(VIEWS), cfg.image_size // 8
    classes = cfg.unet.projection_class_embeddings_input_dim
    seen = collections.Counter()

    def core(q, k, v, heads):
        assert heads == HEADS
        seen[(q.shape[0], q.shape[1], k.shape[1], q.shape[2])] += 1
        return torch.empty_like(q)

    with torch.device("meta"):
        unet = UNetMV2D(cfg.unet).to(torch.bfloat16).eval()
        args = (torch.zeros((nv2, cfg.unet.in_channels, side, side),
                            dtype=torch.bfloat16), torch.tensor(500),
                torch.zeros((nv2, 1, cfg.unet.cross_attention_dim),
                            dtype=torch.bfloat16),
                torch.zeros((nv2, classes), dtype=torch.bfloat16))
    with pytest.MonkeyPatch.context() as mp, torch.inference_mode():
        mp.setattr(am, "attention_core", core)
        unet(*args)
    assert seen == listed


# -- the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def check_against_plain(q, k, v, heads=HEADS):
    n0 = launches()
    got = mk.attention(q, k, v, heads)
    again = mk.attention(q, k, v, heads)
    want = mk.attention_reference(q, k, v, heads)
    torch.cuda.synchronize()
    assert launches() == n0 + 2
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.equal(got, again)
    ulps = mk.output_ulps(got, want, v, heads)
    rel = mk.output_rel_l2(got, want)
    assert ulps <= ULPS, ulps
    assert rel <= REL_L2, rel
    return ulps, rel


@pytest.mark.cuda
@pytest.mark.parametrize("core", cell_cores())
def test_kernel_matches_plain_at_the_cell_cores(core, cuda_device):
    b, sq, sk, c = core
    check_against_plain(*qkv(b, sq, sk, c, seed=sq + sk + c,
                             device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1000, 3000, 320), (1, 1, 1, 320),
                                   (3, 130, 77, 640), (2, 5, 200, 1280),
                                   (2, 384, 384, 64), (12, 64, 1, 64),
                                   (6, 130, 128, 128), (12, 16, 1, 128)])
def test_kernel_matches_plain_at_ragged_lengths(shape, cuda_device):
    """Ragged lengths, and the narrow UNets' head dims 8 and 16 (the
    ``--tiny`` CLI's and the dry run's)."""
    check_against_plain(*qkv(*shape, seed=11, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [320, 640, 1280])
def test_kernel_reads_split_keys_where_they_lie(c, cuda_device):
    """The split path: local queries (Sq ≠ Sk) over keys and values that
    are the two halves of one gathered (rows, Sk, 2C) tensor, row stride
    2C; the kernel reads them in place and matches the plain version on
    contiguous copies."""
    b, sq, sk = 2, 3 * 96 // (c // 320), 6 * 96 // (c // 320)
    g = torch.Generator(device=cuda_device).manual_seed(c)
    q = (2 * torch.randn((b, sq, c), generator=g, device=cuda_device)
         ).bfloat16()
    kv = torch.randn((b, sk, 2 * c), generator=g, device=cuda_device
                     ).bfloat16()
    k, v = kv[..., :c], kv[..., c:]
    assert k.stride(1) == 2 * c
    check_against_plain(q, k, v)
    got = mk.attention(q, k, v, HEADS)
    assert torch.equal(got, mk.attention(q, k.contiguous(), v.contiguous(),
                                         HEADS))


@pytest.mark.cuda
def test_kernel_refuses_a_head_dim_it_does_not_take(cuda_device):
    q, k, v = qkv(2, 64, 64, 512, device=cuda_device)    # d = 64
    n0 = launches()
    with pytest.raises(ValueError, match="head dim"):
        mk.attention(q, k, v, HEADS)
    with pytest.raises(TypeError, match="no core"):
        mk.attention(q.half(), k.half(), v.half(), HEADS)
    assert launches() == n0


@pytest.mark.cuda
def test_f32_and_float64_on_the_card_take_plain_version(cuda_device):
    for dtype in (torch.float32, torch.float64):
        q, k, v = qkv(2, 64, 96, 320, device=cuda_device, dtype=dtype)
        n0 = launches()
        got = am.attention_core(q, k, v, HEADS)
        assert launches() == n0
        assert torch.equal(got, mk.attention_reference(q, k, v, HEADS))
