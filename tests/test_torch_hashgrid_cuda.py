"""PyTorch port on the GPU: the hand-written hash-grid kernels (encode,
table gradient, row gather) against their plain PyTorch twins, alone and
through the autograd Function of ``models/hashgrid.py``.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_hashgrid_cuda.py

Tolerances:
  * encode, f32: max |kernel − twin| ≤ 1e-5 · max |twin| (the two round the
    same f32 products and sums, but the compiler may contract a product
    and a sum into one FMA on either side);
  * encode, bf16 compute: within one bf16 ulp of the largest output;
  * table gradients: relative L2 ≤ 1e-5 of the twin's f32 scatter (f32
    compute) and ≤ 1e-2 (bf16 compute; both sum in f32, in another order),
    ≤ 1e-6 of the same f32 terms summed in float64, bit-equal to
    ``hashgrid_bwd_fixed_point`` (the kernel's int64 arithmetic in plain
    PyTorch), bit-identical from launch to launch and under a permutation of
    the points, NaN where the twin is not finite;
  * row gather: bit-equal to ``tab[idx]``.
"""

import math

import numpy as np
import pytest
import torch

from drawingspinup_torch.kernels import hashgrid as hk
from drawingspinup_torch.models import hashgrid as thg

# the production grid of neus-ortho.yaml: levels 0-3 dense, 4-9 hashed
PROD = dict(n_levels=10, n_features_per_level=2, log2_hashmap_size=19,
            base_resolution=32, per_level_scale=1.3195079107728942)
DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
          ("bfloat16", "float32")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _setup(tdt, cdt, n, seed, device, **kw):
    cfg = thg.HashGridConfig(**{**PROD, **kw}, table_dtype=tdt,
                             compute_dtype=cdt)
    g = torch.Generator().manual_seed(seed)
    tables = [(torch.randn(t.shape, generator=g) * 0.1).to(cfg.tdt)
              .to(device) for t in thg.init_table(cfg, g)]
    x = torch.rand((n, 3), generator=g)
    x[:8] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [1.0, 0.0, 0.5],
                          [0.0, 1.0, 1.0], [0.5, 0.5, 1.0], [1.0, 0.25, 0.0],
                          [0.999999, 1.0, 0.0], [0.0, 0.000001, 1.0]])
    return cfg, tables, x.to(device)


def _ulp_bound(want):
    """One bf16 ulp of the largest |value|."""
    m = float(want.float().abs().max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def _check_fwd(got, want, cdt):
    assert got.dtype == want.dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    if cdt == "float32":
        assert err <= 1e-5 * float(want.abs().max()), err
    else:
        assert err <= _ulp_bound(want), err


def _rel_l2(got, want):
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,cdt", DTYPES)
@pytest.mark.parametrize("n_active", [4, 6, 10])
@pytest.mark.parametrize("with_jac", [False, True])
def test_encode_kernel_matches_twin(tdt, cdt, n_active, with_jac,
                                    cuda_device):
    """Dense and hashed levels, points on the faces of the unit cube, fewer
    active levels than levels (the rest zero)."""
    cfg, tables, x = _setup(tdt, cdt, 5000, 1, cuda_device)
    spec = cfg.spec()
    enc, denc = hk.hashgrid_fwd(x, tables, spec, n_active, with_jac)
    ref, dref = hk.hashgrid_fwd_reference(x, tables, spec, n_active,
                                          with_jac)
    torch.cuda.synchronize()
    _check_fwd(enc, ref, cdt)
    assert not enc[:, n_active * 2:].any()
    if with_jac:
        _check_fwd(denc, dref, cdt)
        assert not denc[:, :, n_active * 2:].any()
    else:
        assert denc is None


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,cdt", DTYPES)
@pytest.mark.parametrize("cell_rows", [True, False])
def test_table_gradient_kernel_matches_twin(tdt, cdt, cell_rows,
                                            cuda_device):
    cfg, tables, x = _setup(tdt, cdt, 20000, 2, cuda_device,
                            dense_cell_rows=cell_rows)
    spec = cfg.spec()
    na = 6
    g = torch.Generator(device=cuda_device).manual_seed(3)
    lf = cfg.n_levels * 2
    g_enc = torch.randn((x.shape[0], lf), generator=g,
                        device=cuda_device).to(cfg.cdt)
    g_denc = torch.randn((3, x.shape[0], lf), generator=g,
                         device=cuda_device).to(cfg.cdt)
    for gd in (None, g_denc):
        got = hk.hashgrid_bwd(x, tables, spec, na, g_enc, gd)
        again = hk.hashgrid_bwd(x, tables, spec, na, g_enc, gd)
        want = hk.hashgrid_bwd_reference(x, tables, spec, na, g_enc, gd)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert len(got) == len(want) == na
        tol = 1e-5 if cdt == "float32" else 1e-2
        for lvl, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == torch.float32 and a.shape == tables[lvl].shape
            assert _rel_l2(a, b) <= tol, (lvl, _rel_l2(a, b))


def _cotangents(cfg, n, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    lf = cfg.n_levels * cfg.n_features_per_level
    return (torch.randn((n, lf), generator=g, device=device).to(cfg.cdt),
            torch.randn((3, n, lf), generator=g, device=device).to(cfg.cdt))


def _exact(x, tables, spec, na, g_enc, g_denc):
    """The kernel's own f32 terms (the twin's arithmetic) summed in
    float64."""
    out = []
    for lvl in range(na):
        idx, c = hk._level_terms(x, spec, lvl, g_enc, g_denc, torch.float32)
        buf = torch.zeros(tables[lvl].shape, dtype=torch.float64,
                          device=x.device)
        out.append(buf.index_add_(0, idx.reshape(-1),
                                  c.reshape(-1, spec.n_features).double()))
    return out


def _ray_points(n_rays, per_ray, device, seed):
    """Ray-ordered samples as an NSR step evaluates them: per ray a run of
    sorted samples along a straight segment (neighbouring lanes share the
    coarse levels' cells), rays one after another."""
    g = torch.Generator(device=device).manual_seed(seed)
    o = torch.rand((n_rays, 1, 3), generator=g, device=device)
    d = torch.nn.functional.normalize(
        torch.randn((n_rays, 1, 3), generator=g, device=device), dim=-1)
    t = torch.sort(torch.rand((n_rays, per_ray, 1), generator=g,
                              device=device), dim=1).values * 0.5
    return (o + d * t).clamp(0, 1).reshape(-1, 3).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,cdt", DTYPES)
@pytest.mark.parametrize("rays", [False, True])
def test_table_gradient_kernel_is_the_fixed_point_sum(tdt, cdt, rays,
                                                      cuda_device):
    """Bit-equal to hashgrid_bwd_fixed_point in f32 and in the table dtype,
    on uniform and on ray-ordered points; within 1e-6 of float64;
    bit-identical under a permutation."""
    cfg, tables, x = _setup(tdt, cdt, 16384, 7, cuda_device)
    if rays:
        x = _ray_points(256, 64, cuda_device, 8)
    spec = cfg.spec()
    na = 6
    ge, gd = _cotangents(cfg, x.shape[0], cuda_device, 9)
    for gdn in (None, gd):
        got = hk.hashgrid_bwd(x, tables, spec, na, ge, gdn)
        want = hk.hashgrid_bwd_fixed_point(x, tables, spec, na, ge, gdn)
        as_tab = hk.hashgrid_bwd(x, tables, spec, na, ge, gdn,
                                 out_dtype=cfg.tdt)
        exact = _exact(x, tables, spec, na, ge, gdn)
        perm = torch.randperm(x.shape[0], device=cuda_device)
        shuffled = hk.hashgrid_bwd(
            x[perm].contiguous(), tables, spec, na, ge[perm].contiguous(),
            gdn[:, perm].contiguous() if gdn is not None else None)
        torch.cuda.synchronize()
        for lvl in range(na):
            assert torch.equal(got[lvl], want[lvl]), lvl
            assert torch.equal(shuffled[lvl], got[lvl]), lvl
            assert as_tab[lvl].dtype == cfg.tdt
            assert torch.equal(as_tab[lvl], want[lvl].to(cfg.tdt)), lvl
            rel = float((got[lvl].double() - exact[lvl]).norm()
                        / exact[lvl].norm())
            assert rel <= 1e-6, (lvl, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_table_gradient_kernel_nan_and_zero(cdt, cuda_device):
    """NaN in the entries where the twin is not finite, the rest as the
    fixed-point sum; all-zero cotangents give zeros."""
    cfg, tables, x = _setup(cdt, cdt, 8192, 10, cuda_device)
    spec = cfg.spec()
    ge, gd = _cotangents(cfg, x.shape[0], cuda_device, 11)
    ge[10, 0] = math.nan
    gd[1, 20, 5] = math.inf
    gd[2, 30, 6] = -math.inf
    got = hk.hashgrid_bwd(x, tables, spec, 6, ge, gd)
    twin = hk.hashgrid_bwd_reference(x, tables, spec, 6, ge, gd)
    want = hk.hashgrid_bwd_fixed_point(x, tables, spec, 6, ge, gd)
    zero = hk.hashgrid_bwd(x, tables, spec, 6, torch.zeros_like(ge),
                           torch.zeros_like(gd))
    torch.cuda.synchronize()
    for lvl in range(6):
        bad = ~torch.isfinite(twin[lvl])
        assert bool(bad.any()) == (lvl in (0, 2, 3)), lvl
        assert bool(torch.isnan(got[lvl][bad]).all()), lvl
        assert bool(torch.isfinite(got[lvl][~bad]).all()), lvl
        assert torch.equal(got[lvl].nan_to_num(), want[lvl].nan_to_num())
        assert not zero[lvl].any() and not zero[lvl].isnan().any()


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,cdt", DTYPES[:2])
def test_encode_writes_the_inactive_columns(tdt, cdt, cuda_device):
    """The kernel zeroes the levels past n_active itself: memory that the
    caching allocator hands back full of NaN comes out zero there."""
    cfg, tables, x = _setup(tdt, cdt, 4099, 12, cuda_device)
    spec = cfg.spec()
    lf = cfg.n_levels * 2
    for jac in (False, True):
        torch.cuda.synchronize()
        poison = torch.full((4 * 4099 * lf + 4096,), math.nan,
                            dtype=cfg.cdt, device=cuda_device)
        del poison
        enc, denc = hk.hashgrid_fwd(x, tables, spec, 5, jac)
        ref, dref = hk.hashgrid_fwd_reference(x, tables, spec, 5, jac)
        torch.cuda.synchronize()
        assert not enc[:, 10:].any() and not enc.isnan().any()
        _check_fwd(enc, ref, cdt)
        if jac:
            assert not denc[:, :, 10:].any() and not denc.isnan().any()
            _check_fwd(denc, dref, cdt)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,cdt", DTYPES[:2])
def test_autograd_function_on_the_card(tdt, cdt, cuda_device):
    """encode_with_spatial_grad through the kernels: forward as the twin on
    the same tensors, table gradients of a linear functional as the twin's
    (cast once to the table dtype), and exactly one launch of each."""
    cfg, tables, x = _setup(tdt, cdt, 3000, 4, cuda_device)
    mask = (torch.arange(cfg.n_levels, device=cuda_device) < 5).float()
    leaves = [t.clone().requires_grad_(True) for t in tables]
    hk.FWD_JAC_LAUNCHES = hk.BWD_LAUNCHES = 0
    enc, denc = thg.encode_with_spatial_grad(leaves, x, cfg, mask, 5)
    w1 = torch.randn(enc.shape, device=cuda_device).to(enc.dtype)
    w2 = torch.randn(denc.shape, device=cuda_device).to(denc.dtype)
    ((enc * w1).float().sum() + (denc * w2).float().sum()).backward()
    torch.cuda.synchronize()
    assert hk.FWD_JAC_LAUNCHES == 1 and hk.BWD_LAUNCHES == 1
    spec = cfg.spec()
    ref, dref = hk.hashgrid_fwd_reference(x, tables, spec, 5, True)
    m = mask.repeat_interleave(2).to(ref.dtype)
    _check_fwd(enc[:, 3:], ref * m, cdt)
    _check_fwd(denc[:, :, 3:], dref * m, cdt)
    # the cotangents that reach the levels: the functional's weights past
    # the xyz prefix, through the level mask
    g_enc = w1[:, 3:].contiguous() * m
    g_denc = w2[:, :, 3:].contiguous() * m
    want = hk.hashgrid_bwd_reference(x, tables, spec, 5, g_enc, g_denc)
    for lvl, leaf in enumerate(leaves):
        if lvl >= 5:
            assert leaf.grad is None or not leaf.grad.any()
            continue
        tol = 1e-5 if cdt == "float32" else 1e-2
        assert leaf.grad.dtype == leaf.dtype
        assert _rel_l2(leaf.grad.float(), want[lvl].to(leaf.dtype).float()) \
            <= tol, lvl


@pytest.mark.cuda
@pytest.mark.parametrize("rows,dtype,cols", [(74 ** 3, torch.bfloat16, 16),
                                             (129 ** 3, torch.bfloat16, 16),
                                             (5000, torch.float32, 12),
                                             (777, torch.bfloat16, 2)])
def test_row_gather_is_bit_equal(rows, dtype, cols, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    tab = torch.randn((rows, cols), generator=g, device=cuda_device).to(dtype)
    idx = torch.randint(0, rows, (262144,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    idx[:2] = torch.tensor([0, rows - 1], device=cuda_device)
    n0 = hk.GATHER_LAUNCHES
    out = hk.row_gather(tab, idx)
    torch.cuda.synchronize()
    assert hk.GATHER_LAUNCHES == n0 + 1
    assert torch.equal(out, tab[idx.long()])


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    cfg, tables, x = _setup("float32", "float32", 10, 6, cuda_device)
    spec = cfg.spec()
    with pytest.raises(ValueError):
        hk.hashgrid_fwd(x.double(), tables, spec, 4, False)
    with pytest.raises(ValueError):
        hk.hashgrid_fwd(x, tables, spec, 0, False)
    with pytest.raises(ValueError):
        hk.hashgrid_fwd(x, [t.cpu() for t in tables], spec, 4, False)
    with pytest.raises(ValueError):
        hk.row_gather(tables[0], torch.zeros(3, dtype=torch.int64,
                                             device=cuda_device))
    g_enc = torch.zeros((10, 20), device=cuda_device)
    with pytest.raises(TypeError):
        hk.hashgrid_bwd(x, tables, spec, 4, g_enc, None,
                        out_dtype=torch.float64)
    with pytest.raises(ValueError):
        hk.hashgrid_bwd(x, tables, spec, 4, g_enc[:, :18], None)
    with pytest.raises(ValueError):
        hk.hashgrid_bwd(x, tables, spec, 4, g_enc.double(), None)
    with pytest.raises(ValueError):
        hk.hashgrid_bwd(x, tables, spec, 4, g_enc,
                        torch.zeros((2, 10, 20), device=cuda_device))
    with pytest.raises(ValueError):
        hk.hashgrid_bwd(x, tables, spec, 11, g_enc, None)
    with pytest.raises(ValueError):
        hk.HashGridFunction.apply(x.requires_grad_(True), spec, 4, False,
                                  *tables)
