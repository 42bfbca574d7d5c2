"""PyTorch port: the hash-grid encode (``models/hashgrid.py`` over
``kernels/hashgrid.py``'s plain twins) against the JAX package's
``models/hashgrid.py``, forward, jacobian and table gradient.

Inputs are numpy draws handed to both. The grid has a dense level and three
hashed ones (base resolution 16, 2^13 rows). Tolerances:
  * f32: max |port − JAX| ≤ 1e-6 · max |JAX| (the two sum the 8 corners'
    f32 products in another association; measured ~1e-7);
  * bf16 compute: within one bf16 ulp of the largest output (the twin
    rounds after every product and sum as XLA does; measured bit-equal);
  * table gradients, f32: max |port − JAX| ≤ 1e-5 · max |JAX|; bf16: the
    port's gradient within relative L2 1e-2 of a float64 reference and no
    farther from it than JAX's (bf16 scatter-add); both for the CPU path,
    the kernel's fixed-point arithmetic (``hashgrid_bwd_fixed_point``, int64
    multiples of 2^-e_l), and for the plain twin (f32 sums cast once);
  * the fixed-point sums against the same f32 terms summed in float64:
    relative L2 ≤ 1e-6, and per entry |err| ≤ 2^-22 |exact| + 2^-40 B_l
    (one f32 rounding of the result, 2^-24 relative, plus at most 2^-(e_l+1)
    per term: with P = 2000 points and a few dozen terms a row that is
    ~2^-43 B_l); bit-identical under a permutation of the points.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from drawingspinup_tpu.models import hashgrid as jhg
from drawingspinup_torch.kernels import hashgrid as hk
from drawingspinup_torch.models import hashgrid as thg
from drawingspinup_torch.utils import jax_params

GRID = dict(n_levels=4, base_resolution=16, log2_hashmap_size=13)
DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
          ("bfloat16", "float32")]


def _configs(tdt, cdt, cell_rows=True, **kw):
    kw = dict(GRID, table_dtype=tdt, compute_dtype=cdt,
              dense_cell_rows=cell_rows, **kw)
    return jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)


def _tables(cfg, seed):
    rng = np.random.default_rng(seed)
    jt = tuple(jnp.asarray(
        rng.standard_normal((int(r + 1) ** 3 if cfg.is_dense(r)
                             else cfg.table_size, cfg.n_features_per_level)),
        jnp.dtype(cfg.table_dtype)) for r in cfg.level_resolutions())
    return jt, [jax_params._tensor(np.asarray(t)) for t in jt]


def _points(n, seed):
    """Uniform points, with the 8 cube corners (px == 0 and 1) first."""
    x = np.random.default_rng(seed).uniform(0, 1, (n, 3)).astype(np.float32)
    x[:8] = [[a, b, c] for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    return x


def _assert_close(got, want, cdt, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    big = np.abs(want).max()
    if cdt == "float32":
        tol = 1e-6 * big
    else:
        tol = 2.0 ** (np.floor(np.log2(big)) - 7)       # one bf16 ulp
    err = np.abs(got - want).max()
    assert err <= tol, (what, err, tol)


def test_grid_config_matches_jax():
    for kw in (GRID, {}, dict(GRID, dense_max_rows=1 << 14)):
        j, t = jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)
        np.testing.assert_array_equal(t.level_resolutions(),
                                      j.level_resolutions())
        assert [t.is_dense(r) for r in t.level_resolutions()] == \
            [j.is_dense(r) for r in j.level_resolutions()]
        assert t.n_output_dims == j.n_output_dims
        for step in (0, 999, 1000, 2500, 10 ** 6):
            assert t.current_level(step) == j.current_level(step)
            np.testing.assert_array_equal(
                thg.progressive_mask(t, step).numpy(),
                np.asarray(jhg.progressive_mask(j, jnp.asarray(step))))
            assert thg.finite_difference_eps(t, step) == pytest.approx(
                float(jhg.finite_difference_eps(j, jnp.asarray(step))),
                rel=1e-6)


@pytest.mark.parametrize("tdt,cdt", DTYPES)
@pytest.mark.parametrize("cell_rows", [True, False])
@pytest.mark.parametrize("n_active", [None, 3])
def test_encode_matches_jax(tdt, cdt, cell_rows, n_active):
    """encode and encode_with_spatial_grad, dense and hashed levels, corner
    points (px == 0 and 1: the cell-row slope is one-sided there), a level
    mask with a hole, and levels past n_active."""
    jc, tc = _configs(tdt, cdt, cell_rows)
    jt, tt = _tables(jc, 1)
    x = _points(300, 2)
    mask = np.array([1, 1, 0, 1], np.float32)
    je, jd = jhg.encode_with_spatial_grad(jt, jnp.asarray(x), jc,
                                          jnp.asarray(mask), n_active)
    te, td = thg.encode_with_spatial_grad(tt, torch.from_numpy(x), tc,
                                          torch.from_numpy(mask), n_active)
    assert te.dtype == getattr(torch, cdt)
    _assert_close(te, je, cdt, "enc")
    _assert_close(td, jd, cdt, "denc")
    j0 = jhg.encode(jt, jnp.asarray(x), jc, jnp.asarray(mask), n_active)
    t0 = thg.encode(tt, torch.from_numpy(x), tc, torch.from_numpy(mask),
                    n_active)
    _assert_close(t0, j0, cdt, "encode")
    # no mask, no xyz
    jc2, tc2 = _configs(tdt, cdt, cell_rows, include_xyz=False)
    _assert_close(thg.encode(tt, torch.from_numpy(x), tc2, None, n_active),
                  jhg.encode(jt, jnp.asarray(x), jc2, None, n_active), cdt,
                  "encode, no mask")


def test_cell_row_slope_is_one_sided_at_the_far_face():
    """px == 1 on the dense level: with cell rows the x-slope is the last
    cell's (nonzero), without it is 0, in both packages."""
    x = np.array([[1.0, 0.3, 0.6]], np.float32)
    for cell_rows, nonzero in ((True, True), (False, False)):
        jc, tc = _configs("float32", "float32", cell_rows, n_levels=1)
        jt, tt = _tables(jc, 3)
        _, td = thg.encode_with_spatial_grad(tt, torch.from_numpy(x), tc)
        _, jd = jhg.encode_with_spatial_grad(jt, jnp.asarray(x), jc)
        assert bool((td[0, 0, 3:] != 0).any()) == nonzero
        _assert_close(td, jd, "float32", "denc at px == 1")


@pytest.mark.parametrize("tdt,cdt", DTYPES[:2])
def test_table_gradient_matches_jax(tdt, cdt, monkeypatch):
    """The table gradient of a random linear functional of enc and denc,
    with a masked level and a locked one (no gradient, no launch), summed
    by the plain twin (f32 ``index_add_``, cast once to the table dtype)."""
    monkeypatch.setattr(
        hk, "hashgrid_bwd_fixed_point",
        lambda *args, out_dtype: [g.to(out_dtype) for g in _TWIN(*args)])
    _check_table_gradient(tdt, cdt)


@pytest.mark.parametrize("tdt,cdt", DTYPES[:2])
def test_fixed_point_gradient_matches_jax(tdt, cdt):
    """The same on the CPU path as it runs, summing as the kernel does: int64
    multiples of 2^-e_l, converted once to f32 and cast to the table dtype
    (the kernel writes that dtype itself, rounding from f32 the same way)."""
    _check_table_gradient(tdt, cdt)


def _check_table_gradient(tdt, cdt):
    jc, tc = _configs(tdt, cdt)
    jt, _ = _tables(jc, 4)
    x = _points(2000, 5)
    rng = np.random.default_rng(6)
    d = jc.n_output_dims
    a = rng.standard_normal((x.shape[0], d)).astype(np.float32)
    b = rng.standard_normal((3, x.shape[0], d)).astype(np.float32)
    mask = np.array([1, 0, 1, 1], np.float32)

    def loss(t):
        e, dd = jhg.encode_with_spatial_grad(t, jnp.asarray(x), jc,
                                             jnp.asarray(mask), 3)
        return jnp.sum(e.astype(jnp.float32) * a) \
            + jnp.sum(dd.astype(jnp.float32) * b)

    jg = jax.grad(loss)(jt)
    tt = [jax_params._tensor(np.asarray(t)).requires_grad_(True) for t in jt]
    e, dd = thg.encode_with_spatial_grad(tt, torch.from_numpy(x), tc,
                                         torch.from_numpy(mask), 3)
    ((e.float() * torch.from_numpy(a)).sum()
     + (dd.float() * torch.from_numpy(b)).sum()).backward()
    assert tt[3].grad is None                       # locked level
    tgrads = [t.grad for t in tt[:3]]
    assert all(g.dtype == getattr(torch, tdt) for g in tgrads)
    if tdt == "float32":
        for lvl, g in enumerate(tgrads):
            want = np.asarray(jg[lvl])
            err = np.abs(g.numpy() - want).max()
            assert err <= 1e-5 * np.abs(want).max(), (lvl, err)
        return
    # bf16: both against the float64 twin on the same table values
    spec = hk.GridSpec(**{**tc.spec().__dict__, "compute_dtype": "float64"})
    m = torch.from_numpy(np.repeat(mask, 2)).double()
    ref = _TWIN(
        torch.from_numpy(x).double(), [t.detach().double() for t in tt], spec,
        3, torch.from_numpy(a[:, 3:]).double() * m,
        torch.from_numpy(b[:, :, 3:]).double() * m)
    for lvl, g in enumerate(tgrads):
        r = ref[lvl].numpy()
        norm = np.linalg.norm(r)
        if norm == 0:                                # the masked level
            assert not g.float().abs().sum() and not np.any(jg[lvl])
            continue
        port = np.linalg.norm(g.float().numpy() - r) / norm
        jax_err = np.linalg.norm(np.asarray(jg[lvl], np.float32) - r) / norm
        assert port <= 1e-2 and port <= jax_err, (lvl, port, jax_err)


_TWIN = hk.hashgrid_bwd_reference


def _fixed_point_case(cdt, jac, n=2000, seed=7):
    """(x, tables, spec, n_active, g_enc, g_denc) at the test grid, all
    four levels active, cotangents N(0, 1) in the compute dtype."""
    _, tc = _configs("float32", cdt)
    tabs = thg.init_table(tc, torch.Generator().manual_seed(seed))
    x = torch.from_numpy(_points(n, seed))
    rng = np.random.default_rng(seed + 1)
    lf = tc.n_levels * tc.n_features_per_level
    g_enc = torch.from_numpy(rng.standard_normal((n, lf)).astype(np.float32))
    g_denc = torch.from_numpy(
        rng.standard_normal((3, n, lf)).astype(np.float32)) if jac else None
    cast = (lambda g: g.to(tc.cdt) if g is not None else None)
    return x, tabs, tc.spec(), tc.n_levels, cast(g_enc), cast(g_denc)


def _exact(x, tabs, spec, na, g_enc, g_denc):
    """The kernel's own f32 terms summed in float64."""
    out = []
    for lvl in range(na):
        idx, c = hk._level_terms(x, spec, lvl, g_enc, g_denc, torch.float32)
        buf = torch.zeros(tabs[lvl].shape, dtype=torch.float64)
        out.append(buf.index_add_(0, idx.reshape(-1),
                                  c.reshape(-1, spec.n_features).double()))
    return out


def _bounds(spec, na, g_enc, g_denc):
    """B_l of each level, as the kernel's scale pass forms it."""
    nf = spec.n_features
    out = []
    for lvl in range(na):
        cols = slice(lvl * nf, (lvl + 1) * nf)
        m = [float(g_enc[:, cols].float().abs().max())]
        if g_denc is not None:
            m += [float(g_denc[k, :, cols].float().abs().max())
                  for k in range(3)]
        out.append(hk.level_bound(spec.res[lvl], *m))
    return out


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("jac", [True, False])
def test_fixed_point_gradient_is_float64_accurate(cdt, jac):
    x, tabs, spec, na, ge, gd = _fixed_point_case(cdt, jac)
    got = hk.hashgrid_bwd_fixed_point(x, tabs, spec, na, ge, gd)
    want = _exact(x, tabs, spec, na, ge, gd)
    plain = hk.hashgrid_bwd_reference(x, tabs, spec, na, ge, gd)
    for lvl, (g, w, b) in enumerate(zip(got, want, _bounds(spec, na, ge, gd))):
        assert g.dtype == torch.float32
        err = (g.double() - w).abs()
        rel = float(err.norm() / w.norm())
        assert rel <= 1e-6, (lvl, rel)
        assert bool((err <= 2.0 ** -22 * w.abs() + 2.0 ** -40 * b).all()), lvl
        # the twin's sequential f32 sum, for scale (not bounded here)
        assert float((plain[lvl].double() - w).norm() / w.norm()) < 1e-5


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_fixed_point_gradient_is_permutation_invariant(cdt):
    x, tabs, spec, na, ge, gd = _fixed_point_case(cdt, True)
    perm = torch.from_numpy(np.random.default_rng(9).permutation(len(x)))
    got = hk.hashgrid_bwd_fixed_point(x, tabs, spec, na, ge, gd)
    again = hk.hashgrid_bwd_fixed_point(x[perm], tabs, spec, na, ge[perm],
                                        gd[:, perm])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_fixed_point_gradient_of_a_tiny_row():
    """A row fed only by terms ~1e-9 B_l keeps its value: the error is at
    most 2^-(e_l+1) per term, here 2^-50 against terms of 1.25e-10 (a
    relative error up to ~3.6e-6; in general n P 2^-59 B_l / |sum| for n
    terms, so a row's relative error passes f32's 2^-24 only where its sum
    is under ~2^-35 P n B_l)."""
    _, tc = _configs("float32", "float32", n_levels=1)
    spec = tc.spec()
    tabs = thg.init_table(tc, torch.Generator().manual_seed(0))
    r = spec.res[0]
    n = 1000
    rng = np.random.default_rng(10)
    x = rng.uniform(0, 0.5, (n, 3)).astype(np.float32)
    x[-1] = (r - 0.5) / r                    # a cell centre none else reaches
    g = np.ones((n, spec.n_features), np.float32)
    g[-1] = 1e-9
    x, g = torch.from_numpy(x), torch.from_numpy(g)
    got = hk.hashgrid_bwd_fixed_point(x, tabs, spec, 1, g, None)[0]
    want = _exact(x, tabs, spec, 1, g, None)[0]
    e = hk.fixed_point_exponent(1.0, n)
    assert e == 62 - 13
    idx = hk._corners(x[-1:], r, spec.dense[0], spec.cell_rows,
                      spec.table_size)[0].reshape(-1)
    tiny = want[idx]
    assert bool((tiny - 1.25e-10).abs().max() < 1e-16)
    err = (got[idx].double() - tiny).abs()
    assert bool((err <= 2.0 ** -(e + 1) + 2.0 ** -24 * tiny).all())
    assert float((err / tiny).max()) < 4e-6


def test_fixed_point_gradient_is_nan_where_the_twin_is_not_finite():
    x, tabs, spec, na, ge, gd = _fixed_point_case("float32", True)
    ge, gd = ge.clone(), gd.clone()
    ge[10, 0] = math.nan                     # level 0, feature 0
    gd[1, 20, 5] = math.inf                  # level 2, feature 1
    gd[2, 30, 6] = -math.inf                 # level 3, feature 0
    got = hk.hashgrid_bwd_fixed_point(x, tabs, spec, na, ge, gd)
    twin = hk.hashgrid_bwd_reference(x, tabs, spec, na, ge, gd)
    want = _exact(x, tabs, spec, na, ge, gd)
    for lvl, (g, t, w) in enumerate(zip(got, twin, want)):
        bad = ~torch.isfinite(t)
        assert bool(bad.any()) == (lvl != 1), lvl
        assert bool(torch.isnan(g[bad]).all())
        assert bool(torch.isfinite(g[~bad]).all())
        ok = torch.isfinite(w)
        assert torch.equal(ok, ~bad)
        rel = float((g[ok].double() - w[ok]).norm() / w[ok].norm())
        assert rel <= 1e-6, (lvl, rel)


def test_fixed_point_gradient_of_zero_cotangents():
    x, tabs, spec, na, ge, gd = _fixed_point_case("float32", True)
    got = hk.hashgrid_bwd_fixed_point(x, tabs, spec, na, torch.zeros_like(ge),
                                      torch.zeros_like(gd))
    assert hk.fixed_point_exponent(0.0, len(x)) == 0
    assert all(not g.any() and not g.isnan().any() for g in got)


@pytest.mark.parametrize("bound", [1.0, 0.75, 3e-30, 7.5e29, -1.0])
def test_fixed_point_exponent_at_the_overflow_edge(bound):
    """All 8P terms of a level at ±B_l (and at B_l (1 + 2^-7), the most the
    weights' and slopes' roundings add) into one row: the int64 sum is
    exact, inside int64, and converts back to the float64 sum."""
    p = 1 << 15
    e = hk.fixed_point_exponent(abs(bound), p)
    # B = 1 makes 8 P B a power of two: no headroom from the ceil
    assert 2.0 ** 61 < 8 * p * abs(bound) * 2.0 ** e <= 2.0 ** 62
    for t in (bound, bound * (1 + 2.0 ** -7)):
        terms = torch.full((8 * p, 1), np.float32(t), dtype=torch.float32)
        idx = torch.zeros(8 * p, dtype=torch.int64)
        acc, bad = hk.fixed_point_sum(idx, terms, 1, e)
        q = round(float(np.float32(t)) * 2.0 ** e)
        assert abs(q * 8 * p) < 2 ** 63 and int(acc[0, 0]) == q * 8 * p
        assert not bad.any()
        got = float(acc[0, 0]) * 2.0 ** -e
        want = 8 * p * float(np.float32(t))
        assert abs(got - want) <= 2.0 ** -40 * abs(want)


def test_init_table_layout():
    _, tc = _configs("bfloat16", "bfloat16")
    tabs = thg.init_table(tc, torch.Generator().manual_seed(0))
    jc, _ = _configs("bfloat16", "bfloat16")
    want = jhg.init_table(jc, jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in tabs] == [w.shape for w in want]
    assert all(t.dtype == torch.bfloat16 for t in tabs)
    assert all(float(t.float().abs().max()) <= 1.01e-4 for t in tabs)


def test_row_gather_twin_and_dispatch():
    tab = torch.randn(50, 16, dtype=torch.float32).to(torch.bfloat16)
    idx = torch.tensor([3, 0, 49, 3, 17], dtype=torch.int32)
    assert torch.equal(hk.row_gather_reference(tab, idx), tab[idx.long()])
    with pytest.raises(ValueError, match="CUDA"):
        hk.row_gather(tab, idx)


def test_kernel_wrappers_reject_cpu_tensors():
    """The CUDA wrappers raise on CPU tensors before building anything; the
    autograd Function refuses positions that need a gradient."""
    _, tc = _configs("float32", "float32")
    tabs = thg.init_table(tc, torch.Generator().manual_seed(0))
    x = torch.rand(10, 3)
    spec = tc.spec()
    with pytest.raises(ValueError, match="CUDA"):
        hk.hashgrid_fwd(x, tabs, spec, 2, False)
    with pytest.raises(ValueError, match="CUDA"):
        hk.hashgrid_bwd(x, tabs, spec, 2, torch.zeros(10, 8), None)
    with pytest.raises(ValueError, match="CUDA"):
        hk.row_gather(torch.zeros(4, 16), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="grad"):
        hk.HashGridFunction.apply(x.requires_grad_(True), spec, 2, False,
                                  *tabs)
    from drawingspinup_torch.kernels import _build
    assert _build._ext is None
