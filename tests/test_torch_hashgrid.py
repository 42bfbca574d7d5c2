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
    port's gradient (f32 sums cast once) within relative L2 1e-2 of a
    float64 reference and no farther from it than JAX's (bf16 scatter-add).
"""

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
def test_table_gradient_matches_jax(tdt, cdt):
    """The table gradient of a random linear functional of enc and denc,
    with a masked level and a locked one (no gradient, no launch)."""
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
    ref = hk.hashgrid_bwd_reference(
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
    assert torch.equal(hk.gather_rows(tab, idx), tab[idx.long()])
    assert torch.equal(hk.row_gather_reference(tab, idx), tab[idx.long()])


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
