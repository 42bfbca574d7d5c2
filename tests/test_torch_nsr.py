"""PyTorch port, stage 2b: the NSR fields, renderer, visual hull, losses,
optimizer and one whole training step against the JAX package.

Inputs come from numpy seeds or from JAX's own init, converted through
``utils/jax_params.py``; a step's random draws are re-created from JAX's
key and injected. Small config: 4 levels (one dense, three hashed), base
resolution 16, 2^13 rows, 32-wide MLPs, 256 rays of 16 + 16 samples, 64²
views. Tolerances (each test states its own):
  * f32: losses within relative 1e-4, gradients, updates and Adam moments
    within relative L2 1e-4 (measured ≤ 2e-5: summation order);
  * bf16 compute and tables: losses within relative 1e-2, MLP gradients
    within relative L2 5e-2 (measured ≤ 2.5e-2: bf16 rounding at other
    places). The bf16 table gradients are dominated by bf16 rounding in
    both packages (each ~35-55 % from the f32-compute gradient on the same
    tables, measured); the port's must be no farther from that f32
    gradient than 1.25 × JAX's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from drawingspinup_tpu.core import UidPaths as JPaths
from drawingspinup_tpu.models import fields as jf
from drawingspinup_tpu.models import hashgrid as jhg
from drawingspinup_tpu.pipelines import stage2_recon as js2
from drawingspinup_tpu.render import hull as jhull
from drawingspinup_tpu.render import neus as jneus
from drawingspinup_tpu.render.cameras import view_matrices
from drawingspinup_tpu.train import losses as jL
from drawingspinup_tpu.train import nsr as jnsr
from drawingspinup_torch.models import fields as tf
from drawingspinup_torch.models import hashgrid as thg
from drawingspinup_torch.render import hull as thull
from drawingspinup_torch.render import neus as tneus
from drawingspinup_torch.train import losses as tL
from drawingspinup_torch.train import nsr as tnsr
from drawingspinup_torch.utils import jax_params
from drawingspinup_torch.utils.synthetic import write_sphere_mv

N_ACTIVE = 3


def configs(tdt="float32", cdt="float32", **kw):
    """(JAX NSRConfig, port NSRConfig) of the small test config."""
    kw = {"max_steps": 120, "constant_steps": 40, **kw}
    out = []
    for nsr, fields, hg in ((jnsr, jf, jhg), (tnsr, tf, thg)):
        grid = hg.HashGridConfig(n_levels=4, base_resolution=16,
                                 log2_hashmap_size=13, table_dtype=tdt,
                                 compute_dtype=cdt, start_level=3,
                                 update_steps=50)
        out.append(nsr.NSRConfig(
            sdf=fields.SDFFieldConfig(grid=grid, mlp=fields.MLPConfig(
                n_neurons=32, n_hidden_layers=1, sphere_init=True,
                weight_norm=True)),
            radiance=fields.RadianceConfig(mlp=fields.MLPConfig(
                n_neurons=32, n_hidden_layers=2,
                output_activation="sigmoid")),
            train_num_rays=256, n_coarse=16, n_fine=16, n_random_pts=256,
            cos_anneal_end=200, **kw))
    return out


def t(a):
    return torch.from_numpy(np.array(a))


def rel(got, want):
    got, want = (x.detach().float().numpy() if torch.is_tensor(x) else x
                 for x in (got, want))
    want = np.asarray(want, np.float32)
    n = np.linalg.norm(want)
    return np.linalg.norm(np.asarray(got, np.float32) - want) / (n or 1.0)


@pytest.fixture(scope="module")
def sphere_data(tmp_path_factory):
    """The JAX loader's data for a 64² synthetic sphere uid, as JAX arrays
    and as the port's tensors (with the packed pixel table)."""
    root = str(tmp_path_factory.mktemp("sphere"))
    write_sphere_mv(root, "s", size=64)
    jdata = js2.load_ortho_data(JPaths(root, "s"), im_size=64)
    tdata = {k: t(v) for k, v in jdata.items()}
    tdata["pixels"] = tnsr.pack_pixels(tdata)
    return jdata, tdata


# ---------------------------------------------------------------------------
# (b) fields
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tdt,cdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16")])
def test_fields_match_jax(tdt, cdt):
    """sdf_forward, sdf_with_grad_analytic, sdf_with_grad (FD), radiance and
    inv_s at JAX's init (tables re-drawn at scale 0.1 so they matter).
    f32: relative 1e-5 of each output's largest value; bf16: 2e-2."""
    jc, tc = configs(tdt, cdt)
    params = jax.device_get(jnsr.init_params(jc, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    params["geometry"]["table"] = tuple(
        jnp.asarray(rng.standard_normal(np.shape(x)) * 0.1, jnp.dtype(tdt))
        for x in params["geometry"]["table"])
    tp = jax_params.nsr_params(params, requires_grad=False)
    x = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    mask = np.array([1, 1, 1, 0], np.float32)
    tol = 1e-5 if cdt == "float32" else 2e-2

    def close(got, want, what):
        want = np.asarray(want, np.float32)
        got = got.detach().float().numpy()
        assert got.shape == want.shape, what
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= tol, (what, err)

    j = jf.sdf_forward(jc.sdf, params["geometry"], jnp.asarray(x),
                       jnp.asarray(mask), N_ACTIVE)
    p = tf.sdf_forward(tc.sdf, tp["geometry"], t(x), t(mask), N_ACTIVE)
    close(p[0], j[0], "sdf")
    close(p[1], j[1], "feature")
    j = jf.sdf_with_grad_analytic(jc.sdf, params["geometry"], jnp.asarray(x),
                                  jnp.asarray(mask), N_ACTIVE)
    p = tf.sdf_with_grad_analytic(tc.sdf, tp["geometry"], t(x), t(mask),
                                  N_ACTIVE)
    for k, what in enumerate(("sdf", "grad", "feature")):
        close(p[k], j[k], "analytic " + what)
    j = jf.sdf_with_grad(jc.sdf, params["geometry"], jnp.asarray(x), 1e-2,
                         jnp.asarray(mask), with_laplace=True,
                         n_active=N_ACTIVE)
    p = tf.sdf_with_grad(tc.sdf, tp["geometry"], t(x), 1e-2, t(mask),
                         with_laplace=True, n_active=N_ACTIVE)
    if cdt == "float32":     # FD of bf16 sdf values is rounding noise
        # the difference quotients divide the sdf's last-bit differences
        # by 2·eps (grad) and eps² (laplace): 1e-4 and 1e-2 of their peaks
        for k, what, ftol in ((0, "sdf", tol), (1, "grad", 1e-4),
                              (2, "feature", tol), (3, "laplace", 1e-2)):
            err = np.abs(p[k].detach().numpy() - np.asarray(j[k])).max() \
                / np.abs(np.asarray(j[k])).max()
            assert err <= ftol, ("FD " + what, err)
    feat = rng.standard_normal((50, 7, 13)).astype(np.float32)
    nrm = rng.standard_normal((50, 7, 3)).astype(np.float32)
    close(tf.radiance_forward(tc.radiance, tp["texture"], t(feat), None,
                              t(nrm)),
          jf.radiance_forward(jc.radiance, params["texture"],
                              jnp.asarray(feat), None, jnp.asarray(nrm)),
          "radiance")
    assert float(tf.inv_s(tp["variance"])) == pytest.approx(
        float(jf.inv_s(params["variance"])), rel=1e-6)
    for kind in ("aabb", "sphere"):
        np.testing.assert_allclose(
            tf.contract(t(x * 1.3), 1.0, kind).numpy(),
            np.asarray(jf.contract(jnp.asarray(x * 1.3), 1.0, kind)),
            rtol=1e-6, atol=1e-7)


def test_init_params_layout_matches_jax():
    jc, tc = configs("bfloat16", "bfloat16")
    want = jax.device_get(jnsr.init_params(jc, jax.random.PRNGKey(0)))
    got = tnsr.init_params(tc, torch.Generator().manual_seed(0))
    jn = dict(tnsr.named_leaves(want))
    tn = dict(tnsr.named_leaves(got))
    assert sorted(jn) == sorted(tn)
    for n, v in tn.items():
        assert tuple(v.shape) == np.shape(jn[n]), n
        assert str(v.dtype).split(".")[-1] == np.asarray(jn[n]).dtype.name, n
        assert v.requires_grad
    # sphere init: the SDF at the origin is about -radius
    sdf, _ = tf.sdf_forward(tc.sdf, got["geometry"], torch.zeros(1, 3))
    assert float(sdf) == pytest.approx(-0.5, abs=0.1)


# ---------------------------------------------------------------------------
# (c) renderer, hull, losses
# ---------------------------------------------------------------------------

def test_neus_render_functions_match_jax():
    """aabb_intersect, stratified_samples, sample_pdf (jitter injected),
    neus_alpha, composite: f32 within 1e-5 relative (sample_pdf: the cdf
    cumsum's order; counts identical)."""
    rng = np.random.default_rng(2)
    r, s, n = 64, 16, 24
    ro = rng.uniform(-2, 2, (r, 3)).astype(np.float32)
    rd = rng.standard_normal((r, 3)).astype(np.float32)
    rd[:4, 0] = 0.0                          # axis-parallel rays
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    jn, jf_ = jneus.aabb_intersect(jnp.asarray(ro), jnp.asarray(rd), 1.0)
    tn, tf_ = tneus.aabb_intersect(t(ro), t(rd), 1.0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    np.testing.assert_allclose(tf_.numpy(), np.asarray(jf_), rtol=1e-6)

    near = rng.uniform(0, 1, r).astype(np.float32)
    far = near + rng.uniform(0.1, 2, r).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jt = jneus.stratified_samples(key, jnp.asarray(near), jnp.asarray(far), s,
                                  True)
    jit = np.asarray(jax.random.uniform(key, (r, s)))
    tt = tneus.stratified_samples(t(near), t(far), s, t(jit))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    w = rng.uniform(0, 1, (r, s)).astype(np.float32) ** 4
    key2 = jax.random.PRNGKey(4)
    jp = jneus.sample_pdf(key2, jt, jnp.asarray(w), n, True)
    tp = tneus.sample_pdf(tt, t(w), n, t(jax.random.uniform(key2, (r, n))))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6)
    # without jitter, u sits on bin edges: a last-bit cdf difference
    # divided by a narrow bin's mass moves a sample by up to 1e-4 relative
    np.testing.assert_allclose(
        tneus.sample_pdf(tt, t(w), n, None).numpy(),
        np.asarray(jneus.sample_pdf(None, jt, jnp.asarray(w), n, False)),
        rtol=1e-4, atol=1e-6)

    sdf = rng.standard_normal((r, s)).astype(np.float32) * 0.3
    nrm = rng.standard_normal((r, s, 3)).astype(np.float32)
    dirs = np.broadcast_to(rd[:, None], (r, s, 3)).copy()
    dists = rng.uniform(0.01, 0.1, (r, s)).astype(np.float32)
    ja = jneus.neus_alpha(jnp.asarray(sdf), jnp.asarray(nrm),
                          jnp.asarray(dirs), jnp.asarray(dists),
                          jnp.float32(20.0), jnp.float32(0.3))
    ta = tneus.neus_alpha(t(sdf), t(nrm), t(dirs), t(dists),
                          torch.tensor(20.0), 0.3)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-7)
    vals = {"rgb": rng.uniform(0, 1, (r, s, 3)).astype(np.float32)}
    jc_ = jneus.composite(ja, {k: jnp.asarray(v) for k, v in vals.items()})
    tc_ = tneus.composite(ta, {k: t(v) for k, v in vals.items()})
    for k in jc_:
        np.testing.assert_allclose(tc_[k].numpy(), np.asarray(jc_[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("compute_hw", [None, 16])
def test_hull_t_ranges_match_jax(compute_hw):
    """The hull intervals of 6 views of a blob, marched at the mask size
    and at a quarter of it (bilinear upsampling, borders included): within
    1e-5 of the span."""
    views = ["front", "front_right", "right", "back", "left", "front_left"]
    c2w, _ = view_matrices(views)
    yy, xx = np.mgrid[0:64, 0:64]
    rng = np.random.default_rng(5)
    masks = np.stack([(np.hypot(yy - 32 + rng.integers(-4, 4),
                                xx - 32 + rng.integers(-4, 4)) < 14 + v)
                      for v in range(6)]).astype(np.float32)
    want = np.asarray(jhull.hull_t_ranges(jnp.asarray(masks),
                                          jnp.asarray(c2w), 1.0,
                                          compute_hw=compute_hw,
                                          dilate_px=3))
    got = thull.hull_t_ranges(t(masks), t(c2w), 1.0, compute_hw=compute_hw,
                              dilate_px=3).numpy()
    assert got.shape == want.shape == (6, 64, 64, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (want[..., 1] - want[..., 0]).min() > 0


def test_losses_match_jax():
    rng = np.random.default_rng(6)
    n = 300
    err = rng.uniform(0, 1, n).astype(np.float32)
    err[10:20] = err[0]                                  # ties
    mask = rng.uniform(0, 1, n) > 0.3
    w = rng.uniform(0.5, 2, n).astype(np.float32)
    for kw in ({}, {"mask": mask}, {"mask": mask, "extra_weights": w},
               {"extra_weights": w, "reduction": "sum"}):
        jkw = {k: jnp.asarray(v) if not isinstance(v, str) else v
               for k, v in kw.items()}
        tkw = {k: t(v) if not isinstance(v, str) else v
               for k, v in kw.items()}
        assert float(tL.ranking_loss(t(err), 0.8, **tkw)) == pytest.approx(
            float(jL.ranking_loss(jnp.asarray(err), 0.8, **jkw)), rel=1e-6)
    g = rng.standard_normal((n, 3)).astype(np.float32)
    g2 = g + rng.standard_normal((n, 3)).astype(np.float32) * 0.1
    pairs = [
        (tL.eikonal_loss(t(g)), jL.eikonal_loss(jnp.asarray(g))),
        (tL.eikonal_loss(t(g), t(mask)),
         jL.eikonal_loss(jnp.asarray(g), jnp.asarray(mask))),
        (tL.sparsity_loss(t(err - 0.5)),
         jL.sparsity_loss(jnp.asarray(err - 0.5))),
        (tL.normal_smooth_loss(t(g), t(g2)),
         jL.normal_smooth_loss(jnp.asarray(g), jnp.asarray(g2))),
    ]
    for got, want in pairs:
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(
        tL.binary_cross_entropy(t(err), t(mask.astype(np.float32))).numpy(),
        np.asarray(jL.binary_cross_entropy(jnp.asarray(err),
                                           jnp.asarray(mask, jnp.float32))),
        rtol=1e-6)
    np.testing.assert_allclose(
        tL.cosine_similarity(t(g), t(g2)).numpy(),
        np.asarray(jL.cosine_similarity(jnp.asarray(g), jnp.asarray(g2))),
        rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# (d) one whole training step, and the optimizer
# ---------------------------------------------------------------------------

def jax_draws(cfg, key, v, h, w):
    """The draws of ``jnsr.train_step(..., key)``, re-created from its key
    in the order the JAX step splits it, as the port's ``Draws``."""
    k_pix, k_render = jax.random.split(key)
    kv, ky, kx = jax.random.split(k_pix, 3)
    r = cfg.train_num_rays
    rk = jax.random.split(k_render, 3)
    k1, k2 = jax.random.split(rk[2])
    return tnsr.Draws(
        t(jax.random.randint(kv, (r,), 0, v)).long(),
        t(jax.random.randint(ky, (r,), 0, h)).long(),
        t(jax.random.randint(kx, (r,), 0, w)).long(),
        t(jax.random.uniform(rk[0], (r, cfg.n_coarse))),
        t(jax.random.uniform(rk[1], (r, cfg.n_fine))),
        t(jax.random.uniform(k1, (cfg.n_random_pts, 3), minval=-1.0,
                             maxval=1.0)),
        t(jax.random.normal(k2, (cfg.n_random_pts, 3))))


def jax_step_parts(cfg, tx, state, data, key):
    """JAX's gradients, logs and updated state for ``key``, as
    ``jnsr.train_step`` computes them (value_and_grad of the same loss,
    then the optimizer)."""
    k_pix, k_render = jax.random.split(key)
    ro, rd, targets = jnsr.sample_pixel_rays(k_pix, data, cfg.train_num_rays)
    t_range = targets.pop("t_range")

    def loss_fn(p):
        out = jnsr.render_rays(cfg, p, ro, rd, k_render, state.step,
                               train=True, n_active=N_ACTIVE,
                               t_range=t_range)
        out["rays_d"] = rd
        return jnsr.compute_losses(cfg, out, targets)

    (_, logs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params)
    updates, opt_state = jax.jit(tx.update)(grads, state.opt_state,
                                            state.params)
    import optax
    params = optax.apply_updates(state.params, updates)
    return logs, grads, jnsr.TrainState(params, opt_state, state.step + 1)


@pytest.mark.parametrize("tdt,cdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16")])
def test_train_step_matches_jax(tdt, cdt, sphere_data):
    """Two steps of ``jnsr.train_step``, then the third from the converted
    state with JAX's draws injected: logs, gradients, updates, Adam moments
    and count."""
    jdata, tdata = sphere_data
    jc, tc = configs(tdt, cdt)
    tx = jnsr.make_optimizer(jc)
    state = jnsr.init_state(jc, jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    for _ in range(2):
        key, k = jax.random.split(key)
        state, _ = jnsr.train_step(jc, tx, state, jdata, k,
                                   n_active=N_ACTIVE)
    key, k = jax.random.split(key)
    jlogs, jgrads, new = jax_step_parts(jc, tx, state, jdata, k)

    host = jax.device_get(state.params)
    mu, nu, count = jax_params.nsr_opt_state(state.opt_state)
    assert count == 2
    ts = tnsr.TrainState(jax_params.nsr_params(host),
                         tnsr.OptState(mu, nu, count), int(state.step))
    tlogs = tnsr.loss_and_grads(tc, ts, tdata, jax_draws(jc, k, 6, 64, 64),
                                n_active=N_ACTIVE)
    tgrads = {n: p.grad for n, p in tnsr.named_leaves(ts.params)}
    tnsr.make_optimizer(tc).step(ts.params, ts.opt_state)
    assert ts.opt_state.count == 3

    f32 = tdt == "float32"
    loss_tol, grad_tol = (1e-4, 1e-4) if f32 else (1e-2, 5e-2)
    for name, v in jlogs.items():
        assert float(tlogs[name]) == pytest.approx(float(v), rel=loss_tol), \
            name
    jmu, jnu, jcount = jax_params.nsr_opt_state(new.opt_state)
    assert jcount == 3
    old = dict(tnsr.named_leaves(host))
    jnew = dict(tnsr.named_leaves(jax.device_get(new.params)))
    for n, jg in tnsr.named_leaves(jax.device_get(jgrads)):
        p = dict(tnsr.named_leaves(ts.params))[n]
        assert p.dtype == jax_params._tensor(jnew[n]).dtype, n
        if n.startswith("geometry.table.") and int(n[-1]) >= N_ACTIVE:
            assert tgrads[n] is None and not np.any(jg), n   # locked level
            assert torch.equal(p, jax_params._tensor(old[n])), n
            continue
        if not f32 and n.startswith("geometry.table."):
            continue                           # below, against f32 compute
        assert rel(tgrads[n], jg) <= grad_tol, (n, rel(tgrads[n], jg))
        if f32:          # the update itself
            step_j = np.asarray(jnew[n], np.float32) - np.asarray(
                old[n], np.float32)
            step_t = p.detach().numpy() - np.asarray(old[n], np.float32)
            assert rel(step_t, step_j) <= 1e-4, n
        assert rel(ts.opt_state.mu[n], jmu[n]) <= (1e-4 if f32 else 2e-2), n
        assert rel(ts.opt_state.nu[n], jnu[n]) <= (1e-4 if f32 else 2e-2), n
    if f32:
        return
    # bf16: Adam normalises every entry's step to about lr, so the step of
    # a near-zero gradient entry follows its bf16 rounding (up to 0.25
    # relative L2 on the first SDF layer, measured). The update is held on
    # JAX's own gradients instead: from the same state, the port's
    # optimizer must give JAX's new params, within one bf16 ulp for the
    # tables (the moments' bf16 rounding, which XLA may skip, moves an
    # update by less than lr·2^-8) and 1e-5 relative L2 for the f32
    # leaves.
    mu2, nu2, _ = jax_params.nsr_opt_state(state.opt_state)
    js = tnsr.TrainState(jax_params.nsr_params(host),
                         tnsr.OptState(mu2, nu2, count), int(state.step))
    jg_named = dict(tnsr.named_leaves(jax.device_get(jgrads)))
    for n, p in tnsr.named_leaves(js.params):
        locked = n.startswith("geometry.table.") and int(n[-1]) >= N_ACTIVE
        p.grad = None if locked else jax_params._tensor(jg_named[n])
    tnsr.make_optimizer(tc).step(js.params, js.opt_state)
    for n, p in tnsr.named_leaves(js.params):
        want = np.asarray(jnew[n], np.float32)
        got = p.detach().float().numpy()
        if p.dtype == torch.bfloat16:
            np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                       atol=tc.lr_geometry * 2 ** -8,
                                       err_msg=n)
        else:
            assert rel(got, want) <= 1e-5, n
    # bf16 table gradients against the f32-compute gradient on the same
    # table values: the port no farther from it than 1.25 x JAX
    _, tc32 = configs("float32", "float32")
    ref = jax_params.nsr_params(host)
    ref["geometry"]["table"] = [x.detach().float().requires_grad_(True)
                                for x in ref["geometry"]["table"]]
    rs = tnsr.TrainState(ref, tnsr.OptState(mu, nu, count), int(state.step))
    tnsr.loss_and_grads(tc32, rs, tdata, jax_draws(jc, k, 6, 64, 64),
                        n_active=N_ACTIVE)
    for lvl in range(N_ACTIVE):
        want = ref["geometry"]["table"][lvl].grad.numpy()
        port = rel(tgrads[f"geometry.table.{lvl}"], want)
        jerr = rel(jgrads["geometry"]["table"][lvl], want)
        assert port <= 1.25 * jerr, (lvl, port, jerr)


def test_optimizer_and_lr_trajectory_match_jax():
    """optax's make_optimizer against the port's NSROptimizer over
    max_steps updates of random gradients on a small tree (bf16 and f32
    tables, weight-normed MLP, texture, variance): params, moments and,
    from a constant unit gradient on the variance, the learning rate at
    every step (constant, then exponential)."""
    jc, tc = configs("bfloat16", "float32", max_steps=60, constant_steps=20)
    rng = np.random.default_rng(7)
    tree = {"geometry": {"table": (jnp.asarray(rng.standard_normal((9, 2)),
                                               jnp.bfloat16),
                                   jnp.asarray(rng.standard_normal((5, 2)),
                                               jnp.float32)),
                         "mlp": {"layers": [{
                             "w": jnp.asarray(rng.standard_normal((3, 4)),
                                              jnp.float32),
                             "b": jnp.zeros(4, jnp.float32),
                             "g": jnp.ones(4, jnp.float32)}]}},
            "texture": {"mlp": {"layers": [{
                "w": jnp.asarray(rng.standard_normal((4, 3)), jnp.float32),
                "b": jnp.zeros(3, jnp.float32)}]}},
            "variance": {"variance": jnp.asarray(0.3, jnp.float32)}}
    tx = jnsr.make_optimizer(jc)
    jstate = tx.init(tree)
    update = jax.jit(tx.update)
    tparams = jax_params.nsr_params(jax.device_get(tree))
    opt = tnsr.make_optimizer(tc)
    tstate = opt.init(tparams)
    import optax
    for step in range(jc.max_steps):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(np.shape(x)) * 1e-2,
                                  x.dtype), tree)
        grads["variance"]["variance"] = jnp.asarray(1.0, jnp.float32)
        upd, jstate = update(grads, jstate, tree)
        lr = -float(upd["variance"]["variance"])       # |Adam step| = 1
        assert float(tnsr.learning_rate(tc, tc.lr_variance, step)) == \
            pytest.approx(lr, rel=1e-5), step
        tree = optax.apply_updates(tree, upd)
        for (n, p), (_, g) in zip(tnsr.named_leaves(tparams),
                                  tnsr.named_leaves(jax.device_get(grads))):
            p.grad = jax_params._tensor(g)
        opt.step(tparams, tstate)
        for n, want in tnsr.named_leaves(jax.device_get(tree)):
            got = dict(tnsr.named_leaves(tparams))[n]
            assert got.dtype == jax_params._tensor(want).dtype
            np.testing.assert_allclose(got.detach().float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=2e-6 if got.dtype != torch.bfloat16
                                       else 1e-2, atol=1e-7, err_msg=n)
    assert lr == pytest.approx(jc.lr_variance * jc.lr_decay_target ** (
        (jc.max_steps - 1 - jc.constant_steps)
        / (jc.max_steps - jc.constant_steps)), rel=1e-4)
    tparams_dtype = {n: p.dtype for n, p in tnsr.named_leaves(tparams)}
    mu, nu, count = jax_params.nsr_opt_state(jstate)
    assert count == tstate.count == jc.max_steps
    for n in mu:
        # f32 leaves 1e-4; a bf16 leaf's (1 - b1)·g is a bf16 product,
        # which XLA may keep in f32 (excess precision): one bf16 ulp
        bf16 = tparams_dtype[n] == torch.bfloat16
        assert rel(tstate.mu[n], mu[n]) <= (2 ** -8 if bf16 else 1e-4), n
        assert rel(tstate.nu[n], nu[n]) <= 1e-2, n


def test_render_image_matches_jax():
    """The eval render (no jitter, no probes) of a 24² front view at JAX's
    init with its tables redrawn at scale 0.1: every output within 1e-4
    (without jitter the pdf samples sit on bin edges, where a last-bit
    difference of the cdf moves a sample by up to 1e-4 relative)."""
    jc, tc = configs()
    params = jax.device_get(jnsr.init_params(jc, jax.random.PRNGKey(5)))
    rng = np.random.default_rng(12)
    params["geometry"]["table"] = tuple(
        jnp.asarray(rng.standard_normal(np.shape(x)) * 0.1, jnp.float32)
        for x in params["geometry"]["table"])
    c2w = view_matrices(["front_right"])[0][0]
    want = jnsr.render_image(jc, params, c2w, 24, 24, step=60)
    got = tnsr.render_image(tc, jax_params.nsr_params(params), c2w, 24, 24,
                            step=60)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape == (24, 24, want[k].shape[-1])
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    assert 0.05 < (want["opacity"] > 0.5).mean() < 0.95
