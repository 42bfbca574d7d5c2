"""PyTorch port: the tensor-parallel axis (``parallel/mesh.py::make_mesh``,
``parallel/tp.py``, the column-parallel FFC generator of
``models/ffc.py``) and the dry run (``parallel/dryrun.py``) against JAX's
``shard_params_tp`` and ``__graft_entry__.py::dryrun_multichip``.

The port's ranks are spawned from ``tests/torch_dp_worker.py`` (``tp``
task) through ``test_torch_parallel.py``'s ``start_ranks`` (gloo, a join
timeout), at the dry run's widths (``ngf`` 16, two downsamplings, two
blocks, 32² crops, a batch of 2·dp):

  * the rule: the sharded leaves and shard shapes of JAX's
    ``shard_params_tp`` on the conftest's virtual devices, at the dry run's
    widths and LaMa's full width, tp 2, 3 and 4;
  * self-consistency in float64: two steps on dp 2 × tp 2, dp 1 × tp 3
    (replicated local streams beside sharded global ones) and dp 1 × tp 4
    (also with the local Fourier unit, and with ``out_ffc``, whose inline
    block adds a replicated stream to a sharded one) against the port's
    one-process step on the whole batch: losses, parameters, running
    statistics and Adam moments within 1e-12 of each leaf's largest value;
  * parity with JAX in float64: JAX's dp × tp step (restated from
    ``__graft_entry__.py:114-128``, jitted on ``make_mesh(4, tp=2)``
    with ``shard_params_tp``) against the port's dp 2 × tp 2 step, within
    1e-7 of each leaf's largest value.

The transposed convs' biases feed a train-mode batch norm: their exact
gradient is 0, and each run moves them by its own rounding (~1e-12), as
``tests/test_torch_lama.py`` notes. They are held below 1e-9 (their
moments below 1e-15), and the running means of the batch norms they feed,
which move by 0.1 × the bias of step 1, are compared with that share
taken out.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from drawingspinup_tpu.models import ffc as jffc
from drawingspinup_tpu.parallel.mesh import (
    make_mesh, replicated, shard_batch, shard_params_tp,
)
from drawingspinup_torch.models import ffc as tffc
from drawingspinup_torch.parallel import dryrun, mesh as tmesh, tp as ttp
from drawingspinup_torch.train.lama import make_optimizer
from drawingspinup_torch.utils.jax_params import ffc_params
from test_torch_lama import _f64, jax_float64  # noqa: F401
from test_torch_parallel import start_ranks  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = {}                       # LaMa's full width: the defaults
WIDTHS = {"dryrun": dryrun.DRYRUN_FFC, "full": FULL}
PER_RANK = {("dryrun", 2): 67_593, ("dryrun", 3): 93_761,
            ("dryrun", 4): 34_189, ("full", 2): 13_522_849,
            ("full", 3): 17_581_825, ("full", 4): 6_762_993}
SIZE = 32
CONSISTENCY = 1e-12
PARITY = 1e-7
# the cases of each mesh: generator kwargs over the dry run's; at tp 2
# ``pairs`` cuts the Fourier unit's (re, im) pairs across the ranks (6
# interleaved channels), ``mixed`` adds a replicated conv1 output to a
# sharded Fourier unit output (2 channels, 4 interleaved)
MESHES = {(2, 2): {"dryrun": {},
                   "pairs": {"ngf": 4, "n_downsampling": 1, "n_blocks": 1},
                   "mixed": {"ngf": 3, "n_downsampling": 1, "n_blocks": 1}},
          (1, 3): {"dryrun": {}},
          (1, 4): {"dryrun": {}, "lfu": {"enable_lfu": True},
                   "out_ffc": {"out_ffc": True}}}


# ------------------------------------------------------------- the rule --

def _jax_specs(kw, tp):
    """JAX's shardings of the generator's params (shapes only), on
    ``make_mesh(n, tp=tp)`` over the conftest's devices (n 8, 6 at tp 3)."""
    model = jffc.FFCResNetGenerator(**kw)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 4)))["params"]
    mesh = make_mesh(6 if tp == 3 else 8, tp=tp)
    return shapes, shard_params_tp(shapes, mesh)


@pytest.mark.parametrize("tp", [2, 3, 4])
@pytest.mark.parametrize("width", ["dryrun", "full"])
def test_rule_is_jaxs(width, tp):
    """Per parameter: sharded exactly where JAX's rule shards the leaf, with
    JAX's shard shape (in torch's layout), and each rank's count."""
    shapes, specs = _jax_specs(WIDTHS[width], tp)
    marks = ffc_params(jax.tree.map(
        lambda s, sh: np.full(s.shape, float(sh.spec != P()), np.float32),
        shapes, specs))
    shards = ffc_params(jax.tree.map(
        lambda s, sh: np.zeros(sh.shard_shape(s.shape), np.float32),
        shapes, specs))
    with torch.device("meta"):
        model = tffc.FFCResNetGenerator(**WIDTHS[width])
    mesh = tmesh.Mesh(dp=(6 if tp == 3 else 8) // tp, tp=tp, tp_index=1)
    axes = ttp.shard_params_tp(model, mesh)
    params = dict(model.named_parameters())
    assert params.keys() == marks.keys()
    for name, p in params.items():
        assert (axes[name] is not None) == bool(marks[name].any()), name
        assert tuple(p.shape) == tuple(shards[name].shape), name
    assert sum(p.numel() for p in params.values()) == PER_RANK[width, tp]
    for name, b in model.named_buffers():    # running stats follow weight
        owner = name.rsplit(".", 1)[0] + ".weight"
        assert axes[name] == axes[owner], name


def test_world1_is_the_plain_step():
    """At world size 1 ``make_mesh(1, 1)`` leaves the module as it is, and
    two steps through it are bit-identical to the plain loss, backward and
    Adam step."""
    x, y = _batch(1)
    runs = []
    for tp_path in (False, True):
        model = dryrun.seeded_generator(**dryrun.DRYRUN_FFC)
        opt = make_optimizer(model, dryrun.LR)
        if tp_path:
            mesh = tmesh.make_mesh(1, 1)
            ttp.shard_params_tp(model, mesh)
            assert model.tp is None
            losses = [dryrun.ffc_tp_train_step(model, opt, x, y, mesh)
                      for _ in range(2)]
        else:
            losses = []
            for _ in range(2):
                model.train()
                opt.zero_grad()
                loss = dryrun.dryrun_loss(model(x), y)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
        runs.append((losses, model.state_dict()))
    (l0, s0), (l1, s1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_mesh_layout_and_world_size():
    """Without a process group only the 1 × 1 mesh exists."""
    assert tmesh.make_mesh(1) == tmesh.Mesh()
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tmesh.make_mesh(2, 2)
    with pytest.raises(NotImplementedError):
        ttp.shard_params_tp(torch.nn.Conv2d(4, 8, 3), tmesh.Mesh())


# ------------------------------------------------------------ the steps --

def _batch(dp, dtype=torch.float32):
    """The dry run's global batch (2·dp rows of 32², from seeds 0 and 1),
    NCHW, its f32 values in ``dtype``."""
    b = 2 * dp
    x = np.random.default_rng(0).random((b, SIZE, SIZE, 4)).astype(
        np.float32)
    y = (np.random.default_rng(1).random((b, SIZE, SIZE, 1)) > 0.5
         ).astype(np.float32)
    return (torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(dtype)
            for a in (x, y))


def _zero_grad(model):
    """The biases of the transposed convs, and the batch norms after them."""
    seq = list(model.model)
    idx = [i for i, m in enumerate(seq)
           if isinstance(m, torch.nn.ConvTranspose2d)]
    return ([f"model.{i}.bias" for i in idx],
            [f"model.{i + 1}.running_mean" for i in idx])


def _one_process(kw, state, x, y, zero_grad):
    """The port's plain step on the whole batch, twice, in float64."""
    model = tffc.FFCResNetGenerator(**kw).double()
    model.load_state_dict(state)
    opt = make_optimizer(model, dryrun.LR)
    params = dict(model.named_parameters())
    losses = [float(dryrun.ffc_tp_train_step(model, opt, x, y))]
    bias1 = {k: params[k].detach().clone() for k in zero_grad}
    losses.append(float(dryrun.ffc_tp_train_step(model, opt, x, y)))
    return {"losses": losses, "state": model.state_dict(), "bias1": bias1,
            "mu": {n: opt.state[p]["exp_avg"] for n, p in params.items()},
            "nu": {n: opt.state[p]["exp_avg_sq"] for n, p in params.items()}}


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3e} of its largest value > {tol:g}"


def _hold(got, want, tol, zero_grad, after, what):
    """Every leaf within ``tol`` of its largest value; the zero-gradient
    biases below 1e-9 (moments 1e-15); the running means after them with
    0.1 × the step-1 bias difference taken out."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=tol,
                               atol=0, err_msg=what + " losses")
    for part in ("state", "mu", "nu"):
        for k, w in want[part].items():
            g = got[part][k]
            if k in zero_grad:
                bound = 1e-9 if part == "state" else 1e-15
                assert max(float(w.abs().max()), float(g.abs().max())) \
                    < bound, (what, part, k)
                continue
            if part == "state" and k in after:
                b = zero_grad[after.index(k)]
                g = g - 0.1 * (got["bias1"][b] - want["bias1"][b])
            _close(g, w, tol, f"{what} {part} {k}")


def _inputs(dp, tp, jax_state=None):
    cases = []
    for name, extra in MESHES[dp, tp].items():
        kw = {**dryrun.DRYRUN_FFC, **extra}
        model = dryrun.seeded_generator(seed=len(cases), **kw)
        state = jax_state if name == "dryrun" and jax_state is not None \
            else model.state_dict()
        x, y = _batch(dp, torch.float64)
        cases.append({"name": name, "kw": kw, "x": x, "y": y,
                      "state": {k: v.double() for k, v in state.items()},
                      "zero_grad": _zero_grad(model)[0]})
    return {"dp": dp, "tp": tp, "cases": cases}


def _check_ranks(outs, inputs):
    """What every rank of a run must show: the same gathered state and
    losses, bit-identical replicated parameters, each conv computing its
    slice of the output channels, the rule's count, the predicted
    collectives, a falling loss."""
    dp, tp = inputs["dp"], inputs["tp"]
    for case in inputs["cases"]:
        name = case["name"]
        runs = [o[name] for o in outs]
        model = tffc.FFCResNetGenerator(**case["kw"])
        axes = ttp.tp_axes(model, tp)
        for r in runs[1:]:
            assert r["losses"] == runs[0]["losses"], name
            for k, v in runs[0]["state"].items():
                assert torch.equal(r["state"][k], v), (name, k)
        for i in range(dp):       # a tp group's replicated bits agree
            group = runs[i * tp:(i + 1) * tp]
            for k, v in group[0]["replicated"].items():
                assert all(torch.equal(g["replicated"][k], v)
                           for g in group), (name, k)
        mods = dict(model.named_modules())
        for conv, c in runs[0]["channels"].items():
            full = mods[conv].out_channels
            key = conv + ".weight"
            assert c == (full // tp if axes[key] is not None else full), \
                (name, conv, c)
        assert len(runs[0]["channels"]) == sum(
            isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))
            for m in model.modules())
        if name == "dryrun":
            assert runs[0]["n_params"] == PER_RANK["dryrun", tp]
        if name not in ("lfu", "out_ffc"):     # the predictor's scope
            for r in runs:
                assert r["traffic"] == dryrun.predicted_traffic(
                    model, 2, SIZE, tp, dp, element_bytes=8), name
        assert runs[0]["losses"][1] < runs[0]["losses"][0], name
        assert all(s == 2.0 for s in runs[0]["steps"])


_RUNS = {}


def _run(start_ranks, tmp_path, dp, tp, jax_state=None):  # noqa: F811
    """The ranks' outputs of a mesh's cases (one run a mesh per module)."""
    if (dp, tp) not in _RUNS:
        run = start_ranks(f"tp-{dp}x{tp}", dp * tp, tmp_path)
        inputs = _inputs(dp, tp, jax_state)
        outs = run(inputs)
        _check_ranks(outs, inputs)
        _RUNS[dp, tp] = (inputs, outs[0])
    return _RUNS[dp, tp]


@pytest.mark.parametrize("dp,tp", list(MESHES))
def test_tp_step_matches_one_process(dp, tp, start_ranks,  # noqa: F811
                                     tmp_path):
    """Each case's two steps on the mesh against the port's one-process
    step on the whole batch, in float64."""
    inputs, out = _run(start_ranks, tmp_path, dp, tp)
    for case in inputs["cases"]:
        model = tffc.FFCResNetGenerator(**case["kw"])
        zero_grad, after = _zero_grad(model)
        want = _one_process(case["kw"], case["state"], case["x"], case["y"],
                            zero_grad)
        _hold(out[case["name"]], want, CONSISTENCY, zero_grad, after,
              f"{dp}x{tp} {case['name']}")


def _hi_lo(tree):
    """A float64 tree as two f32 trees whose sum is its value to ~2^-48, so
    that ``ffc_params``' f32 conversion keeps float64's precision."""
    hi = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    lo = jax.tree.map(lambda a, h: np.asarray(
        np.asarray(a, np.float64) - h, np.float32), tree, hi)
    return hi, lo


def _ported(tree, stats=None):
    parts = [ffc_params(*t) for t in zip(
        _hi_lo(tree), _hi_lo(stats) if stats is not None else (None, None))]
    return {k: parts[0][k].double() + parts[1][k].double() for k in parts[0]}


def _jax_step(kw, params, stats, x, y):
    """``__graft_entry__.py:83-128``'s step: params by ``shard_params_tp``,
    Adam state and statistics replicated, the batch over ``dp``, on
    ``make_mesh(4, tp=2)``; two steps → the port's names in float64."""
    model = jffc.FFCResNetGenerator(**kw)
    tx = optax.adam(dryrun.LR)
    opt_state = tx.init(params)
    mesh = make_mesh(4, tp=2)
    params = jax.device_put(params, shard_params_tp(params, mesh))
    opt_state = jax.device_put(opt_state, jax.tree.map(
        lambda _: replicated(mesh), opt_state))
    stats = jax.device_put(stats, jax.tree.map(lambda _: replicated(mesh),
                                               stats))
    x = jax.device_put(x, shard_batch(mesh))
    y = jax.device_put(y, shard_batch(mesh))

    @jax.jit
    def train_step(params, batch_stats, opt_state, x, y):
        def loss_fn(p):
            out, mut = model.apply(
                {"params": p, "batch_stats": batch_stats}, x, train=True,
                mutable=["batch_stats"])
            eps = 1e-6
            bce = -(y * jnp.log(out + eps) + (1 - y) * jnp.log(1 - out + eps))
            return jnp.mean(bce), mut["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, \
            opt_state, loss

    losses = []
    with mesh:
        for _ in range(2):
            params, stats, opt_state, loss = train_step(
                params, stats, opt_state, x, y)
            losses.append(float(loss))
    adam = jax.tree.map(np.asarray, opt_state[0])
    return {"losses": losses,
            "state": _ported(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, stats)),
            "mu": _ported(adam.mu), "nu": _ported(adam.nu)}


def test_dp2_tp2_step_matches_jax(start_ranks, tmp_path,  # noqa: F811
                                  jax_float64):  # noqa: F811
    """The port's dp 2 × tp 2 step from JAX's converted init against JAX's
    sharded step, both in float64, over two steps."""
    kw = dryrun.DRYRUN_FFC
    x, y = _batch(2)
    xj, yj = (jnp.asarray(a.permute(0, 2, 3, 1).numpy(), jnp.float64)
              for a in (x, y))
    variables = jffc.FFCResNetGenerator(**kw).init(jax.random.PRNGKey(0),
                                                   xj[:1])
    # under x64 flax draws float64: both packages start from its f32 values
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32), variables)
    state = ffc_params(variables["params"], variables["batch_stats"])
    _RUNS.pop((2, 2), None)         # this run starts from JAX's weights
    inputs, out = _run(start_ranks, tmp_path, 2, 2, jax_state=state)
    want = _jax_step(kw, _f64(variables["params"]),
                     _f64(variables["batch_stats"]), xj, yj)
    model = tffc.FFCResNetGenerator(**kw)
    zero_grad, _ = _zero_grad(model)
    # JAX's bias after step 1 is not read back: the 1e-7 bound holds the
    # running means without taking the bias's share out
    got = dict(out["dryrun"], bias1={})
    _hold(got, want, PARITY, zero_grad, [], "dp 2 × tp 2 against JAX")
    assert want["losses"][1] < want["losses"][0]


# ------------------------------------------------------------- dry run --

def test_dryrun_cli_on_two_cpu_ranks():
    """``python -m drawingspinup_torch.parallel.dryrun --ranks 2 --device
    cpu`` runs the four parts and prints JAX's four ``ok`` lines."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "drawingspinup_torch.parallel.dryrun",
         "--ranks", "2", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("dryrun_multichip[")]
    assert [ln.split("]")[0] for ln in lines] == [
        "dryrun_multichip[ffc dp×tp", "dryrun_multichip[nsr ray-dp "
        "production", "dryrun_multichip[mv batch-dp",
        "dryrun_multichip[gan patch-dp"], proc.stdout
    assert all(ln.endswith(" ok") for ln in lines)
    assert "mesh={'dp': 1, 'tp': 2}" in lines[0]
    assert "dp=2" in lines[2]


def test_entry_is_the_full_width_generator():
    """``entry`` (``__graft_entry__.py::entry``'s counterpart): LaMa's
    full-width generator in eval mode and a 512² zero input."""
    model, x = dryrun.entry("cpu")
    assert sum(p.numel() for p in model.parameters()) == 27_042_561
    assert not model.training and model.tp is None
    assert x.shape == (1, 4, 512, 512) and not x.any()


def test_dryrun_refuses_a_world_that_does_not_fit():
    with pytest.raises(ValueError, match="process group of 1"):
        dryrun.dryrun_multichip(2, "cpu")
