"""PyTorch port, ISNet DIS (stage 2a's side-view matte) against the JAX
package on the CPU.

  * the port's ``ISNetDIS`` at full width on small inputs (48², and 37×45
    for the ceil-mode pooling), weights and batch statistics drawn from a
    seed into JAX's variables and converted by
    ``utils/jax_params.py::isnet_params``: all six side maps within
    relative L2 1e-5 of JAX's ``apply``;
  * upstream's names: the converted ``state_dict`` is what JAX's
    ``port_isnet_torch_state`` reads, it loads strictly with or without
    ``num_batches_tracked``, and a stray or missing key raises;
  * ``background_removal`` with ``DSU_ISNET_CKPT`` (a torch ``state_dict``
    and an ``.npz``) against JAX's on the same image: the written u8 masks
    differ on < 0.1 % of pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from drawingspinup_tpu.models import isnet as jisnet
from drawingspinup_tpu.pipelines import stage2_mv as jmv
from drawingspinup_torch.models import isnet as tisnet
from drawingspinup_torch.pipelines import stage2_mv as tmv
from drawingspinup_torch.utils.jax_params import isnet_params
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
MASK_SHARE = 1e-3


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def variables():
    """JAX's ISNet variables with every leaf drawn from a seed: kernels of
    std 1/sqrt(fan-in), biases 0.05, BN scales 1 ± 0.1, means 0.1, vars
    0.5-1.5."""
    shapes = jax.eval_shape(jisnet.ISNetDIS().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(0)
    out = {}
    for coll in ("params", "batch_stats"):
        flat = {}
        for path, s in flatten_dict(shapes[coll]).items():
            shape, leaf = s.shape, path[-1]
            if leaf == "kernel":
                v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:3]))
            elif leaf == "scale":
                v = 1 + 0.1 * rng.standard_normal(shape)
            elif leaf == "var":
                v = rng.uniform(0.5, 1.5, shape)
            elif leaf == "mean":
                v = 0.1 * rng.standard_normal(shape)
            else:
                v = 0.05 * rng.standard_normal(shape)
            flat[path] = v.astype(np.float32)
        out[coll] = unflatten_dict(flat)
    return out


@pytest.fixture(scope="module")
def model(variables):
    return tisnet.load_isnet_state(tisnet.ISNetDIS(),
                                   isnet_params(variables)).eval()


@pytest.mark.parametrize("hw", [(48, 48), (37, 45)])
def test_isnet_matches_jax(variables, model, hw):
    x = np.random.default_rng(1).uniform(-0.5, 0.5, (2, *hw, 3)).astype(
        np.float32)
    want = jisnet.ISNetDIS().apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.shape == (2, 1, *hw)
        assert _rel_l2(g.numpy()[:, 0], np.asarray(w)[..., 0]) < TOL
    d1 = np.asarray(want[0])
    assert d1.std() > 0.01            # the check sees more than a constant


def test_upstream_names_load_strictly(variables, model, tmp_path):
    sd = isnet_params(variables)
    # JAX's porter reads exactly these names, leaf for leaf
    ported = jisnet.port_isnet_torch_state(
        {k: v.numpy() for k, v in sd.items()}, variables)
    for coll in ("params", "batch_stats"):
        a, b = flatten_dict(variables[coll]), flatten_dict(ported[coll])
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # the model's own state_dict: upstream's keys plus num_batches_tracked
    own = tisnet.ISNetDIS().state_dict()
    assert set(own) - set(sd) == {k for k in own
                                  if k.endswith("num_batches_tracked")}
    tisnet.load_isnet_state(tisnet.ISNetDIS(), own)
    assert torch.equal(model.stage3.rebnconv2d.conv_s1.weight,
                       sd["stage3.rebnconv2d.conv_s1.weight"])
    with pytest.raises(KeyError, match="unexpected"):
        tisnet.load_isnet_state(tisnet.ISNetDIS(),
                                {**sd, "stage9.conv.weight": sd["side1.bias"]})
    with pytest.raises(KeyError, match="missing"):
        tisnet.load_isnet_state(tisnet.ISNetDIS(), {
            k: v for k, v in sd.items() if k != "side6.weight"})


def _side_view():
    yy, xx = np.mgrid[0:64, 0:64]
    img = np.ones((64, 64, 3), np.float32)
    blob = np.hypot(yy - 30, xx - 34) < 18
    img[blob] = np.random.default_rng(2).uniform(0, 0.8, (blob.sum(), 3))
    return img


@pytest.fixture(scope="module")
def jax_mask(variables, tmp_path_factory):
    """JAX's ``background_removal`` with ``DSU_ISNET_CKPT`` naming the
    converted weights as a torch ``state_dict``."""
    path = str(tmp_path_factory.mktemp("isnet") / "isnet.pth")
    torch.save(isnet_params(variables), path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DSU_ISNET_CKPT", path)
        mp.setattr(jmv, "_ISNET_CACHE", {})
        return jmv.background_removal(_side_view())


@pytest.mark.parametrize("fmt", ["pth", "npz"])
def test_background_removal_with_ckpt_matches_jax(variables, jax_mask,
                                                  tmp_path, monkeypatch, fmt):
    sd = isnet_params(variables)
    path = str(tmp_path / f"isnet.{fmt}")
    if fmt == "pth":
        torch.save({**sd, "conv_in.bn.num_batches_tracked":
                    torch.tensor(7)}, path)
    else:
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    monkeypatch.setenv("DSU_ISNET_CKPT", path)
    got = tmv.background_removal(_side_view(), device="cpu")
    want = jax_mask
    assert got.shape == want.shape == (64, 64) and got.dtype == np.float32

    def u8(m):
        return np.floor(np.clip(m * 255.0 + 0.5, 0, 255)).astype(np.uint8)

    assert (u8(got) != u8(want)).mean() < MASK_SHARE
    assert np.abs(got - want).max() < 1e-4
    assert want.std() > 0.01
