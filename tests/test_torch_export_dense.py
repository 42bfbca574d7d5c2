"""PyTorch port, stage-2b export: the level chain (JAX's
``isosurface_level`` → ``isosurface_from_level``) and the choice between it
and the device-smooth chain, against the JAX package on the CPU.

  * from one set of params (JAX's init with redrawn tables, converted by
    ``utils/jax_params.py``), the level field at R = 64, dense and
    band-sparse, within one bf16 ulp of JAX's plus one f32 ulp at 1: both
    round the SDF through bf16, the grid coordinates may differ in their
    last f32 bit, and near the surface the SDF is the f32 difference of
    O(1) terms, whose rounding (~6e-8) bf16 keeps there;
  * the marched and remeshed meshes of each within 10 % in V and F, with
    and without the front-mask carve;
  * ``recon_uid`` takes JAX's chain, with the same coarse grid, at R = 64,
    256, 258 and 260 and with ``DSU_DEVICE_SMOOTH=0``.
"""

import dataclasses

import numpy as np
import pytest

from drawingspinup_tpu.core import UidPaths as JPaths
from drawingspinup_tpu.pipelines import stage2_recon as js2
from drawingspinup_torch.pipelines import stage2_export as texport
from drawingspinup_torch.pipelines import stage2_recon as ts2
from drawingspinup_torch.utils import jax_params
from drawingspinup_torch.utils.synthetic import write_sphere_mv
from test_torch_nsr import configs
from test_torch_recon import _trained_like
from torch_native_guard import ensure_jax_native
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """JAX's native library, built under a lock if another worker's
    build raced this one's."""
    ensure_jax_native()


@pytest.fixture(scope="module")
def sphere(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sphere"))
    write_sphere_mv(root, "s", size=64)
    return root


def _bf16_ulp(x):
    """One bf16 ulp at |x| (2^-7 relative, normal range)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_level_chain_matches_jax(sphere, sparse):
    jc, tc, params = _trained_like("float32", "float32")
    tp = jax_params.nsr_params(params, requires_grad=False)
    R, step = 64, jc.max_steps
    want, vmin, vmax = js2.isosurface_level(jc, params, R, step,
                                            sparse=sparse)
    ev = texport.FieldEvaluator(tc, tp, step, "cpu")
    got, tvmin, tvmax = texport.isosurface_level(ev, R, tc.radius,
                                                 sparse=sparse)
    np.testing.assert_array_equal(tvmin, vmin)
    np.testing.assert_array_equal(tvmax, vmax)
    assert got.shape == want.shape == (R, R, R) and got.dtype == np.float32
    assert 0.05 < (want <= 0).mean() < 0.9
    diff = np.abs(got - want)
    tol = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 2.0 ** -23
    assert (diff <= tol).all(), (diff - tol).max()
    front = js2.load_front_mask(JPaths(sphere, "s"))
    for mask in (front, None):
        tv, tf = texport.isosurface_from_level(got, vmin, vmax, R, mask, 2000)
        jv, jf = js2.isosurface_from_level(want, vmin, vmax, R, mask, 2000)
        assert len(jf) > 500
        assert abs(len(tv) - len(jv)) <= 0.1 * len(jv)
        assert abs(len(tf) - len(jf)) <= 0.1 * len(jf)
    # the host half alone is the original, array for array
    for a, b in zip(texport.isosurface_from_level(want, vmin, vmax, R, front,
                                                  2000),
                    js2.isosurface_from_level(want, vmin, vmax, R, front,
                                              2000)):
        np.testing.assert_array_equal(a, b)


class _Chain(Exception):
    pass


@pytest.mark.parametrize("res,env", [(64, None), (256, None), (258, None),
                                     (260, None), (256, "0"), (64, "0"),
                                     (256, "")])
def test_recon_uid_takes_jaxs_chain(sphere, monkeypatch, res, env):
    """With no training steps, each ``recon_uid`` stops at its first
    bbox pass: the coarse grid (sparse or not) and its spacing (blocks or
    slabs) name the chain."""
    if env is None:
        monkeypatch.delenv("DSU_DEVICE_SMOOTH", raising=False)
    else:
        monkeypatch.setenv("DSU_DEVICE_SMOOTH", env)
    jc, tc = (dataclasses.replace(c, max_steps=0) for c in configs())

    def stop(*args, sparse=True, use_blocks=False, **kw):
        raise _Chain((sparse, use_blocks))

    monkeypatch.setattr(js2, "_bbox_pass", lambda cfg, params, r, step,
                        sparse, use_blocks=False: stop(sparse=sparse,
                                                       use_blocks=use_blocks))
    monkeypatch.setattr(texport, "bbox_pass", lambda ev, r, radius,
                        sparse=True, use_blocks=True: stop(
                            sparse=sparse, use_blocks=use_blocks))
    chains = []
    for run in (lambda: js2.recon_uid(sphere, "s", jc, mc_resolution=res,
                                      im_size=64, log_every=0),
                lambda: ts2.recon_uid(sphere, "s", tc, mc_resolution=res,
                                      im_size=64, log_every=0,
                                      device="cpu")):
        with pytest.raises(_Chain) as e:
            run()
        chains.append(e.value.args[0])
    assert chains[0] == chains[1]
    device_smooth = res >= 256 and res % 4 == 0 and env not in ("", "0")
    assert texport.use_device_smooth(res) == device_smooth
    assert chains[1] == (res >= 256 and res % 4 == 0, device_smooth)
