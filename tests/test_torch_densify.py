"""The port's densification and pruning (``animate3d_tpu_torch/gaussians/densify.py``)
against the JAX package's on the same states, stats and generator seeds,
mirroring tests/test_densify.py: clone, split, prune and the opacity reset."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animate3d_tpu.gaussians import densify as JD
from animate3d_tpu.gaussians.state import GaussianState as JState
from animate3d_tpu_torch.gaussians import densify as TD
from animate3d_tpu_torch.gaussians.state import GaussianState as TState

FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "scaling", "rotation")


def _arrays(n, scale, opacity, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return {"xyz": rng.normal(size=(n, 3)).astype(np.float32),
            "features_dc": rng.normal(size=(n, 1, 3)).astype(np.float32),
            "features_rest": np.zeros((n, 0, 3), np.float32),
            "opacity": np.full((n, 1), opacity, np.float32),
            "scaling": np.log(np.full((n, 3), scale, np.float32)
                              * rng.uniform(0.5, 1.5, (n, 1))).astype(np.float32),
            "rotation": q / np.linalg.norm(q, axis=-1, keepdims=True)}


def _pair(n=10, scale=0.01, opacity=3.0):
    a = _arrays(n, scale, opacity)
    return (JState(**{k: jnp.asarray(v) for k, v in a.items()}, sh_degree=0),
            TState(**{k: torch.as_tensor(v) for k, v in a.items()}, sh_degree=0))


def _same(jax_state, port_state):
    assert port_state.num_points == jax_state.num_points
    for k in FIELDS:
        np.testing.assert_allclose(getattr(port_state, k).numpy(),
                                   np.asarray(getattr(jax_state, k)), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("name,scale,opacity,grads,cfg,expect", [
    # clone: 3 small high-gradient gaussians are duplicated
    ("clone", 0.001, 3.0, np.r_[np.ones(3), np.zeros(7)],
     dict(densify_grad_threshold=0.5), 13),
    # split: every large parent becomes 2 children inside its covariance
    ("split", 0.5, 3.0, np.ones(10), dict(densify_grad_threshold=0.5, max_world_scale_rel=10.0),
     20),
    # prune: transparent gaussians go
    ("prune", 0.01, -10.0, np.zeros(10), {}, 0),
    # all at once: half clone, the scales mixed, some pruned by size
    ("mixed", 0.05, 3.0, np.r_[np.ones(5), np.zeros(5)],
     dict(densify_grad_threshold=0.5, percent_dense=0.05, max_world_scale_rel=0.06), None),
])
def test_densify_and_prune_matches_jax(name, scale, opacity, grads, cfg, expect):
    js, ts = _pair(scale=scale, opacity=opacity)
    g2 = np.stack([grads, grads], -1)
    radii = np.ones(10)
    jstats = JD.DensifyStats.zero(10).update(g2, radii).update(g2, radii)
    tstats = TD.DensifyStats.zero(10).update(g2, radii).update(g2, radii)
    np.testing.assert_array_equal(tstats.grad_accum, jstats.grad_accum)
    jnew, jst = JD.densify_and_prune(js, jstats, JD.DensifyConfig(**cfg), 1.0,
                                     np.random.default_rng(0))
    tnew, tst = TD.densify_and_prune(ts, tstats, TD.DensifyConfig(**cfg), 1.0,
                                     np.random.default_rng(0))
    if expect is not None:
        assert tnew.num_points == expect
    _same(jnew, tnew)
    assert tst.grad_accum.shape == jst.grad_accum.shape == (tnew.num_points,)
    assert isinstance(tnew.xyz, torch.Tensor) and tnew.xyz.dtype == torch.float32


def test_reset_opacity_matches_jax():
    js, ts = _pair(n=5, opacity=5.0)
    jnew, tnew = JD.reset_opacity(js, 0.01), TD.reset_opacity(ts, 0.01)
    _same(jnew, tnew)
    assert torch.all(torch.sigmoid(tnew.opacity) <= 0.011)
