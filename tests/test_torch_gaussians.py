"""The port's gaussian modules against the JAX package's, on the CPU:
rotation and SH helpers, the PLY round trip both ways, the K-planes
sampler (the port's ``sample_frames`` against JAX's time-factorised
``interpolate_ms_features_frames``), ``DeformationField.deform_frames``
with and without the global transform (weights carried across by
``deform_params_from_flax``), KNN, connectivity and the ARAP energy with the
same node sample. Inputs are made by numpy from a seed."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animate3d_tpu.gaussians import arap as jarap
from animate3d_tpu.gaussians import deform as jdeform
from animate3d_tpu.gaussians import kplanes as jkp
from animate3d_tpu.gaussians import ply as jply
from animate3d_tpu.gaussians import state as jstate
from animate3d_tpu.ops import knn as jknn
from animate3d_tpu.utils import loss as jloss
from animate3d_tpu.utils import rotation as jrot
from animate3d_tpu.utils import sh as jsh
from animate3d_tpu_torch.convert.from_flax import deform_params_from_flax
from animate3d_tpu_torch.gaussians import arap, kplanes, ply
from animate3d_tpu_torch.gaussians.deform import DeformationField, DeformConfig
from animate3d_tpu_torch.gaussians.state import GaussianState, from_point_cloud, BasicPointCloud
from animate3d_tpu_torch.ops import knn
from animate3d_tpu_torch.utils import loss, rotation, sh

from torch_cpu_host import warm_vml

warm_vml()  # before the first torch.exp: see tests/torch_cpu_host.py


def T(a):
    return torch.from_numpy(np.array(a))


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q[:4] = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]  # every pivot branch
    return q


def test_rotation_helpers_match_jax():
    rng = np.random.default_rng(0)
    q = _quats(rng, 64)
    m = np.asarray(jrot.quat_to_matrix(jnp.asarray(q)))
    np.testing.assert_allclose(rotation.quat_to_matrix(T(q)).numpy(), m, atol=1e-6)
    np.testing.assert_allclose(rotation.matrix_to_quat(T(m)).numpy(),
                               np.asarray(jrot.matrix_to_quat(jnp.asarray(m))), atol=1e-6)
    ang = rng.uniform(-math.pi, math.pi, (5, 3)).astype(np.float32)
    for a in ang:
        np.testing.assert_allclose(rotation.euler_to_matrix(T(a)).numpy(),
                                   np.asarray(jrot.euler_to_matrix(jnp.asarray(a))), atol=1e-6)
    np.testing.assert_allclose(rotation.euler_to_matrix(T(ang)).numpy()[2],
                               np.asarray(jrot.euler_to_matrix(jnp.asarray(ang[2]))), atol=1e-6)
    np.testing.assert_allclose(rotation.quat_to_matrix_np(q), jrot.quat_to_matrix_np(q))
    np.testing.assert_allclose(rotation.matrix_to_quat_np(m), jrot.matrix_to_quat_np(m))


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    coef = rng.normal(size=(50, 16, 3)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(sh.sh_color(deg, T(coef), T(d)).numpy(),
                               np.asarray(jsh.sh_color(deg, jnp.asarray(coef), jnp.asarray(d))),
                               atol=1e-5)
    np.testing.assert_allclose(sh.rgb_to_sh(coef[:, 0]), jsh.rgb_to_sh(coef[:, 0]))


def test_tv_loss_matches_jax():
    img = np.random.default_rng(1).uniform(size=(3, 9, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(float(loss.tv_loss(T(img))),
                               float(jloss.tv_loss(jnp.asarray(img))), rtol=1e-6)


def _state_np(rng, n=40, deg=1):
    k = (deg + 1) ** 2
    return dict(xyz=rng.uniform(-0.5, 0.5, (n, 3)), features_dc=rng.normal(size=(n, 1, 3)),
                features_rest=rng.normal(size=(n, k - 1, 3)), opacity=rng.normal(size=(n, 1)),
                scaling=rng.uniform(-4, -2, (n, 3)), rotation=_quats(rng, n))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ply_round_trip_with_jax(tmp_path, writer):
    """One package writes, the other reads; ``load_gaussians`` re-poses alike."""
    d = {k: v.astype(np.float32) for k, v in _state_np(np.random.default_rng(2)).items()}
    path = str(tmp_path / "a.ply")
    if writer == "port":
        ply.write_gaussian_ply(path, GaussianState.from_numpy(**d, sh_degree=1))
        got = jply.read_gaussian_ply(path, max_sh_degree=1)
    else:
        jply.write_gaussian_ply(path, jstate.GaussianState(**d, sh_degree=1))
        got = ply.read_gaussian_ply(path, max_sh_degree=1)
    for k, v in d.items():
        np.testing.assert_array_equal(np.asarray(getattr(got, k)), v, err_msg=k)
    mine = ply.load_gaussians(path, 90.0, 30.0, 1.5, max_sh_degree=1)
    ref = jply.load_gaussians(path, 90.0, 30.0, 1.5, max_sh_degree=1)
    for k in d:
        np.testing.assert_allclose(getattr(mine, k).numpy(), np.asarray(getattr(ref, k)),
                                   atol=1e-6, err_msg=k)


def test_from_point_cloud_matches_jax():
    rng = np.random.default_rng(3)
    pcd = (rng.uniform(-1, 1, (70, 3)).astype(np.float32),
           rng.uniform(0, 1, (70, 3)).astype(np.float32), np.zeros((70, 3), np.float32))
    mine = from_point_cloud(BasicPointCloud(*pcd))
    ref = jstate.from_point_cloud(jstate.BasicPointCloud(*pcd))
    # scales: log sqrt of KNN distances, |q|² + |p|² - 2 q·p summed in another order
    for k, atol in (("xyz", 0), ("features_dc", 0), ("opacity", 0), ("scaling", 1e-5),
                    ("rotation", 0)):
        np.testing.assert_allclose(getattr(mine, k).numpy(), np.asarray(getattr(ref, k)),
                                   atol=atol, rtol=1e-6, err_msg=k)


def test_grid_sample_2d_matches_jax():
    """The JAX bilinear (border clamp, align_corners) incl. coords outside [-1, 1]."""
    rng = np.random.default_rng(4)
    plane = rng.normal(size=(5, 7, 9)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (200, 2)).astype(np.float32)
    coords[:4] = [[-1, -1], [1, 1], [1, -1], [-1, 1]]
    np.testing.assert_allclose(
        kplanes.grid_sample_2d(T(plane), T(coords)).numpy(),
        np.asarray(jkp.grid_sample_2d(jnp.asarray(plane), jnp.asarray(coords))), atol=1e-6)


GRID = ((6, 7, 8, 4), (10, 9, 11, 5))


def _grids(rng, dim=3):
    return [[rng.uniform(0.1, 1.0, (dim, reso[c1], reso[c0])).astype(np.float32)
             for c0, c1 in kplanes.COO_COMBS] for reso in GRID]


def test_interpolate_ms_features_match_jax():
    rng = np.random.default_rng(5)
    grids = _grids(rng)
    xyz = rng.uniform(-1, 1, (60, 3)).astype(np.float32)
    ts = np.linspace(-1, 1, 5).astype(np.float32)
    tg = [[T(p) for p in s] for s in grids]
    jg = [[jnp.asarray(p) for p in s] for s in grids]
    np.testing.assert_allclose(
        kplanes.sample_frames(T(xyz), T(ts), tg).numpy(),
        np.asarray(jax.jit(jkp.interpolate_ms_features_frames)(jnp.asarray(xyz),
                                                               jnp.asarray(ts), jg)),
        atol=1e-5)
    pts = np.concatenate([xyz, np.full((60, 1), 0.3, np.float32)], 1)
    np.testing.assert_allclose(
        kplanes.interpolate_ms_features(T(pts), tg).numpy(),
        np.asarray(jax.jit(jkp.interpolate_ms_features)(jnp.asarray(pts), jg)), atol=1e-5)


@pytest.fixture(scope="module")
def deform_case():
    """A JAX field of each kind, its params with every ``out`` layer made
    nonzero (so the deformation moves points), and a shared asset."""
    rng = np.random.default_rng(6)
    d = {k: v.astype(np.float32) for k, v in _state_np(rng, n=50, deg=0).items()}
    jst = jstate.GaussianState(**{k: jnp.asarray(v) for k, v in d.items()}, sh_degree=0)
    out = {}
    for global_trans in (False, True):
        cfg = jdeform.DeformConfig(grid_sizes=GRID, grid_feature_dim=4,
                                   use_global_trans=global_trans)
        field = jdeform.DeformationField(cfg)
        params = jax.jit(field.init)(jax.random.PRNGKey(0), jst, jnp.asarray(0.0))
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: jnp.asarray(rng.normal(size=v.shape) * 0.2, v.dtype)
            if "out" in jax.tree_util.keystr(p) else v, params)
        ts = jnp.asarray(np.linspace(-1, 1, 4), jnp.float32)
        ref, one = jax.jit(lambda p: (
            field.apply(p, jst, ts, True, method=jdeform.DeformationField.deform_frames),
            field.apply(p, jst, jnp.asarray(0.25), False,
                        method=jdeform.DeformationField.deform)))(params)
        out[global_trans] = (jax.tree_util.tree_map(np.asarray, params),
                             [np.asarray(x) for x in ref], [np.asarray(x) for x in one[:3]])
    return GaussianState.from_numpy(**d), out


@pytest.mark.parametrize("global_trans", [False, True])
def test_deform_frames_matches_jax(deform_case, global_trans):
    st, cases = deform_case
    params, ref, one = cases[global_trans]
    field = DeformationField(DeformConfig(grid_sizes=GRID, grid_feature_dim=4,
                                          use_global_trans=global_trans))
    field.load_state_dict(deform_params_from_flax(params), strict=True)
    with torch.no_grad():
        got = field.deform_frames(st, torch.linspace(-1, 1, 4), True)
        got_one = field.deform(st, 0.25, False)[:3]
        many = field.deform_frames(st, torch.tensor([0.25]), False)
    assert np.abs(ref[0] - st.xyz.numpy()).max() > 1e-2  # the field moves the points
    for a, b, name in zip(list(got) + list(got_one), ref + one, ("xyz", "rot", "scales") * 2):
        np.testing.assert_allclose(a.numpy(), b, atol=2e-5, err_msg=name)
    for a, b in zip(many, got_one):
        np.testing.assert_allclose(a[0].numpy(), b.numpy(), atol=1e-6)


def test_deform_field_init_layout():
    """Zero ``out`` layers, time planes of 1, space planes in [0.1, 0.5]."""
    field = DeformationField(DeformConfig(grid_sizes=GRID, grid_feature_dim=4,
                                          use_global_trans=True),
                             generator=torch.Generator().manual_seed(0))
    sd = field.state_dict()
    assert all(float(v.abs().max()) == 0 for k, v in sd.items() if k.endswith("out.weight"))
    for p, (c0, c1) in enumerate(kplanes.COO_COMBS):
        v = sd[f"grid_0_{p}"]
        assert v.shape == (4, GRID[0][c1], GRID[0][c0])
        if c1 == 3:
            assert bool((v == 1).all())
        else:
            assert 0.1 <= float(v.min()) and float(v.max()) <= 0.5


def test_knn_matches_jax():
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    d2, idx = knn.knn(T(pts), T(pts), k=4, exclude_self=True, chunk=128)
    jd2, jidx = jknn.knn(jnp.asarray(pts), jnp.asarray(pts), k=4, exclude_self=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), atol=1e-6)
    np.testing.assert_allclose(knn.mean_sq_dist_to_knn(T(pts)).numpy(),
                               np.asarray(jknn.mean_sq_dist_to_knn(jnp.asarray(pts))), atol=1e-6)


def test_arap_matches_jax():
    """Connectivity (with the rest-frame radius filter) and the ARAP energy
    with the same node sample and frame weights."""
    rng = np.random.default_rng(8)
    nv, nt = 120, 4
    base = rng.uniform(-0.3, 0.3, (nv, 3)).astype(np.float32)
    seq = np.stack([base] + [base + rng.normal(0, 0.01, (nv, 3)).astype(np.float32)
                             for _ in range(nt - 1)])
    conn = arap.connectivity_from_points(T(seq[:2]), radius=0.05, K=5)
    jconn = jarap.connectivity_from_points(jnp.asarray(seq[:2]), radius=0.05, K=5)
    np.testing.assert_array_equal(conn.nn_idx.numpy(), np.asarray(jconn.nn_idx))
    # exp(-d² / mean d²) of distances summed in another order (see knn)
    np.testing.assert_allclose(conn.weight.numpy(), np.asarray(jconn.weight), rtol=2e-4,
                               atol=1e-7)
    key = jax.random.PRNGKey(3)
    sample = np.array(jax.random.choice(key, nv, (32,), replace=True))
    fw = np.asarray([1.0, 0.0, 0.5], np.float32)
    got = arap.arap_error(T(seq), conn, sample_idx=torch.as_tensor(sample), sample_num=32,
                          frame_weights=T(fw))
    ref = jax.jit(lambda s, c, k, w: jarap.arap_error(s, c, k, sample_num=32,
                                                      frame_weights=w))(
        jnp.asarray(seq), jconn, key, jnp.asarray(fw))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    # undeformed frames: identity rotations, zero energy
    still = arap.arap_error(T(np.stack([base] * 3)), conn, sample_idx=torch.as_tensor(sample))
    assert float(still) == 0.0


def test_estimate_rotations_matches_jax():
    rng = np.random.default_rng(9)
    src = rng.normal(size=(40, 6, 3)).astype(np.float32)
    R = np.asarray(jrot.quat_to_matrix(jnp.asarray(_quats(rng, 40))))
    tgt = np.einsum("nij,nkj->nki", R, src) + rng.normal(0, 0.01, src.shape).astype(np.float32)
    tgt[:5] = -tgt[:5]  # reflections: the det <= 0 column flip
    w = rng.uniform(size=(40, 6)).astype(np.float32)
    np.testing.assert_allclose(
        arap.estimate_rotations(T(src), T(tgt), T(w)).numpy(),
        np.asarray(jarap.estimate_rotations(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w))),
        atol=1e-4)


def test_mesh_edge_helpers_match_jax(tmp_path):
    edges = {"0": {"1": 1.0, "2": 1.0}, "1": {"0": 1.0}, "2": {"0": 1.0, "1": 1.0, "3": 1.0},
             "3": {"2": 1.0}}
    nn_idx, valid = arap.connectivity_from_mesh_edges(edges)
    jidx, jvalid = jarap.connectivity_from_mesh_edges(json.loads(json.dumps(edges)))
    np.testing.assert_array_equal(nn_idx, jidx)
    key = jax.random.PRNGKey(4)
    scores = np.asarray(jax.random.uniform(key, nn_idx.shape))
    got = arap.sample_neighbor_subset(torch.as_tensor(nn_idx), torch.as_tensor(valid), 2,
                                      scores=T(scores))
    ref = jarap.sample_neighbor_subset(key, jnp.asarray(jidx), jnp.asarray(jvalid), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
