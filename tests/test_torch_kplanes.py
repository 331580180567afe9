"""``kplanes.sample_frames``: the K-planes features of N points at F times.

On the CPU it is the plain gather (``interpolate_ms_features`` on the
points ``cat(xyz, t)`` of every frame), held here against that gather frame
by frame, values and plane gradients, with points at and beyond ±1 and
times at both ends; ``deform_many`` and ``features()`` give what they gave
before it. On the card it is kernel I (``csrc/kplanes.cu``), held against
the plain gather (``routing.plain_ops``) by the ``cuda`` tests at the recon
shapes. This file imports nothing of JAX: the JAX-parity tests of the
gather stay in ``tests/test_torch_gaussians.py``.
"""

import numpy as np
import pytest
import torch

from animate3d_tpu_torch.gaussians import kplanes
from animate3d_tpu_torch.gaussians.deform import DeformationField, DeformConfig
from animate3d_tpu_torch.gaussians.state import GaussianState
from animate3d_tpu_torch.ops import _build, routing

GRID = ((6, 7, 8, 4), (10, 9, 11, 5))
RECON_GRID = ((50, 50, 50, 8), (100, 100, 100, 16))  # motion_recon_frame_16.yaml


def _grids(rng, grid, dim, device="cpu"):
    """Per scale the six planes: time planes about 1, space planes in
    [0.1, 0.5], as the field starts and trains."""
    out = []
    for reso in grid:
        planes = []
        for c0, c1 in kplanes.COO_COMBS:
            lo, hi = (0.5, 1.5) if c1 == 3 else (0.1, 0.5)
            p = rng.uniform(lo, hi, (dim, reso[c1], reso[c0])).astype(np.float32)
            planes.append(torch.tensor(p, device=device, requires_grad=True))
        out.append(planes)
    return out


def _points(rng, n, device="cpu"):
    """Points in [-1.2, 1.2]³ with corners at exactly ±1 and beyond (the
    clamp and the border cell x0 == x1)."""
    xyz = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    xyz[:4] = [[-1, -1, -1], [1, 1, 1], [1.0, -1.0, 1.2], [-1.5, 1.5, 0.0]]
    return torch.tensor(xyz, device=device)


def _times(f, device="cpu"):
    ts = np.linspace(-1, 1, f) if f > 1 else np.array([0.37])
    return torch.tensor(ts, dtype=torch.float32, device=device)


def _per_frame(xyz, ts, grids):
    """The gather one frame at a time, as ``deform`` asks it."""
    n = xyz.shape[0]
    return torch.stack([kplanes.interpolate_ms_features(
        torch.cat([xyz, t.expand(n, 1)], dim=-1), grids) for t in ts])


@pytest.mark.parametrize("f", [1, 3])
def test_sample_frames_on_cpu_is_the_gather_at_every_frame(f):
    rng = np.random.default_rng(f)
    grids = _grids(rng, GRID, 4)
    xyz, ts = _points(rng, 40), _times(f)
    planes = [p for s in grids for p in s]
    before = dict(_build.LAUNCHES)
    got = kplanes.sample_frames(xyz, ts, grids)
    assert dict(_build.LAUNCHES) == before  # the CPU never counts a launch
    want = _per_frame(xyz, ts, grids)
    assert got.shape == (f, 40, 8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    cot = torch.tensor(rng.normal(size=got.shape).astype(np.float32))
    g_got = torch.autograd.grad(got, planes, cot)
    g_want = torch.autograd.grad(want, planes, cot)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert all(float(g.abs().max()) > 0 for g in g_got)


def test_deform_many_and_features_unchanged():
    """``deform_many`` against its earlier body (the gather on the
    expanded points) and ``features()`` against the one-frame gather,
    bitwise."""
    rng = np.random.default_rng(9)
    n = 30
    field = DeformationField(DeformConfig(grid_sizes=GRID, grid_feature_dim=4,
                                          use_global_trans=True),
                             generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in field.named_parameters():
            if name.endswith("out.weight"):
                p.copy_(torch.tensor(rng.normal(0, 0.2, p.shape).astype(np.float32)))
    q = rng.normal(size=(n, 4)).astype(np.float32)
    st = GaussianState.from_numpy(
        xyz=_points(rng, n).numpy(), features_dc=np.zeros((n, 1, 3)),
        features_rest=np.zeros((n, 0, 3)), opacity=np.zeros((n, 1)),
        scaling=rng.normal(-3, 0.1, (n, 3)), rotation=q / np.linalg.norm(q, axis=-1, keepdims=True))
    ts = _times(4)
    with torch.no_grad():
        got = field.deform_many(st, ts, True)
        pts = torch.cat([st.xyz.expand(4, n, 3), ts[:, None, None].expand(4, n, 1)], dim=-1)
        feats = kplanes.interpolate_ms_features(pts.reshape(4 * n, 4), field.grids)
        want = field._displace(st.xyz, st.rotation, st.scaling, feats.reshape(4, n, -1), True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        t = torch.tensor(0.25)
        assert torch.equal(field.features(st.xyz, 0.25), kplanes.interpolate_ms_features(
            torch.cat([st.xyz, t.expand(n, 1)], dim=-1), field.grids))


def test_kernel_i_refuses_time_rows_beyond_shared_memory():
    """Kernel I sums a scale's three time planes' rows in a block's shared
    memory; a grid whose rows do not fit is refused before anything runs
    (here 300 x (40 + 40 + 40) cells of 20 bytes, 720,000 > 232,448), as
    are other layouts it does not serve."""
    from animate3d_tpu_torch.ops import kplanes as kernel_i

    rng = np.random.default_rng(2)
    xyz, ts = _points(rng, 10), _times(2)
    with torch.no_grad():
        with pytest.raises(ValueError, match="shared memory"):
            kernel_i.sample_frames(xyz, ts, _grids(rng, ((40, 40, 40, 300),), 4))
        with pytest.raises(ValueError, match="multiple of 4"):
            kernel_i.sample_frames(xyz, ts, _grids(rng, GRID, 6))
        with pytest.raises(ValueError, match="1 to 4"):
            kernel_i.sample_frames(xyz, ts, _grids(rng, GRID * 3, 4))


# -- kernel I on the card -------------------------------------------------------------

CUDA_CASES = {
    # the recon step's buckets, the mesh's 15 active frames and the
    # one-frame features() call at the recon config: 20,000 points, both
    # scales, 16 channels
    **{f"recon-f{f}": (RECON_GRID, 16, 20000, f) for f in (1, 2, 4, 8, 15, 16)},
    # 4 channels a plane, rectangular planes, 5 and 4 time rows
    "odd-c4": (GRID, 4, 3000, 5),
}


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_kernel_i_matches_the_gather_on_cuda(case):
    """Kernel I against the plain gather on the card: features relative L2
    <= 1e-6 (the same float operations in the same order: 0 expected),
    each plane's gradient relative L2 <= 1e-5 (f32 sums by atomics in
    another order); one forward and one backward launch counted, none
    through the gather."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    grid, dim, n, f = CUDA_CASES[case]
    rng = np.random.default_rng(len(case) + f)
    grids = _grids(rng, grid, dim, "cuda")
    planes = [p for s in grids for p in s]
    xyz, ts = _points(rng, n, "cuda"), _times(f, "cuda")
    cot = torch.randn((f, n, dim * len(grid)), device="cuda")
    _build.reset_launches()
    out = kplanes.sample_frames(xyz, ts, grids)
    g_k = torch.autograd.grad(out, planes, cot)
    torch.cuda.synchronize()
    key = (f, n, len(grid))
    assert _build.LAUNCHES["kplanes_fwd", key] == 1
    assert _build.LAUNCHES["kplanes_bwd", key] == 1
    with routing.plain_ops():
        ref = kplanes.sample_frames(xyz, ts, grids)
        g_p = torch.autograd.grad(ref, planes, cot)
    assert sum(_build.launch_totals().values()) == 2
    assert _rel(out, ref) <= 1e-6
    for a, b in zip(g_k, g_p):
        assert _rel(a, b) <= 1e-5


@pytest.mark.cuda
def test_kernel_i_refuses_a_gradient_of_the_points_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    grids = _grids(rng, GRID, 4, "cuda")
    xyz, ts = _points(rng, 10, "cuda"), _times(2, "cuda")
    with pytest.raises(ValueError, match="no gradient"):
        kplanes.sample_frames(xyz.requires_grad_(), ts, grids)
    with pytest.raises(ValueError, match="no gradient"):
        kplanes.sample_frames(xyz.detach(), ts.requires_grad_(), grids)
    with torch.no_grad():
        assert kplanes.sample_frames(xyz, ts, grids).shape == (2, 10, 8)


@pytest.mark.cuda
def test_deform_many_launches_no_index_kernel_on_cuda():
    """The recon path's deformation, forward and backward, on the card: no
    ``index_elementwise`` gather or ``indexing_backward`` scatter left."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    field = DeformationField(DeformConfig(grid_sizes=RECON_GRID, use_global_trans=True),
                             generator=torch.Generator().manual_seed(0)).cuda()
    rng = np.random.default_rng(1)
    n = 2000
    q = rng.normal(size=(n, 4)).astype(np.float32)
    st = GaussianState.from_numpy(
        xyz=_points(rng, n).numpy(), features_dc=np.zeros((n, 1, 3)),
        features_rest=np.zeros((n, 0, 3)), opacity=np.zeros((n, 1)),
        scaling=rng.normal(-3, 0.1, (n, 3)),
        rotation=q / np.linalg.norm(q, axis=-1, keepdims=True), device="cuda")
    ts = _times(16, "cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = field.deform_many(st, ts, True)
        sum(o.sum() for o in out).backward()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert any("kplanes_fwd_kernel" in k for k in names)
    assert any("kplanes_bwd_kernel" in k for k in names)
    assert not [k for k in names if "index_elementwise" in k or "indexing_backward" in k]
