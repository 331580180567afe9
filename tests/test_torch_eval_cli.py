"""Stage 1's evaluation surface in the port against the JAX package, on the
CPU: the evaluation cameras (exact), PSNR / SSIM / LPIPS (random LPIPS
weights carried to both packages from one torch state dict), the
``attention_backend`` routes (``packed_flash``'s plain path against the
Pallas ``packed_temporal_flash`` forward in interpret mode), and tiny
drives of ``--test`` on the testset grid, ``--validate`` and ``--export``
that check the files written. Inputs are made by numpy from a seed.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animate3d_tpu.data import cameras as jcams
from animate3d_tpu.ops import attention as JA
from animate3d_tpu.utils import metrics as jmetrics
from animate3d_tpu_torch.data import cameras
from animate3d_tpu_torch.ops import _build
from animate3d_tpu_torch.ops import attention as TA
from animate3d_tpu_torch.utils import metrics

from torch_cpu_host import warm_vml

warm_vml()  # before the first torch.exp: see tests/torch_cpu_host.py

_KEYS = ("c2w", "fovy", "camera_positions", "elevation", "azimuth", "camera_distances",
         "timestamps", "height", "width")


@pytest.mark.parametrize("name,kwargs", [
    ("val_orbit_cameras", dict(n_views=7, height=32, width=32, total_frame=4)),
    ("testset_grid_cameras", dict(height=64, width=64, total_frame=2)),
    ("testset_grid_cameras", dict(elevations_deg=(5.0, -10.0),
                                  azimuth_sets_deg=((0.0, 45.0, 90.0), (10.0, 20.0, 30.0)),
                                  distance=2.5, fovy_deg=30.0, total_frame=3)),
])
def test_eval_cameras_match_jax(name, kwargs):
    mine, ref = getattr(cameras, name)(**kwargs), getattr(jcams, name)(**kwargs)
    for k in _KEYS:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)


def test_testset_grid_pairs_each_elevation_with_its_azimuths():
    b = cameras.testset_grid_cameras(total_frame=1)
    assert b["elevation"].tolist() == [15.0] * 4 + [0.0] * 4 + [30.0] * 4
    assert b["azimuth"][4:8].tolist() == [30.0, 120.0, 210.0, 300.0]
    with pytest.raises(ValueError, match="one azimuth set per elevation"):
        cameras.testset_grid_cameras(elevations_deg=(0.0,), total_frame=1)


def _images(seed, n=2, h=48, w=40):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    return a, b


def test_psnr_and_ssim_match_jax():
    """PSNR at 1e-5 relative; SSIM (per image and of one (H, W, C) image) at
    atol 1e-5: f32 window sums in another order."""
    a, b = _images(0)
    np.testing.assert_allclose(float(metrics.psnr(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    np.testing.assert_allclose(
        metrics.psnr(torch.from_numpy(a), torch.from_numpy(b), axis=(-3, -2, -1)).numpy(),
        np.asarray(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b), axis=(-3, -2, -1))),
        rtol=1e-5)
    np.testing.assert_allclose(metrics.ssim(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-5)
    np.testing.assert_allclose(float(metrics.ssim(torch.from_numpy(a[0]), torch.from_numpy(b[0]))),
                               float(jmetrics.ssim(jnp.asarray(a[0]), jnp.asarray(b[0]))),
                               atol=1e-5)


def _random_lpips_states(seed):
    """torchvision ``alexnet().features`` and ``lpips`` linear-head state
    dicts with random weights."""
    rng = np.random.default_rng(seed)
    alex, lin, cin = {}, {}, 3
    for i, (tid, cout, k) in enumerate(zip((0, 3, 6, 8, 10), (64, 192, 384, 256, 256),
                                           (11, 5, 3, 3, 3))):
        alex[f"{tid}.weight"] = torch.from_numpy(
            (rng.normal(size=(cout, cin, k, k)) / np.sqrt(k * k * cin)).astype(np.float32))
        alex[f"{tid}.bias"] = torch.from_numpy(rng.normal(scale=0.1, size=cout).astype(np.float32))
        lin[f"lin{i}.model.1.weight"] = torch.from_numpy(
            rng.uniform(-0.2, 1.0, size=(1, cout, 1, 1)).astype(np.float32))
        cin = cout
    return alex, lin


def test_lpips_matches_jax():
    """The port's Lpips module and the JAX package's, both from one pair of
    torch state dicts through their ``lpips_params_from_torch``: distances
    at 1e-4 relative (f32 convolution sums in another order through five
    layers)."""
    alex, lin = _random_lpips_states(1)
    x, y = _images(2, n=2, h=67, w=64)
    model = metrics.Lpips()
    model.load_state_dict(metrics.lpips_params_from_torch(alex, lin))
    with torch.no_grad():
        d = model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    ref = np.asarray(jmetrics.Lpips()(jmetrics.lpips_params_from_torch(alex, lin),
                                      jnp.asarray(x), jnp.asarray(y)))
    assert d.shape == (2,) and (d > 0).all()
    np.testing.assert_allclose(d, ref, rtol=1e-4)


def test_load_lpips_reads_the_jax_npz_and_is_none_without_weights(tmp_path, monkeypatch):
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    monkeypatch.chdir(tmp_path)
    assert metrics.load_lpips() is None
    alex, lin = _random_lpips_states(3)
    params = jmetrics.lpips_params_from_torch(alex, lin)
    path = tmp_path / "lpips.npz"
    np.savez(path, **{f"{m}/{leaf}": np.asarray(v) for m, d in params.items()
                      for leaf, v in d.items()})
    model = metrics.load_lpips(str(path))
    x, y = _images(4, n=1, h=64, w=64)
    with torch.no_grad():
        d = model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(d, np.asarray(jmetrics.Lpips()(params, jnp.asarray(x),
                                                              jnp.asarray(y))), rtol=1e-4)


@pytest.mark.parametrize("batch,seq,head_dim", [
    pytest.param(24, 16, 40, id="40"), pytest.param(24, 16, 160, id="160"),
    pytest.param(8, 32, 160, id="32-160")])
def test_packed_flash_plain_path_matches_pallas_kernel(batch, seq, head_dim):
    """``attention_backend("packed_flash")`` on a temporal site (S = 16 with
    d = 40 as at L0, 160 as at L2, L3 and mid; S = 32 with d = 160, a
    32-frame clip at the 1280-channel motion modules, which kernel B takes)
    on the CPU takes kernel B's plain version, which computes what the TPU's
    ``packed_temporal_flash`` kernel computes (its Pallas forward in
    interpret mode): atol 1e-5 in f32. Nothing is launched."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(batch, seq, 2 * head_dim)).astype(np.float32)
               for _ in range(3))
    scale = head_dim ** -0.5
    ref = np.asarray(JA._packed_temporal_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v), 2, scale))
    _build.reset_launches()
    with TA.attention_backend("packed_flash"):
        out = TA.multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), 2, self_attention=True)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    assert sum(_build.launch_totals().values()) == 0


# (batch, sq, sk, channels, heads, self-attention) of the UNet's sites at
# 256² (the CFG batch): spatial / cross-view flash sites, text cross-attention,
# temporal sites at L0-L3; L2 cross-view sites at 512² (160-wide heads),
# one of them at the CFG batch; an L2 temporal site of a 32-frame clip, and
# L0 and L2 temporal sites of a one-frame clip
_SITES = [(32, 4096, 4096, 320, 8, True), (32, 1024, 1024, 640, 8, True),
          (128, 1024, 77, 320, 8, False), (8192, 16, 16, 320, 8, True),
          (2048, 16, 16, 640, 8, True), (512, 16, 16, 1280, 8, True),
          (8, 1024, 1024, 1280, 8, True), (32, 1024, 1024, 1280, 8, True),
          (512, 32, 32, 1280, 8, True), (8192, 1, 1, 320, 8, True),
          (512, 1, 1, 1280, 8, True)]


@pytest.mark.parametrize("backend", ["xla", "flash", "packed", "packed_flash"])
def test_forced_backends_route_as_jax(backend, monkeypatch):
    """Under each forced backend, the port's route on CUDA is the JAX
    package's on the TPU: its padded plans under the override, then
    ``multi_head_attention(backend=...)``. A forced flash still packs the
    temporal sites (the pinned quirk); packed_flash takes F's kernel where
    the TPU does, at every head width."""
    monkeypatch.setattr(JA.jax, "default_backend", lambda: "tpu")
    for b, sq, sk, c, h, self_attn in _SITES:
        with JA.attention_backend(backend):
            if self_attn and JA.padded_packed_plan(b, sq, c, h):
                jax_route = "packed"
            elif JA.padded_flash_plan(b, sq, sk, c, h):
                jax_route = "flash"
            else:
                packable = sq == sk and sq <= 32 and b >= 2 * (128 // sq)
                if packable and backend == "packed_flash" and 128 % sq == 0:
                    jax_route = "packed_flash"
                elif packable and backend in ("packed", "packed_flash"):
                    jax_route = "packed_plain"
                elif backend == "flash" and sk % 512 == 0:
                    jax_route = "flash"
                else:
                    jax_route = "plain"
        mine = TA.forced_plan(b, sq, sk, c, h, self_attn, sq == sk, True, backend)
        assert mine == jax_route, (backend, b, sq, sk, c)
        if mine == "packed_flash":  # kernel B forward, kernel E backward: neither raises
            assert TA.packed_kernel_takes(sq, c // h), (sq, c, h)
            TA.check_packed_shape("packed_attention", sq, c, h)
            TA.check_packed_shape("packed_attention_bwd", sq, c, h)
        if mine == "flash":  # kernels A and D take it: the wrapper does not raise
            assert TA.flash_kernel_takes(c // h), (sq, c, h)
        if backend != "flash":
            assert TA.forced_plan(b, sq, sk, c, h, self_attn, sq == sk, False, backend) != \
                "packed_flash"
    if backend == "packed_flash":  # a 32-frame clip at 160-wide heads: kernel B as F, then E
        assert TA.forced_plan(512, 32, 32, 1280, 8, True, True, True, backend) == "packed_flash"
        assert TA.packed_kernel_takes(32, 160)
        TA.check_packed_shape("packed_attention_bwd", 32, 1280, 8)
        with pytest.raises(ValueError, match="unsupported S=24, D=160"):
            TA.check_packed_shape("packed_attention_bwd", 24, 1280, 8)
    with pytest.raises(ValueError, match="is not one of"):
        with TA.attention_backend("pallas"):
            pass


def test_packed_kernel_takes_the_motion_modules_head_widths():
    """Kernel B and its backward E take 40-, 80- and 160-wide heads at every
    S up to 32 dividing 128, as the TPU's ``padded_packed_plan`` (the F route
    at the 1280-channel motion modules, 32-frame and one-frame clips
    included): one rule, ``packed_kernel_takes``, for both. Nothing else, so
    the F route raises on CUDA rather than taking the plain version."""
    assert TA.PACKED_SEQ == tuple(s for s in range(1, 33) if 128 % s == 0)
    for s in TA.PACKED_SEQ:
        for d in (40, 80, 160):
            assert TA.packed_kernel_takes(s, d), (s, d)
            for name in ("packed_attention", "packed_attention_bwd"):
                TA.check_packed_shape(name, s, 8 * d, 8)
    assert not hasattr(TA, "packed_bwd_kernel_takes")
    for s, d in ((16, 64), (16, 128), (24, 40), (64, 40), (16, 320)):
        assert not TA.packed_kernel_takes(s, d), (s, d)
        with pytest.raises(ValueError, match="packed_attention_bwd: unsupported"):
            TA.check_packed_shape("packed_attention_bwd", s, 8 * d, 8)


@pytest.mark.parametrize("head_dim", [40, 160])
def test_packed_bwd_plain_at_32_frames_matches_jax_vjp(head_dim):
    """Kernel E's plain version at S 32 (a 32-frame clip at 40- and
    160-wide heads, the shape E takes since its redesign) against
    ``jax.vjp`` of ``packed_temporal_flash``, whose backward is XLA's
    recompute of the packed attention: directly, and through
    ``PackedAttentionFn`` under ``attention_backend("packed_flash")`` (the
    CPU takes the plain versions). f32 at "highest" precision, atol 1e-5."""
    rng = np.random.default_rng(9 + head_dim)
    b, s, h = 8, 32, 2
    q, k, v, g = (rng.normal(size=(b, s, h * head_dim)).astype(np.float32) for _ in range(4))
    scale = head_dim ** -0.5
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda *a: JA.packed_temporal_flash(*a, h, scale),
                         *(jnp.asarray(x) for x in (q, k, v)))
        ref = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    got = TA._packed_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v, g)), h, scale)
    for x, r in zip(got, ref):
        np.testing.assert_allclose(x.numpy(), r, atol=1e-5)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    _build.reset_launches()
    with TA.attention_backend("packed_flash"):
        out = TA.multi_head_attention(*leaves, h, self_attention=True)
    for x, r in zip(torch.autograd.grad(out, leaves, torch.from_numpy(g)), ref):
        np.testing.assert_allclose(x.numpy(), r, atol=1e-5)
    assert sum(_build.launch_totals().values()) == 0


# --- tiny drives of the evaluation entry points -----------------------------

NV, NF, RES = 4, 2, 32


@pytest.fixture(scope="module")
def trial(tmp_path_factory):
    """A trained tiny trial: a seeded random asset written by the port, 8
    RGBA frames rendered from it, the recon config at 32² (kernel G's
    route) trained for one step."""
    from PIL import Image

    from animate3d_tpu_torch.cli.launch import main
    from animate3d_tpu_torch.gaussians.ply import write_gaussian_ply
    from animate3d_tpu_torch.gaussians.state import random_state

    root = tmp_path_factory.mktemp("eval_cli")
    write_gaussian_ply(str(root / "asset.ply"),
                       random_state(40, radius=0.4, opacity_init=0.5,
                                    generator=torch.Generator().manual_seed(0)))
    (root / "frames").mkdir()
    rng = np.random.default_rng(0)
    for i in range(NV * NF):
        rgba = rng.uniform(0, 255, size=(RES, RES, 4)).astype(np.uint8)
        Image.fromarray(rgba, "RGBA").save(root / "frames" / f"{i}.png")
    cfg = f"""
name: "eval"
tag: "t"
use_timestamp: false
exp_root_dir: "{root}/outputs"
data:
  image_root: "{root}/frames"
  height: {RES}
  width: {RES}
  n_view: {NV}
  total_frame: {NF}
  n_val_views: 6
  random_camera:
    eval_height: 16
    eval_width: 16
    eval_elevation_deg: [15.0, 0.0]
    eval_azimuth_deg: [[0.0, 90.0], [45.0, 135.0]]
system:
  n_view: {NV}
  n_frame: {NF}
  test_option: "four_view"
  geometry:
    grid_size: [[8, 8, 8, 3]]
    n_grid_dims: 4
    use_global_trans: true
    geometry_convert_from: "{root}/asset.ply"
  renderer:
    back_ground_color: [0.5, 0.5, 0.5]
  loss:
    arap_K: 2
    arap_sample_num: 8
trainer:
  max_steps: 1
"""
    (root / "config.yaml").write_text(cfg)
    main(["--config", str(root / "config.yaml"), "--train", "--device", "cpu"])
    return root


def _run(trial, *args):
    from animate3d_tpu_torch.cli.launch import main

    return main(["--config", str(trial / "config.yaml"), "--device", "cpu", *args])


def test_test_renders_the_testset_grid(trial):
    """``system.test_option=testset``: the grid from data.random_camera (a
    data.<key> override wins: 24² here), resumed from the checkpoint named
    by ``resume``; one png per render, one video per view, no report."""
    from PIL import Image

    ckpt = trial / "outputs" / "eval" / "t" / "ckpts" / "step_1"
    res = _run(trial, "--test", "system.test_option=testset", f"resume={ckpt}",
               "data.eval_height=24", "data.eval_width=24")
    save = trial / "outputs" / "eval" / "t" / "save"
    images = os.listdir(save / "images")
    assert len(images) == 4 * NF and res["rgb"].shape == (4, NF, 24, 24, 3)
    with Image.open(save / "images" / "0.png") as im:
        assert im.size == (24, 24) and im.mode == "RGBA"
    assert len(res["videos"]) == 4 and all(os.path.exists(v) for v in res["videos"])
    assert res["report"] is None and np.isfinite(res["rgb"]).all()


def test_validate_renders_the_orbit(trial):
    res = _run(trial, "--validate", "data.eval_height=16", "data.eval_width=16")
    assert res["rgb"].shape == (6, 16, 16, 3) and np.isfinite(res["rgb"]).all()
    assert res["gif"].endswith(os.path.join("val", "orbit.gif")) and os.path.exists(res["gif"])
    assert os.path.exists(res["video"])
    from PIL import Image

    with Image.open(res["gif"]) as gif:
        assert gif.size == (16, 16)


def test_export_writes_trajectories_and_the_report(trial):
    """``--export``: the four-view test with per-frame trajectories, and the
    PSNR / SSIM report against the frames, whose numbers are the metrics'
    own on the rendered images."""
    res = _run(trial, "--export")
    save = trial / "outputs" / "eval" / "t" / "save"
    trajs = sorted(os.listdir(save / "gaussian_trajectory"))
    assert trajs == [f"means3D_frame_{f}.npy" for f in range(NF)]
    assert np.load(save / "gaussian_trajectory" / trajs[0]).shape == (40, 3)
    report = json.load(open(save / "metrics_test.json"))
    assert report == res["report"] and len(report["per_view"]) == NV and "lpips" not in report
    from animate3d_tpu_torch.data.multi_image import load_rgba_frames

    gt_rgb, gt_mask = load_rgba_frames(str(trial / "frames"), RES, RES)
    gt = (gt_rgb * gt_mask + 0.5 * (1.0 - gt_mask)).reshape(NV, NF, RES, RES, 3)
    p0 = float(metrics.psnr(torch.from_numpy(res["rgb"][0]), torch.from_numpy(gt[0])))
    assert report["per_view"][0]["psnr"] == round(p0, 3)
    assert np.isfinite([report["psnr"], report["ssim"]]).all()
