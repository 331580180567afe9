"""The port's rasterizer (``animate3d_tpu_torch/ops/rasterize.py``) against the
JAX package's, on the CPU.

Kernel H's plain versions against ``composite_coarse_pallas`` /
``composite_coarse_pallas_bwd`` in interpret mode on the same fields
(kc 256: two candidate blocks; cases where the early stop binds, where the
0.99 clamp binds and where a block misses a fine tile); ``rasterize``
against JAX ``rasterize(backend="pallas")`` with ``approx_binning=False``
on a 128² scene (RGB, depth, alpha, overflow, gradients of the 5 gaussian
inputs). Inputs are made by numpy from a seed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animate3d_tpu.ops import rasterize as jrz
from animate3d_tpu.ops.rasterize_pallas import composite_coarse_pallas, composite_coarse_pallas_bwd
from animate3d_tpu.utils import camera as jcam
from animate3d_tpu_torch.ops import _build, routing
from animate3d_tpu_torch.ops import rasterize as R

from torch_cpu_host import warm_vml

warm_vml()  # before the first torch.exp: see tests/torch_cpu_host.py

CS, EXT = 4, 64  # coarse tile: 4 x 4 fine tiles of 16 px


def make_fields(seed, n_ct=3, kc=256):
    """Coarse tiles of depth-sorted candidates. Tile 0: its second block sits
    in the first fine tile only (the block misses the other 15). Tile 1:
    random. Tile 2: an opaque front block covering the whole coarse tile,
    so the largest transmittance falls under 1e-4 and the second block is
    skipped everywhere. Opacity 1 near the first candidates' centres makes
    the 0.99 clamp bind."""
    rng = np.random.default_rng(seed)
    corig = np.stack([np.arange(n_ct) * EXT, np.zeros(n_ct)], 1).astype(np.float32)
    f = np.zeros((n_ct, 12, kc), np.float32)
    for c in range(n_ct):
        x0 = corig[c, 0]
        f[c, 0] = rng.uniform(x0 - 8, x0 + EXT + 8, kc)
        f[c, 1] = rng.uniform(-8, EXT + 8, kc)
        sx, sy = rng.uniform(1.5, 9, kc), rng.uniform(1.5, 9, kc)
        rho = rng.uniform(-0.5, 0.5, kc)
        c00, c11, c01 = sx ** 2, sy ** 2, rho * sx * sy
        det = c00 * c11 - c01 ** 2
        f[c, 2], f[c, 3], f[c, 4] = c11 / det, -c01 / det, c00 / det
        f[c, 5] = rng.uniform(0.05, 1.0, kc)
        # wide, opaque: raw = e^power > 0.99 within ~1 px of the centre
        f[c, 2, :20], f[c, 3, :20], f[c, 4, :20], f[c, 5, :20] = 1 / 64, 0.0, 1 / 64, 1.0
        f[c, 6:9] = rng.uniform(0, 1, (3, kc))
        f[c, 9] = np.sort(rng.uniform(1, 5, kc))
        f[c, 10] = rng.uniform(size=kc) > 0.1
        f[c, 11] = np.ceil(3 * np.maximum(sx, sy))
    f[0, 0, 128:] = rng.uniform(2, 12, kc - 128)
    f[0, 1, 128:] = rng.uniform(2, 12, kc - 128)
    f[0, 11, 128:] = np.minimum(f[0, 11, 128:], 3.0)
    f[2, 0, :128] = rng.uniform(2 * EXT, 3 * EXT, 128)
    f[2, 1, :128] = rng.uniform(0, EXT, 128)
    f[2, 2, :128], f[2, 3, :128], f[2, 4, :128] = 5e-4, 0.0, 5e-4
    f[2, 5, :128], f[2, 10, :128], f[2, 11, :128] = 1.0, 1.0, 200.0
    return corig, f


@pytest.fixture(scope="module", params=[0, 1])
def h_case(request):
    seed = request.param
    corig, f = make_fields(seed)
    cot = (np.random.default_rng(seed + 10).normal(size=(3, CS * CS, 8, 256)) * 1e-2
           ).astype(np.float32)
    jc, jf = jnp.asarray(corig), jnp.asarray(f)
    planes = np.asarray(composite_coarse_pallas(jc, jf, interpret=True))
    grad = np.asarray(composite_coarse_pallas_bwd(jc, jf, jnp.asarray(cot), interpret=True))
    return corig, f, cot, planes, grad


def test_h_cases_bind(h_case):
    """The fields exercise what they claim to."""
    corig, f, cot, planes, grad = h_case
    assert planes[2, :, 5].max() < 1e-4  # T after the opaque block: early stop
    assert np.abs(grad[2, :, 128:]).max() == 0.0  # ... so block 2 takes no gradient
    # block 2 of tile 0: every AABB inside fine tile 0 (x, y + r < 16), so it
    # misses the other 15 fine tiles, and fine tile 0 takes it
    assert (f[0, 0, 128:] + f[0, 11, 128:] < 16).all()
    assert (f[0, 1, 128:] + f[0, 11, 128:] < 16).all()
    assert np.abs(grad[0, 6:9, 128:]).max() > 0


def test_h_plain_forward_matches_pallas(h_case):
    corig, f, cot, planes, grad = h_case
    out = R._composite_coarse_plain(torch.from_numpy(f), torch.from_numpy(corig))
    np.testing.assert_allclose(out.numpy(), planes, atol=1e-5)


def test_h_plain_backward_matches_pallas(h_case):
    """Each gradient row at atol 1e-5 of that row's largest magnitude: the
    conic rows carry dx² factors of up to ~5e3 px², so their gradients reach
    ~1e2 where the colour rows stay under 1."""
    corig, f, cot, planes, grad = h_case
    g = R._composite_coarse_bwd_plain(torch.from_numpy(f), torch.from_numpy(corig),
                                      torch.from_numpy(cot)).numpy()
    assert np.abs(g[:, 10:]).max() == 0.0
    for row in range(10):
        scale = np.abs(grad[:, row]).max()
        assert scale > 0, row
        np.testing.assert_allclose(g[:, row] / scale, grad[:, row] / scale, atol=1e-5,
                                   err_msg=f"row {row}")


def test_composite_fn_on_cpu_takes_plain_versions(h_case):
    corig, f, cot, planes, grad = h_case
    _build.reset_launches()
    ft = torch.from_numpy(f).requires_grad_()
    out = R.CompositeCoarseFn.apply(ft, torch.from_numpy(corig), CS, 16, 1.0 / 255.0, 0.99)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), planes, atol=1e-5)
    scale = np.abs(grad).max()
    np.testing.assert_allclose(ft.grad.numpy() / scale, grad / scale, atol=1e-5)
    assert sum(_build.launch_totals().values()) == 0


def make_t_fall_fields(seed=7, kc=256):
    """One coarse tile on which T falls under 1e-4 in the middle of block 1
    while later candidates of that block still hit: 30 wide candidates of
    alpha ~0.5 over the whole tile (T ~0.5^30 ~1e-9 after them, under 1e-4
    after the 14th), then 98 faint ones (opacity 0.05) inside the tile, then
    a block of opaque ones that the early stop skips. T_final ends far under
    1e-4 but far above f32 underflow, so a per-pixel exit at 1e-4 inside the
    block would leave it ~1e5 times too large."""
    rng = np.random.default_rng(seed)
    corig = np.zeros((1, 2), np.float32)
    f = np.zeros((1, 12, kc), np.float32)
    f[0, 0] = rng.uniform(4, EXT - 4, kc)
    f[0, 1] = rng.uniform(4, EXT - 4, kc)
    f[0, 2], f[0, 3], f[0, 4] = 0.2, 0.0, 0.2
    f[0, 5] = rng.uniform(0.5, 1.0, kc)
    f[0, 5, 30:128] = 0.05
    f[0, 2, :30], f[0, 4, :30], f[0, 5, :30] = 1e-6, 1e-6, 0.5
    f[0, 6:9] = rng.uniform(0, 1, (3, kc))
    f[0, 9] = np.sort(rng.uniform(1, 5, kc))
    f[0, 10] = 1.0
    f[0, 11] = 6.0
    f[0, 11, :30] = 200.0
    return corig, f


def test_h_plain_keeps_compositing_under_the_early_stop():
    """Kernel H's plain forward against the Pallas kernel (interpret mode)
    where T falls under 1e-4 inside a block: T_final (plane 5) at rtol
    1e-4, the other planes at atol 1e-5; the next block is skipped."""
    corig, f = make_t_fall_fields()
    planes = np.asarray(composite_coarse_pallas(jnp.asarray(corig), jnp.asarray(f),
                                                interpret=True))
    t_final = planes[:, :, 5]
    assert t_final.max() < 1e-6 and t_final.min() > 1e-12
    out = R._composite_coarse_plain(torch.from_numpy(f), torch.from_numpy(corig)).numpy()
    np.testing.assert_allclose(out[:, :, 5], t_final, rtol=1e-4)
    np.testing.assert_allclose(out, planes, atol=1e-5)
    # block 2 alone is live on the tile: the early stop skips real work
    skipped = R._composite_coarse_plain(torch.from_numpy(f[:, :, 128:].copy()),
                                        torch.from_numpy(corig)).numpy()
    assert skipped[:, :, 5].min() < 0.5


def _scene(n=300, res=128, seed=3, sh_degree=1):
    rng = np.random.default_rng(seed)
    c2w = jcam.generate_c2w(10.0, 30.0, distance=3.0)[0]
    fov = math.radians(40)
    cam = jcam.gs_camera(c2w, fov, fov, res, res)
    means = rng.uniform(-0.45, 0.45, (n, 3)).astype(np.float32)
    scales = (0.05 * (0.5 + rng.uniform(size=(n, 3)))).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    op = rng.uniform(0.3, 0.95, n).astype(np.float32)
    shs = (rng.normal(size=(n, (sh_degree + 1) ** 2, 3)) * 0.5).astype(np.float32)
    return cam, (means, scales, q, op, shs)


def _torch_cam(cam):
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))[None]
    return R.GSCameraArrays(f(cam.world_view), f(cam.full_proj), f(cam.camera_center),
                            f(cam.tanfovx), f(cam.tanfovy))


@pytest.fixture(scope="module")
def raster_case():
    res, coarse_k = 128, 128
    cam, arrs = _scene(res=res)
    jcfg = jrz.RasterConfig(height=res, width=res, coarse=4, coarse_k=coarse_k,
                            approx_binning=False)
    bg = np.asarray([0.2, 0.4, 0.9], np.float32)
    jcam_arr = jrz.camera_arrays(cam)

    def jloss(m, s, q, o, sh):
        out = jrz.rasterize(m, s, q, o, jcam_arr, jcfg, shs=sh, bg=jnp.asarray(bg),
                            active_sh_degree=1, backend="pallas")
        return (jnp.mean(out.rgb ** 2) + jnp.mean(out.alpha) + 0.01 * jnp.mean(out.depth),
                out)

    (_, out), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in arrs))
    jout = {k: np.asarray(getattr(out, k)) for k in ("rgb", "depth", "alpha", "overflow")}
    return cam, arrs, bg, jout, [np.asarray(g) for g in grads], coarse_k


def _port_render(cam, arrs, bg, coarse_k, res=128):
    means, scales, q, op, shs = (torch.tensor(a) for a in arrs)
    leaves = [means, scales, q, op, shs]
    for t in leaves:
        t.requires_grad_()
    cfg = R.RasterConfig(height=res, width=res, coarse=4, coarse_k=coarse_k)
    out = R.rasterize(means[None], scales[None], q[None], op, _torch_cam(cam), cfg, shs=shs,
                      bg=torch.tensor(bg), active_sh_degree=1)
    return out, leaves


def test_rasterize_forward_matches_jax(raster_case):
    cam, arrs, bg, jout, _, coarse_k = raster_case
    out, _ = _port_render(cam, arrs, bg, coarse_k)
    assert jout["alpha"].max() > 0.5
    np.testing.assert_allclose(out.rgb[0].detach().numpy(), jout["rgb"], atol=2e-5)
    np.testing.assert_allclose(out.alpha[0].detach().numpy(), jout["alpha"], atol=2e-5)
    np.testing.assert_allclose(out.depth[0].detach().numpy(), jout["depth"], atol=2e-4)
    assert int(out.overflow) == int(jout["overflow"]) > 0  # coarse_k 128 truncates


def test_rasterize_gradients_match_jax(raster_case):
    """Gradients of means, scales, rotations, opacity and SH (degree 1) at
    3e-4 of each input's largest gradient: the JAX package's own tolerance
    between its XLA and Pallas routes (tests/test_rasterize_pallas.py)."""
    cam, arrs, bg, _, jgrads, coarse_k = raster_case
    out, leaves = _port_render(cam, arrs, bg, coarse_k)
    loss = (out.rgb ** 2).mean() + out.alpha.mean() + 0.01 * out.depth.mean()
    loss.backward()
    for t, g, name in zip(leaves, jgrads, ("means", "scales", "rotations", "opacity", "shs")):
        got = t.grad.numpy()
        scale = np.abs(g).max()
        assert np.isfinite(got).all() and scale > 0, name
        np.testing.assert_allclose(got / scale, g / scale, atol=3e-4, err_msg=name)


def test_rasterize_batches_views():
    """Two views in one call equal the two views rendered alone."""
    cam, arrs = _scene(n=60, res=96, seed=5, sh_degree=0)
    cam2 = jcam.gs_camera(jcam.generate_c2w(20.0, 100.0, distance=3.0)[0], 0.7, 0.7, 96, 96)
    cams = R.GSCameraArrays(*(torch.cat(p) for p in zip(_torch_cam(cam), _torch_cam(cam2))))
    means, scales, q, op, shs = (torch.tensor(a) for a in arrs)
    cfg = R.RasterConfig(height=96, width=96)
    both = R.rasterize(means.expand(2, -1, -1), scales.expand(2, -1, -1), q.expand(2, -1, -1),
                       op, cams, cfg, shs=shs)
    for v in range(2):
        one = R.rasterize(means[None], scales[None], q[None], op, cams.index(slice(v, v + 1)),
                          cfg, shs=shs)
        np.testing.assert_allclose(both.rgb[v].numpy(), one.rgb[0].numpy(), atol=1e-6)


def test_fields_route_raises():
    """What raises on kernel G's route (an image of coarse² = 16 tiles or
    fewer) is G's wrapper, on a K its kernel does not take; the route
    itself renders (:func:`test_fields_route_renders_on_cpu`)."""
    with pytest.raises(ValueError, match="K=200"):
        R._check_g("composite_fields", (torch.zeros((2, 12, 200)), torch.zeros(2, 2)), 200, 16)


def test_fields_route_renders_on_cpu():
    """A 64² image (16 tiles) renders on the CPU through G's plain versions
    with no launch (tests/test_torch_fields.py holds the route against
    JAX)."""
    cam, arrs = _scene(n=10, res=64)
    means, scales, q, op, shs = (torch.tensor(a) for a in arrs)
    _build.reset_launches()
    out = R.rasterize(means[None], scales[None], q[None], op, _torch_cam(cam),
                      R.RasterConfig(height=64, width=64), shs=shs)
    assert out.rgb.shape == (1, 64, 64, 3) and bool(torch.isfinite(out.rgb).all())
    assert sum(_build.launch_totals().values()) == 0


def test_h_wrapper_rejects_what_the_kernel_does_not_take():
    f = torch.zeros((2, 12, 640))
    with pytest.raises(ValueError, match="kc=640"):
        R._check_h("composite_coarse", (f, torch.zeros(2, 2)), 640, 16)
    with pytest.raises(ValueError, match="float32"):
        R._check_h("composite_coarse", (f.double(), torch.zeros(2, 2)), 128, 16)


@pytest.mark.parametrize("n_ct,cs,ranks", [(1024, 4, 1), (512, 4, 1), (256, 4, 2),
                                           (128, 4, 4), (3, 4, 16), (3, 2, 4), (3, 1, 1),
                                           (5, 3, 8)])
def test_h_bwd_ranks_fill_the_card(n_ct, cs, ranks):
    # the recon step's 1024 coarse tiles and the frame buckets' 512 / 256 /
    # 128: clusters only where the coarse tiles alone leave the grid under
    # 512 CTAs, a power of two, at most cs^2 and 16
    got = R.coarse_bwd_ranks(n_ct, cs)
    assert got == ranks
    assert got & (got - 1) == 0 and got <= min(cs * cs, 16)
    # rank r walks fine tiles r, r + ranks, ... (csrc/composite_coarse.cu):
    # every fine tile falls to exactly one rank and no rank is idle
    walks = [list(range(r, cs * cs, got)) for r in range(got)]
    assert all(walks) and sorted(sum(walks, [])) == list(range(cs * cs))


def _h_fields(n_ct, kc, cs, dense, seed):
    """Coarse tiles of cs x cs fine tiles, 8 a row, with kc depth-sorted
    candidates around each: dense (1-8 px wide, opacity U(0.05, 1), 4 wide
    opaque candidates at the front where the 0.99 clamp binds) or faint
    (0.5-2 px wide, opacity U(0.01, 0.1), as the recon asset)."""
    rng = np.random.default_rng(seed)
    ext = 16 * cs
    t = np.arange(n_ct)
    corig = np.stack([t % 8 * ext, t // 8 * ext], 1).astype(np.float32)
    f = np.zeros((n_ct, 12, kc), np.float32)
    f[:, 0] = rng.uniform(corig[:, :1] - 8, corig[:, :1] + ext + 8, (n_ct, kc))
    f[:, 1] = rng.uniform(corig[:, 1:] - 8, corig[:, 1:] + ext + 8, (n_ct, kc))
    lo, hi = (1.0, 8.0) if dense else (0.5, 2.0)
    sx, sy = rng.uniform(lo, hi, (n_ct, kc)), rng.uniform(lo, hi, (n_ct, kc))
    rho = rng.uniform(-0.5, 0.5, (n_ct, kc))
    c00, c11, c01 = sx ** 2, sy ** 2, rho * sx * sy
    det = c00 * c11 - c01 ** 2
    f[:, 2], f[:, 3], f[:, 4] = c11 / det, -c01 / det, c00 / det
    f[:, 5] = rng.uniform(0.05, 1.0, (n_ct, kc)) if dense else rng.uniform(0.01, 0.1, (n_ct, kc))
    f[:, 11] = 3 * np.maximum(sx, sy)
    if dense:
        f[:, 2, :4], f[:, 3, :4], f[:, 4, :4], f[:, 5, :4], f[:, 11, :4] = 1 / 64, 0, 1 / 64, 1, 24
    f[:, 6:9] = rng.uniform(0, 1, (n_ct, 3, kc))
    f[:, 9] = np.sort(rng.uniform(1, 5, (n_ct, kc)), axis=-1)
    f[:, 10] = rng.uniform(size=(n_ct, kc)) > 0.1
    return corig, f


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("cs", [1, 2, 4])
@pytest.mark.parametrize("kc", [128, 256, 512])
def test_h_bwd_kernel_matches_plain_on_cuda(kc, cs, dense):
    """Kernel H's backward against its plain version (relative L2 <= 1e-3:
    f32 sums in another order; rows 10-11 zero), two launches bitwise
    equal (no atomics), at 24 coarse tiles (clusters of up to 16 ranks) and
    at 600 (one rank)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for n_ct in (24, 600):
        corig, f = _h_fields(n_ct, kc, cs, dense, seed=kc + cs)
        fc, cc = torch.from_numpy(f).cuda(), torch.from_numpy(corig).cuda()
        cot = torch.randn((n_ct, cs * cs, 8, 256), device="cuda") * 1e-2
        g = R.composite_coarse_bwd(fc, cc, cot, cs)
        gref = R._composite_coarse_bwd_plain(fc, cc, cot, cs)
        assert torch.equal(g, R.composite_coarse_bwd(fc, cc, cot, cs))
        assert float(g[:, 10:].abs().max()) == 0.0
        assert float((g - gref).norm() / gref.norm()) <= 1e-3


@pytest.mark.cuda
def test_h_kernel_matches_plain_on_cuda():
    """Kernel H forward and backward against the plain versions on the card
    (planes max |diff| <= 2^-6, relative L2 <= 1e-4; gradient relative L2
    <= 1e-3: f32 sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    corig, f = make_fields(0)
    fc, cc = torch.from_numpy(f).cuda(), torch.from_numpy(corig).cuda()
    cot = torch.randn((3, CS * CS, 8, 256), device="cuda") * 1e-2
    out, ref = R.composite_coarse(fc, cc), R._composite_coarse_plain(fc, cc)
    g, gref = R.composite_coarse_bwd(fc, cc, cot), R._composite_coarse_bwd_plain(fc, cc, cot)
    assert float((out - ref).abs().max()) <= 2.0 ** -6
    assert float((out - ref).norm() / ref.norm()) <= 1e-4
    assert float((g - gref).norm() / gref.norm()) <= 1e-3
    with routing.plain_ops():
        assert R.CompositeCoarseFn.apply(fc, cc, CS, 16, 1.0 / 255.0, 0.99).shape == out.shape


@pytest.mark.cuda
def test_h_kernel_keeps_compositing_under_the_early_stop_on_cuda():
    """Kernel H's forward where T falls under 1e-4 inside a block
    (:func:`make_t_fall_fields`): planes within 2^-6 and relative L2 1e-4
    of the plain version, and T_final (plane 5) within relative error 1e-3
    wherever the plain T is above 1e-30."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    corig, f = make_t_fall_fields()
    fc, cc = torch.from_numpy(f).cuda(), torch.from_numpy(corig).cuda()
    out, ref = R.composite_coarse(fc, cc), R._composite_coarse_plain(fc, cc)
    assert float((out - ref).abs().max()) <= 2.0 ** -6
    assert float((out - ref).norm() / ref.norm()) <= 1e-4
    t, t_ref = out[:, :, 5], ref[:, :, 5]
    keep = t_ref > 1e-30
    assert bool(keep.all())
    assert float(((t - t_ref).abs() / t_ref)[keep].max()) <= 1e-3
