"""The rasterizer's fields route (kernel G) in the port against the JAX
package, on the CPU.

Kernel G's plain versions against ``composite_fields_pallas`` /
``composite_fields_pallas_bwd`` in interpret mode on the same fields (K 32:
one candidate block; K 256: two; a tile whose transmittance falls under
1e-4, where G, unlike H, keeps compositing), and against themselves in
float64 where clamp-binding candidates lead the lists; ``_tile_select`` and
``pack_fields`` on the same projection; ``rasterize`` at 32² and 64² against
JAX ``rasterize(backend="pallas")`` (``approx_binning=False``); one
``Animate3DSystem`` step at 32² against the JAX system on its Pallas route. The JAX Pallas
kernels run one tile a grid step here (``tiles_per_program=1``, a blocking
parameter that leaves the function as it is), patched for this module
only: the JAX package is not edited. Inputs are made by numpy from a seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import animate3d_tpu.ops.rasterize_pallas as jrp
import animate3d_tpu.rendering.renderer4d as jr4
from animate3d_tpu.data.cameras import fixed_view_cameras as jfixed_view_cameras
from animate3d_tpu.data.cameras import gs_cameras_from_batch as jgs_cameras_from_batch
from animate3d_tpu.gaussians.deform import DeformConfig as JDeformConfig
from animate3d_tpu.gaussians.state import GaussianState as JGaussianState
from animate3d_tpu.ops import rasterize as jrz
from animate3d_tpu.systems import animate3d as jsys
from animate3d_tpu_torch.convert.from_flax import deform_params_from_flax
from animate3d_tpu_torch.data.cameras import fixed_view_cameras, gs_cameras_from_batch
from animate3d_tpu_torch.gaussians.deform import DeformConfig
from animate3d_tpu_torch.gaussians.state import GaussianState
from animate3d_tpu_torch.ops import _build
from animate3d_tpu_torch.ops import rasterize as R
from animate3d_tpu_torch.rendering.renderer4d import RenderDraws, Renderer4DConfig
from animate3d_tpu_torch.systems.animate3d import (
    Animate3DConfig,
    Animate3DSystem,
    LossConfig,
    StepDraws,
)

from test_torch_raster import _scene, _torch_cam
from torch_cpu_host import warm_vml

warm_vml()  # before the first torch.exp: see tests/torch_cpu_host.py


@pytest.fixture(scope="module", autouse=True)
def one_tile_per_program():
    """The JAX fields kernels one tile a grid step (interpret mode compiles
    the unrolled tiles of a program: 8 by default)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("composite_fields_pallas", "composite_fields_pallas_bwd"):
            mp.setattr(jrp, name, functools.partial(getattr(jrp, name), tiles_per_program=1))
        yield


def make_fields(seed, k, n_t=8, clamp_front=False):
    """Tiles of depth-sorted candidates over a 4 x 2 grid of 16² tiles.
    Tiles other than 3 random, their last 4 candidates (with
    ``clamp_front``, their first 4) wide with opacity 1, so the 0.99 clamp
    binds near their centres. (At the back for the Pallas comparison: a
    clamp-binding candidate at the front of a list divides the whole
    suffix by 1 - alpha ~ 0.01, where the Pallas kernel's own float32 error
    reaches ~1e-5 of the row's largest against a float64 evaluation;
    :func:`test_g_plain_front_clamp_matches_float64` holds that case.)
    Tile 3: its first 8 candidates opaque and wide over the whole tile, so
    its transmittance falls under 1e-4 and the later candidates still
    contribute (no early stop in G)."""
    rng = np.random.default_rng(seed)
    org = np.stack([np.arange(n_t) % 4 * 16, np.arange(n_t) // 4 * 16], 1).astype(np.float32)
    f = np.zeros((n_t, 12, k), np.float32)
    for t in range(n_t):
        f[t, 0] = rng.uniform(org[t, 0] - 6, org[t, 0] + 22, k)
        f[t, 1] = rng.uniform(org[t, 1] - 6, org[t, 1] + 22, k)
        sx, sy = rng.uniform(1.0, 6, k), rng.uniform(1.0, 6, k)
        rho = rng.uniform(-0.5, 0.5, k)
        c00, c11, c01 = sx ** 2, sy ** 2, rho * sx * sy
        det = c00 * c11 - c01 ** 2
        f[t, 2], f[t, 3], f[t, 4] = c11 / det, -c01 / det, c00 / det
        f[t, 5] = rng.uniform(0.05, 1.0, k)
        cl = slice(0, 4) if clamp_front else slice(-4, None)
        f[t, 2, cl], f[t, 3, cl], f[t, 4, cl], f[t, 5, cl] = 1 / 64, 0.0, 1 / 64, 1.0
        f[t, 6:9] = rng.uniform(0, 1, (3, k))
        f[t, 9] = np.sort(rng.uniform(1, 5, k))
        f[t, 10] = rng.uniform(size=k) > 0.1
    f[3, 0, :8] = org[3, 0] + 8
    f[3, 1, :8] = org[3, 1] + 8
    f[3, 2, :8], f[3, 3, :8], f[3, 4, :8] = 1e-4, 0.0, 1e-4
    f[3, 5, :8], f[3, 10, :8] = 1.0, 1.0
    return org, f


@pytest.fixture(scope="module", params=[(0, 32), (1, 256)], ids=["K32", "K256"])
def g_case(request):
    seed, k = request.param
    org, f = make_fields(seed, k)
    cot = (np.random.default_rng(seed + 10).normal(size=(8, 8, 256)) * 1e-2).astype(np.float32)
    jo, jf = jnp.asarray(org), jnp.asarray(f)
    planes = np.asarray(jrp.composite_fields_pallas(jo, jf, interpret=True))
    grad = np.asarray(jrp.composite_fields_pallas_bwd(jo, jf, jnp.asarray(cot), interpret=True))
    return org, f, cot, planes, grad


def test_g_cases_bind(g_case):
    """Tile 3's transmittance falls under 1e-4, and its later candidates
    still take gradient (H's early stop would have zeroed them); the 0.99
    clamp binds in the others."""
    org, f, cot, planes, grad = g_case
    assert planes[3, 5].max() < 1e-4
    lin = np.arange(256)
    dx = f[:3, 0, -4:, None] - (org[:3, 0, None, None] + lin % 16)
    dy = f[:3, 1, -4:, None] - (org[:3, 1, None, None] + lin // 16)
    assert (np.exp(-0.5 * (dx ** 2 + dy ** 2) / 64) > 0.99).any()
    assert np.abs(grad[3, 6:9, 8:]).max() > 0
    assert np.abs(grad[:, 10:]).max() == 0


def test_g_plain_forward_matches_pallas(g_case):
    org, f, cot, planes, grad = g_case
    out = R._composite_fields_plain(torch.from_numpy(f), torch.from_numpy(org))
    assert out.shape == planes.shape
    np.testing.assert_allclose(out.numpy(), planes, atol=1e-5)


def test_g_plain_backward_matches_pallas(g_case):
    """Each gradient row at atol 1e-5 of that row's largest magnitude (the
    conic rows carry dx² factors, the colour rows stay under 1)."""
    org, f, cot, planes, grad = g_case
    g = R._composite_fields_bwd_plain(torch.from_numpy(f), torch.from_numpy(org),
                                      torch.from_numpy(cot)).numpy()
    assert np.abs(g[:, 10:]).max() == 0.0
    for row in range(10):
        scale = np.abs(grad[:, row]).max()
        assert scale > 0, row
        np.testing.assert_allclose(g[:, row] / scale, grad[:, row] / scale, atol=1e-5,
                                   err_msg=f"row {row}")


def _front_clamp_case(k):
    org, f = make_fields(2 + k, k, clamp_front=True)
    cot = (np.random.default_rng(k).normal(size=(8, 8, 256)) * 1e-2).astype(np.float32)
    return org, f, cot


@pytest.mark.parametrize("k", [32, 256])
def test_g_plain_front_clamp_matches_float64(k):
    """Clamp-binding candidates at the front of tiles 0-2 and 4-7 (tile 3
    as in :func:`make_fields`): each of them divides the suffix term of its
    pixels by 1 - alpha ~ 0.01. G's plain forward and backward in float32
    against the same formulas in float64: planes at atol 1e-5, each
    gradient row at atol 1e-5 of that row's largest magnitude."""
    org, f, cot = _front_clamp_case(k)
    lin = np.arange(256)
    dx = f[:3, 0, :4, None] - (org[:3, 0, None, None] + lin % 16)
    dy = f[:3, 1, :4, None] - (org[:3, 1, None, None] + lin // 16)
    assert (np.exp(-0.5 * (dx ** 2 + dy ** 2) / 64) > 0.99).any()
    args32 = [torch.from_numpy(a) for a in (f, org, cot)]
    args64 = [a.double() for a in args32]
    out = R._composite_fields_plain(*args32[:2]).numpy()
    out64 = R._composite_fields_plain(*args64[:2]).numpy()
    np.testing.assert_allclose(out, out64, atol=1e-5)
    g = R._composite_fields_bwd_plain(*args32).numpy()
    g64 = R._composite_fields_bwd_plain(*args64).numpy()
    assert g.dtype == np.float32 and g64.dtype == np.float64
    for row in range(10):
        scale = np.abs(g64[:, row]).max()
        assert scale > 0, row
        np.testing.assert_allclose(g[:, row] / scale, g64[:, row] / scale, atol=1e-5,
                                   err_msg=f"row {row}")


def test_composite_fields_fn_on_cpu_takes_plain_versions(g_case):
    org, f, cot, planes, grad = g_case
    _build.reset_launches()
    ft = torch.from_numpy(f).requires_grad_()
    out = R.CompositeFieldsFn.apply(ft, torch.from_numpy(org), 16, 1.0 / 255.0, 0.99)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), planes, atol=1e-5)
    scale = np.abs(grad).max()
    np.testing.assert_allclose(ft.grad.numpy() / scale, grad / scale, atol=1e-5)
    assert sum(_build.launch_totals().values()) == 0


def test_tile_select_and_pack_fields_match_jax():
    """On one projection (JAX's, handed to both): the per-tile lists (``ok``
    exactly, the indices where ``ok``), the overflow past a K cap of 48,
    and the packed fields (rows 0-9 where ``ok``, rows 10-11 exactly)."""
    cam, (means, scales, q, op, shs) = _scene(res=64)
    jcfg = jrz.RasterConfig(height=64, width=64, max_per_tile=48, approx_binning=False)
    jproj = jrz.project_gaussians(jnp.asarray(means), jrz.build_cov3d(
        jnp.asarray(scales), jnp.asarray(q)), jrz.camera_arrays(cam), jcfg)
    colors = np.clip(shs[:, 0] + 0.5, 0.0, 1.0)
    jidx, jok, jover = jrz._tile_select(jproj, jcfg)
    jfields = np.asarray(jrp.pack_fields(jproj, jnp.asarray(colors), jnp.asarray(op), jidx, jok))
    proj = R.Projected(*(torch.as_tensor(np.asarray(a))[None] for a in jproj))
    cfg = R.RasterConfig(height=64, width=64, max_per_tile=48)
    idx, ok, over = R._tile_select(proj, cfg)
    jok, jidx = np.asarray(jok), np.asarray(jidx)
    np.testing.assert_array_equal(ok[0].numpy(), jok)
    np.testing.assert_array_equal(np.where(jok, idx[0].numpy(), -1), np.where(jok, jidx, -1))
    assert int(over) == int(jover) > 0
    fields = R.pack_fields(proj, torch.from_numpy(colors)[None], torch.from_numpy(op)[None],
                           idx, ok).numpy()
    assert fields.shape == jfields.shape == (16, 12, 48)
    np.testing.assert_array_equal(fields[:, 10:], jfields[:, 10:])
    okm = jok[:, None, :]
    np.testing.assert_array_equal(np.where(okm, fields[:, :10], 0),
                                  np.where(okm, jfields[:, :10], 0))


def _jax_render(cam, arrs, jcfg, bg, backend):
    def jloss(m, s, q, o, sh):
        out = jrz.rasterize(m, s, q, o, jrz.camera_arrays(cam), jcfg, shs=sh,
                            bg=jnp.asarray(bg), active_sh_degree=1, backend=backend)
        return (jnp.mean(out.rgb ** 2) + jnp.mean(out.alpha) + 0.01 * jnp.mean(out.depth),
                out)

    (_, out), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in arrs))
    jout = {k: np.asarray(getattr(out, k)) for k in ("rgb", "depth", "alpha", "overflow")}
    return jout, [np.asarray(g) for g in grads]


def _check_render(cam, arrs, cfg, bg, jout, jgrads):
    """RGB / alpha at atol 2e-5, depth 2e-4, overflow equal; gradients of
    means, scales, rotations, opacity and SH at 3e-4 of each input's
    largest (the JAX package's own tolerance between its routes)."""
    leaves = [torch.tensor(a).requires_grad_() for a in arrs]
    means, scales, q, op, shs = leaves
    out = R.rasterize(means[None], scales[None], q[None], op, _torch_cam(cam), cfg, shs=shs,
                      bg=torch.tensor(bg), active_sh_degree=1)
    assert jout["alpha"].max() > 0.5
    np.testing.assert_allclose(out.rgb[0].detach().numpy(), jout["rgb"], atol=2e-5)
    np.testing.assert_allclose(out.alpha[0].detach().numpy(), jout["alpha"], atol=2e-5)
    np.testing.assert_allclose(out.depth[0].detach().numpy(), jout["depth"], atol=2e-4)
    assert int(out.overflow) == int(jout["overflow"])
    ((out.rgb ** 2).mean() + out.alpha.mean() + 0.01 * out.depth.mean()).backward()
    for t, g, name in zip(leaves, jgrads, ("means", "scales", "rotations", "opacity", "shs")):
        scale = np.abs(g).max()
        assert np.isfinite(t.grad.numpy()).all() and scale > 0, name
        np.testing.assert_allclose(t.grad.numpy() / scale, g / scale, atol=3e-4, err_msg=name)
    return out


@pytest.mark.parametrize("res,max_per_tile", [(32, 128), (64, 256)])
def test_rasterize_fields_route_matches_jax(res, max_per_tile):
    """At 32² (4 tiles, K 128: one block, the cap truncates) and 64² (16
    tiles, K 256): the route of coarse² tiles or fewer, kernel G's."""
    cam, arrs = _scene(res=res)
    bg = np.asarray([0.2, 0.4, 0.9], np.float32)
    jcfg = jrz.RasterConfig(height=res, width=res, max_per_tile=max_per_tile,
                            approx_binning=False)
    jout, jgrads = _jax_render(cam, arrs, jcfg, bg, "pallas")
    cfg = R.RasterConfig(height=res, width=res, max_per_tile=max_per_tile)
    _build.reset_launches()
    _check_render(cam, arrs, cfg, bg, jout, jgrads)
    assert sum(_build.launch_totals().values()) == 0
    if res == 32:
        assert int(jout["overflow"]) > 0


N, NV, NF, RES = 60, 2, 4, 32  # 32² = 4 tiles: the fields route (kernel G)
GRID = ((8, 8, 8, 4), (12, 12, 12, 4))


def test_system_step_on_the_fields_route_matches_jax():
    """One step of the recon system at 32² (step 0: one unlocked frame,
    bucketed to 2, 2 views x 2 items) against the JAX system with its
    renderer on the Pallas route, fed the JAX step's straight-through masks
    and ARAP sample: loss and metrics at 1e-5 relative, every parameter
    after one Adam step at 1e-5 relative."""
    rng = np.random.default_rng(0)
    d = dict(xyz=rng.uniform(-0.4, 0.4, (N, 3)), features_dc=rng.uniform(-1, 1, (N, 1, 3)),
             features_rest=np.zeros((N, 0, 3)), opacity=rng.uniform(-1, 3, (N, 1)),
             scaling=rng.uniform(-3.0, -2.0, (N, 3)), rotation=rng.normal(size=(N, 4)))
    d = {k: v.astype(np.float32) for k, v in d.items()}
    common = dict(n_view=NV, n_frame=NF, progressive_iter_per_frame=50)
    rgb = rng.uniform(size=(NV * NF, RES, RES, 3)).astype(np.float32)
    mask = rng.uniform(size=(NV * NF, RES, RES, 1)) > 0.3
    key = jax.random.PRNGKey(5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jr4, "rasterize", functools.partial(jrz.rasterize, backend="pallas"))
        jcfg = jsys.Animate3DConfig(
            **common, deform=JDeformConfig(grid_sizes=GRID, grid_feature_dim=4,
                                           use_global_trans=True),
            renderer=jr4.Renderer4DConfig(height=RES, width=RES,
                                          back_ground_color=(0.5, 0.5, 0.5)),
            loss=jsys.LossConfig(arap_sample_num=16))
        jsystem = jsys.Animate3DSystem(
            jcfg, state=JGaussianState(**{k: jnp.asarray(v) for k, v in d.items()}),
            key=jax.random.PRNGKey(1))
        params0 = jax.tree_util.tree_map(np.asarray, jsystem.params)
        jc = jfixed_view_cameras(azimuths_deg=(0.0, 120.0), height=RES, width=RES,
                                 total_frame=NF)
        jbatch = {"gs_cameras": jgs_cameras_from_batch(jc),
                  "timestamps": jc["timestamps"], "rgb": rgb, "mask": mask}
        jm = {k: float(v) for k, v in jsystem.step(jbatch, key).items()}
        jparams = deform_params_from_flax(jax.tree_util.tree_map(np.asarray, jsystem.params))

    cfg = Animate3DConfig(
        **common, deform=DeformConfig(grid_sizes=GRID, grid_feature_dim=4, use_global_trans=True),
        renderer=Renderer4DConfig(height=RES, width=RES, back_ground_color=(0.5, 0.5, 0.5)),
        loss=LossConfig(arap_sample_num=16))
    port = Animate3DSystem(cfg, state=GaussianState.from_numpy(**d), seed=0, device="cpu")
    port.field.load_state_dict(deform_params_from_flax(params0), strict=True)
    cams = fixed_view_cameras(azimuths_deg=(0.0, 120.0), height=RES, width=RES, total_frame=NF)
    batch = {"gs_cameras": gs_cameras_from_batch(cams), "timestamps": cams["timestamps"],
             "rgb": torch.from_numpy(rgb), "mask": torch.from_numpy(mask.astype(np.float32))}
    k_render, k_arap, _ = jax.random.split(key, 3)
    n_items = NV * 2
    masks = np.stack([np.asarray(jax.random.uniform(k, (N, 1)) < 0.1, np.float32)
                      for k in jax.random.split(k_render, n_items)])
    arap = np.array(jax.random.choice(k_arap, N, (16,), replace=True))
    _build.reset_launches()
    m = port.step(batch, draws=StepDraws(render=RenderDraws(torch.from_numpy(masks)),
                                         arap_idx=torch.as_tensor(arap, dtype=torch.long)))
    assert sum(_build.launch_totals().values()) == 0
    for k in ("loss", "loss_rgb", "loss_mask", "psnr", "loss_arap", "raster_overflow"):
        np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-5, atol=1e-12, err_msg=k)
    for name, p in port.field.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jparams[name].numpy(), rtol=1e-5, atol=1e-10,
                                   err_msg=name)


def _route_fields(res, azimuths=(0.0, 120.0)):
    """Kernel G's inputs as the fields route builds them: a seeded
    ``random_state`` asset (2,000 gaussians) projected and binned by the
    port through one view a azimuth (two by default) at ``res``²."""
    from animate3d_tpu_torch.gaussians.state import random_state

    st = random_state(2000, radius=0.4, generator=torch.Generator().manual_seed(0))
    cams = fixed_view_cameras(azimuths_deg=azimuths, height=res, width=res, total_frame=1)
    b, n = len(azimuths), st.num_points
    with torch.no_grad():
        fields, orig, _, _ = R.tile_fields(
            st.xyz.expand(b, n, 3), st.get_scaling().expand(b, n, 3),
            st.get_rotation().expand(b, n, 4), st.get_opacity().reshape(-1),
            gs_cameras_from_batch(cams).index(torch.arange(b)),
            R.RasterConfig(height=res, width=res), shs=st.get_features())
    return fields, orig


def _dense_fields_with_non_pd_conics():
    """:func:`make_fields` at K 256 with every 7th candidate's conic made
    indefinite (b² > a c) and every 11th's negative definite, all opaque and
    shallow: the power rule must keep them."""
    org, f = make_fields(3, 256)
    f[:, 3, ::7] = 2.0 * np.sqrt(f[:, 2, ::7] * f[:, 4, ::7])
    f[:, 2:5, ::7] *= 0.01  # shallow, so e^power stays finite where power > 0
    f[:, 2:5, ::11] *= -0.01
    f[:, 5, ::7] = 1.0
    f[:, 5, ::11] = 1.0
    return torch.from_numpy(f), torch.from_numpy(org)


@pytest.mark.parametrize("case", ["route-64", "dense"])
def test_g_cull_drops_only_candidates_dead_at_every_pixel(case):
    """Kernel G backward's cull (``_fields_tile_dead``, the plain mirror of
    ``rect_dead``): on the fields route's own fields at 64² and on dense
    random tiles with non-positive-definite conics, no culled (tile,
    candidate) is live at any pixel under the plain ``_block_alpha``, nor
    any candidate culled for a warp's 16 x 2 pixels at any of them; most
    of the route's candidates are culled (82%, and 0.02% kept though dead
    at every pixel); the non-PD conics are kept by the power rule. And the
    plain backward with the culled candidates' ``ok`` set to 0 equals
    (bitwise) the plain backward of the original fields, whose culled rows
    are zero."""
    if case == "dense":
        fields, orig = _dense_fields_with_non_pd_conics()
    else:
        fields, orig = _route_fields(64)
    dead = R._fields_tile_dead(fields, orig)
    _, _, gx, gy = R._pixel_grid(orig, 16, 1)
    alpha, _ = R._block_alpha(fields, gx, gy, 1.0 / 255.0, 0.99)
    live = (alpha > 0)[:, 0].any(1)  # (T, K): live at some pixel of the tile
    assert live.any() and dead.any()
    assert not (live & dead).any()
    share = float(dead.float().mean())
    # each warp's 16 x 2 pixels: culled there wherever culled in the tile, and more
    strips = R._fields_tile_dead(fields, orig, strip=2)
    assert strips.shape == (fields.shape[0], 8, fields.shape[2])
    assert not ((alpha > 0)[:, 0].unflatten(1, (8, 32)).any(2) & strips).any()
    assert (strips | ~dead[:, None]).all()
    assert float(strips.float().mean()) > share
    if case == "dense":
        f = fields.numpy()
        kept = (f[:, 10] > 0) & (f[:, 5] >= 1.0 / 255.0)
        assert not dead.numpy()[:, ::7][kept[:, ::7]].any()
        assert not dead.numpy()[:, ::11][kept[:, ::11]].any()
        assert share > 0.05, share
    else:  # most candidates culled, and nearly every one kept is live somewhere
        assert share > 0.5, share
        assert float((~dead & ~live).float().mean()) < 0.01
    cot = torch.from_numpy(
        (np.random.default_rng(6).normal(size=(fields.shape[0], 8, 256)) * 1e-2)
        .astype(np.float32))
    culled = fields.clone()
    culled[:, 10][dead] = 0.0
    g = R._composite_fields_bwd_plain(fields, orig, cot)
    assert torch.equal(R._composite_fields_bwd_plain(culled, orig, cot), g)
    assert not g[:, :10].permute(0, 2, 1)[dead].any()


_BUCKET2_AZIMUTHS = tuple(45.0 * i for i in range(8))  # 8 renders at 64²: 128 tiles


def _g_fields(case):
    """(fields, origins) of kernel G: the route's at 64² (two renders, or a
    bucket-2 batch of eight), dense random tiles with non-PD conics, or
    tiles whose lists open with clamp-binding candidates."""
    if case == "route-64":
        return _route_fields(64)
    if case == "bucket-2":
        return _route_fields(64, _BUCKET2_AZIMUTHS)
    if case == "dense":
        return _dense_fields_with_non_pd_conics()
    org, f, _ = _front_clamp_case(256)
    return torch.from_numpy(f), torch.from_numpy(org)


@pytest.mark.parametrize("case", ["route-64", "bucket-2", "dense", "front-clamp"])
def test_g_forward_cull_keeps_the_planes(case):
    """Kernel G forward's walk: each warp takes only the listed candidates
    it marks for its own 16 x 2 pixels, those that neither the tile's nor
    the band's cull drops (``_fields_tile_dead``, and with ``strip=2``). No
    candidate dropped for a band is live at any of its pixels, and the plain
    forward with those candidates' ``ok`` set to 0 gives the band's pixels
    the bits of the plain forward of the original fields."""
    fields, orig = _g_fields(case)
    n_t = fields.shape[0]
    dead = R._fields_tile_dead(fields, orig)[:, None] | R._fields_tile_dead(fields, orig, strip=2)
    assert dead.shape == (n_t, 8, fields.shape[2])
    _, _, gx, gy = R._pixel_grid(orig, 16, 1)
    alpha, _ = R._block_alpha(fields, gx, gy, 1.0 / 255.0, 0.99)
    live = (alpha[:, 0] > 0).unflatten(1, (8, 32)).any(2)  # (T, 8, K): live in the band
    del alpha
    assert live.any() and dead.any()
    assert not (live & dead).any()
    planes = R._composite_fields_plain(fields, orig)
    for w in range(8):
        culled = fields.clone()
        culled[:, 10][dead[:, w]] = 0.0
        band = slice(32 * w, 32 * (w + 1))
        assert torch.equal(R._composite_fields_plain(culled, orig)[:, :, band],
                           planes[:, :, band]), w
    if case in ("route-64", "bucket-2"):  # a band walks few of the route's candidates
        assert float(dead.float().mean()) > 0.9


def test_g_wrapper_rejects_what_the_kernel_does_not_take():
    f = torch.zeros((2, 12, 1152))
    with pytest.raises(ValueError, match="K=1152"):
        R._check_g("composite_fields", (f, torch.zeros(2, 2)), 1152, 16)
    with pytest.raises(ValueError, match="float32"):
        R._check_g("composite_fields", (f.double(), torch.zeros(2, 2)), 128, 16)
    with pytest.raises(ValueError, match="16x16"):
        R._check_g("composite_fields", (f, torch.zeros(2, 2)), 128, 8)


@pytest.mark.cuda
def test_g_kernel_matches_plain_on_cuda():
    """Kernel G forward and backward against the plain versions on the card
    (planes max |diff| <= 2^-6, relative L2 <= 1e-4, T_final (plane 5)
    within 1e-3 relative wherever the plain T is above 1e-30: a live
    candidate (alpha >= 1/255) that the cull dropped moves T by 0.39% or
    more; gradient relative L2 <= 1e-3: f32 sums in another order), on
    :func:`make_fields` tiles, the route's bucket-2 batch (128 tiles at
    64²) and 128 dense tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cases = [make_fields(1, 256), make_fields(5, 256, n_t=128)]
    f, org = _g_fields("bucket-2")
    cases.append((org.numpy(), f.numpy()))
    for i, (org, f) in enumerate(cases):
        fc, oc = torch.from_numpy(f).cuda(), torch.from_numpy(org).cuda()
        cot = torch.randn((fc.shape[0], 8, 256), device="cuda") * 1e-2
        out, ref = R.composite_fields(fc, oc), R._composite_fields_plain(fc, oc)
        g, gref = R.composite_fields_bwd(fc, oc, cot), R._composite_fields_bwd_plain(fc, oc, cot)
        assert float((out - ref).abs().max()) <= 2.0 ** -6, i
        assert float((out - ref).norm() / ref.norm()) <= 1e-4, i
        keep = ref[:, 5] > 1e-30
        t_rel = ((out[:, 5] - ref[:, 5]).abs() / ref[:, 5])[keep]
        assert float(t_rel.max()) <= 1e-3, i
        assert float((g - gref).norm() / gref.norm()) <= 1e-3, i


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 256])
def test_g_kernel_front_clamp_matches_float64_on_cuda(k):
    """Kernel G on the front-clamp fields against G's plain versions in
    float64: planes at atol 1e-5, each gradient row at atol 1e-4 of that
    row's largest magnitude (f32 sums over a tile's 256 pixels in the
    kernel's order, each term up to 100x its dalpha)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    org, f, cot = (torch.from_numpy(a).cuda() for a in _front_clamp_case(k))
    out = R.composite_fields(f, org)
    out64 = R._composite_fields_plain(f.double(), org.double())
    assert float((out.double() - out64).abs().max()) <= 1e-5
    g = R.composite_fields_bwd(f, org, cot).double()
    g64 = R._composite_fields_bwd_plain(f.double(), org.double(), cot.double())
    for row in range(10):
        scale = float(g64[:, row].abs().max())
        assert float((g[:, row] - g64[:, row]).abs().max()) <= 1e-4 * scale, row
