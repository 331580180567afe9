"""4D-SDS guidance and the refine step of the port against the JAX package,
on the CPU.

One module fixture builds the JAX ``AnimateMVGuidance`` as
``tests/test_guidance.py`` does (tiny UNet and VAE, 4 views x 2 frames,
guidance at 16²), with the tiny vision tower in the loop. The UNet's and the
vision tower's weights are the port's seeded init carried to flax by the
JAX converter (no JAX ``init``); the VAE's come from the JAX init through
``convert/from_flax.py``. The JAX step's random draws (t, the posterior ε,
the noise of frames 1..F-1, the straight-through masks, the ARAP sample)
are recomputed here with ``jax.random`` from the same keys and given to
the port. The JAX system renders on its Pallas route (one tile a grid step,
as ``tests/test_torch_fields.py`` patches it for its module only).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import animate3d_tpu.ops.rasterize_pallas as jrp
import animate3d_tpu.rendering.renderer4d as jr4
from animate3d_tpu.convert.torch_to_flax import torch_to_flax_params
from animate3d_tpu.data.cameras import HybridRandomCameraSampler as JSampler
from animate3d_tpu.data.cameras import RandomCameraConfig as JRandomCameraConfig
from animate3d_tpu.data.cameras import fixed_view_cameras as jfixed_view_cameras
from animate3d_tpu.data.cameras import gs_cameras_from_batch as jgs_cameras_from_batch
from animate3d_tpu.gaussians.deform import DeformConfig as JDeformConfig
from animate3d_tpu.gaussians.state import GaussianState as JGaussianState
from animate3d_tpu.models.clip import CLIPVisionConfig as JVisionConfig
from animate3d_tpu.models.clip import CLIPVisionModelWithProjection as JVision
from animate3d_tpu.models.clip import encode_ip_adapter_images as jencode_ip
from animate3d_tpu.models.unet_mv import MVMotionUNet as JaxUNet, MVUNetConfig as JaxUNetConfig
from animate3d_tpu.models.vae import AutoencoderKL as JaxVAE, VAEConfig as JaxVAEConfig
from animate3d_tpu.ops import rasterize as jrz
from animate3d_tpu.pipelines import guidance as JG
from animate3d_tpu.systems import animate3d as jsys
from animate3d_tpu_torch.convert.from_flax import deform_params_from_flax, load_flax_params
from animate3d_tpu_torch.data.cameras import HybridRandomCameraSampler, RandomCameraConfig
from animate3d_tpu_torch.data.cameras import fixed_view_cameras, gs_cameras_from_batch
from animate3d_tpu_torch.gaussians.deform import DeformConfig
from animate3d_tpu_torch.gaussians.state import GaussianState
from animate3d_tpu_torch.models.clip import (
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    encode_ip_adapter_images,
)
from animate3d_tpu_torch.models.factory import init_params
from animate3d_tpu_torch.models.unet_mv import MVMotionUNet, MVUNetConfig
from animate3d_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from animate3d_tpu_torch.pipelines import guidance as TG
from animate3d_tpu_torch.rendering.renderer4d import RenderDraws, Renderer4DConfig
from animate3d_tpu_torch.systems.animate3d import (
    Animate3DConfig,
    Animate3DSystem,
    LossConfig,
    StepDraws,
)
from animate3d_tpu_torch.utils import trace

from torch_cpu_host import warm_vml

warm_vml()  # before the first torch.exp: see tests/torch_cpu_host.py

NV, NF, G_RES = 4, 2, 16
LAT = G_RES  # one-level VAE: latents at the image size
UCFG = dict(num_views=NV, layers_per_block=1, block_out_channels=(32,))
VCFG = dict(layers_per_block=1, block_out_channels=(32,))
HIGHEST = jax.default_matmul_precision("highest")


def _rel_l2(a, b):
    return float(np.linalg.norm(np.ravel(a) - np.ravel(b)) / np.linalg.norm(np.ravel(b)))


def _unet(dtype):
    """A one-level tiny UNet, seeded: its mid block holds the cross-view,
    I2V, cross and IP attention, every block a motion module. (The JAX
    compile of the UNet forward is most of this module's time; the UNet
    itself is held against JAX in test_torch_unet.py.)"""
    unet = MVMotionUNet(MVUNetConfig.tiny(**UCFG))
    init_params(unet, 7)
    return unet.to(dtype).eval().requires_grad_(False)


@pytest.fixture(scope="module")
def pair():
    """(JAX guidance f32, its params, port modules, numpy inputs)."""
    unet = _unet(torch.float32)
    vision = CLIPVisionModelWithProjection(CLIPVisionConfig.tiny(
        projection_dim=unet.config.image_embed_dim))
    init_params(vision, 7)
    with torch.no_grad():  # make the zero-init I2V out-projections live
        for name, p in unet.named_parameters():
            if "to_out_i2v" in name:
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    unet_params = {"params": torch_to_flax_params(sd(unet))}
    ie_params = {"params": torch_to_flax_params(sd(vision))}
    jvae = JaxVAE(JaxVAEConfig.tiny(**VCFG))
    vae_params = jax.jit(jvae.init)(jax.random.PRNGKey(0), jnp.zeros((1, G_RES, G_RES, 3)))
    tvae = AutoencoderKL(VAEConfig.tiny(**VCFG)).eval().requires_grad_(False)
    load_flax_params(tvae, vae_params)
    junet = JaxUNet(JaxUNetConfig.tiny(**UCFG))
    jvision = JVision(JVisionConfig.tiny(projection_dim=unet.config.image_embed_dim))

    def unet_apply(p, lat, t, ctx, cam, ie, i2v_cond_time_zero=False):
        return junet.apply(p, lat, t, ctx, cam, ie, i2v_cond_time_zero=i2v_cond_time_zero)

    jg = JG.AnimateMVGuidance(
        unet_apply, lambda p, x: jvae.apply(p, x, method=JaxVAE.encode),
        JG.GuidanceConfig(n_view=NV, n_frame=NF, image_size=G_RES),
        image_encode=lambda p, imgs: jencode_ip(jvision, p, imgs))
    rng = np.random.default_rng(0)
    d = unet.config.cross_attention_dim
    inputs = dict(text_c=rng.normal(size=(NV, 7, d)).astype(np.float32),
                  text_u=rng.normal(size=(NV, 7, d)).astype(np.float32),
                  img=rng.normal(size=(NV, unet.config.image_embed_dim)).astype(np.float32))
    return dict(jg=jg, jvae=jvae, unet_params=unet_params, vae_params=vae_params,
                ie_params=ie_params, unet=unet, vae=tvae, vision=vision, **inputs)


def _port_guidance(pair, unet=None, vision=True, vae=None, encode=None, **cfg):
    unet = unet or pair["unet"]

    def unet_apply(lat, t, ctx, cam, ie, i2v_cond_time_zero=False):
        with torch.no_grad():
            return unet(lat, t, ctx, cam, ie, i2v_cond_time_zero=i2v_cond_time_zero)

    image_encode = (lambda imgs: encode_ip_adapter_images(pair["vision"], imgs)) if vision \
        else None
    return TG.AnimateMVGuidance(unet_apply, encode or (vae or pair["vae"]).encode,
                                TG.GuidanceConfig(n_view=NV, n_frame=NF, image_size=G_RES,
                                                  **cfg),
                                image_encode=image_encode)


def _jax_draws(key, t_range, bnf, lat_hw):
    """pixel_grad's draws from ``key``: ``_sample_t`` splits off t, the loss
    splits the rest into the posterior ε and the frames' noise."""
    key, k_t = jax.random.split(key)
    mn, mx = t_range
    u = jax.random.uniform(k_t, (bnf // NF // NV,))
    t = jnp.clip((mn + u * (mx + 1 - mn)).astype(jnp.int32), mn, mx)
    k_post, k_noise = jax.random.split(key)
    post = jax.random.normal(k_post, (bnf, lat_hw, lat_hw, 4))
    noise = jax.random.normal(k_noise, (bnf // NF, NF - 1, lat_hw, lat_hw, 4))
    return TG.GuidanceDraws(*(torch.from_numpy(np.array(a)) for a in (t, post, noise)))


def _c2w(seed):
    cams = HybridRandomCameraSampler(RandomCameraConfig(batch_size=NV * NF, n_view=NV,
                                                        total_frame=NF), seed=seed).sample()
    return cams["c2w"]


@pytest.fixture(scope="module")
def f32_case(pair):
    """The f32 case's renders, cameras and draws, and the JAX guidance's
    loss and ∂loss/∂rgb on them (vision tower in the loop)."""
    jg = pair["jg"]
    res = G_RES
    rng = np.random.default_rng(res)
    rgb = rng.uniform(size=(NV * NF, res, res, 3)).astype(np.float32)
    c2w = _c2w(1)
    key = jax.random.PRNGKey(res)
    with HIGHEST:
        jl, jgrad = jg.pixel_grad(pair["unet_params"], pair["vae_params"], jnp.asarray(rgb),
                                  jnp.asarray(pair["text_c"]), jnp.asarray(pair["text_u"]),
                                  jnp.asarray(c2w), jnp.asarray(pair["img"]), key, (20, 200),
                                  ie_params=pair["ie_params"])
    return dict(rgb=rgb, c2w=c2w, draws=_jax_draws(key, (20, 200), NV * NF, LAT),
                jl=float(jl), jgrad=np.asarray(jgrad))


def _pixel_grad(pair, case, tg):
    return tg.pixel_grad(torch.from_numpy(case["rgb"]), torch.from_numpy(pair["text_c"]),
                         torch.from_numpy(pair["text_u"]), case["c2w"],
                         torch.from_numpy(pair["img"]), (20, 200), case["draws"])


def _assert_matches_jax_f32(case, loss, grad):
    np.testing.assert_allclose(float(loss), case["jl"], rtol=1e-4)
    assert _rel_l2(grad.numpy(), case["jgrad"]) <= 1e-3


def test_pixel_grad_matches_jax_f32(pair, f32_case):
    """Loss and ∂loss/∂rgb, f32, vision tower in the loop (per-view frame-0
    embeds, the 16² renders upsampled to its 28²): loss within 1e-4
    relative, gradient within 1e-3 relative L2. (The refine path renders the
    SDS batch at the guidance size, so the guidance's own resize does not
    run there; the resample itself is held in test_torch_conditioning.py.)"""
    loss, grad = _pixel_grad(pair, f32_case, _port_guidance(pair))
    assert np.isfinite(f32_case["jl"]) and f32_case["jl"] > 0
    assert np.abs(f32_case["jgrad"]).max() > 0
    _assert_matches_jax_f32(f32_case, loss, grad)


def test_encode_plan_keeps_chunks_while_they_fit():
    """The plan's arithmetic alone: 64 images at 256² in chunks of 8, 760
    MiB an image, 10 GB allocated."""
    chunk_bytes = 8 * 760 * 2 ** 20
    assert TG.encode_plan(8, chunk_bytes, (10 * 10 ** 9, 80 * 10 ** 9)) == (True,) * 8
    assert TG.encode_plan(8, chunk_bytes, (10 * 10 ** 9, 16 * 10 ** 9)) == (False,) * 8
    assert TG.device_memory(torch.device("cpu")) is None
    assert TG.encode_plan(8, chunk_bytes, TG.device_memory(torch.device("cpu"))) == (False,) * 8
    assert TG.encode_plan(8, None, (0, 80 * 10 ** 9)) == (False,) * 8  # not measured yet


CHUNK_BYTES = 1000


def _encode_counts(fn):
    """``fn()`` under a CPU profiler session → (its result, the change of
    the ``vae_encode_chunk`` counters)."""
    before = trace.snapshot()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    trace.span("_")  # outside the session: the tracer's hooks off again
    return out, {k: n for (c, k), n in trace.changes(before).items() if c == "vae_encode_chunk"}


@pytest.mark.parametrize("kept", [4, 0, 2], ids=["all_kept", "all_recomputed", "mixed"])
def test_chunked_encode_plans_match_the_unchunked_encode(pair, f32_case, monkeypatch, kept):
    """``vae_encode_chunk`` 2 splits the 8 renders into 4 chunks. The memory
    probe reads a card on which each chunk's encode holds 1000 bytes more:
    the first call, its chunks' bytes not yet measured, recomputes every
    chunk and learns them in the backward; the second keeps ``kept`` chunks
    on a card with room for ``kept`` + 1 and a half of them (one for the
    recompute). Loss and ∂loss/∂rgb equal the unchunked
    encode's to 1e-6 relative and JAX's within the f32 tolerances; the
    counters count the plan."""
    card = {"allocated": 0, "capacity": 0}
    monkeypatch.setattr(TG, "device_memory",
                        lambda device: (card["allocated"], card["capacity"]))

    def encode(x):
        card["allocated"] += CHUNK_BYTES
        return pair["vae"].encode(x)

    want_loss, want_grad = _pixel_grad(pair, f32_case, _port_guidance(pair))
    tg = _port_guidance(pair, encode=encode, vae_encode_chunk=2)
    _, counts = _encode_counts(lambda: _pixel_grad(pair, f32_case, tg))
    assert counts == {"recomputed": 4}
    card.update(allocated=0, capacity=TG.ENCODE_HEADROOM_BYTES + (kept + 1) * CHUNK_BYTES + 500)
    (loss, grad), counts = _encode_counts(lambda: _pixel_grad(pair, f32_case, tg))
    assert counts == {k: n for k, n in (("kept", kept), ("recomputed", 4 - kept)) if n}
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert _rel_l2(grad.numpy(), want_grad.numpy()) <= 1e-6
    _assert_matches_jax_f32(f32_case, loss, grad)


def test_pixel_grad_matches_jax_bf16(pair):
    """The guidance as ``build_guidance_from_config`` builds it: UNet in
    bf16 (JAX: bf16 params, dtype bf16), VAE weights rounded to bf16 and
    computing in f32 (flax promotes the bf16 params against its f32 dtype;
    the port keeps f32 tensors holding bf16 values). Loss within 1e-2
    relative, gradient within 5e-2 relative L2."""
    to_bf16 = lambda t: jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), t)
    junet = JaxUNet(JaxUNetConfig.tiny(**UCFG), dtype=jnp.bfloat16)
    jvae = pair["jvae"]
    jg = JG.AnimateMVGuidance(
        lambda p, lat, t, ctx, cam, ie, i2v_cond_time_zero=False: junet.apply(
            p, lat, t, ctx, cam, ie, i2v_cond_time_zero=i2v_cond_time_zero),
        lambda p, x: jvae.apply(p, x, method=JaxVAE.encode),
        JG.GuidanceConfig(n_view=NV, n_frame=NF, image_size=G_RES))
    rng = np.random.default_rng(3)
    rgb = rng.uniform(size=(NV * NF, G_RES, G_RES, 3)).astype(np.float32)
    c2w = _c2w(2)
    key = jax.random.PRNGKey(11)
    jl, jgrad = jg.pixel_grad(to_bf16(pair["unet_params"]), to_bf16(pair["vae_params"]),
                              jnp.asarray(rgb), jnp.asarray(pair["text_c"]),
                              jnp.asarray(pair["text_u"]), jnp.asarray(c2w),
                              jnp.asarray(pair["img"]), key, (20, 200))
    unet = _unet(torch.bfloat16)
    unet.load_state_dict(pair["unet"].state_dict())
    vae = AutoencoderKL(VAEConfig.tiny(**VCFG)).eval().requires_grad_(False)
    vae.load_state_dict(pair["vae"].state_dict())
    with torch.no_grad():
        for p in vae.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    tg = _port_guidance(pair, unet=unet, vision=False, vae=vae)
    loss, grad = tg.pixel_grad(torch.from_numpy(rgb), torch.from_numpy(pair["text_c"]),
                               torch.from_numpy(pair["text_u"]), c2w,
                               torch.from_numpy(pair["img"]), (20, 200),
                               _jax_draws(key, (20, 200), NV * NF, LAT))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-2)
    assert _rel_l2(grad.numpy(), np.asarray(jgrad, np.float32)) <= 5e-2


def test_min_max_step_and_camera16(pair):
    jg = pair["jg"]
    tg = _port_guidance(pair)
    for spec in (0.2, [0, 0.98, 0.2, 100]):
        jc = JG.GuidanceConfig(n_view=NV, n_frame=NF, max_step_percent=spec)
        j2 = JG.AnimateMVGuidance(jg.unet_apply, jg.vae_encode, jc)
        t2 = TG.AnimateMVGuidance(tg.unet_apply, tg.vae_encode, TG.GuidanceConfig(
            n_view=NV, n_frame=NF, max_step_percent=spec))
        for step in (0, 37, 100, 150):
            assert t2.min_max_step(step) == j2.min_max_step(step)
    c2w = _c2w(3)
    np.testing.assert_allclose(TG.AnimateMVGuidance.camera16(c2w, NV, NF).numpy(),
                               np.asarray(JG.AnimateMVGuidance.camera16(c2w, NV, NF)),
                               atol=1e-6)


def test_preview_matches_jax(pair):
    """The guidance-eval sampler, 2 DDIM steps from t 500, the same noise;
    the decoded frames within 1e-4."""
    jg, jvae = pair["jg"], pair["jvae"]
    rng = np.random.default_rng(5)
    lat = rng.normal(size=(NV, NF, LAT, LAT, 4)).astype(np.float32)
    cam = TG.AnimateMVGuidance.camera16(_c2w(4), NV, NF).numpy()
    key = jax.random.PRNGKey(4)
    decode = jax.jit(lambda p, z: jvae.apply(p, z, method=JaxVAE.decode))
    with HIGHEST:
        ref = jg.preview(pair["unet_params"], decode, pair["vae_params"], jnp.asarray(lat),
                         jnp.asarray(pair["text_c"]), jnp.asarray(pair["text_u"]),
                         jnp.asarray(cam), jnp.asarray(pair["img"]), t_start=500, key=key,
                         num_steps=2)
    k_n, _ = jax.random.split(key)
    noise = torch.from_numpy(np.array(jax.random.normal(k_n, (NV, NF - 1, LAT, LAT, 4))))
    out = _port_guidance(pair).preview(
        pair["vae"].decode, torch.from_numpy(lat), torch.from_numpy(pair["text_c"]),
        torch.from_numpy(pair["text_u"]), torch.from_numpy(cam), torch.from_numpy(pair["img"]),
        t_start=500, num_steps=2, noise=noise)
    assert out.shape == (NV, NF, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_random_camera_sampler_matches_jax():
    """One seed, the same cameras, at the refine yaml's ranges and with
    every perturbation on, across the progressive widening."""
    kw = dict(batch_size=32, n_view=4, total_frame=4, width=32, height=32,
              camera_distance_range=(0.8, 1.0), fovy_range=(15, 60), elevation_range=(0, 30),
              progressive_until=3)
    for extra in ({}, dict(camera_perturb=0.1, center_perturb=0.2, up_perturb=0.05)):
        js = JSampler(JRandomCameraConfig(**kw, **extra), seed=9)
        ts = HybridRandomCameraSampler(RandomCameraConfig(**kw, **extra), seed=9)
        for step in (0, 1, 5):
            js.update_step(step)
            ts.update_step(step)
            a, b = js.sample(), ts.sample()
            for k in b:
                np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)


N, RES = 60, 32
GRID = ((6, 6, 6, 2), (8, 8, 8, 2))


def test_refine_system_step_matches_jax(pair):
    """One refine step (4 views x 2 frames, recon renders at 32², the SDS
    batch of random cameras at the guidance's 16², lambda_sds 0.5) from
    weights whose ``out`` layers are nonzero: the JAX system (its guidance
    the module's, its optimizer SGD(1), so the gradient reads off the step)
    against the port fed the JAX step's draws. loss, loss_sds and the
    recon metrics within 1e-4 relative; the deformation gradient within
    1e-3 relative L2 over all parameters, the scales' branch included
    (only the SDS renders deform the scales)."""
    rng = np.random.default_rng(0)
    d = dict(xyz=rng.uniform(-0.4, 0.4, (N, 3)), features_dc=rng.uniform(-1, 1, (N, 1, 3)),
             features_rest=np.zeros((N, 0, 3)), opacity=rng.uniform(-1, 3, (N, 1)),
             scaling=rng.uniform(-3.0, -2.0, (N, 3)), rotation=rng.normal(size=(N, 4)))
    d = {k: v.astype(np.float32) for k, v in d.items()}
    common = dict(n_view=NV, n_frame=NF, progressive_iter_per_frame=50, load_guidance=True)
    loss_kw = dict(arap_sample_num=16, lambda_sds=0.5)
    rgb = rng.uniform(size=(NV * NF, RES, RES, 3)).astype(np.float32)
    mask = rng.uniform(size=(NV * NF, RES, RES, 1)) > 0.3
    rc = HybridRandomCameraSampler(RandomCameraConfig(
        batch_size=NV * NF, n_view=NV, total_frame=NF, width=G_RES, height=G_RES), seed=3)
    rc.update_step(10)
    raw_rc = rc.sample()
    key = jax.random.PRNGKey(5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jr4, "rasterize", functools.partial(jrz.rasterize, backend="pallas"))
        for name in ("composite_fields_pallas", "composite_fields_pallas_bwd"):
            mp.setattr(jrp, name, functools.partial(getattr(jrp, name), tiles_per_program=1))
        jcfg = jsys.Animate3DConfig(
            **common, deform=JDeformConfig(grid_sizes=GRID, grid_feature_dim=4,
                                           use_global_trans=True),
            renderer=jr4.Renderer4DConfig(height=RES, width=RES,
                                          back_ground_color=(0.5, 0.5, 0.5)),
            loss=jsys.LossConfig(**loss_kw))
        jsystem = jsys.Animate3DSystem(
            jcfg, state=JGaussianState(**{k: jnp.asarray(v) for k, v in d.items()}),
            key=jax.random.PRNGKey(1), guidance=pair["jg"],
            guidance_inputs={"unet_params": pair["unet_params"],
                             "vae_params": pair["vae_params"], "ie_params": pair["ie_params"]})
        prng = np.random.default_rng(3)
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: (prng.normal(size=v.shape) * 0.05).astype(v.dtype)
            if "out" in jax.tree_util.keystr(p) else np.asarray(v), jsystem.params)
        jsystem.tx = optax.sgd(1.0)
        jsystem._train_step = jax.jit(jsystem._train_step_impl,
                                      static_argnames=("do_guidance",))
        jsystem.params = jax.tree_util.tree_map(jnp.asarray, params)
        jsystem.opt_state = jsystem.tx.init(jsystem.params)
        jc = jfixed_view_cameras(height=RES, width=RES, total_frame=NF)
        jbatch = {"gs_cameras": jgs_cameras_from_batch(jc), "timestamps": jc["timestamps"],
                  "rgb": rgb, "mask": mask}
        jgb = {"cameras": jgs_cameras_from_batch(raw_rc),
               "timestamps": jnp.asarray(raw_rc["timestamps"]),
               "c2w": jnp.asarray(raw_rc["c2w"]), "text_cond": jnp.asarray(pair["text_c"]),
               "text_uncond": jnp.asarray(pair["text_u"]),
               "image_embeds": jnp.asarray(pair["img"])}
        with HIGHEST:
            jm = {k: float(v) for k, v in jsystem.step(jbatch, key, guidance_batch=jgb).items()}
        jafter = deform_params_from_flax(jax.tree_util.tree_map(np.asarray, jsystem.params))
    before = deform_params_from_flax(params)

    cfg = Animate3DConfig(
        **common, deform=DeformConfig(grid_sizes=GRID, grid_feature_dim=4, use_global_trans=True),
        renderer=Renderer4DConfig(height=RES, width=RES, back_ground_color=(0.5, 0.5, 0.5)),
        loss=LossConfig(**loss_kw))
    port = Animate3DSystem(cfg, state=GaussianState.from_numpy(**d), seed=0, device="cpu",
                           guidance=_port_guidance(pair))
    port.field.load_state_dict(before, strict=True)
    cams = fixed_view_cameras(height=RES, width=RES, total_frame=NF)
    batch = {"gs_cameras": gs_cameras_from_batch(cams), "timestamps": cams["timestamps"],
             "rgb": torch.from_numpy(rgb), "mask": torch.from_numpy(mask.astype(np.float32))}
    gb = {"cameras": gs_cameras_from_batch(raw_rc), "timestamps": raw_rc["timestamps"],
          "c2w": torch.from_numpy(raw_rc["c2w"]), "text_cond": torch.from_numpy(pair["text_c"]),
          "text_uncond": torch.from_numpy(pair["text_u"]),
          "image_embeds": torch.from_numpy(pair["img"])}
    # the JAX step: key, k_g = split(key); k_g → the guidance's draws; key →
    # the train step's split(key, 3) → straight-through masks, ARAP sample
    key, k_g = jax.random.split(key)
    k_render, k_arap, _ = jax.random.split(key, 3)
    masks = np.stack([np.asarray(jax.random.uniform(k, (N, 1)) < 0.1, np.float32)
                      for k in jax.random.split(k_render, NV * 2)])
    arap = np.array(jax.random.choice(k_arap, N, (16,), replace=True))
    draws = StepDraws(render=RenderDraws(torch.from_numpy(masks)),
                      arap_idx=torch.as_tensor(arap, dtype=torch.long),
                      guidance=_jax_draws(k_g, (20, 200), NV * NF, LAT))
    cams_s, ts, rgb_s, mask_s, fw = port.step_batch(batch)
    lambdas = port.lambdas(0)
    assert (lambdas["g_min_step"], lambdas["g_max_step"]) == (20, 200)
    loss, m = port.loss(cams_s, torch.as_tensor(ts), rgb_s, mask_s, torch.as_tensor(fw),
                        lambdas, draws)
    loss.backward()  # the recon part; the SDS part as the JAX step adds it
    loss_sds, g_sds = port.sds_gradients(gb, lambdas, draws.guidance)
    np.testing.assert_allclose(float(loss_sds), jm["loss_sds"], rtol=1e-4)
    np.testing.assert_allclose(float(loss.detach()) + 0.5 * float(loss_sds), jm["loss"],
                               rtol=1e-4)
    for k in ("loss_rgb", "loss_mask", "loss_arap"):
        np.testing.assert_allclose(float(m[k].detach()), jm[k], rtol=1e-4, err_msg=k)
    got, want = [], []
    for name, p in port.field.named_parameters():
        jg_ = (before[name] - jafter[name]).numpy()
        rec = p.grad if p.grad is not None else torch.zeros_like(p)
        got.append((rec + lambdas["lambda_sds"] * g_sds[name]).numpy().ravel())
        want.append(jg_.ravel())
        if name.startswith("delta_scaling"):
            assert np.abs(jg_).max() > 0, name
    assert _rel_l2(np.concatenate(got), np.concatenate(want)) <= 1e-3
