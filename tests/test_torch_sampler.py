"""Port DDIM / FreeInit / sampler / VAE pieces against the JAX package.

The sampler test feeds the same numpy noise to both sides (``jax.random``
and ``torch.Generator`` differ) and runs the JAX package's own jitted
denoise loop; UNet weights are the port's seeded init carried to flax by
the JAX converter, VAE weights come from the JAX init through
convert/from_flax.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animate3d_tpu.convert.torch_to_flax import torch_to_flax_params
from animate3d_tpu.models import diffusion as JD
from animate3d_tpu.models.unet_mv import MVMotionUNet as JaxUNet, MVUNetConfig as JaxUNetConfig
from animate3d_tpu.models.vae import AutoencoderKL as JaxVAE, VAEConfig as JaxVAEConfig
from animate3d_tpu.pipelines import mv_sampler as JS
from animate3d_tpu_torch.convert.from_flax import load_flax_params
from animate3d_tpu_torch.models import diffusion as TD
from animate3d_tpu_torch.models.factory import build_models
from animate3d_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from animate3d_tpu_torch.pipelines import mv_sampler as TS

HIGHEST = jax.default_matmul_precision("highest")


def test_ddim_tables_and_step():
    js, ts = JD.DDIMScheduler.create(), TD.DDIMScheduler()
    np.testing.assert_allclose(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod),
                               rtol=1e-6)
    for n in (2, 25):
        np.testing.assert_array_equal(ts.timesteps(n).numpy(), np.asarray(js.timesteps(n)))
    rng = np.random.default_rng(0)
    eps, sample = (rng.normal(size=(2, 3, 4, 4, 4)).astype(np.float32) for _ in range(2))
    for t in (981, 501, 21, 1):
        prev, x0 = ts.step(torch.from_numpy(eps), torch.tensor(t), torch.from_numpy(sample), 25)
        jprev, jx0 = js.step(jnp.asarray(eps), jnp.asarray(t), jnp.asarray(sample), 25)
        np.testing.assert_allclose(prev.numpy(), np.asarray(jprev), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        ts.add_noise(torch.from_numpy(sample), torch.from_numpy(eps), 999).numpy(),
        np.asarray(js.add_noise(jnp.asarray(sample), jnp.asarray(eps), jnp.asarray(999))),
        atol=1e-6)
    np.testing.assert_allclose(
        ts.pred_original(torch.from_numpy(sample), torch.from_numpy(eps), 501).numpy(),
        np.asarray(js.pred_original(jnp.asarray(sample), jnp.asarray(eps), jnp.asarray(501))),
        atol=1e-5, rtol=1e-5)


def test_freeinit_blend():
    rng = np.random.default_rng(1)
    x, noise = (rng.normal(size=(2, 7, 6, 5, 4)).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(TD._butterworth_lowpass_3d((7, 6, 5)),
                                  JD._butterworth_lowpass_3d((7, 6, 5)))
    out = TD.freeinit_blend(torch.from_numpy(x), torch.from_numpy(noise))
    ref = JD.freeinit_blend(jnp.asarray(x), jnp.asarray(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_two_step_freeinit_sample_matches_jax():
    """2 DDIM steps x 2 FreeInit iterations at tiny size: the port's
    prepare / denoise / re-noise pieces against the JAX sampler's jitted
    scan with the same noise, text and image conditioning."""
    n, f, hw = 4, 3, 32
    unet, *_ = build_models("tiny", n, "cpu", seed=5)
    with torch.no_grad():  # make the zero-init I2V out-projections live
        for name, p in unet.named_parameters():
            if "to_out_i2v" in name:
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    params = {"params": torch_to_flax_params(
        {k: v.numpy() for k, v in unet.state_dict().items()})}
    cfg = dict(num_inference_steps=2, guidance_scale=7.5, num_views=n, num_frames=f,
               height=hw, width=hw, freeinit_num_iters=2)
    jax_unet = JaxUNet(JaxUNetConfig.tiny(num_views=n), dtype=jnp.float32)

    def unet_apply(p, lat, t, ctx, cam, ie, i2v_cond_time_zero=False):
        return jax_unet.apply(p, lat, t, ctx, cam, ie, i2v_cond_time_zero=i2v_cond_time_zero)

    jsam = JS.MVSampler(unet_apply, JS.MVSamplerConfig(**cfg))
    tsam = TS.MVSampler(unet, TS.MVSamplerConfig(**cfg))

    rng = np.random.default_rng(2)
    d = unet.config.cross_attention_dim
    ffl = rng.normal(size=(n, 1, 4, 4, 4)).astype(np.float32)
    noise0, fresh = (rng.normal(size=(n, f - 1, 4, 4, 4)).astype(np.float32) for _ in range(2))
    cond, uncond = (rng.normal(size=(n, 77, d)).astype(np.float32) for _ in range(2))
    img = rng.normal(size=(n, unet.config.image_embed_dim)).astype(np.float32)
    text_ctx = np.concatenate([uncond, cond])
    img2 = np.concatenate([np.zeros_like(img), img])

    with HIGHEST:
        cam = jsam.cameras(1)
        ts = jsam.active_timesteps()
        lat = jnp.concatenate([jnp.asarray(ffl), jnp.asarray(noise0)], axis=1)
        for it in range(2):
            if it:
                diffused = jsam.scheduler.add_noise(lat[:, 1:], jnp.asarray(noise0),
                                                    jnp.asarray(999))
                rest = JD.freeinit_blend(diffused, jnp.asarray(fresh))
                lat = jnp.concatenate([jnp.asarray(ffl), rest], axis=1)
            lat = jsam._denoise(params, lat, jnp.asarray(ffl), jnp.asarray(text_ctx), cam,
                                jnp.asarray(img2), ts, 2)
        ref = np.asarray(lat)

    t = torch.from_numpy
    np.testing.assert_allclose(tsam.cameras(1).numpy(), np.asarray(cam), atol=1e-6)
    with torch.no_grad():
        lat = tsam.prepare_initial_latents(t(noise0), t(ffl))
        for it in range(2):
            if it:
                lat = tsam.freeinit_renoise(lat, t(ffl), t(noise0), t(fresh))
            lat = tsam.denoise(lat, t(ffl), t(text_ctx), tsam.cameras(1), t(img2),
                               tsam.scheduler.timesteps(2))
    assert len(tsam.step_seconds) == 4
    np.testing.assert_allclose(lat.numpy(), ref, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(lat[:, :1].numpy(), ffl)  # frame 0 re-injected


@pytest.fixture(scope="module")
def vae_pair():
    jvae = JaxVAE(JaxVAEConfig.tiny())
    params = jax.jit(jvae.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    # perturb the norm scales / biases too, so every leaf's layout matters
    leaves, treedef = jax.tree_util.tree_flatten(params)
    prng = np.random.default_rng(3)
    leaves = [np.asarray(p) + 0.05 * prng.standard_normal(p.shape).astype(np.float32)
              for p in leaves]
    params = jax.tree_util.tree_unflatten(treedef, leaves)
    tvae = AutoencoderKL(VAEConfig.tiny()).eval()
    load_flax_params(tvae, params)
    return jvae, params, tvae


def test_vae_encode_conditioning_images(vae_pair):
    jvae, params, tvae = vae_pair
    imgs = np.random.default_rng(4).uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32)
    with HIGHEST:
        ref = JS.encode_conditioning_images(
            lambda p, x: jvae.apply(p, x, method=JaxVAE.encode_mode), params,
            jnp.asarray(imgs))
    out = TS.encode_conditioning_images(tvae, torch.from_numpy(imgs))
    assert out.shape == (2, 1, 8, 8, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_vae_decode_video(vae_pair):
    jvae, params, tvae = vae_pair
    lat = np.random.default_rng(5).normal(size=(2, 3, 4, 4, 4)).astype(np.float32) * 0.2
    with HIGHEST:
        ref = JS.decode_video(lambda p, z: jvae.apply(p, z, method=JaxVAE.decode), params,
                              jnp.asarray(lat), frame_chunk=4)
    out = TS.decode_video(tvae, torch.from_numpy(lat), frame_chunk=4)
    assert out.shape == (2, 3, 8, 8, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
