"""Stable Video Diffusion XT in the port against its plain reference.

``benchmark/reference/svd/svd_xt.py``, the one plain reference of SVD-XT
(the benchmark's ``correct`` reads it too), is written from the published
description and imports nothing but torch and the benchmark's
``precision.q``, here in its default float32 mode; the port's modules
(``models/unet_svd.py``, ``models/vae_temporal.py``, the Euler-EDM
scheduler, ``pipelines/svd_sampler.py``) are held to it on seeded weights
at a tiny size (widths 32 / 64, two levels, 5 frames), in float32 on the
CPU. The tolerances are float32 rounding in another order of operations
(the port sums attention, blenders and norms in its own order): 1e-5
relative L2 for a module, 1e-4 for a whole run, whose steps amplify it.
"""

import os

import numpy as np
import pytest
import torch

from animate3d_tpu_torch.models.attention_layers import AlphaBlender
from animate3d_tpu_torch.models.diffusion import EulerEDMScheduler
from animate3d_tpu_torch.models.factory import build_svd_models
from animate3d_tpu_torch.models.unet_svd import (
    SpatioTemporalResBlock,
    TransformerSpatioTemporalModel,
)
from animate3d_tpu_torch.ops import attention as TA
from animate3d_tpu_torch.pipelines.svd_sampler import SVDSampler, SVDSamplerConfig
from benchmark.reference import precision
from benchmark.reference.svd import svd_xt as R

F_ = 5  # frames of the tiny clips


def rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


def _unmasked_padded(q, k, v, num_heads, scale):
    """The fault kernel B's mask prevents: keys and values zero-padded to 32
    rows and left in a plain softmax."""
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 32 - t.shape[1]))
    qh, kh, vh = (TA._split_heads(x.float(), num_heads) for x in (q, pad(k), pad(v)))
    return TA._merge_heads(TA.attention_xla(qh, kh, vh, scale))


@pytest.fixture(scope="module")
def models():
    """The tiny port models (biases and blender mixes moved off their init,
    so every branch counts) and the reference built on their weights."""
    torch.manual_seed(0)
    unet, vae, vision = build_svd_models("tiny", "cpu", seed=3)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in (unet, vae):
            for name, p in m.named_parameters():
                if name.endswith("mix_factor") or name.endswith(".bias"):
                    p.add_(0.3 * torch.randn(p.shape, generator=g))
    ucfg = R.UNetConfig(**{k: getattr(unet.config, k) for k in R.UNetConfig.__dataclass_fields__})
    vcfg = R.VAEConfig(block_out_channels=vae.config.block_out_channels)
    icfg = R.VisionConfig(**{k: getattr(vision.config, k)
                             for k in R.VisionConfig.__dataclass_fields__})
    ref = R.build(ucfg, vcfg, icfg)
    for name, m in (("unet", unet), ("vae", vae), ("vision", vision)):
        ref[name].load_state_dict(m.state_dict())
    return {"unet": unet, "vae": vae, "vision": vision, "ref": ref}


def _randn(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def test_unet_matches_reference(models):
    x = _randn(2, F_, 8, 8, 12, seed=1)
    ctx = _randn(2, 1, 32, seed=2)
    ids = torch.tensor([[6.0, 127.0, 0.02]]).repeat(2, 1)
    want = models["ref"]["unet"](x, 1.3, ctx, ids)
    assert rel(models["unet"](x, 1.3, ctx, ids), want) < 1e-5


def test_temporal_resnet_block_matches_reference(models):
    port = models["unet"].down_blocks[0].resnets[1]
    ref = models["ref"]["unet"].down_blocks[0].resnets[1]
    assert isinstance(port, SpatioTemporalResBlock)
    x, temb = _randn(2 * F_, 32, 6, 4, seed=3), _randn(2 * F_, 128, seed=4)
    io = torch.zeros(2, F_)
    assert rel(port(x, temb, io), ref(x, temb, io)) < 1e-5
    h5 = _randn(2, 32, F_, 6, 4, seed=5)
    t5 = temb.reshape(2, F_, -1)
    assert rel(port.temporal_res_block(h5, t5), ref.temporal_res_block(h5, t5)) < 1e-5


def test_spatiotemporal_transformer_matches_reference(models):
    port = models["unet"].down_blocks[0].attentions[0]
    ref = models["ref"]["unet"].down_blocks[0].attentions[0]
    assert isinstance(port, TransformerSpatioTemporalModel)
    x = _randn(2 * F_, 32, 6, 4, seed=6)
    ctx = _randn(2, 1, 32, seed=7)
    io = torch.zeros(2, F_)
    got = port(x, ctx.repeat_interleave(F_, dim=0), ctx, io)
    assert rel(got, ref(x, ctx.repeat_interleave(F_, dim=0), io)) < 1e-5


@pytest.mark.parametrize("switch", [False, True])
def test_blender_switch_and_image_only_frames(switch):
    """alpha = sigmoid(mix), 1 on image-only frames, then 1 - alpha with the
    switch, as the reference's blender (diffusers' learned_with_images)."""
    port = AlphaBlender(0.7, switch=switch)
    ref = R.AlphaBlender(switch=switch, with_images=True)
    ref.mix_factor.data.fill_(0.7)
    a, b = _randn(2, 3, F_, 4, seed=8), _randn(2, 3, F_, 4, seed=9)
    io = torch.tensor([[0.0, 1.0, 0.0, 0.0, 1.0], [0.0] * F_])[:, None, :, None]
    assert rel(port(a, b, io), ref(a, b, io)) < 1e-6
    s = torch.sigmoid(torch.tensor(0.7))
    first = (1 - s) if switch else s
    assert torch.allclose(port(a, b, io)[1], first * a[1] + (1 - first) * b[1], atol=1e-6)
    # an image-only frame takes alpha 1 before the switch
    pick = (1 - 1.0) if switch else 1.0
    assert torch.allclose(port(a, b, io)[0, :, 1], pick * a[0, :, 1] + (1 - pick) * b[0, :, 1])


def test_temporal_decoder_matches_reference(models):
    z = _randn(F_, 8, 12, 4, seed=10)
    got = models["vae"].decode(z, F_)
    want = models["ref"]["vae"].decode(z.permute(0, 3, 1, 2), F_).permute(0, 2, 3, 1)
    assert rel(got, want) < 1e-5
    x = torch.rand((2, 16, 24, 3), generator=torch.Generator().manual_seed(11)) * 2 - 1
    assert rel(models["vae"].encode_mode(x).permute(0, 3, 1, 2),
               models["ref"]["vae"].encode_mode(x.permute(0, 3, 1, 2))) < 1e-5


def test_euler_edm_sigmas_and_step_match_reference():
    sched = EulerEDMScheduler(num_inference_steps=25)
    want = R.karras_sigmas(25)
    assert sched.sigmas == want and sched.sigmas[-1] == 0.0
    assert abs(sched.sigmas[0] - 700.0) < 1e-3 and abs(sched.sigmas[-2] - 0.002) < 1e-8
    assert sched.timesteps == [R.timestep_of(s) for s in want[:-1]]
    assert sched.init_noise_sigma == pytest.approx((700.0 ** 2 + 1) ** 0.5, rel=1e-7)
    x, out = _randn(1, F_, 4, 3, 3, seed=12), _randn(1, F_, 4, 3, 3, seed=13)
    for i in (0, 12, 24):
        s, sn = sched.sigmas[i], sched.sigmas[i + 1]
        d = sched.denoised(out, x, s)
        assert torch.allclose(d, R.denoised(out, x, s), rtol=1e-6, atol=1e-6)
        assert torch.allclose(sched.step(d, x, s, sn), R.euler_step(d, x, s, sn),
                              rtol=1e-6, atol=1e-6)


def test_two_step_sampling_matches_reference(models):
    """A whole request (conditioning, noise, 2 Euler steps with the CFG
    ramp, the decode) through the port's sampler and through the reference,
    the noise drawn in the sampler's order from one seed."""
    cfg = SVDSamplerConfig(num_frames=F_, height=16, width=24, num_inference_steps=2)
    sampler = SVDSampler(models["unet"], models["vae"], models["vision"], cfg)
    image = torch.rand((1, 16, 24, 3), generator=torch.Generator().manual_seed(14))
    got = sampler.sample(image, torch.Generator().manual_seed(15))
    gen = torch.Generator().manual_seed(15)
    aug = torch.randn(image.shape, generator=gen)
    noise = torch.randn((1,) + sampler.latent_shape, generator=gen)
    ref = models["ref"]
    want = R.sample(ref["unet"], ref["vae"], ref["vision"], image, aug, noise, steps=2)
    assert rel(got, want) < 1e-4
    assert rel(sampler.decode(got), R.decode(ref["vae"], want)) < 1e-4


def test_kernel_b_padded_plain_route_at_s25():
    """Kernel B's plain padded route (25-frame sequences zero-padded to 32,
    the padded keys masked) equals attention over the 25 frames alone; left
    unmasked, the padded keys take a share of every softmax."""
    b, s, h, d = 6, 25, 2, 64
    q, k, v = (_randn(b, s, h * d, seed=20 + i) for i in range(3))
    scale = d ** -0.5
    want = R.attention(q, k, v, h, quantise=False)
    assert TA.padded_seq(25, 64) and not TA.padded_seq(16, 64) and not TA.padded_seq(25, 40)
    padded = TA.packed_padded_attention(q, k, v, h, scale)
    assert rel(padded, want) < 1e-6
    assert rel(TA.video_attention(q, k, v, h), want) < 1e-6
    assert rel(_unmasked_padded(q, k, v, h, scale), want) > 0.05
    q5, k5, v5 = (x[:, :5] for x in (q, k, v))
    assert rel(TA.video_attention(q5, k5, v5, h), R.attention(q5, k5, v5, h, quantise=False)) < 1e-6


def test_kernel_predicates_for_the_svd_shapes():
    """Kernel A's forward takes SVD's 64-wide heads; kernels A + D together
    (the training route) and B / E at power-of-two S keep their widths."""
    assert TA.flash_fwd_takes(64) and not TA.flash_kernel_takes(64)
    for d in TA.FLASH_HEAD_DIMS:
        assert TA.flash_fwd_takes(d)
    assert not TA.packed_kernel_takes(25, 64) and not TA.packed_kernel_takes(16, 64)
    # one key: the value projection at every query, bit for bit the softmax's
    v = _randn(3, 1, 128, seed=30)
    qk = _randn(3, 7, 128, seed=31)
    full = R.attention(qk, _randn(3, 1, 128, seed=32), v, 2, quantise=False)
    assert torch.equal(TA.one_key_attention(v).expand(3, 7, 128), full)


def test_svd_name_map_round_trips_a_seeded_state_dict(tmp_path, models):
    """The release's layout (``unet/``, ``vae/``, ``image_encoder/``, diffusers
    and transformers names) written from one seeded build loads into
    another, every tensor equal."""
    from animate3d_tpu_torch.convert.weights import load_svd_artifacts, write_safetensors

    for name, key in (("unet", "unet"), ("vae", "vae"), ("image_encoder", "vision")):
        os.makedirs(tmp_path / name)
        fname = "model.safetensors" if name == "image_encoder" else \
            "diffusion_pytorch_model.fp16.safetensors"
        write_safetensors(str(tmp_path / name / fname),
                          {k: v.contiguous() for k, v in models[key].state_dict().items()})
    unet, vae, vision = build_svd_models("tiny", "cpu", seed=99)
    audit = load_svd_artifacts(str(tmp_path), unet, vae, vision)
    assert audit == {k: {"missing": 0, "unexpected": 0} for k in ("unet", "vae", "image_encoder")}
    for key, m in (("unet", unet), ("vae", vae), ("vision", vision)):
        for k, v in models[key].state_dict().items():
            assert torch.equal(m.state_dict()[k], v), k


def test_svd_cli_writes_a_video(tmp_path):
    """``model_type: svd_xt`` through the sampling CLI at tiny size: the
    yaml selects the build and the sampler; the GIF has every frame."""
    from PIL import Image

    from animate3d_tpu_torch.cli import inference

    img = (np.random.default_rng(0).random((40, 56, 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "cond.png")
    res = inference.main(["--config", "configs/inference/svd_xt.yaml", "--image",
                          str(tmp_path / "cond.png"), "--device", "cpu", "--model_size",
                          "tiny", "-W", "48", "-H", "32", "-L", "5", "--steps", "2",
                          "--output_dir", str(tmp_path / "out")])
    assert res["frames"].shape == (5, 32, 48, 3)
    assert res["latents"].shape == (1, 5, 4, 16, 24) and len(res["step_seconds"]) == 2
    gif = Image.open(res["gif"])
    assert gif.size == (48, 32) and gif.n_frames >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,h", [(4, 9216, 320, 5), (8, 2304, 640, 10), (8, 576, 1280, 20),
                                     (8, 144, 1280, 20)])
def test_flash_kernel_at_d64_matches_plain_on_cuda(b, s, c, h):
    """Kernel A at the SVD UNet's 64-wide heads, its four levels' token
    counts (144 = a partial second key tile), against its plain version:
    2^-6 of the largest output, 1e-2 relative L2 (bf16 P)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(s)
    q, k, v = (torch.randn((b, s, c), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out, lse = TA.flash_attention(q, k, v, h, 0.125)
    want, want_lse = TA._flash_plain(q, k, v, h, 0.125, 1)
    assert (out.float() - want.float()).abs().max() <= 2 ** -6 * want.float().abs().max()
    assert rel(out, want) < 1e-2 and rel(lse, want_lse) < 1e-4


@pytest.mark.cuda
def test_video_attention_refuses_other_head_widths_on_cuda():
    """With the kernels on, ``video_attention`` raises for a head width
    kernel A does not take (48 here) instead of falling back to plain
    attention; under ``plain_ops`` it takes the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from animate3d_tpu_torch.ops import routing

    q, k, v = (torch.randn((2, 64, 96), device="cuda").to(torch.bfloat16) for _ in range(3))
    with pytest.raises(ValueError):
        TA.video_attention(q, k, v, 2)
    with routing.plain_ops():
        assert TA.video_attention(q, k, v, 2).shape == q.shape


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h", [(18432, 320, 5), (1152, 1280, 20), (3, 640, 10)])
def test_packed_kernel_at_s25_matches_plain_on_cuda(b, c, h):
    """Kernel B's padded sequences (25 frames in 32-row tiles, 64-wide
    heads) against the plain padded route and unpadded attention; the
    padded keys masked (unmasked, they would move every row)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(b)
    q, k, v = (torch.randn((b, 25, c), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out = TA.packed_attention(q, k, v, h, 0.125)
    want = TA.packed_padded_attention(q, k, v, h, 0.125)
    assert (out.float() - want.float()).abs().max() <= 2 ** -6 * want.float().abs().max()
    assert rel(out, want) < 1e-2
    assert rel(out, TA.packed_small_attention(q, k, v, h, 0.125)) < 1e-2
    assert rel(_unmasked_padded(q, k, v, h, 0.125), want) > 0.05


def test_svd_reference_is_the_frozen_copy_in_f32():
    """The reference the port is held to is the benchmark's, in float32:
    its ``q`` leaves bf16 and f32 operands as ``x.float()`` bit for bit,
    never the float8 control's rounding."""
    assert R.__name__ == "benchmark.reference.svd.svd_xt"
    assert precision.MODE == "f32"
    x = torch.randn(64, 48, generator=torch.Generator().manual_seed(0)) * 3.0
    for t in (x, x.bfloat16()):
        got = R.q(t)
        assert got.dtype == torch.float32
        assert torch.equal(got, t.float())


def test_reference_imports_nothing_but_torch():
    """The plain reference's own imports are torch, the standard library's
    and the benchmark's ``precision``, and importing it, from the repo's
    root, loads no module of the port nor JAX."""
    import ast
    import subprocess
    import sys
    from pathlib import Path

    src = Path(R.__file__).read_text()
    names = {a.name for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.ImportFrom) and n.module}
    assert {m.split(".")[0] for m in names} <= {"__future__", "math", "dataclasses", "typing",
                                                "torch", "benchmark"}, names
    assert {m for m in names if m.startswith("benchmark")} <= {"benchmark.reference.precision"}
    code = ("import sys; import benchmark.reference.svd.svd_xt;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax',"
            " 'animate3d_tpu', 'animate3d_tpu_torch'));"
            "print(bad); assert not bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(R.__file__).parents[3],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
