"""CogVideoX-5B image-to-video in the port against its plain reference.

``benchmark/reference/cogvideox/cogvideox.py``, the one plain reference of
CogVideoX (the benchmark's ``correct`` reads it too), is written from the
published description and imports nothing but torch, numpy and the
benchmark's ``precision.q``, here in its default float32 mode. The port's
modules (``models/transformer_cogvideox.py``, ``models/t5.py``,
``models/vae_cogvideox.py``, the DDIM scheduler's CogVideoX options,
``pipelines/cogvideox_sampler.py``) are held to it on seeded weights at a
tiny size, in float32 on the CPU; the T5 encoder also to transformers'
``T5EncoderModel`` where that package is installed. The tolerances are
float32 rounding in another order of operations: 1e-5 relative L2 for a
module, 1e-4 for a whole run, whose steps amplify it; the RoPE tables
bitwise (``warm_vml`` first: MKL's first transcendental call in a worker
thread may be off).
"""

import os

import numpy as np
import pytest
import torch

from animate3d_tpu_torch.convert.weights import load_cogvideox_artifacts, write_safetensors
from animate3d_tpu_torch.models.diffusion import DDIMScheduler, SchedulerConfig
from animate3d_tpu_torch.models.factory import build_cogvideox_models
from animate3d_tpu_torch.models.transformer_cogvideox import rotary_table
from animate3d_tpu_torch.ops import attention as TA
from animate3d_tpu_torch.pipelines.cogvideox_sampler import (
    COGVIDEOX_SCHEDULER,
    CogVideoXSampler,
    CogVideoXSamplerConfig,
    stand_in_ids,
)
from benchmark.reference.cogvideox import cogvideox as R
from torch_cpu_host import warm_vml

warm_vml()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


def _ref_configs(transformer, vae, t5):
    c, v, t = transformer.config, vae.config, t5.config
    pick = lambda cls, obj: cls(**{f: getattr(obj, f) for f in cls.__dataclass_fields__})
    return pick(R.TransformerConfig, c), pick(R.T5Config, t), pick(R.VAEConfig, v)


@pytest.fixture(scope="module")
def models():
    """The tiny port models (biases and the positional embedding moved off
    their init, so every branch counts) and the reference built on their
    weights."""
    torch.set_num_threads(4)
    transformer, vae, t5 = build_cogvideox_models("tiny", "cpu", seed=5)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in (transformer, vae):
            for name, p in m.named_parameters():
                if name.endswith(".bias"):
                    p.add_(0.1 * torch.randn(p.shape, generator=g))
        transformer.patch_embed.pos_embedding.normal_(generator=g)
        t5.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight.normal_(
            generator=g)
    refs = R.build(*_ref_configs(transformer, vae, t5), "cpu")
    for name, m in (("transformer", transformer), ("vae", vae), ("t5", t5)):
        refs[name].load_state_dict(m.state_dict())
    return {"transformer": transformer, "vae": vae, "t5": t5, "ref": refs}


def test_rotary_table_matches_the_reference_at_the_published_size():
    """The 3D RoPE table at 13 x 30 x 45 (17,550 video tokens), head 64."""
    from animate3d_tpu_torch.models.transformer_cogvideox import CogVideoXConfig

    c = CogVideoXConfig()
    cos, sin = rotary_table(c, 13, 60, 90, "cpu")
    crop = R.crop_region(30, 45, 45, 30)
    assert crop == ((0, 0), (30, 45))
    rcos, rsin = R.rotary_3d(64, 30, 45, 13, crop)
    assert cos.shape == (17550, 64)
    assert torch.equal(cos, rcos) and torch.equal(sin, rsin)
    # channels: 16 of time, then 24 of height and 24 of width, pairs equal
    assert torch.equal(cos[:, 0::2], cos[:, 1::2])
    assert torch.equal(cos[1350, :16], R.rotary_1d(16, torch.tensor([1.0]))[0][0])


def test_block_matches_the_reference(models):
    tr, ref = models["transformer"], models["ref"]["transformer"]
    c = tr.config
    g = torch.Generator().manual_seed(1)
    h = torch.randn((2, 72, c.inner_dim), generator=g)
    e = torch.randn((2, c.max_text_seq_length, c.inner_dim), generator=g)
    temb = torch.randn((2, c.time_embed_dim), generator=g)
    rope = rotary_table(c, 3, 8, 12, "cpu")
    with torch.no_grad():
        got = tr.transformer_blocks[0](torch.cat([e, h], dim=1), e.shape[1], temb, rope)
        wh, we = ref.transformer_blocks[0](h, e, temb, rope)
    assert rel(got, torch.cat([we, wh], dim=1)) < 1e-5


def test_transformer_matches_the_reference(models):
    tr, ref = models["transformer"], models["ref"]["transformer"]
    c = tr.config
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, 3, c.in_channels, 8, 12), generator=g)
    t = torch.tensor([999, 500])
    text = torch.randn((2, c.max_text_seq_length, c.text_embed_dim), generator=g)
    with torch.no_grad():
        got, want = tr(x, t, text), ref(x, t, text)
    assert got.shape == (2, 3, c.out_channels, 8, 12)
    assert rel(got, want) < 1e-5


def test_t5_matches_the_reference(models):
    ids = torch.tensor([stand_in_ids("a cat", 12, 64), stand_in_ids("", 12, 64)])
    with torch.no_grad():
        assert rel(models["t5"](ids), models["ref"]["t5"](ids)) < 1e-5


def test_t5_matches_transformers_t5_encoder(models):
    """An independent check of the encoder (relative buckets, gated GELU,
    RMSNorm, unscaled scores): transformers' own T5EncoderModel on the same
    state dict, where the package is installed."""
    transformers = pytest.importorskip("transformers")
    c = models["t5"].config
    cfg = transformers.T5Config(vocab_size=c.vocab_size, d_model=c.d_model, d_kv=c.d_kv,
                                d_ff=c.d_ff, num_layers=c.num_layers, num_heads=c.num_heads,
                                relative_attention_num_buckets=c.relative_attention_num_buckets,
                                relative_attention_max_distance=c.relative_attention_max_distance,
                                layer_norm_epsilon=c.layer_norm_epsilon,
                                feed_forward_proj="gated-gelu", dropout_rate=0.0)
    hf = transformers.T5EncoderModel(cfg).eval()
    sd = dict(models["t5"].state_dict())
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"]
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected and not [k for k in missing if "embed_tokens" not in k]
    ids = torch.tensor([stand_in_ids("a dog runs", 200, 64)])  # buckets past max_exact
    with torch.no_grad():
        want = hf(input_ids=ids).last_hidden_state
        assert rel(models["t5"](ids), want) < 1e-5


def test_vae_encode_and_decode_match_the_reference(models):
    """9 frames encode to 3 latent frames; 5 latent frames decode (batches
    3, 2: the first takes the remainder) to 17 frames."""
    vae, ref = models["vae"], models["ref"]["vae"]
    g = torch.Generator().manual_seed(3)
    x = torch.rand((1, 3, 9, 64, 96), generator=g) * 2 - 1
    z = torch.randn((1, 4, 5, 8, 12), generator=g)
    with torch.no_grad():
        (m, lv), (wm, wlv) = vae.encode(x), ref.encode(x)
        assert m.shape == (1, 4, 3, 8, 12)
        assert rel(m, wm) < 1e-5 and rel(lv, wlv) < 1e-5
        got, want = vae.decode(z), ref.decode(z)
    assert got.shape == (1, 3, 17, 64, 96)
    assert rel(got, want) < 1e-5


def test_ddim_v_prediction_trailing_zero_snr():
    """The CogVideoX scheduler: ᾱ (zero-SNR rescaled, ᾱ_999 = 0), trailing
    timesteps 999, 979, ..., 19, the host coefficients of the v step; the
    tensor step, which reads epsilon, refuses it."""
    sched = DDIMScheduler(COGVIDEOX_SCHEDULER)
    a = R.alphas_cumprod()
    np.testing.assert_allclose(sched.alphas64, a, rtol=1e-12, atol=1e-15)
    assert sched.alphas64[-1] == 0.0
    ts = [int(t) for t in sched.timesteps(50)]
    assert ts == R.timesteps(50) and ts[0] == 999 and ts[-1] == 19
    for t in (999, 519, 19):
        c = sched.step_coefficients(t, 50)
        np.testing.assert_allclose(c, R.ddim_coefficients(a, t, 50), rtol=1e-12)
    x = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="step_coefficients"):
        sched.step(x, 519, x, 50)
    with pytest.raises(ValueError, match="step_coefficients"):
        sched.pred_original(x, x, 519)
    # leading spacing, the snr shift: other options of the same table
    shifted = DDIMScheduler(SchedulerConfig(beta_schedule="scaled_linear", snr_shift_scale=3.0))
    np.testing.assert_allclose(shifted.alphas64,
                               R.alphas_cumprod(snr_shift_scale=3.0, zero_snr=False), rtol=1e-12)


def test_mvvdm_default_ddim_is_bitwise_as_before():
    """The MV-VDM's default scheduler: the tables, the leading timesteps
    with steps_offset and an epsilon step equal the code before the
    CogVideoX options were added (written out here), bit for bit."""
    sched = DDIMScheduler(SchedulerConfig())
    betas = np.linspace(0.00085, 0.012, 1000, dtype=np.float64)
    ac = np.cumprod(1.0 - betas)
    assert torch.equal(sched.alphas_cumprod, torch.as_tensor(ac, dtype=torch.float32))
    assert float(sched.final_alpha_cumprod) == 1.0
    ts = (np.arange(25) * 40).round()[::-1].copy() + 1
    assert torch.equal(sched.timesteps(25), torch.as_tensor(ts, dtype=torch.int64))
    g = torch.Generator().manual_seed(5)
    x, eps = torch.randn((2, 4, 8, 8), generator=g), torch.randn((2, 4, 8, 8), generator=g)
    t = torch.tensor(481)
    a_t = sched.alphas_cumprod[481]
    a_prev = sched.alphas_cumprod[441]
    x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    want = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
    prev, got_x0 = sched.step(eps, t, x, 25)
    assert torch.equal(prev, want) and torch.equal(got_x0, x0)
    assert torch.equal(sched.pred_original(x, eps, t), x0)


def test_sampler_matches_the_reference_end_to_end(models):
    """A 3-step request: T5 on [negative, prompt], the posterior sample of
    the image's latent frame, the noise, batched CFG at 6 and the v steps,
    then the decode; the reference's request written out from its parts."""
    tr, vae, t5 = models["transformer"], models["vae"], models["t5"]
    ref = models["ref"]
    cfg = CogVideoXSamplerConfig(num_frames=9, height=64, width=96, num_inference_steps=3)
    sampler = CogVideoXSampler(tr, vae, t5, cfg)
    n = tr.config.max_text_seq_length
    ids = torch.tensor([stand_in_ids("a cat", n, 64)])
    neg = torch.tensor([stand_in_ids("", n, 64)])
    image = torch.rand((1, 64, 96, 3), generator=torch.Generator().manual_seed(6))
    got = sampler.sample(image, ids, neg, torch.Generator().manual_seed(7))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(7)
        text = ref["t5"](torch.cat([neg, ids]))
        lat = R.image_latent(ref["vae"], image, gen, 3)
        x = torch.randn((1, 3, 4, 8, 12), generator=gen)
        a, ts = R.alphas_cumprod(), R.timesteps(3)
        for t in ts:
            out = ref["transformer"](torch.cat([torch.cat([x, x]), torch.cat([lat, lat])], 2),
                                     torch.tensor([t, t]), text)
            u, c = out.chunk(2)
            c_x, c_v = R.ddim_coefficients(a, t, 3)
            x = c_x * x + c_v * (u + 6.0 * (c - u))
        assert rel(got, x) < 1e-4
        assert rel(sampler.decode(got), R.decode(ref["vae"], x)) < 1e-4


def test_loader_maps_the_release_key_names(models, tmp_path):
    """A release root as on the hub: the transformer and the VAE as single
    diffusers files, the T5 encoder in two shards with its tied
    ``encoder.embed_tokens``; every key lands, nothing left over."""
    src = {k: m.state_dict() for k, m in (("transformer", models["transformer"]),
                                          ("vae", models["vae"]), ("text_encoder", models["t5"]))}
    for name in ("transformer", "vae"):
        os.makedirs(tmp_path / name)
        write_safetensors(str(tmp_path / name / "diffusion_pytorch_model.safetensors"),
                          {k: v.contiguous() for k, v in src[name].items()})
    os.makedirs(tmp_path / "text_encoder")
    t5 = {k: v.contiguous() for k, v in src["text_encoder"].items()}
    t5["encoder.embed_tokens.weight"] = t5["shared.weight"].clone()
    keys = sorted(t5)
    for i, part in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:])):
        name = f"model-0000{i + 1}-of-00002.safetensors"
        write_safetensors(str(tmp_path / "text_encoder" / name), {k: t5[k] for k in part})
    fresh = build_cogvideox_models("tiny", "cpu", seed=99)
    audit = load_cogvideox_artifacts(str(tmp_path), *fresh)
    assert audit == {n: {"missing": 0, "unexpected": 0}
                     for n in ("transformer", "vae", "text_encoder")}
    for m, name in zip(fresh, ("transformer", "vae", "text_encoder")):
        for k, v in m.state_dict().items():
            assert torch.equal(v, src[name][k]), (name, k)


def test_cli_runs_the_yaml_at_tiny_size(tmp_path):
    from PIL import Image

    from animate3d_tpu_torch.cli import inference

    png = tmp_path / "in.png"
    Image.fromarray((np.random.default_rng(0).random((40, 60, 3)) * 255).astype(np.uint8)).save(png)
    res = inference.main(["--config", os.path.join(ROOT, "configs/inference/cogvideox_5b_i2v.yaml"),
                          "--image", str(png), "--prompt", "a cat", "--device", "cpu",
                          "--model_size", "tiny", "-W", "96", "-H", "64", "-L", "9", "--steps",
                          "2", "--output_dir", str(tmp_path / "out")])
    assert res["frames"].shape == (9, 64, 96, 3)
    assert len(res["step_seconds"]) == 2 and os.path.exists(res["gif"])


@pytest.mark.cuda
def test_flash_attention_at_the_joint_length_matches_plain():
    """Kernel A at D 64 over 17,776 queries and keys (a partial last tile
    of 112 rows both ways), 4 heads, against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (torch.randn((1, 17776, 256), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out, lse = TA.flash_attention(q, k, v, 4, 0.125)
    want, want_lse = TA._flash_plain(q, k, v, 4, 0.125, 1)
    assert rel(out, want) < 1e-2
    assert rel(lse, want_lse) < 1e-5


@pytest.mark.cuda
def test_joint_attention_routes_through_kernel_a():
    """The transformer's joint attention at the published shape (batch 2,
    17,776 tokens, 48 heads) launches kernel A once, keyed by its shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from animate3d_tpu_torch.models.transformer_cogvideox import CogVideoXConfig, JointAttention
    from animate3d_tpu_torch.ops import _build

    c = CogVideoXConfig()
    attn = JointAttention(c).cuda().to(torch.bfloat16).eval()
    x = torch.randn((2, 17776, c.inner_dim), device="cuda", dtype=torch.bfloat16)
    rope = rotary_table(c, 13, 60, 90, "cuda")
    before = _build.LAUNCHES["flash_fwd", (2, 17776, 17776, 3072, 1)]
    with torch.no_grad():
        out = attn(x, 226, rope)
    assert out.shape == x.shape and torch.isfinite(out.float()).all()
    assert _build.LAUNCHES["flash_fwd", (2, 17776, 17776, 3072, 1)] == before + 1
