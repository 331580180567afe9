"""The main path's conditioning in the port against the JAX package, on the
CPU: the CLIP tokenizer, the cached prompt processor, both tiny CLIP towers
with ``encode_ip_adapter_images``, the antialiased bilinear resample, and
the sampler's i2v similarity init.

The towers' weights are the port's seeded init carried to flax by the JAX
converter (``torch_to_flax_params``), and once the other way through
``convert/from_flax.py``; f32 outputs within atol 1e-5.
"""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animate3d_tpu.convert.torch_to_flax import torch_to_flax_params
from animate3d_tpu.models import clip as jclip
from animate3d_tpu.models import factory as jfactory
from animate3d_tpu.models import prompt_processor as jpp
from animate3d_tpu.pipelines import mv_sampler as JS
from animate3d_tpu.utils import tokenizer as jtok
from animate3d_tpu_torch.convert.from_flax import clip_from_flax
from animate3d_tpu_torch.models import clip as tclip
from animate3d_tpu_torch.models import factory as tfactory
from animate3d_tpu_torch.models import prompt_processor as tpp
from animate3d_tpu_torch.pipelines import mv_sampler as TS
from animate3d_tpu_torch.utils import tokenizer as ttok

from torch_cpu_host import warm_vml

warm_vml()  # before the first torch.exp: see tests/torch_cpu_host.py

HIGHEST = jax.default_matmul_precision("highest")
TEXTS = ["hello", "HeLLo  world", "a b c d e f g h i j", "", "a dragon's 3 heads, roaring!"]


def _tiny_vocab(tmp_path):
    """The tiny BPE vocabulary of tests/test_tokenizer_prompt.py."""
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for i, ch in enumerate("abcdefghijklmnopqrstuvwxyz"):
        vocab[ch] = 2 + i
        vocab[ch + "</w>"] = 28 + i
    vocab.update({"he": 60, "hello": 61, "llo</w>": 62, "hello</w>": 63})
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version\n" + "\n".join(
        ["h e", "l l", "ll o</w>", "he llo</w>"]))
    return str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")


@pytest.mark.parametrize("vocab", ["bpe", "byte_level"])
def test_tokenizer_ids_match_jax(tmp_path, vocab):
    if vocab == "bpe":
        files = _tiny_vocab(tmp_path)
        max_length = 8
    else:
        ttok.write_char_level_tokenizer(str(tmp_path / "tokenizer"))
        jtok.write_char_level_tokenizer(str(tmp_path / "jtok"))
        assert (tmp_path / "tokenizer" / "vocab.json").read_text() == \
            (tmp_path / "jtok" / "vocab.json").read_text()
        files = ttok.find_tokenizer_files(str(tmp_path))
        assert files == jtok.find_tokenizer_files(str(tmp_path))
        max_length = 77
    mine = ttok.ClipTokenizer(*files, max_length=max_length)(TEXTS)
    ref = jtok.ClipTokenizer(*files, max_length=max_length)(TEXTS)
    assert mine.dtype == ref.dtype
    np.testing.assert_array_equal(mine, ref)


def test_prompt_processor_cache_is_shared(tmp_path):
    """The same md5 key and ``.npz`` layout: what one package caches, the
    other reads without encoding."""
    calls = []

    def encode(prompts):
        calls.append(prompts)
        return np.full((len(prompts), 5, 3), float(len(prompts[0])), np.float32)

    mine = tpp.PromptProcessor(encode, cache_dir=str(tmp_path))
    out = mine("a dragon", "ugly", view_dependent=True)
    assert out["cond"].shape == (4, 5, 3) and len(calls) == 5
    ref = jpp.PromptProcessor(None, cache_dir=str(tmp_path))("a dragon", "ugly",
                                                            view_dependent=True)
    for k in ("cond", "uncond"):
        np.testing.assert_array_equal(out[k], ref[k])
    jpp.PromptProcessor(encode, cache_dir=str(tmp_path))("a cat")
    np.testing.assert_array_equal(tpp.PromptProcessor(None, cache_dir=str(tmp_path))
                                  ("a cat")["cond"], np.full((5, 3), 5.0))
    assert tpp.PromptProcessor(None, cache_dir=str(tmp_path))._cache_path("x") == \
        jpp.PromptProcessor(None, cache_dir=str(tmp_path))._cache_path("x")


def test_direction_ids_and_zero_prompts():
    rng = np.random.default_rng(0)
    elev, azim = rng.uniform(-10, 90, 64), rng.uniform(-400, 400, 64)
    np.testing.assert_array_equal(tpp.direction_ids(elev, azim), jpp.direction_ids(elev, azim))
    assert [d.prompt_suffix for d in tpp.DIRECTIONS] == [d.prompt_suffix for d in jpp.DIRECTIONS]
    c, u = tpp.encode_prompt_or_zeros("a cat", "", 4, hidden_size=32)
    jc, ju = jpp.encode_prompt_or_zeros("a cat", "", 4, hidden_size=32)
    for a, b in ((c, jc), (u, ju)):
        assert tuple(a.shape) == b.shape and not a.any() and not np.asarray(b).any()


@pytest.fixture(scope="module")
def towers():
    """The port's tiny towers (the factory's tiny sizes), seeded, and their
    weights as flax trees."""
    _, _, text, vision = tfactory.build_models("tiny", 4, "cpu", seed=3)
    with torch.no_grad():  # a class token that is not all zero
        vision.vision_model.embeddings.class_embedding.normal_(
            generator=torch.Generator().manual_seed(0))
    tree = lambda m: {"params": torch_to_flax_params(
        {k: v.numpy() for k, v in m.state_dict().items()})}
    return text, vision, tree(text), tree(vision)


def test_text_tower_and_encode_text_match_jax(towers, tmp_path):
    text, _, params, _ = towers
    jtext = jclip.CLIPTextModel(jclip.CLIPTextConfig(**vars(text.config)))
    # jitted: one compile instead of an eager dispatch of every op
    jtext_jit = types.SimpleNamespace(apply=jax.jit(jtext.apply))
    ids = np.random.default_rng(1).integers(0, text.config.vocab_size, (3, 77)).astype(np.int32)
    with HIGHEST:
        ref = np.asarray(jtext_jit.apply(params, jnp.asarray(ids)))
    out = text(torch.as_tensor(ids, dtype=torch.long))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    # through the byte-level tokenizer: the factory's per-view cond / uncond
    ttok.write_char_level_tokenizer(str(tmp_path / "tokenizer"))
    assert tfactory.has_tokenizer(str(tmp_path)) and jfactory.has_tokenizer(str(tmp_path))
    cond, uncond = tfactory.encode_text("a red dragon", "blurry", 4, text, str(tmp_path))
    with HIGHEST:
        jc, ju = jfactory.encode_text("a red dragon", "blurry", 4, jtext_jit, params,
                                      str(tmp_path))
    np.testing.assert_allclose(cond.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(uncond.numpy(), np.asarray(ju), atol=1e-5)
    # flax → torch once: the JAX tree loads back into a fresh tower
    fresh = tclip.CLIPTextModel(text.config)
    fresh.load_state_dict(clip_from_flax(params, "text"), strict=True)
    np.testing.assert_array_equal(fresh(torch.as_tensor(ids, dtype=torch.long)).detach().numpy(),
                                  out.numpy())


def test_vision_tower_and_ip_embeds_match_jax(towers):
    """``encode_ip_adapter_images`` on 32² images (downsampled to the tiny
    tower's 28²) and on 28² images, against JAX; the JAX tree carried back
    through ``clip_from_flax`` gives the same tower."""
    _, vision, _, params = towers
    jvision = jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig(**vars(vision.config)))
    jencode = jax.jit(functools.partial(jclip.encode_ip_adapter_images, jvision))
    rng = np.random.default_rng(2)
    for size in (32, 28):
        imgs = rng.uniform(size=(3, size, size, 3)).astype(np.float32)
        with HIGHEST:
            ref = np.asarray(jencode(params, jnp.asarray(imgs)))
        out = tclip.encode_ip_adapter_images(vision, torch.from_numpy(imgs)).numpy()
        assert out.shape == (3, vision.config.projection_dim)
        np.testing.assert_allclose(out, ref, atol=1e-5)
    fresh = tclip.CLIPVisionModelWithProjection(vision.config)
    fresh.load_state_dict(clip_from_flax(params, "vision"), strict=True)
    for k, v in vision.state_dict().items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(), v.numpy(), err_msg=k)
    u8 = rng.integers(0, 255, (2, 28, 28, 3)).astype(np.uint8)
    np.testing.assert_allclose(tclip.preprocess_clip_image(torch.from_numpy(u8)).numpy(),
                               np.asarray(jclip.preprocess_clip_image(jnp.asarray(u8))),
                               atol=1e-6)


@pytest.mark.parametrize("size,out", [(32, 28), (16, 28), (256, 224)])
def test_resize_bilinear_matches_jax_image_resize(size, out):
    """``jax.image.resize(..., "bilinear")`` antialiases when it downsamples;
    the port's triangle-kernel resample does the same (atol 1e-6)."""
    x = np.random.default_rng(size).uniform(size=(2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, out, out, 3), "bilinear"))
    np.testing.assert_allclose(tclip.resize_bilinear(torch.from_numpy(x), out, out).numpy(),
                               ref, atol=1e-6)


def test_similarity_init_matches_jax():
    """``i2v_similarity_strength`` 0.5 / origin prob 0.5 over 4 DDIM steps:
    the same active timesteps, and the same initial latents from the JAX
    run's own noise and uniform draws (its key split)."""
    cfg = dict(num_inference_steps=4, num_views=2, num_frames=4, height=16, width=16,
               freeinit_enabled=False, i2v_similarity_strength=0.5,
               i2v_similarity_origin_prob=0.5)
    jsam = JS.MVSampler(lambda *a, **k: None, JS.MVSamplerConfig(**cfg))
    tsam = TS.MVSampler(torch.nn.Linear(1, 1), TS.MVSamplerConfig(**cfg))
    np.testing.assert_array_equal(tsam.active_timesteps().numpy(),
                                  np.asarray(jsam.active_timesteps()))
    assert len(tsam.active_timesteps()) == 2
    ffl = np.random.default_rng(3).normal(size=(2, 1, 2, 2, 4)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    ref, jnoise = jsam.prepare_initial_latents(key, jnp.asarray(ffl))
    k_noise, k_mask = jax.random.split(key)
    u = np.array(jax.random.uniform(k_mask, (2, 3, 1, 1, 1)))
    assert 0 < (u < 0.5).sum() < u.size  # both branches taken
    out = tsam.prepare_initial_latents(torch.from_numpy(np.array(jnoise)), torch.from_numpy(ffl),
                                       torch.from_numpy(u))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    # the sampling CLI's fields from the inference yaml (the shipped value: null)
    import yaml

    from animate3d_tpu_torch.cli.inference import _similarity_init

    with open("configs/inference/inference.yaml") as f:
        assert _similarity_init(yaml.safe_load(f)) == {
            "i2v_similarity_strength": None, "i2v_similarity_origin_prob": 0.0}
    assert _similarity_init({"i2v_similarity_init": {"strength": 0.5, "origin_prob": 0.3}}) == {
        "i2v_similarity_strength": 0.5, "i2v_similarity_origin_prob": 0.3}
