"""The port's trainer as ``configs/training/train.yaml`` configures it, on the
CPU at tiny size, against the JAX package: weights from an artifact root
(``flax_params_dir``: the CLIP towers and the tokenizer) and from
``pretrained_model_path``'s diffusers ``unet/`` and ``vae/``, the caption and
frame-0 image conditioning, the f32 frozen weights of ``cast_frozen_bf16:
false`` (with flax's dtype rule per layer family), the learnable spatial
encoding inside the full UNet, and ``cli/validate_weights.py``'s report.

The towers, VAE and UNet weights are the port's seeded modules nudged by
0.01 N(0, 1), written by the tests in the released layout; the JAX side
gets the same tensors through ``convert/torch_to_flax.py``. The JAX
trainer CLI is not run (its first compile takes minutes): its functions
are, on the same inputs. One jitted JAX ``value_and_grad`` serves both
frozen dtypes.
"""

import functools
import importlib.util
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from animate3d_tpu.convert import torch_to_flax as t2f
from animate3d_tpu.models import clip as jclip
from animate3d_tpu.models.unet_mv import MVMotionUNet as JaxUNet, MVUNetConfig as JaxUNetConfig
from animate3d_tpu.models.vae import AutoencoderKL as JaxVAE, VAEConfig as JaxVAEConfig
from animate3d_tpu.pipelines import train_mvvdm as JT
from animate3d_tpu.utils.tokenizer import ClipTokenizer as JaxTokenizer
from animate3d_tpu.utils.tokenizer import find_tokenizer_files as jax_tokenizer_files
from animate3d_tpu_torch.convert import weights as W
from animate3d_tpu_torch.convert.from_flax import from_flax
from animate3d_tpu_torch.data.video_dataset import MVideoConfig, MVideoDataset
from animate3d_tpu_torch.models import factory
from animate3d_tpu_torch.models.diffusion import DDIMScheduler
from animate3d_tpu_torch.models.unet_mv import MVMotionUNet, MVUNetConfig
from animate3d_tpu_torch.pipelines import train_mvvdm as TT
from animate3d_tpu_torch.utils.tokenizer import write_char_level_tokenizer

from torch_cpu_host import warm_vml

warm_vml()  # before the first torch.exp: see tests/torch_cpu_host.py

ROOT = pathlib.Path(__file__).resolve().parent.parent
HIGHEST = jax.default_matmul_precision("highest")
N_VIEWS, N_VIDEOS, FRAMES, LAT = 4, 2, 3, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread: they are many and small
    (a window readout per offset and frame, tiny UNets), and under the
    parallel test workers' load OpenMP's thread team makes each of them
    tens of times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _drop_none(tree):
    if isinstance(tree, dict):
        out = {k: _drop_none(v) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if v is not None and not (isinstance(v, dict) and not v)}
    return tree


def _tree(module):
    return {"params": t2f.torch_to_flax_params(
        {k: v.numpy() for k, v in module.state_dict().items()})}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """An artifact root with the text tower, the byte-level tokenizer and
    the image encoder (``sd15/`` + ``IP-Adapter/``), and a diffusers
    ``pretrained_model_path`` tree: ``unet/`` (the base UNet, without the
    trained motion modules and adapters or the IP-Adapter's keys) and
    ``vae/``, both f32 safetensors. From the port's seeded modules (seed
    21), every tensor nudged by 0.01 N(0, 1)."""
    base = tmp_path_factory.mktemp("train_weights")
    unet, vae, text, vision = factory.build_models("tiny", N_VIEWS, "cpu", seed=21)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in (unet, vae, text, vision):
            for p in m.parameters():
                p.add_(0.01 * torch.randn(p.shape, generator=g))
    root = base / "root"
    for sub in ("sd15/text_encoder", "IP-Adapter/models/image_encoder"):
        (root / sub).mkdir(parents=True)
    W.write_safetensors(str(root / "sd15/text_encoder/model.safetensors"),
                        dict(text.state_dict()))
    write_char_level_tokenizer(str(root / "sd15" / "tokenizer"))
    W.write_safetensors(str(root / "IP-Adapter/models/image_encoder/model.safetensors"),
                        dict(vision.state_dict()))
    pre = base / "pretrained"
    for sub in ("unet", "vae"):
        (pre / sub).mkdir(parents=True)
    unet_sd = {k: v for k, v in unet.state_dict().items()
               if not TT.is_trainable(k) and "_ip." not in k
               and not k.startswith("encoder_hid_proj")}
    W.write_safetensors(str(pre / "unet/diffusion_pytorch_model.safetensors"), unet_sd)
    W.write_safetensors(str(pre / "vae/diffusion_pytorch_model.safetensors"),
                        dict(vae.state_dict()))
    return dict(root=root, pre=pre, unet=unet, vae=vae, text=text, vision=vision,
                unet_sd=unet_sd)


def _workspace(tmp_path, caption: str, extra: str = "") -> str:
    """4 views of 4 PNG frames at 16², a one-item manifest with ``caption``
    and the tiny trainer config."""
    rng = np.random.default_rng(0)
    views = []
    for v in range(N_VIEWS):
        d = tmp_path / "vids" / f"view{v}"
        d.mkdir(parents=True)
        for f in range(4):
            Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
                d / f"{f}.png")
        views.append(f"view{v}")
    (tmp_path / "manifest.json").write_text(json.dumps([{"videos": views,
                                                         "caption": caption}]))
    cfg = tmp_path / "train.yaml"
    cfg.write_text(f"""
output_dir: "{tmp_path}/out"
model_size: tiny
num_views: {N_VIEWS}
video_length: 2
sample_size: 16
train_data:
  manifest_path: "{tmp_path}/manifest.json"
  video_root: "{tmp_path}/vids"
  total_frames: 4
max_train_steps: 1
checkpointing_steps: 1
learning_rate: 1.0e-4
global_seed: 0
{extra}""")
    return str(cfg)


def _train(tmp_path, weights, caption="a red toy", *extras):
    from animate3d_tpu_torch.cli.train_mvvdm import main

    cfg = _workspace(tmp_path, caption)
    return main(["--config", cfg, "--device", "cpu", f"flax_params_dir={weights['root']}",
                 f"pretrained_model_path={weights['pre']}", *extras])


def test_trainer_conditioning_matches_jax_towers(weights, tmp_path):
    """(a) The trainer CLI's first-batch text context (the caption, repeated
    over the 4 views), CFG null context (the encoded empty caption) and
    image embeds (frame 0 of each view through the IP-Adapter's vision
    tower) against the JAX towers and tokenizer on the same weights. f32,
    atol 1e-5."""
    res = _train(tmp_path, weights, "a red toy")
    assert {"text_encoder", "image_encoder", "unet", "vae"} <= res["loaded"]
    cond = res["conditioning"]
    text, vision = weights["text"], weights["vision"]
    jtext = jclip.CLIPTextModel(jclip.CLIPTextConfig(**vars(text.config)))
    jvision = jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig(**vars(vision.config)))
    tok = JaxTokenizer(*jax_tokenizer_files(str(weights["root"] / "sd15")), max_length=77)
    raw = next(MVideoDataset(MVideoConfig(
        manifest_path=str(tmp_path / "manifest.json"), video_root=str(tmp_path / "vids"),
        sample_size=16, sample_n_frames=2, num_views=N_VIEWS, total_frames=4),
        seed=0).iterate(batch_size=1))
    frame0 = raw["pixel_values"][:, :, 0].reshape(N_VIEWS, 16, 16, 3)
    with HIGHEST:
        emb = np.asarray(jax.jit(jtext.apply)(_tree(text),
                                              jnp.asarray(tok(["a red toy", ""]))))
        ie = np.asarray(jax.jit(functools.partial(jclip.encode_ip_adapter_images, jvision))(
            _tree(vision), jnp.asarray((frame0 + 1.0) / 2.0)))
    np.testing.assert_allclose(cond["text_ctx"].numpy(), np.repeat(emb[:1], N_VIEWS, 0),
                               atol=1e-5)
    np.testing.assert_allclose(cond["null_text_ctx"].numpy(),
                               np.repeat(emb[1:], N_VIEWS, 0), atol=1e-5)
    np.testing.assert_allclose(cond["image_embeds"].numpy(), ie, atol=1e-5)
    assert np.abs(emb[0] - emb[1]).max() > 1e-3  # the caption is not the null context


def test_caption_content_changes_loss(weights, tmp_path):
    """(b) The port's mirror of tests/test_train_cli.py::
    test_caption_content_changes_loss: same data and seed, another caption,
    another loss, through the text tower."""
    loss_a = _train(tmp_path / "a", weights, "a red toy")["metrics"][0]["loss"]
    loss_b = _train(tmp_path / "b", weights, "a blue dragon flying")["metrics"][0]["loss"]
    assert np.isfinite(loss_a) and np.isfinite(loss_b)
    assert abs(loss_a - loss_b) > 1e-7


def test_validation_sampling_with_towers_and_resume_keeps_f32_frozen(weights, tmp_path):
    """Validation sampling with the caption, the null caption and the image
    embeds; with ``cast_frozen_bf16: false`` the checkpoint keeps the frozen
    weights in f32, equal to the loaded files, and a resumed run restores
    them."""
    from animate3d_tpu_torch.cli.train_mvvdm import main
    from animate3d_tpu_torch.core.checkpoint import restore_checkpoint

    cfg = _workspace(tmp_path, "a toy", "validation_steps: 1\nvalidation_num_steps: 2\n"
                                        "cast_frozen_bf16: false\n")
    args = ["--config", cfg, "--device", "cpu", f"flax_params_dir={weights['root']}",
            f"pretrained_model_path={weights['pre']}"]
    main(args)
    assert (tmp_path / "out" / "samples" / "sample-1.gif").exists()
    state = restore_checkpoint(str(tmp_path / "out" / "checkpoints" / "step_1"))
    for k, v in weights["unet_sd"].items():
        assert state["frozen"][k].dtype == torch.float32 and torch.equal(state["frozen"][k], v), k
    res = main(args + ["max_train_steps=2"])
    assert res["start_step"] == 1
    params = dict(res["unet"].named_parameters())
    for k, v in weights["unet_sd"].items():
        assert torch.equal(params[k].detach(), v), k


# ---------------------------------------------------------------------------
# (c) cast_frozen_bf16: false — bf16 compute, f32 frozen weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_pair():
    """A one-layer-per-block tiny UNet (the port's seeded init nudged by
    0.01 N(0, 1): norm scales off 1, so bf16 rounding moves them), a numpy
    batch and the draws JAX's loss_fn makes from key 0; the JAX trainer's
    loss and trainable gradients with a bf16 model (``dtype=bfloat16``) on
    f32 params, for f32 frozen weights and for frozen weights rounded to
    bf16. Flax computes a bf16-stored weight as its f32 value (Dense / Conv
    cast to bf16 at use, norms promote to f32), so the bf16-frozen case
    holds the rounded values in f32 and one compile serves both."""
    unet = MVMotionUNet(MVUNetConfig.tiny(num_views=N_VIEWS, layers_per_block=1))
    factory.init_params(unet, seed=0)
    rng = np.random.default_rng(99)
    state = {k: v.numpy() + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in unet.state_dict().items()}
    rng = np.random.default_rng(1)
    bn = N_VIDEOS * N_VIEWS
    batch = dict(latents=rng.normal(size=(bn, FRAMES, LAT, LAT, 4)).astype(np.float32),
                 text_ctx=rng.normal(size=(bn, 77, 32)).astype(np.float32),
                 null_text_ctx=np.zeros((bn, 77, 32), np.float32),
                 camera=rng.normal(size=(bn, 16)).astype(np.float32),
                 image_embeds=rng.normal(size=(bn, 16)).astype(np.float32))
    key = jax.random.PRNGKey(0)
    k_t, k_noise, k_drop = jax.random.split(key, 3)
    draws = dict(t=np.array(jax.random.randint(k_t, (N_VIDEOS,), 0, 1000)),
                 noise=np.array(jax.random.normal(k_noise, (bn, FRAMES - 1, LAT, LAT, 4),
                                                  jnp.float32)),
                 drop=np.array(jax.random.bernoulli(k_drop, 0.5, (N_VIDEOS,))))
    junet = JaxUNet(JaxUNetConfig.tiny(num_views=N_VIEWS, layers_per_block=1),
                    dtype=jnp.bfloat16)

    def unet_apply(p, *a, i2v_cond_time_zero=False):
        return junet.apply(p, *a, i2v_cond_time_zero=i2v_cond_time_zero)

    grab = optax.GradientTransformation(
        lambda p: None, lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    step = jax.jit(JT.make_train_step(unet_apply, grab, JT.MVVDMTrainConfig(
        num_views=N_VIEWS, cfg_dropout_prob=0.5)))
    jbatch = JT.TrainBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    bf16 = lambda v: np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
    refs = {}
    for cast in (False, True):
        st = {k: v if (TT.is_trainable(k) or not cast) else bf16(v) for k, v in state.items()}
        _, grads, metrics = step({"params": t2f.torch_to_flax_params(st)}, None, jbatch, key)
        flat = {k: v.numpy() for k, v in from_flax(_drop_none(jax.tree_util.tree_map(
            np.asarray, grads))).items()}
        refs[cast] = (float(metrics["loss"]), flat)
    return state, batch, draws, refs


def _port_bf16_step(state, batch, draws, cast_frozen: bool):
    unet = MVMotionUNet(MVUNetConfig.tiny(num_views=N_VIEWS, layers_per_block=1,
                                          gradient_checkpointing=True)).train()
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    masters = TT.cast_frozen_bf16(unet, torch.bfloat16, cast_frozen=cast_frozen)
    for name, p in unet.named_parameters():
        p.requires_grad_(TT.is_trainable(name))
    loss = TT.loss_fn(unet, TT.TrainBatch(**{k: torch.from_numpy(v) for k, v in batch.items()}),
                      torch.from_numpy(draws["t"]).long(), torch.from_numpy(draws["noise"]),
                      torch.from_numpy(draws["drop"]),
                      TT.MVVDMTrainConfig(num_views=N_VIEWS, cfg_dropout_prob=0.5),
                      DDIMScheduler())
    loss.backward()
    return unet, masters, float(loss.detach())


def _flat(grads: dict, names) -> torch.Tensor:
    return torch.cat([torch.as_tensor(np.asarray(grads[n], np.float32)).reshape(-1)
                      for n in names])


@pytest.mark.parametrize("cast_frozen", [False, True], ids=["f32-frozen", "bf16-frozen"])
def test_bf16_loss_and_grads_match_jax(bf16_pair, cast_frozen):
    """(c) The tiny UNet's loss and trainable gradients in bf16 compute,
    with the frozen weights in f32 (``cast_frozen_bf16: false``) or rounded
    to bf16 (true), against the JAX trainer on the same params, batch and
    draws. Trainable parameters are f32 in both (the optimizer's masters);
    activations are bf16 in both. Limits: the loss within 2e-3 relative,
    the concatenated gradient within 5e-2 relative L2 — bf16's noise floor
    here: the flag itself (a bf16 rounding of the frozen norms' scales and
    biases) moves the gradient by 3.4e-2 in each package, uncorrelated
    across them, and the two packages round their bf16 intermediates at
    other points (the port's plain GEGLU takes its products in f32)."""
    state, batch, draws, refs = bf16_pair
    unet, masters, loss = _port_bf16_step(state, batch, draws, cast_frozen)
    for name, p in unet.named_parameters():
        want = torch.float32 if (name in masters or not cast_frozen) else torch.bfloat16
        assert p.dtype == want, name
    ref_loss, ref_grads = refs[cast_frozen]
    names = sorted(masters)
    assert set(names) == set(ref_grads)
    got = torch.cat([masters[n].grad.reshape(-1) for n in names])
    ref = _flat(ref_grads, names)
    assert abs(loss - ref_loss) <= 2e-3 * abs(ref_loss)
    assert float((got - ref).norm() / ref.norm()) <= 5e-2
    if not cast_frozen:
        # what the flag changes: the same order of change in both packages
        other = _flat(refs[True][1], names)
        jax_move = float((ref - other).norm() / other.norm())
        _, masters_b, loss_b = _port_bf16_step(state, batch, draws, True)
        port_move = float((got - torch.cat([masters_b[n].grad.reshape(-1) for n in names])
                           ).norm() / other.norm())
        assert 1e-2 < jax_move < 1e-1 and 0.5 * jax_move < port_move < 2.0 * jax_move
        assert loss != loss_b and refs[False][0] != refs[True][0]


@pytest.mark.parametrize("family", ["Dense", "Conv", "GroupNorm", "LayerNorm"])
def test_layers_follow_flax_dtype_rule(family):
    """Flax's rule for f32 params under a bf16 module, per layer family,
    against ``models/layers.py`` on the same f32 weights and bf16 input:
    Dense / Conv cast the weights to bf16 at use (equal to bf16 storage),
    the norms apply the f32 scale and bias to f32 statistics before the
    bf16 cast (unlike bf16 storage). Outputs within one bf16 ulp."""
    import flax.linen as fnn

    from animate3d_tpu_torch.models import layers as L

    rng = np.random.default_rng(4)
    c = 32
    x = rng.normal(size=(2, 6, 6, c)).astype(np.float32)
    if family == "Dense":
        fmod, tmod = fnn.Dense(16, dtype=jnp.bfloat16), L.Linear(c, 16)
    elif family == "Conv":
        fmod, tmod = fnn.Conv(16, (3, 3), padding=1, dtype=jnp.bfloat16), L.Conv2d(c, 16, 3,
                                                                                   padding=1)
    elif family == "GroupNorm":
        fmod, tmod = fnn.GroupNorm(num_groups=8, epsilon=1e-5, dtype=jnp.bfloat16), \
            L.GroupNorm(8, c, eps=1e-5)
    else:
        fmod, tmod = fnn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16), L.LayerNorm(c, eps=1e-5)
    with torch.no_grad():
        for name, p in tmod.named_parameters():
            p.copy_(torch.as_tensor(rng.normal(size=p.shape).astype(np.float32) * 0.3
                                    + (1.0 if name == "weight" and p.dim() == 1 else 0.0)))
    tree = {"params": t2f.torch_to_flax_params(
        {f"m.{k}": v.numpy() for k, v in tmod.state_dict().items()})["m"]}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with HIGHEST:
        ref = np.asarray(fmod.apply(tree, xb).astype(jnp.float32))
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).bfloat16()
    if family == "Conv" or family == "GroupNorm":
        out = tmod(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    else:
        out = tmod(xt)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().detach().numpy(), ref,
                               atol=2.0 ** -7 * float(np.abs(ref).max()), rtol=0)
    if family in ("GroupNorm", "LayerNorm"):  # bf16 storage would give another output
        bf = {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16))
              for k, v in t2f.flatten_paths(tree).items()}
        tree_b = {"params": {k.split("/")[-1]: v for k, v in bf.items()}}
        ref_b = np.asarray(fmod.apply(tree_b, xb).astype(jnp.float32))
        assert np.abs(ref_b - ref).max() > 0


# ---------------------------------------------------------------------------
# (d) pretrained_model_path and the VAE key collision
# ---------------------------------------------------------------------------


def test_pretrained_model_path_loads_unet_and_vae(weights):
    """(d) The diffusers ``unet/`` and ``vae/`` over fresh seeded modules:
    every file key lands by name, the UNet equals the JAX converter's route
    on the same file (``torch_to_flax_params`` + ``apply_to_flax_params``),
    and only the trained and IP-Adapter keys stay missing."""
    from animate3d_tpu_torch.cli.train_mvvdm import load_pretrained_model_path

    unet, vae, *_ = factory.build_models("tiny", N_VIEWS, "cpu", seed=0, train=True,
                                         clip=False)
    template = {k: v.numpy().copy() for k, v in unet.state_dict().items()}
    audit = load_pretrained_model_path(str(weights["pre"]), unet, vae)
    (u_missing, u_unexpected), (v_missing, v_unexpected) = audit["unet"], audit["vae"]
    assert not u_unexpected and not v_missing and not v_unexpected
    assert set(u_missing) == set(template) - set(weights["unet_sd"])
    assert all(TT.is_trainable(k) or "_ip." in k or k.startswith("encoder_hid_proj")
               for k in u_missing)
    sd = t2f.load_torch_state_dict(str(weights["pre"] / "unet" /
                                       "diffusion_pytorch_model.safetensors"))
    params, missing, unexpected = t2f.apply_to_flax_params(
        {"params": t2f.torch_to_flax_params(template)}, t2f.torch_to_flax_params(sd))
    assert not unexpected and len(missing) > 0
    for k, v in from_flax(params).items():
        np.testing.assert_array_equal(unet.state_dict()[k].numpy(), v.numpy(), err_msg=k)
    for k, v in weights["vae"].state_dict().items():
        assert torch.equal(vae.state_dict()[k], v), k


def test_vae_encoder_keys_collide_in_jax_not_in_the_port(weights):
    """(d) A pinned deviation: the JAX converter drops ``encoder`` as a
    wrapper, so a diffusers VAE's ``encoder.*`` keys lose their prefix, find
    no home in the flax VAE and leave its whole encoder at init; the
    decoder's ``up_blocks.{i}.upsamplers.0.conv`` becomes a path the flax
    VAE does not have (it names the layer ``up_blocks_{i}_upsamplers_0_conv``)
    and stays at init too. Every other ``decoder.*`` key loads. The port
    loads every VAE key by name."""
    from animate3d_tpu_torch.cli.train_mvvdm import load_pretrained_model_path

    jvae = JaxVAE(JaxVAEConfig.tiny())
    init = jax.jit(jvae.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    sd = t2f.load_torch_state_dict(str(weights["pre"] / "vae" /
                                       "diffusion_pytorch_model.safetensors"))
    params, missing, unexpected = t2f.apply_to_flax_params(init, t2f.torch_to_flax_params(sd))
    stuck = lambda k: k.startswith("encoder") or ".upsamplers." in k or "_upsamplers_" in k
    assert len(unexpected) == len([k for k in sd if stuck(k)]) > 0
    flat_init, flat = t2f.flatten_paths(init["params"]), t2f.flatten_paths(params["params"])
    assert set(missing) == {k for k in flat if stuck(k)}
    for k in flat:
        assert np.array_equal(np.asarray(flat[k]), np.asarray(flat_init[k])) == stuck(k), k
    _, vae, *_ = factory.build_models("tiny", N_VIEWS, "cpu", seed=0, train=True, clip=False)
    load_pretrained_model_path(str(weights["pre"]), torch.nn.Identity(), vae)
    for k, v in sd.items():
        np.testing.assert_array_equal(vae.state_dict()[k].numpy(), v, err_msg=k)


# ---------------------------------------------------------------------------
# (e) the learnable spatial encoding
# ---------------------------------------------------------------------------


def test_learnable_encoding_matches_golden():
    """(e) A motion module with the learnable spatial encoding against
    tests/golden/ref_mini.npz's ``motion_learn`` case (the reference's
    processors transcribed to torch), the tables sized by
    ``spatial_size``. f32, the golden test's tolerance (atol 2e-5, rtol
    1e-4)."""
    from animate3d_tpu_torch.models.unet_blocks import MotionAttnConfig, MotionModule

    golden = dict(np.load(ROOT / "tests" / "golden" / "ref_mini.npz"))
    b, n, f, c, heads, fs = (int(v) for v in golden["meta"][:6])
    cfg = MotionAttnConfig(enabled=True, spatial_attn=True, image_attn=False,
                           use_alpha_blender=True, spatial_encoding="learnable",
                           camera_encoding=None)
    x = golden["in:motion:x"]
    mod = MotionModule(c, heads, n, cfg, max_seq_length=32, spatial_size=x.shape[2:])
    sd = {W.unet_key(k[len("sd:motion_learn:"):]): torch.from_numpy(v)
          for k, v in golden.items() if k.startswith("sd:motion_learn:")}
    res = mod.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    with torch.no_grad():
        out = mod(torch.from_numpy(x), f)
    np.testing.assert_allclose(out.numpy(), golden["out:motion_learn"], atol=2e-5, rtol=1e-4)


def test_full_unet_with_learnable_encoding_matches_jax():
    """(e) A tiny full UNet (one layer a block) with the learnable spatial
    encoding, its tables sized from ``MVUNetConfig.latent_size`` at each
    level (8² and 4²), against the JAX UNet on the same weights (through
    ``convert/torch_to_flax.py``, checked against the shapes JAX's ``init``
    gives them). f32, atol 1e-4 (the golden UNet test's)."""
    from animate3d_tpu.models.unet_blocks import MotionAttnConfig as JaxMotionAttn
    from animate3d_tpu_torch.models.unet_blocks import MotionAttnConfig

    attn = dict(enabled=True, spatial_attn=True, image_attn=False, use_alpha_blender=True,
                spatial_encoding="learnable", camera_encoding=None)
    with pytest.raises(ValueError, match="latent_size"):
        MVMotionUNet(MVUNetConfig.tiny(motion_attn=MotionAttnConfig(**attn)))
    unet = MVMotionUNet(MVUNetConfig.tiny(num_views=N_VIEWS, layers_per_block=1,
                                          motion_attn=MotionAttnConfig(**attn),
                                          latent_size=(LAT, LAT))).eval()
    factory.init_params(unet, seed=1)
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for p in unet.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    tables = {k: tuple(v.shape) for k, v in unet.state_dict().items() if "row_embed" in k}
    assert set(tables.values()) == {(LAT, 32 // 2), (LAT // 2, 64 // 2)}
    rng = np.random.default_rng(5)
    inputs = (rng.normal(size=(N_VIEWS, 2, LAT, LAT, 4)).astype(np.float32),
              np.float32(301.0), rng.normal(size=(N_VIEWS, 77, 32)).astype(np.float32),
              rng.normal(size=(N_VIEWS, 16)).astype(np.float32),
              rng.normal(size=(N_VIEWS, 16)).astype(np.float32))
    junet = JaxUNet(JaxUNetConfig.tiny(num_views=N_VIEWS, layers_per_block=1,
                                       motion_attn=JaxMotionAttn(**attn)))
    params = _tree(unet)
    want = jax.eval_shape(lambda k: junet.init(k, *map(jnp.asarray, inputs)),
                          jax.random.PRNGKey(0))
    shapes = lambda t: {k: tuple(v.shape) for k, v in t2f.flatten_paths(t).items()}
    assert shapes(params) == shapes(want)
    with HIGHEST:
        ref = np.asarray(jax.jit(junet.apply)(params, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        out = unet(*(torch.as_tensor(a) for a in inputs))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# (f) cli/validate_weights.py
# ---------------------------------------------------------------------------


def _script_report(tmp_path, audit: dict) -> dict:
    """``scripts/convert_weights.py::validate_bundle``'s report for ``audit``,
    with its model build and bundle load stubbed (its golden step then sees
    a zero output of the golden shape): the report's keys and ok rule."""
    spec = importlib.util.spec_from_file_location(
        "convert_weights", ROOT / "scripts" / "convert_weights.py")
    cw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cw)
    from animate3d_tpu.models import factory as jfactory

    unet = types.SimpleNamespace(apply=lambda p, lat, *a: jnp.zeros(lat.shape))
    orig = jfactory.build_models, jfactory.init_and_load
    jfactory.build_models = lambda *a, **k: (unet, None, None, None)
    jfactory.init_and_load = lambda *a, **k: (None, None, None, None, set(audit))
    tmp_path.mkdir()
    try:
        return cw.validate_bundle(str(tmp_path), audit)
    finally:
        jfactory.build_models, jfactory.init_and_load = orig


def test_validate_weights_report_matches_the_script(weights, tmp_path, monkeypatch):
    """(f) ``validate_weights --smoke`` on the tiny root (towers, tokenizer)
    with the UNet and VAE of ``pretrained_model_path`` copied in as the
    MVDream stack: the report's keys, the golden statistics' keys, the
    smoke record's keys and the ok rule equal the script's; an audit with
    an unexpected key fails in both."""
    import shutil

    from animate3d_tpu_torch.cli.validate_weights import main

    root = tmp_path / "root"
    shutil.copytree(weights["root"], root)
    for sub in ("unet", "vae"):
        shutil.copytree(weights["pre"] / sub, root / "sd15" / sub)
    rep = main(["--all", str(root), "--output", str(tmp_path / "out"), "--model_size", "tiny",
                "--smoke", "--smoke_model_size", "tiny", "--smoke_res", "16", "--smoke_frames",
                "2", "--device", "cpu"])
    saved = json.loads((tmp_path / "out" / "parity_report.json").read_text())
    assert saved["ok"] and saved["smoke"]["ok"] and saved["loaded_families"] == sorted(
        ["unet", "vae", "text_encoder", "image_encoder"])
    eps = np.load(tmp_path / "out" / "golden_denoise_eps.npy")
    assert list(eps.shape) == saved["golden_denoise"]["shape"] == [8, 2, 8, 8, 4]
    ref = _script_report(tmp_path / "script", rep["audit"])
    assert set(saved) - {"smoke"} == set(ref) and ref["ok"]
    assert set(saved["golden_denoise"]) == set(ref["golden_denoise"])
    assert set(saved["smoke"]) == {"gif", "ok", "n_frames", "frame_size", "pixel_std"}
    bad = dict(rep["audit"], unet={"missing": 0, "unexpected": 1})
    assert not _script_report(tmp_path / "script_bad", bad)["ok"]
    orig = W.load_artifacts
    monkeypatch.setattr(W, "load_artifacts", lambda *a, **k: dict(
        orig(*a, **k), unet={"missing": 0, "unexpected": 1}))
    with pytest.raises(SystemExit):
        main(["--all", str(root), "--output", str(tmp_path / "bad"), "--model_size", "tiny",
              "--device", "cpu"])
    assert not json.loads((tmp_path / "bad" / "parity_report.json").read_text())["ok"]
