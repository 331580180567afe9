"""The port's weight loaders (``convert/weights.py``, ``factory.init_and_load``)
and the sampling CLI with both CLIP towers, on a tiny artifact root the
tests write: the released layout with a ``.bin`` UNet, a ``.safetensors``
motion adapter and text encoder, a nested ``ip-adapter_sd15.bin``, an image
encoder and a motion ``.ckpt``.

The UNet the port loads is held against the JAX converter's route on the
same files (``torch_to_flax_params`` / ``merge_params`` /
``scripts/convert_weights.py::convert_ip_adapter`` / ``apply_to_flax_params``
/ ``load_animate3d_motion_checkpoint``), read back through
``convert/from_flax.py``: the same tensors, and the same count of missing
(frozen) keys.
"""

import functools
import importlib.util
import json
import types
import os
import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from animate3d_tpu.convert import torch_to_flax as t2f
from animate3d_tpu.models import clip as jclip
from animate3d_tpu.models import factory as jfactory
from animate3d_tpu.models.unet_mv import MVUNetConfig as JaxUNetConfig
from animate3d_tpu_torch.convert import weights as W
from animate3d_tpu_torch.convert.from_flax import from_flax
from animate3d_tpu_torch.core.checkpoint import save_checkpoint
from animate3d_tpu_torch.models import factory
from animate3d_tpu_torch.pipelines.train_mvvdm import extract_motion_modules, is_trainable
from animate3d_tpu_torch.utils.tokenizer import write_char_level_tokenizer

from torch_cpu_host import warm_vml

warm_vml()  # before the first torch.exp: see tests/torch_cpu_host.py

ROOT = pathlib.Path(__file__).resolve().parent.parent
HIGHEST = jax.default_matmul_precision("highest")


def _convert_weights_script():
    spec = importlib.util.spec_from_file_location(
        "convert_weights", ROOT / "scripts" / "convert_weights.py")
    cw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cw)
    return cw


def _released(name: str) -> str:
    """A port UNet name → the released diffusers key: attention-processor
    adapters under ``.processor.``, the IP projections in a list of one."""
    for marker in ("to_q_i2v", "to_k_i2v", "to_v_i2v", "to_out_i2v", "to_q_sp", "to_k_sp",
                   "to_v_sp", "to_out_sp", "alpha_blender"):
        name = name.replace(f".{marker}", f".processor.{marker}")
    return name.replace(".to_k_ip.", ".to_k_ip.0.").replace(".to_v_ip.", ".to_v_ip.0.")


def _hand_written_safetensors(path, tensors):
    """The format written by hand: little-endian u64 header length, the JSON
    header, the raw buffers."""
    codes = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16",
             torch.int64: "I64", torch.uint8: "U8"}
    header, blobs, off = {"__metadata__": {"format": "pt"}}, [], 0
    for k, t in tensors.items():
        raw = t.contiguous().view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[k] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def test_safetensors_reader(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(3, 4, generator=g),
               "b": torch.randn(5, generator=g).to(torch.bfloat16),
               "c": torch.randn(2, 2, generator=g).half(),
               "ids": torch.arange(6).reshape(2, 3),
               "u8": torch.tensor([1, 255], dtype=torch.uint8),
               "empty": torch.zeros(0, 4)}
    _hand_written_safetensors(tmp_path / "m.safetensors", tensors)
    got = W.read_safetensors(str(tmp_path / "m.safetensors"))
    assert set(got) == set(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape
        assert torch.equal(got[k], t), k
    W.write_safetensors(str(tmp_path / "w.safetensors"), tensors)
    for k, t in W.read_safetensors(str(tmp_path / "w.safetensors")).items():
        assert torch.equal(t, tensors[k]), k
    raw = (tmp_path / "m.safetensors").read_bytes().replace(b'"F16"', b'"F8X"')
    (tmp_path / "bad.safetensors").write_bytes(raw)
    with pytest.raises(ValueError, match="F8X"):
        W.read_safetensors(str(tmp_path / "bad.safetensors"))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The released layout at tiny size, from the port's seeded modules
    (seed 11, every tensor nudged so none is zero): base UNet, motion adapter
    (the motion modules, halved), IP-Adapter (image projection and attn2 IP
    projections, a nested ``.bin``), motion checkpoint (every trained key:
    the motion modules, the I2V / spatial adapters and alpha blenders under
    ``.processor.``), VAE, text encoder, tokenizer, image encoder."""
    root = tmp_path_factory.mktemp("artifacts")
    unet, vae, text, vision = factory.build_models("tiny", 4, "cpu", seed=11)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in (unet, vae, text, vision):
            for p in m.parameters():
                p.add_(0.01 * torch.randn(p.shape, generator=g))
    sd = unet.state_dict()
    mv = root / "mvdream-sd1.5-diffusers"
    for sub in ("unet", "vae", "text_encoder"):
        (mv / sub).mkdir(parents=True)
    ip_keys = [k for k in sd if "_ip." in k or k.startswith("encoder_hid_proj")]
    motion = {k for k in sd if "motion_modules" in k and not any(
        m in k for m in ("_i2v", "_sp", "alpha_blender"))}
    trained = {k for k in sd if is_trainable(k)} - motion
    base = {_released(k): v for k, v in sd.items()
            if k not in motion and k not in trained and k not in ip_keys}
    torch.save(base, mv / "unet" / "diffusion_pytorch_model.bin")
    ma = root / "animatediff-motion-adapter-v1-5-2"
    ma.mkdir()
    (ma / "config.json").write_text(json.dumps({"_class_name": "MotionAdapter"}))
    # the adapter's motion modules, which the motion checkpoint overrides
    W.write_safetensors(str(ma / "diffusion_pytorch_model.safetensors"),
                        {_released(k): 0.5 * sd[k] for k in sorted(motion)})
    # ip-adapter_sd15.bin: processor index 2·i + 1 is the i-th cross-attention
    order = ["down_blocks.0.attentions.0", "down_blocks.0.attentions.1",
             "up_blocks.1.attentions.0", "up_blocks.1.attentions.1",
             "up_blocks.1.attentions.2", "mid_block.attentions.0"]
    ip_adapter = {}
    for i, block in enumerate(order):
        for kv in ("to_k_ip", "to_v_ip"):
            ip_adapter[f"{2 * i + 1}.{kv}.weight"] = sd[
                f"{block}.transformer_blocks.0.attn2.{kv}.weight"]
    proj = "encoder_hid_proj.image_projection_layers.0."
    image_proj = {"proj.weight": sd[proj + "image_embeds.weight"],
                  "proj.bias": sd[proj + "image_embeds.bias"],
                  "norm.weight": sd[proj + "norm.weight"], "norm.bias": sd[proj + "norm.bias"]}
    ip = root / "IP-Adapter"
    (ip / "models" / "image_encoder").mkdir(parents=True)
    torch.save({"image_proj": image_proj, "ip_adapter": ip_adapter},
               ip / "models" / "ip-adapter_sd15.bin")
    torch.save(vision.state_dict(), ip / "models" / "image_encoder" / "pytorch_model.bin")
    ckpt = root / "animate3d_motion_modules.ckpt"
    torch.save({_released(k): sd[k] for k in sorted(trained | motion)}, ckpt)
    torch.save(vae.state_dict(), mv / "vae" / "diffusion_pytorch_model.bin")
    text_sd = dict(text.state_dict())
    text_sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    W.write_safetensors(str(mv / "text_encoder" / "model.safetensors"), text_sd)
    write_char_level_tokenizer(str(mv / "tokenizer"))
    return dict(root=root, mv=mv, ma=ma, ip=ip, ckpt=ckpt, unet=unet, vae=vae, text=text,
                vision=vision, base=base, ip_sd={"image_proj": image_proj,
                                                 "ip_adapter": ip_adapter})


def test_discover_artifacts_matches_the_script(artifacts):
    found = W.discover_artifacts(str(artifacts["root"]))
    assert found == _convert_weights_script().discover_artifacts(str(artifacts["root"]))
    assert found["animate3d_ckpt"] == str(artifacts["ckpt"])


def test_init_and_load_matches_the_jax_converter(artifacts):
    """Every family into fresh seeded modules (seed 0): the UNet equals the
    JAX route's result exactly, with the same frozen-key count; the VAE and
    both towers equal the files."""
    a = artifacts
    unet, vae, text, vision = factory.build_models("tiny", 4, "cpu", seed=0)
    template = {k: v.numpy().copy() for k, v in unet.state_dict().items()}
    unet, vae, text_out, vision_out, loaded = factory.init_and_load(
        unet, vae, text, vision, str(a["root"]), None)
    assert loaded == {"unet", "motion_ckpt", "vae", "text_encoder", "image_encoder"}
    assert text_out is text and vision_out is vision

    cw = _convert_weights_script()
    np_sd = lambda path: {k: np.asarray(v, np.float32) for k, v in
                          t2f.load_torch_state_dict(str(path)).items()}
    converted = t2f.torch_to_flax_params(np_sd(a["mv"] / "unet" /
                                                "diffusion_pytorch_model.bin"))
    converted = t2f.merge_params(converted, t2f.torch_to_flax_params(
        np_sd(a["ma"] / "diffusion_pytorch_model.safetensors")))
    flat_ip = {f"{grp}.{k}": v.numpy() for grp, d in a["ip_sd"].items() for k, v in d.items()}
    converted = t2f.merge_params(converted, cw.convert_ip_adapter(
        flat_ip, JaxUNetConfig.tiny(num_views=4)))
    params, missing, unexpected = t2f.apply_to_flax_params(
        {"params": t2f.torch_to_flax_params(template)}, converted)
    assert not unexpected and missing
    params, n_missing = t2f.load_animate3d_motion_checkpoint(params, str(a["ckpt"]))
    ref = from_flax(params)
    mine = unet.state_dict()
    assert set(ref) == set(mine)
    for k, v in ref.items():
        np.testing.assert_array_equal(mine[k].numpy(), v.numpy(), err_msg=k)
        np.testing.assert_array_equal(mine[k].numpy(), a["unet"].state_dict()[k].numpy(),
                                      err_msg=k)
    # the port's audit of the same checkpoint on a fresh UNet
    fresh = factory.build_models("tiny", 4, "cpu", seed=0, clip=False)[0]
    assert W.load_animate3d_motion_checkpoint(fresh, str(a["ckpt"])) == n_missing > 0
    for mod, ref_mod in ((vae, a["vae"]), (text, a["text"]), (vision, a["vision"])):
        for k, v in ref_mod.state_dict().items():
            assert torch.equal(mod.state_dict()[k], v), k


def test_motion_checkpoint_audit_raises_as_jax(artifacts, tmp_path):
    """An unknown key, or a trained key the file lacks, raises in both."""
    sd = torch.load(artifacts["ckpt"], weights_only=True)
    unet = factory.build_models("tiny", 4, "cpu", seed=0, clip=False)[0]
    template = {"params": t2f.torch_to_flax_params(
        {k: v.numpy() for k, v in unet.state_dict().items()})}
    bad_key = dict(sd, **{"down_blocks.0.nonsense.weight": torch.zeros(2)})
    first_trained = next(k for k in sd if "alpha_blender" in k or "_sp." in k)
    lacking = {k: v for k, v in sd.items() if k != first_trained}
    for i, case in enumerate((bad_key, lacking)):
        path = str(tmp_path / f"case{i}.ckpt")
        torch.save(case, path)
        with pytest.raises(ValueError):
            t2f.load_animate3d_motion_checkpoint(template, path)
        with pytest.raises(ValueError):
            W.load_animate3d_motion_checkpoint(unet, path)


def test_orbax_bundle_root_raises(tmp_path):
    (tmp_path / "unet" / "step_0").mkdir(parents=True)
    (tmp_path / "unet" / "step_0" / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        W.check_artifact_root(str(tmp_path))
    unet, vae, text, vision = factory.build_models("tiny", 4, "cpu", seed=0)
    with pytest.raises(ValueError, match="orbax"):
        factory.init_and_load(unet, vae, text, vision, str(tmp_path), None)


def test_key_renames():
    assert W.unet_key("down_blocks.0.attentions.1.transformer_blocks.0.attn2.processor."
                      "to_k_ip.0.weight") == \
        "down_blocks.0.attentions.1.transformer_blocks.0.attn2.to_k_ip.weight"
    assert W.unet_key("mid_block.motion_modules.0.transformer_blocks.0.attn1.processor."
                      "alpha_blender.mix_factor") == \
        "mid_block.motion_modules.0.transformer_blocks.0.attn1.alpha_blender.mix_factor"
    assert W.vae_key("encoder.mid_block.attentions.0.proj_attn.weight") == \
        "encoder.mid_block.attentions.0.to_out.0.weight"
    assert W.vae_key("decoder.mid_block.attentions.0.query.bias") == \
        "decoder.mid_block.attentions.0.to_q.bias"


def test_pretrained_unet_path_loads_the_trainer_export(tmp_path):
    """``--pretrained_unet_path`` on the port trainer's keep-2 export: the
    newest step's motion entries are grafted, the base keeps its init."""
    donor = factory.build_models("tiny", 4, "cpu", seed=5, clip=False)[0]
    export = extract_motion_modules(donor.state_dict())
    save_checkpoint(str(tmp_path / "motion_modules"), 3, {"params": {
        k: torch.zeros_like(v) for k, v in export.items()}})
    save_checkpoint(str(tmp_path / "motion_modules"), 7, {"params": export})
    unet, vae, text, vision = factory.build_models("tiny", 4, "cpu", seed=0)
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    _, _, t_out, v_out, loaded = factory.init_and_load(
        unet, vae, text, vision, None, str(tmp_path / "motion_modules"))
    assert loaded == {"motion_ckpt"} and t_out is None and v_out is None
    for k, v in unet.state_dict().items():
        assert torch.equal(v, export[k] if k in export else before[k]), k


def test_sampling_cli_with_both_towers(artifacts, tmp_path):
    """The sampling CLI on the tiny root: the prompt through the tokenizer
    and the text tower, the conditioning renders through the vision tower
    (resized 32² → 28²), each against the JAX functions on the same
    weights; a multi-frame GIF."""
    from animate3d_tpu_torch.cli.inference import main

    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
            tmp_path / f"{i}.png")
    res = main(["--device", "cpu", "--model_size", "tiny", "-W", "32", "-H", "32", "-L", "2",
                "--steps", "1", "--freeinit_iters", "1", "--prompt", "a red dragon",
                "--flax_params", str(artifacts["root"]), "--ip_image_root", str(tmp_path),
                "--output_dir", str(tmp_path / "out")])
    assert {"unet", "text_encoder", "image_encoder"} <= res["loaded"]
    with Image.open(res["gif"]) as gif:
        assert gif.n_frames == 2 and gif.size == (4 * 32, 32)
    tree = lambda m: {"params": t2f.torch_to_flax_params(
        {k: v.numpy() for k, v in m.state_dict().items()})}
    text, vision = artifacts["text"], artifacts["vision"]
    jtext = jclip.CLIPTextModel(jclip.CLIPTextConfig(**vars(text.config)))
    jvision = jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig(**vars(vision.config)))
    cond = np.stack([np.asarray(Image.open(tmp_path / f"{i}.png").convert("RGB"), np.float32)
                     / 255.0 for i in range(4)])
    with HIGHEST:  # jitted: one compile instead of an eager dispatch of every op
        jc, _ = jfactory.encode_text("a red dragon", "", 4,
                                     types.SimpleNamespace(apply=jax.jit(jtext.apply)),
                                     tree(text), str(artifacts["mv"]))
        jie = jax.jit(functools.partial(jclip.encode_ip_adapter_images, jvision))(
            tree(vision), jnp.asarray(cond))
    np.testing.assert_allclose(res["text_cond"].numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(res["image_embeds"].numpy(), np.asarray(jie), atol=1e-5)
