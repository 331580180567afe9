"""Stage-2 refine through the port's entry points, on the CPU: the refine
config as the JAX package loads it, the random-camera SDS batch of the
multi-image dataset against the JAX dataset's, stage chaining from a port
recon checkpoint (``system.weights``), and the refine CLI at tiny size
chained from a port recon trial, with both CLIP towers read from a tiny
artifact root.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from animate3d_tpu.core import config as jconfig
from animate3d_tpu.data.multi_image import MultiImageDataset as JMultiImageDataset
from animate3d_tpu_torch.convert.weights import write_safetensors
from animate3d_tpu_torch.core import config
from animate3d_tpu_torch.core.checkpoint import find_latest_checkpoint, restore_checkpoint
from animate3d_tpu_torch.data.multi_image import MultiImageDataset
from animate3d_tpu_torch.gaussians.ply import write_gaussian_ply
from animate3d_tpu_torch.gaussians.state import GaussianState
from animate3d_tpu_torch.models.factory import build_models
from animate3d_tpu_torch.utils.tokenizer import write_char_level_tokenizer

RECON_YAML = "configs/animate3d/motion_recon_frame_16.yaml"
REFINE_YAML = "configs/animate3d/refine_frame_16.yaml"
NV, NF, RES = 4, 2, 32


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A seeded asset (.ply), 4 views x 2 frames of RGBA at 32², a tiny
    artifact root (text encoder, tokenizer, image encoder at the factory's
    tiny sizes), and one recon trial of the port's CLI (1 step)."""
    from animate3d_tpu_torch.cli.launch import main

    root = tmp_path_factory.mktemp("refine")
    rng = np.random.default_rng(0)
    n = 48
    state = GaussianState.from_numpy(
        xyz=rng.uniform(-0.4, 0.4, (n, 3)), features_dc=rng.uniform(-1, 1, (n, 1, 3)),
        features_rest=np.zeros((n, 0, 3)), opacity=rng.uniform(-1, 3, (n, 1)),
        scaling=rng.uniform(-3.0, -2.0, (n, 3)), rotation=rng.normal(size=(n, 4)))
    write_gaussian_ply(str(root / "asset.ply"), state)
    (root / "frames").mkdir()
    for i in range(NV * NF):
        rgba = rng.uniform(0, 255, size=(RES, RES, 4)).astype(np.uint8)
        rgba[..., 3] = 255
        Image.fromarray(rgba, "RGBA").save(root / "frames" / f"{i}.png")
    _, _, text, vision = build_models("tiny", NV, "cpu", seed=21)
    weights = root / "weights"
    (weights / "sd15" / "text_encoder").mkdir(parents=True)
    write_safetensors(str(weights / "sd15" / "text_encoder" / "model.safetensors"),
                      text.state_dict())
    write_char_level_tokenizer(str(weights / "sd15" / "tokenizer"))
    (weights / "IP-Adapter" / "models" / "image_encoder").mkdir(parents=True)
    torch.save(vision.state_dict(),
               weights / "IP-Adapter" / "models" / "image_encoder" / "pytorch_model.bin")
    common = [f"data.image_root={root}/frames", f"data.height={RES}", f"data.width={RES}",
              f"data.total_frame={NF}", f"system.n_frame={NF}",
              f"system.geometry.geometry_convert_from={root}/asset.ply",
              "system.geometry.grid_size=[[6, 6, 6, 2], [8, 8, 8, 2]]",
              "system.geometry.n_grid_dims=4", "system.loss.arap_sample_num=16",
              "system.prompt_processor.prompt=a toy", f"exp_root_dir={root}/out"]
    res = main(["--config", RECON_YAML, "--train", "--device", "cpu", *common,
                "trainer.max_steps=1"])
    return dict(root=root, common=common, weights=weights, recon_trial=res["trial_dir"],
                text=text, vision=vision)


def _refine_args(ws, *extra):
    rc = "data.random_camera"
    return [*ws["common"], f"{rc}.batch_size={NV * NF}", f"{rc}.total_frame={NF}",
            f"{rc}.width=16", f"{rc}.height=16", f"{rc}.eval_width={RES}",
            f"{rc}.eval_height={RES}", "system.guidance.model_size=tiny",
            "system.guidance.image_size=16",
            f"system.prompt_processor.cache_dir={ws['root']}/text_cache", *extra]


def test_refine_config_loads_as_jax(workspace, tmp_path):
    args = _refine_args(workspace, f"system.weights={workspace['recon_trial']}/ckpts")
    mine = config.load_config(REFINE_YAML, cli_args=args, makedirs=False)
    ref = jconfig.load_config(REFINE_YAML, cli_args=args, makedirs=False)
    for k in ("data", "system", "trainer", "checkpoint", "seed", "data_type", "system_type"):
        assert getattr(mine, k) == getattr(ref, k), k
    assert mine.system["load_guidance"] and mine.data["use_random_camera"]
    # the SDS batch the dataset draws each step: the JAX dataset's, seed for seed
    ours = MultiImageDataset.from_config(mine.data, seed=3)
    theirs = JMultiImageDataset.from_config(ref.data, seed=3)
    for step in (0, 1, 7):
        a, b = theirs.batch(step), ours.batch(step)
        for k in ("rgb", "mask", "c2w", "timestamps"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        for k in b["random_camera"]:
            np.testing.assert_array_equal(np.asarray(b["random_camera"][k]),
                                          np.asarray(a["random_camera"][k]), err_msg=k)
        assert b["random_camera"]["c2w"].shape == (NV * NF, 4, 4)


def test_stage_chaining_from_a_port_recon_checkpoint(workspace):
    """``system.weights``: a ``ckpts`` directory (its newest step) or a
    ``step_N`` restores the field's parameters; a missing one raises."""
    from animate3d_tpu_torch.cli.launch import build_system, load_system_weights

    ckpts = os.path.join(workspace["recon_trial"], "ckpts")
    want = restore_checkpoint(find_latest_checkpoint(ckpts))["params"]
    for weights in (ckpts, os.path.join(ckpts, "step_1")):
        cfg = config.load_config(RECON_YAML, makedirs=False, cli_args=[
            *workspace["common"], f"system.weights={weights}"])
        system = build_system(cfg, seed=1, device="cpu")
        assert any(not torch.equal(v, want[k]) for k, v in system.field.state_dict().items())
        load_system_weights(cfg, system)
        for k, v in system.field.state_dict().items():
            assert torch.equal(v, want[k]), k
    cfg.system["weights"] = os.path.join(ckpts, "step_9")
    with pytest.raises(FileNotFoundError, match="recon"):
        load_system_weights(cfg, system)


def test_refine_cli_on_cpu(workspace):
    """``launch --config refine_frame_16.yaml --train`` at tiny size: chained
    from the recon trial, guidance UNet / VAE seeded (tiny), both CLIP towers
    read from the artifact root; 2 steps with loss_sds logged, the guidance
    preview GIF at step 2, the checkpoint, then the testset pass (12 views x
    2 frames at 32²)."""
    from animate3d_tpu_torch.cli.launch import main

    ws = workspace
    res = main(["--config", REFINE_YAML, "--train", "--device", "cpu", *_refine_args(
        ws, f"system.weights={ws['recon_trial']}/ckpts",
        f"system.guidance.flax_params_dir={ws['weights']}", "trainer.max_steps=2",
        "trainer.log_every_n_steps=1", "trainer.guidance_eval_interval=2",
        "trainer.guidance_eval_steps=2", "checkpoint.every_n_train_steps=2")])
    trial = res["trial_dir"]
    system = res["system"]
    assert system.guidance is not None and system.global_step == 2
    unet, vae, text, vision = system.guidance.modules
    for mine, ref in ((text, ws["text"]), (vision, ws["vision"])):
        for k, v in ref.state_dict().items():
            assert torch.equal(mine.state_dict()[k], v), k
    assert next(unet.parameters()).dtype == torch.bfloat16
    assert all(torch.equal(p, p.to(torch.bfloat16).float()) for p in vae.parameters())
    assert system.guidance_inputs["text_cond"].abs().sum() > 0  # the prompt went through CLIP
    metrics = [json.loads(line) for line in open(os.path.join(trial, "metrics.jsonl"))]
    assert [m["step"] for m in metrics] == [0, 1]
    assert all(np.isfinite(m["loss_sds"]) and m["loss_sds"] > 0 for m in metrics)
    assert os.path.exists(os.path.join(trial, "ckpts", "step_2", "checkpoint.pt"))
    with Image.open(os.path.join(trial, "save", "guidance_eval", "it2.gif")) as gif:
        assert gif.n_frames == NF and gif.size == (NV * 16, 16)
    assert len(os.listdir(os.path.join(trial, "save", "images"))) == 12 * NF
    assert res["rgb"].shape == (12, NF, RES, RES, 3) and np.isfinite(res["rgb"]).all()


def test_guidance_build_needs_cuda_unless_told_cpu():
    """The guidance build, like every entry point, runs on ``cuda`` unless
    given the CPU."""
    from animate3d_tpu_torch.pipelines.guidance import build_guidance_from_config
    from animate3d_tpu_torch.systems.animate3d import Animate3DConfig

    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the guidance builds there without device='cpu'")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_guidance_from_config({"guidance": {"model_size": "tiny"}},
                                   Animate3DConfig(n_view=NV, n_frame=NF))
