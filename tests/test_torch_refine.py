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
from animate3d_tpu_torch.core import config
from animate3d_tpu_torch.core.checkpoint import find_latest_checkpoint, restore_checkpoint
from animate3d_tpu_torch.data.multi_image import MultiImageDataset
from torch_refine_workspace import NF, NV, RECON_YAML, REFINE_YAML, RES, build
from torch_refine_workspace import refine_args as _refine_args


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The refine workspace (tests/torch_refine_workspace.py): a seeded
    asset, 4 views x 2 frames at 32², a tiny artifact root and one recon
    trial of the port's CLI (1 step)."""
    return build(tmp_path_factory.mktemp("refine"))


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
