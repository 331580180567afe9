"""The stage-2 refine workspace of the port's CPU tests (``build``): a seeded
asset (.ply), 4 views x 2 frames of RGBA at 32², a tiny artifact root (text
encoder, tokenizer, image encoder at the factory's tiny sizes) and one recon
trial of the port's CLI (1 step); ``refine_args`` are the refine CLI's
overrides at that size."""

import numpy as np
import torch
from PIL import Image

from animate3d_tpu_torch.convert.weights import write_safetensors
from animate3d_tpu_torch.gaussians.ply import write_gaussian_ply
from animate3d_tpu_torch.gaussians.state import GaussianState
from animate3d_tpu_torch.models.factory import build_models
from animate3d_tpu_torch.utils.tokenizer import write_char_level_tokenizer

RECON_YAML = "configs/animate3d/motion_recon_frame_16.yaml"
REFINE_YAML = "configs/animate3d/refine_frame_16.yaml"
NV, NF, RES = 4, 2, 32


def build(root) -> dict:
    from animate3d_tpu_torch.cli.launch import main

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


def refine_args(ws, *extra) -> list:
    rc = "data.random_camera"
    return [*ws["common"], f"{rc}.batch_size={NV * NF}", f"{rc}.total_frame={NF}",
            f"{rc}.width=16", f"{rc}.height=16", f"{rc}.eval_width={RES}",
            f"{rc}.eval_height={RES}", "system.guidance.model_size=tiny",
            "system.guidance.image_size=16",
            f"system.prompt_processor.cache_dir={ws['root']}/text_cache", *extra]
