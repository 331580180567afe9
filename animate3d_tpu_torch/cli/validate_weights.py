"""Validate an artifact root of released torch weights: the port of
``scripts/convert_weights.py``'s validation (``validate_bundle`` and
``smoke_sample``). The port reads the torch artifacts directly, so nothing
is converted.

    python -m animate3d_tpu_torch.cli.validate_weights --all pretrained_models/ \\
        --output reports/ [--smoke [--smoke_images renders/]] [--device cpu]

On the root (the layout of ``convert/weights.py::discover_artifacts``) it
records the key audit per family that ``load_artifacts`` returns, runs the
golden denoise step (the full UNet in bf16 on the CFG pair of 8 x 16
latents at 32², ``numpy.random.default_rng(0)`` inputs drawn in the
script's order, t = 501), saves ``golden_denoise_eps.npy`` with its
statistics, and with ``--smoke`` samples a short clip through
``cli/inference.py`` with ``--flax_params <root>``. ``parity_report.json``
takes the script's keys and its ok rule: a finite golden output and no
family with unexpected keys (and, with ``--smoke``, a finite GIF that is not
blank). Exits 1 when it is not ok. Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


# golden denoise inputs (frames, latent size): the script's at full size; a
# CPU-sized step for the tiny test model
GOLDEN = {"full": (16, 32), "tiny": (2, 8)}


def validate_root(root: str, output: str, model_size: str = "full", device=None) -> dict:
    """The audit and the golden denoise step (the script's
    ``validate_bundle``); writes ``<output>/golden_denoise_eps.npy``."""
    from animate3d_tpu_torch.convert.weights import load_artifacts
    from animate3d_tpu_torch.core.device import resolve_device
    from animate3d_tpu_torch.models.factory import build_models

    dev = resolve_device(device)
    unet, vae, text_model, vision_model = build_models(model_size, 4, dev,
                                                       dtype=torch.bfloat16)
    unet.float()  # released files are f32: round once, after loading
    audit = load_artifacts(root, unet, vae, text_model, vision_model)
    unet.to(torch.bfloat16)
    report = {"audit": audit, "loaded_families": sorted(audit)}

    ucfg = unet.config
    rng = np.random.default_rng(0)
    bn, (f, s) = 8, GOLDEN[model_size]
    draw = lambda *shape: torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                                          device=dev)
    latents = draw(bn, f, s, s, 4)
    text = draw(bn, 77, ucfg.cross_attention_dim)
    cam = draw(bn, 16)
    ie = draw(bn, ucfg.image_embed_dim)
    with torch.no_grad():
        eps = unet(latents, torch.tensor(501.0, device=dev), text, cam, ie)
    eps = eps.float().cpu().numpy()
    report["golden_denoise"] = {
        "input_seed": 0, "timestep": 501, "shape": list(eps.shape),
        "finite": bool(np.isfinite(eps).all()),
        "mean": float(eps.mean()), "std": float(eps.std()),
        "min": float(eps.min()), "max": float(eps.max()),
    }
    os.makedirs(output, exist_ok=True)
    np.save(os.path.join(output, "golden_denoise_eps.npy"), eps)
    # unexpected keys mean a broken file; missing ones are the frozen base
    # a motion-modules-only file leaves
    report["ok"] = bool(report["golden_denoise"]["finite"] and all(
        a.get("unexpected", 0) == 0 for a in audit.values()))
    return report


def smoke_sample(root: str, output: str, images=None, steps: int = 2,
                 prompt: str = "a dragon head roaring", res: int = 256, frames: int = 16,
                 model_size=None, device=None) -> dict:
    """A short DDIM sample through the sampling CLI on the root (the
    script's ``smoke_sample``): synthetic four-view renders unless
    ``images`` names a directory of ``0.png`` .. ``3.png``."""
    from PIL import Image

    from animate3d_tpu_torch.cli.inference import main as inference_main

    cond_dir = images
    if cond_dir is None:
        cond_dir = os.path.join(output, "smoke_cond")
        os.makedirs(cond_dir, exist_ok=True)
        yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / (res - 1.0)
        for i in range(4):
            img = np.stack([0.5 + 0.5 * np.cos(6.28 * (xx + i / 4.0)), yy, 1.0 - yy], axis=-1)
            a = (((xx - 0.5) ** 2 + (yy - 0.5) ** 2) < 0.16) * 255.0
            rgba = np.concatenate([img * 255.0, a[..., None]], axis=-1)
            Image.fromarray(rgba.astype(np.uint8), "RGBA").save(
                os.path.join(cond_dir, f"{i}.png"))
    argv = ["--ip_image_root", cond_dir, "--output_dir", os.path.join(output, "smoke_sample"),
            "--flax_params", root, "--prompt", prompt, "--steps", str(steps),
            "--freeinit_iters", "1", "-W", str(res), "-H", str(res), "-L", str(frames),
            "--seed", "0"]
    if model_size:
        argv += ["--model_size", model_size]
    if device:
        argv += ["--device", device]
    gif = inference_main(argv)["gif"]
    rec = {"gif": gif, "ok": False}
    if os.path.exists(gif):
        with Image.open(gif) as im:
            n_frames = getattr(im, "n_frames", 1)
            arr = np.asarray(im.convert("RGB"), np.float32)
            rec.update(ok=bool(np.isfinite(arr).all() and arr.std() > 1.0),
                       n_frames=int(n_frames), frame_size=list(im.size),
                       pixel_std=float(arr.std()))
    print(f"[smoke] sample {'OK' if rec['ok'] else 'FAILED'}: {gif}")
    return rec


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--all", required=True, metavar="DIR",
                        help="the artifact root of the released torch weights")
    parser.add_argument("--output", default=None,
                        help="where the report and the golden output go (default: DIR)")
    parser.add_argument("--model_size", default="full", choices=["full", "tiny"],
                        help="tiny = test scale (its golden step: 2 frames at 8²)")
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--smoke_images", default=None, metavar="DIR")
    parser.add_argument("--smoke_steps", type=int, default=2)
    parser.add_argument("--smoke_prompt", default="a dragon head roaring")
    parser.add_argument("--smoke_res", type=int, default=256)
    parser.add_argument("--smoke_frames", type=int, default=16)
    parser.add_argument("--smoke_model_size", default=None, choices=[None, "full", "tiny"])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    output = args.output or args.all
    report = validate_root(args.all, output, args.model_size, args.device)
    if args.smoke:
        report["smoke"] = smoke_sample(args.all, output, args.smoke_images, args.smoke_steps,
                                       args.smoke_prompt, args.smoke_res, args.smoke_frames,
                                       args.smoke_model_size, args.device)
    path = os.path.join(output, "parity_report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[validate] golden denoise {'OK' if report['ok'] else 'FAILED'}; report at {path}")
    if not report["ok"] or not report.get("smoke", {}).get("ok", True):
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
