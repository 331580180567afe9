"""MV-VDM sampling CLI of the PyTorch port.

    python -m animate3d_tpu_torch.cli.inference --ip_image_root DIR \\
        --model_size full -W 256 -H 256 -N 4 -L 16 --steps 25

Builds the MV motion UNet, VAE and CLIP towers (seeded), loads the
released torch artifacts under ``--flax_params`` (the artifact root of
``convert/weights.py``: the MVDream stack, motion adapter, IP-Adapter and
image encoder) and ``--pretrained_unet_path`` (the released motion
checkpoint, or the port trainer's motion-module export directory), where
they exist; else it warns (smoke mode). It VAE-encodes the N conditioning
renders ``{0..N-1}.png``, runs the DDIM / CFG / FreeInit sampler and writes
the horizontal N-view GIF. Text conditioning comes from
``--prompt_embeds_path`` (npz with ``cond``/``uncond`` (77, D) arrays), else
from ``--prompt`` through the text tower and tokenizer when both were
loaded, else zeros; the IP-Adapter image embeds come from the conditioning
renders through the vision tower when it was loaded, else zeros.

``--mesh_sp N`` (or the yaml's ``mesh_sp``), under ``torchrun`` with N
processes (NCCL on CUDA, gloo with ``--device cpu``), shards the token axis
of the long self-attention sites over the N ranks: K/V travel around a ring
(``ops/attention.py::sp_ring``, ``parallel/sp_attention.py``). Every rank
samples the same seeded run; rank 0 writes the GIF. Runs on CUDA;
``--device cpu`` exists for the tests.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    """Run the CLI; returns {"gif": path, "latents": final latents,
    "text_cond", "image_embeds", "loaded" (components read from files),
    "step_seconds": per-denoise-step wall times, "run_seconds": conditioning,
    sampling and decode}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None, help="inference yaml")
    parser.add_argument("--prompt", default="")
    parser.add_argument("--ip_image_root", required=True,
                        help="dir with the N conditioning renders {0..N-1}.png")
    parser.add_argument("--ip_image_name", default="")
    parser.add_argument("--save_name", default="sample")
    parser.add_argument("--output_dir", default="outputs/inference")
    parser.add_argument("--pretrained_unet_path", default=None,
                        help="released motion checkpoint, or the port trainer's motion export")
    parser.add_argument("--flax_params", default=None,
                        help="artifact root of the released torch weights")
    parser.add_argument("--prompt_embeds_path", default=None)
    parser.add_argument("--model_size", default=None, choices=[None, "full", "tiny"],
                        help="tiny = test scale (overrides config)")
    parser.add_argument("-W", type=int, default=256)
    parser.add_argument("-H", type=int, default=256)
    parser.add_argument("-L", type=int, default=16)
    parser.add_argument("-N", type=int, default=4)
    parser.add_argument("--steps", type=int, default=25)
    parser.add_argument("--guidance_scale", type=float, default=7.5)
    parser.add_argument("--freeinit_iters", type=int, default=3)
    parser.add_argument("--seed", type=int, default=8673)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cpu is for tests")
    parser.add_argument("--mesh_sp", type=int, default=0,
                        help="shard the long self-attention sequences over N ranks "
                             "(a K/V ring; run under torchrun with N processes)")
    args = parser.parse_args(argv)

    import yaml
    from PIL import Image

    from animate3d_tpu_torch.core.device import resolve_device
    from animate3d_tpu_torch.models.clip import encode_ip_adapter_images
    from animate3d_tpu_torch.models.diffusion import DDIMScheduler, SchedulerConfig
    from animate3d_tpu_torch.models.factory import (
        build_models,
        encode_text,
        has_tokenizer,
        init_and_load,
    )
    from animate3d_tpu_torch.ops.attention import sp_ring
    from animate3d_tpu_torch.parallel import mesh as pmesh
    from animate3d_tpu_torch.pipelines.mv_sampler import (
        MVSampler,
        MVSamplerConfig,
        decode_video,
        encode_conditioning_images,
    )
    from animate3d_tpu_torch.utils.saving import export_to_gif_mv

    cfg_yaml = {}
    if args.config:
        with open(args.config) as fh:
            cfg_yaml = yaml.safe_load(fh) or {}
    dev = resolve_device(args.device)
    mesh_sp = int(cfg_yaml.get("mesh_sp", 0) or args.mesh_sp)
    joined, mesh = False, None
    if mesh_sp > 1:
        dev, joined = pmesh.init_distributed(dev)
        mesh = pmesh.make_mesh(dp=1, sp=mesh_sp)
        if mesh.is_main:
            print(f"[mesh] sp={mesh_sp}: long self-attention K/V ride the ring")

    # 1. models, then the weights on disk (seeded where none are given)
    model_size = args.model_size or cfg_yaml.get("model_size", "full")
    towers = bool(args.flax_params) and os.path.isdir(args.flax_params)
    unet, vae, text_model, vision_model = build_models(model_size, args.N, dev, clip=towers)
    unet, vae, text_model, vision_model, loaded = init_and_load(
        unet, vae, text_model, vision_model, args.flax_params, args.pretrained_unet_path)

    # 2. conditioning images (the static N-view renders)
    def load_cond(i):
        name = f"{args.ip_image_name}_{i}.png" if args.ip_image_name else f"{i}.png"
        img = Image.open(os.path.join(args.ip_image_root, name)).convert("RGB")
        img = img.resize((args.W, args.H), Image.LANCZOS)
        return np.asarray(img, np.float32) / 255.0

    cond_images = torch.as_tensor(np.stack([load_cond(i) for i in range(args.N)]),
                                  device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_run = time.perf_counter()

    # 3. text + image conditioning
    ucfg = unet.config
    if args.prompt_embeds_path:
        z = np.load(args.prompt_embeds_path)
        text_cond = torch.as_tensor(np.tile(z["cond"][None], (args.N, 1, 1)), device=dev)
        text_uncond = torch.as_tensor(np.tile(z["uncond"][None], (args.N, 1, 1)), device=dev)
    elif text_model is not None and has_tokenizer(args.flax_params):
        text_cond, text_uncond = encode_text(args.prompt, "", args.N, text_model,
                                             args.flax_params)
    else:
        print("[prompt] WARNING: no text encoder — zero text embeddings (smoke mode)")
        text_cond = torch.zeros((args.N, 77, ucfg.cross_attention_dim), device=dev)
        text_uncond = text_cond
    if vision_model is not None:
        with torch.no_grad():
            image_embeds = encode_ip_adapter_images(vision_model, cond_images).float()
    else:
        print("[ip] WARNING: no image encoder — zero image embeds (smoke mode)")
        image_embeds = torch.zeros((args.N, ucfg.image_embed_dim), device=dev)

    # 4. sample
    sched_kwargs = cfg_yaml.get("noise_scheduler_kwargs", {})
    scheduler = DDIMScheduler(SchedulerConfig(
        **{k: v for k, v in sched_kwargs.items()
           if k in SchedulerConfig.__dataclass_fields__}), device=dev)
    scfg = MVSamplerConfig(
        num_inference_steps=cfg_yaml.get("steps", args.steps),
        guidance_scale=cfg_yaml.get("guidance_scale", args.guidance_scale),
        num_views=args.N, num_frames=args.L, height=args.H, width=args.W,
        vae_scale_factor=2 ** (len(vae.config.block_out_channels) - 1),
        freeinit_enabled=cfg_yaml.get("freeinit_enabled", True),
        freeinit_num_iters=cfg_yaml.get("freeinit_num_iters", args.freeinit_iters),
        i2v_cond_time_zero=cfg_yaml.get("i2v_cond_time_zero", False),
        **_similarity_init(cfg_yaml),
    )
    sampler = MVSampler(unet, scfg, scheduler)
    ffl = encode_conditioning_images(vae, cond_images * 2.0 - 1.0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    try:
        with sp_ring(mesh) if mesh is not None else contextlib.nullcontext():
            latents = sampler.sample(ffl, text_cond, text_uncond, image_embeds, generator=gen)
    finally:
        pmesh.leave(joined)
    video = decode_video(vae, latents)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run_seconds = time.perf_counter() - t_run

    save_name = "-".join(args.prompt.replace("/", "").split(" ")[:10]) or "sample"
    out = os.path.join(args.output_dir, args.save_name, f"0-{save_name}.gif")
    if mesh is None or mesh.is_main:
        export_to_gif_mv(video.cpu().numpy(), out)
        print(f"saved {out}")
    return {"gif": out, "latents": latents, "text_cond": text_cond, "image_embeds": image_embeds,
            "loaded": loaded, "step_seconds": list(sampler.step_seconds),
            "run_seconds": run_seconds}


def _similarity_init(cfg_yaml: dict) -> dict:
    """The sampler's similarity-init fields from the inference yaml's
    ``i2v_similarity_init: {strength, origin_prob}`` (null in the shipped
    yaml, which keeps the pure-noise start)."""
    sim = cfg_yaml.get("i2v_similarity_init") or {}
    return {"i2v_similarity_strength": sim.get("strength"),
            "i2v_similarity_origin_prob": sim.get("origin_prob", 0.0)}


if __name__ == "__main__":
    main()
