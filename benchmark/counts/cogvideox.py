"""Counted operations of CogVideoX-5B image-to-video: the products and
convolutions of the reference (``reference/cogvideox/``) over meta tensors
at the configuration's sizes, by ``torch.utils.flop_counter``. A DDIM step
is one CFG transformer call (batch 2: the linears, the patch embed and the
joint attention's QKᵀ and PV over 17,776 tokens); a request's conditioning
is the T5 encoder on [negative, prompt] and the VAE encoder on the one
image frame. The decode is not in the cell's window and is not counted
here."""

from __future__ import annotations

from dataclasses import fields
from typing import Dict

import torch


def _pick(cls, d: dict):
    names = {f.name for f in fields(cls)}
    return cls(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items()
                  if k in names})


def ref_configs(config: dict):
    """The reference's (transformer, T5, VAE) configs from the configuration
    file's groups."""
    from benchmark.reference.cogvideox import cogvideox as ref

    return (_pick(ref.TransformerConfig, config["transformer"]), _pick(ref.T5Config, config["t5"]),
            _pick(ref.VAEConfig, config["vae"]))


def request_flops(config: dict) -> Dict[str, float]:
    """{"step": one CFG transformer call, "condition": T5 and the image
    encode} in flops."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.cogvideox import cogvideox as ref

    tc, t5c, vc = ref_configs(config)
    s = config["sampling"]
    mods = ref.build(tc, t5c, vc, "meta")
    down = 2 ** (len(vc.block_out_channels) - 1)
    frames = (s["num_frames"] - 1) // vc.temporal_compression_ratio + 1
    h, w = s["height"] // down, s["width"] // down
    meta = dict(device="meta")

    def count(fn) -> float:
        with FlopCounterMode(display=False) as fc:
            fn()
        return float(fc.get_total_flops())

    step = count(lambda: mods["transformer"](
        torch.zeros((2, frames, tc.in_channels, h, w), **meta), torch.zeros((2,), **meta),
        torch.zeros((2, tc.max_text_seq_length, tc.text_embed_dim), **meta)))
    t5 = count(lambda: mods["t5"](
        torch.zeros((2, tc.max_text_seq_length), dtype=torch.long, **meta)))
    enc = count(lambda: mods["vae"].encode(
        torch.zeros((1, vc.in_channels, 1, s["height"], s["width"]), **meta)))
    return {"step": step, "condition": t5 + enc}
