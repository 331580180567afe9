"""Seeded weights, made on the device in a few large calls: the same seed
gives the same tensors to the program and to the reference."""

from __future__ import annotations

from typing import Dict

import torch

_CHUNK = 1 << 27  # normal draws a call


def seeded_weights(shapes: Dict[str, torch.Size], seed: int, device,
                   dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """A state dict for ``shapes`` (name → shape, in order): a matrix or
    kernel N(0, 1/fan_in), a one-dimensional ``weight`` (norm scales)
    1 + 0.1·N(0, 1), anything else (biases, blender mixes) 0.02·N(0, 1); in
    ``dtype``. Every branch of the model contributes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out, buf, pos = {}, None, 0
    for name, shape in shapes.items():
        n = 1
        for s in shape:
            n *= int(s)
        if buf is None or pos + n > buf.numel():
            buf = torch.randn(max(_CHUNK, n), generator=gen, device=device)
            pos = 0
        z = buf[pos:pos + n].view(shape)
        pos += n
        if len(shape) >= 2:
            w = z * (n // int(shape[0])) ** -0.5
        elif name.endswith("weight"):
            w = 1.0 + 0.1 * z
        else:
            w = 0.02 * z
        out[name] = w.to(dtype)
    return out


def shapes_of(module: torch.nn.Module) -> Dict[str, torch.Size]:
    return {k: v.shape for k, v in module.state_dict().items()}
