"""The precision the reference computes in.

``"f32"`` is the reference: float32 everywhere, TF32 off. ``"tf32"`` is
the control of a float32 model: TF32 on for the products and
convolutions. ``"fp8"`` is the control of a model with bfloat16 parts (the
MV-VDM UNet) beside float32 ones: every operand of the UNet's products and
convolutions (activations and weights alike, the layers and ops that read
them through :func:`q`) is rounded to float8 e4m3 with one scale a tensor
(its largest magnitude onto 448), summed in float32; the float32 parts
(VAE, towers, renderer) take TF32, one step below them."""

from __future__ import annotations

import contextlib

import torch

MODE = "f32"
_FP8_MAX = 448.0


def q(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the current mode's products read it (float32 out)."""
    x = x.float()
    if MODE != "fp8":
        return x
    scale = x.abs().amax().clamp_min(1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


@contextlib.contextmanager
def mode(name: str):
    """Run the reference in ``name`` ("f32", "fp8" or "tf32") in this scope."""
    global MODE
    if name not in ("f32", "fp8", "tf32"):
        raise ValueError(f"precision mode {name!r}")
    prev = MODE
    MODE = name
    _tf32(name != "f32")
    try:
        yield
    finally:
        MODE = prev
        _tf32(prev != "f32")
