"""Image quality metrics, PSNR, SSIM and LPIPS: the port of
``animate3d_tpu/utils/metrics.py``.

* :func:`psnr` and :func:`ssim` (11-tap Gaussian window applied as two
  separable depthwise convolutions, 'valid' padding, C1 = (0.01 L)², C2 =
  (0.03 L)²): the ``--test`` report's per-view numbers against the
  ground-truth video.
* :class:`Lpips`: AlexNet-backbone LPIPS (Zhang et al. 2018) as an
  ``nn.Module``; :func:`lpips_params_from_torch` builds its state dict from
  torchvision's ``alexnet().features`` and the ``lpips`` package's linear
  heads; :func:`load_lpips` returns None when no weights file exists (the
  report then leaves LPIPS out).

Images are channels-last float in [0, 1], as in the JAX package. On CUDA
the convolutions run with cuDNN's TF32 off (:func:`_no_tf32`), so they are
float32 as on the CPU.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0,
         axis: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB of the squared error averaged over
    ``axis`` (default: all, one scalar)."""
    err = (pred.float() - target.float()) ** 2
    mse = err.mean() if axis is None else err.mean(dim=tuple(axis))
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel1d(size: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum()


def _filter2d_sep(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable 'valid' filter of an (N, C, H, W) batch, channels
    independent: along W, then along H."""
    c, size = img.shape[1], k.shape[0]
    out = F.conv2d(img, k.reshape(1, 1, 1, size).repeat(c, 1, 1, 1), groups=c)
    return F.conv2d(out, k.reshape(1, 1, size, 1).repeat(c, 1, 1, 1), groups=c)


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Structural similarity (Wang et al. 2004) of (H, W, C) or (N, H, W, C)
    images → () or (N,)."""
    squeeze = pred.dim() == 3
    if squeeze:
        pred, target = pred[None], target[None]
    x = pred.float().permute(0, 3, 1, 2)
    y = target.float().permute(0, 3, 1, 2)
    k = _gaussian_kernel1d(kernel_size, sigma, x.device)
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    with _no_tf32():
        mu_x, mu_y = _filter2d_sep(x, k), _filter2d_sep(y, k)
        mu_xx, mu_yy = _filter2d_sep(x * x, k), _filter2d_sep(y * y, k)
        mu_xy = _filter2d_sep(x * y, k)
    var_x = mu_xx - mu_x * mu_x
    var_y = mu_yy - mu_y * mu_y
    cov = mu_xy - mu_x * mu_y
    s = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / (
        (mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2))
    out = s.mean(dim=(1, 2, 3))
    return out[0] if squeeze else out


# torchvision AlexNet ``features`` taps: each conv's output after its ReLU
_ALEX_CHANNELS = (64, 192, 384, 256, 256)
_ALEX_KERNELS = (11, 5, 3, 3, 3)
_ALEX_STRIDES = (4, 1, 1, 1, 1)
_ALEX_PADS = (2, 2, 1, 1, 1)
_ALEX_POOL_AFTER = (0, 1)  # 3x3 / 2 max-pool after taps 0 and 1
_ALEX_CONV_IDS = (0, 3, 6, 8, 10)  # their indices in alexnet().features
# lpips.LPIPS's ScalingLayer
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


class Lpips(torch.nn.Module):
    """AlexNet-backbone LPIPS distance: ``forward(x, y)`` with x, y (N, H, W,
    3) in [0, 1] → (N,). Scale to [-1, 1], ImageNet-normalise, unit-normalise
    each tap over channels, squared difference, the non-negative 1x1 linear
    head, spatial mean, sum over the 5 taps (the ``lpips`` package's
    ``LPIPS(net='alex')``). Weights are random until loaded."""

    def __init__(self):
        super().__init__()
        cins = (3,) + _ALEX_CHANNELS[:-1]
        self.convs = torch.nn.ModuleList(
            torch.nn.Conv2d(cin, cout, k, stride=s, padding=p)
            for cin, cout, k, s, p in zip(cins, _ALEX_CHANNELS, _ALEX_KERNELS, _ALEX_STRIDES,
                                          _ALEX_PADS))
        self.lins = torch.nn.ModuleList(torch.nn.Conv2d(c, 1, 1, bias=False)
                                        for c in _ALEX_CHANNELS)
        self.register_buffer("shift", torch.tensor(_LPIPS_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_LPIPS_SCALE).reshape(1, 3, 1, 1))

    def _features(self, x: torch.Tensor) -> list:
        x = (2.0 * x.permute(0, 3, 1, 2) - 1.0 - self.shift) / self.scale
        feats = []
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            feats.append(x)
            if i in _ALEX_POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with _no_tf32():
            fx, fy = self._features(x.float()), self._features(y.float())
            total = 0.0
            for a, b, lin in zip(fx, fy, self.lins):
                a = a / torch.sqrt((a ** 2).sum(dim=1, keepdim=True) + 1e-10)
                b = b / torch.sqrt((b ** 2).sum(dim=1, keepdim=True) + 1e-10)
                d = F.conv2d((a - b) ** 2, torch.clamp(lin.weight, min=0.0))
                total = total + d.mean(dim=(1, 2, 3))
        return total


def lpips_params_from_torch(alex_state: dict, lin_state: dict) -> dict:
    """:class:`Lpips`'s state dict from torchvision's ``alexnet().features``
    state dict (``{0,3,6,8,10}.weight/bias``) and the ``lpips`` package's
    linear heads (``lin{i}.model.1.weight``, (1, C_i, 1, 1))."""
    f32 = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.float32)
    out = {}
    for i, tid in enumerate(_ALEX_CONV_IDS):
        out[f"convs.{i}.weight"] = f32(alex_state[f"{tid}.weight"])
        out[f"convs.{i}.bias"] = f32(alex_state[f"{tid}.bias"])
        out[f"lins.{i}.weight"] = f32(lin_state[f"lin{i}.model.1.weight"])
    out["shift"] = torch.tensor(_LPIPS_SHIFT).reshape(1, 3, 1, 1)
    out["scale"] = torch.tensor(_LPIPS_SCALE).reshape(1, 3, 1, 1)
    return out


def _state_from_npz(path: str) -> dict:
    """The JAX package's flattened ``conv{i}/kernel`` (HWIO), ``conv{i}/bias``
    and ``lin{i}/kernel`` (1, 1, C, 1) arrays as :class:`Lpips`'s state."""
    flat = dict(np.load(path))
    alex, lin = {}, {}
    for i, tid in enumerate(_ALEX_CONV_IDS):
        alex[f"{tid}.weight"] = flat[f"conv{i}/kernel"].transpose(3, 2, 0, 1)
        alex[f"{tid}.bias"] = flat[f"conv{i}/bias"]
        lin[f"lin{i}.model.1.weight"] = flat[f"lin{i}/kernel"].transpose(3, 2, 0, 1)
    return lpips_params_from_torch(alex, lin)


def load_lpips(path: Optional[str] = None, device="cpu") -> Optional[Lpips]:
    """:class:`Lpips` with calibrated weights on ``device``, or None when no
    weights file exists. ``path``: an ``.npz`` in the JAX package's layout,
    or a torch file ``{"alex": features state, "lin": linear heads}``.
    Looked for when None: ``$LPIPS_WEIGHTS``, ``./weights/lpips_alex.npz``."""
    candidates = [path] if path else [os.environ.get("LPIPS_WEIGHTS", ""),
                                      os.path.join(os.getcwd(), "weights", "lpips_alex.npz")]
    for p in candidates:
        if not p or not os.path.exists(p):
            continue
        if p.endswith(".npz"):
            state = _state_from_npz(p)
        else:
            blob = torch.load(p, map_location="cpu", weights_only=True)
            state = lpips_params_from_torch(blob["alex"], blob["lin"])
        model = Lpips()
        model.load_state_dict(state)
        return model.eval().to(device)
    print("[metrics] LPIPS calibration weights not found: LPIPS disabled (PSNR / SSIM remain); "
          "set $LPIPS_WEIGHTS to enable")
    return None
