"""Foreground segmentation of the generated multi-view video (the port of
``animate3d_tpu/tools/tracking.py``).

    python -m animate3d_tpu_torch.tools.tracking --frames_dir frames/ \\
        --template_dir <static trial>/save/images --output_dir tracked/ [--device cpu]

Each view's track is seeded with the alpha of its static render (the
template) and carried through the generated frames; the frames are written
back as RGBA with the same numbering. Backends (``segment_video``):

  * ``"propagation"`` (default): a weights-free memory tracker — a bank of
    (appearance features, mask) pairs (the template's permanently, recent
    frames in a small working memory), a space-local affinity readout per
    frame, a colour-model vote on the uncertain band, then morphological
    closing, hole filling and the drop of components with no support in the
    previous mask. Features and readout run in torch on ``device`` (CUDA
    unless asked for the CPU); the binary morphology stays on the host
    (``scipy.ndimage``), as in the JAX module;
  * ``"chroma"``: background-distance thresholding, valid only for the
    near-white backgrounds of default renders (host NumPy);
  * ``"xmem"``: the learned XMem tracker (``tools/xmem_arch.py``) on
    ``device``, from the checkpoint given by ``weights=`` or
    ``$XMEM_WEIGHTS`` (none is in the repository); without one it raises.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

_BACKENDS: Dict[str, Callable] = {}


def register_backend(name: str):
    def deco(fn):
        _BACKENDS[name] = fn
        return fn

    return deco


def _keep_supported(binary: np.ndarray, prev: np.ndarray) -> np.ndarray:
    """The components of ``binary`` that touch ``prev`` or are larger than
    a quarter of it."""
    from scipy import ndimage

    labels, n = ndimage.label(binary)
    keep = np.zeros_like(binary)
    for comp in range(1, n + 1):
        comp_mask = labels == comp
        if (comp_mask & prev).sum() > 0 or comp_mask.sum() > 0.25 * prev.sum():
            keep |= comp_mask
    return keep


@register_backend("chroma")
def _chroma_backend(frames: np.ndarray, template_mask: np.ndarray,
                    bg_color=(1.0, 1.0, 1.0), threshold: float = 0.12, **_) -> np.ndarray:
    """(F, H, W, 3) in [0, 1] + (H, W) template → (F, H, W) float masks."""
    from scipy import ndimage

    bg = np.asarray(bg_color, np.float32)
    masks = []
    prev = template_mask > 0.5
    for f in frames:
        keep = _keep_supported(np.linalg.norm(f - bg, axis=-1) > threshold, prev)
        keep = ndimage.binary_closing(keep, iterations=2)
        keep = ndimage.binary_fill_holes(keep)
        masks.append(keep.astype(np.float32))
        prev = keep
    return np.stack(masks)


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of a length-``n`` axis padded by ``r`` on each side in
    ``scipy.ndimage``'s "reflect" mode (d c b a | a b c d | d c b a)."""
    idx = torch.arange(-r, n + r, device=device)
    idx = torch.where(idx < 0, -idx - 1, idx)
    return torch.where(idx >= n, 2 * n - idx - 1, idx)


def _correlate1d(x: torch.Tensor, weights, dim: int) -> torch.Tensor:
    """``scipy.ndimage.correlate1d`` with mode "reflect" along ``dim``."""
    r = (len(weights) - 1) // 2
    n = x.shape[dim]
    xp = x.index_select(dim, _reflect_index(n, r, x.device))
    out = torch.zeros_like(x)
    for k, w in enumerate(weights):
        if w != 0.0:
            out = out + float(w) * xp.narrow(dim, k, n)
    return out


def _gaussian_weights(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    return phi / phi.sum()


def _propagation_features(img: torch.Tensor, sigma: float = 1.5) -> torch.Tensor:
    """(..., H, W, 3) → (..., H, W, 9) appearance descriptor: colour, the
    colour blurred (``gaussian_filter`` with sigma (sigma, sigma, 0)) and
    the per-channel gradient magnitude of the blur (``sobel`` along y and x,
    each smoothing [1, 2, 1] over the other axes, the channel axis
    included, as ``scipy.ndimage.sobel`` does on an (H, W, 3) array)."""
    h_dim, w_dim, c_dim = img.dim() - 3, img.dim() - 2, img.dim() - 1
    g = _gaussian_weights(sigma)
    blur = _correlate1d(_correlate1d(img, g, h_dim), g, w_dim)

    def sobel(axis):
        out = _correlate1d(blur, (-1.0, 0.0, 1.0), axis)
        for other in (h_dim, w_dim, c_dim):
            if other != axis:
                out = _correlate1d(out, (1.0, 2.0, 1.0), other)
        return out

    gx, gy = sobel(w_dim), sobel(h_dim)
    return torch.cat([img, blur, torch.sqrt(gx * gx + gy * gy)], dim=-1)


def _window_readout(fq: torch.Tensor, memory, window: int, tau: float) -> torch.Tensor:
    """Space-local memory attention: each query pixel soft-attends to the
    memory pixels within a (2w+1)² window (rolled-in borders excluded).
    Returns the propagated soft mask (H, W)."""
    h, w_ = fq.shape[:2]
    num = torch.zeros((h, w_), device=fq.device)
    den = torch.zeros((h, w_), device=fq.device)
    offsets = [(dy, dx) for dy in range(-window, window + 1)
               for dx in range(-window, window + 1)]
    for fm, mm in memory:
        for dy, dx in offsets:
            fs = torch.roll(fm, (dy, dx), dims=(0, 1))
            ms = torch.roll(mm, (dy, dx), dims=(0, 1))
            aff = torch.exp(-torch.mean((fq - fs) ** 2, dim=-1) / tau)
            if dy > 0:
                aff[:dy] = 0
            elif dy < 0:
                aff[dy:] = 0
            if dx > 0:
                aff[:, :dx] = 0
            elif dx < 0:
                aff[:, dx:] = 0
            num += aff * ms
            den += aff
    return num / (den + 1e-8)


@register_backend("propagation")
def _propagation_backend(frames: np.ndarray, template_mask: np.ndarray, window: int = 4,
                         tau: float = 0.02, memory_every: int = 4, max_memory: int = 4,
                         device=None) -> np.ndarray:
    """XMem-style memory propagation, weights-free: the template is a
    permanent memory entry, every ``memory_every``-th frame joins a working
    memory of ``max_memory``, and the previous frame is always read."""
    from scipy import ndimage

    from animate3d_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    frames_t = torch.as_tensor(np.asarray(frames, np.float32), device=dev)
    feats = _propagation_features(frames_t)
    template = torch.as_tensor((template_mask > 0.5).astype(np.float32), device=dev)
    anchor = (feats[0], template)
    working, masks = [], []
    prev = template_mask > 0.5
    last = anchor
    for i in range(frames_t.shape[0]):
        frame, fq = frames_t[i], feats[i]
        memory = [anchor] + working[-max_memory:] + ([last] if i else [])
        soft = _window_readout(fq, memory, window, tau)
        fg, bg = soft > 0.7, soft < 0.3
        if int(fg.sum()) > 64 and int(bg.sum()) > 64:
            d_fg = torch.linalg.vector_norm(frame - frame[fg].mean(dim=0), dim=-1)
            d_bg = torch.linalg.vector_norm(frame - frame[bg].mean(dim=0), dim=-1)
            vote = (d_bg > d_fg).float()
            soft = torch.where(~fg & ~bg, 0.5 * soft + 0.5 * vote, soft)
        binary = ndimage.binary_closing((soft > 0.5).cpu().numpy(), iterations=2)
        binary = ndimage.binary_fill_holes(binary)
        keep = _keep_supported(binary, prev)
        masks.append(keep.astype(np.float32))
        prev = keep
        last = (fq, torch.as_tensor(masks[-1], device=dev))
        if i and i % memory_every == 0:
            working.append(last)
    return np.stack(masks)


@register_backend("xmem")
def _xmem_backend(frames: np.ndarray, template_mask: np.ndarray,
                  weights: Optional[str] = None, device=None, **kw) -> np.ndarray:
    """The learned XMem tracker (``tools/xmem_arch.py``, state-dict
    compatible with the released ``XMem-s012.pth``) on ``device``. The
    checkpoint comes from ``weights=`` or ``$XMEM_WEIGHTS``; without one
    this backend raises rather than track with random weights."""
    from animate3d_tpu_torch.core.device import resolve_device
    from animate3d_tpu_torch.tools.xmem_arch import load_xmem, xmem_segment_video

    path = weights or os.environ.get("XMEM_WEIGHTS", "")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "xmem backend needs a checkpoint: pass weights= or set $XMEM_WEIGHTS to "
            "XMem-s012.pth (without one, use backend='propagation')")
    dev = resolve_device(device)
    net = load_xmem(path).to(dev)
    return xmem_segment_video(frames, (template_mask > 0.5).astype(np.float32), net,
                              device=dev, **kw)


def segment_video(frames: np.ndarray, template_mask: np.ndarray,
                  backend: str = "propagation", **kw) -> np.ndarray:
    """(F, H, W, 3) frames in [0, 1] and an (H, W) template alpha → (F, H, W)
    float masks in {0, 1}."""
    if backend not in _BACKENDS:
        raise KeyError(f"Unknown segmentation backend {backend!r}; "
                       f"available: {sorted(_BACKENDS)}")
    return _BACKENDS[backend](frames, template_mask, **kw)


def run(frames_dir: str, template_dir: str, output_dir: str, n_views: int = 4,
        backend: str = "propagation", device=None) -> None:
    """``frames_dir``: the split GIF (``{view·F + frame}.png``);
    ``template_dir``: the static four-view RGBA renders (``{view}.png``),
    whose alpha is resized to the frame size where it differs. Writes RGBA
    frames to ``output_dir`` with the same numbering."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    names = sorted((n for n in os.listdir(frames_dir) if n.endswith(".png")),
                   key=lambda x: int(x[:-4]))
    n_frames = len(names) // n_views
    for view in range(n_views):
        with Image.open(os.path.join(template_dir, f"{view}.png")) as im:
            tmpl = np.asarray(im.convert("RGBA"), np.float32) / 255.0
        frames = []
        for fi in range(n_frames):
            with Image.open(os.path.join(frames_dir, names[view * n_frames + fi])) as im:
                frames.append(np.asarray(im.convert("RGB"), np.float32) / 255.0)
        frames = np.stack(frames)
        if tmpl.shape[:2] != frames.shape[1:3]:
            tm = Image.fromarray((tmpl[..., 3] * 255).astype(np.uint8)).resize(
                (frames.shape[2], frames.shape[1]))
            template_mask = np.asarray(tm, np.float32) / 255.0
        else:
            template_mask = tmpl[..., 3]
        kw = {"device": device} if backend in ("propagation", "xmem") else {}
        masks = segment_video(frames, template_mask, backend=backend, **kw)
        for fi in range(n_frames):
            rgba = np.concatenate([(frames[fi] * 255).astype(np.uint8),
                                   (masks[fi] * 255).astype(np.uint8)[..., None]], axis=-1)
            Image.fromarray(rgba, "RGBA").save(
                os.path.join(output_dir, names[view * n_frames + fi]))
    print(f"segmented {n_views * n_frames} frames → {output_dir}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames_dir", required=True)
    parser.add_argument("--template_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--n_views", type=int, default=4)
    parser.add_argument("--backend", default="propagation")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu, for the propagation and xmem backends")
    args = parser.parse_args(argv)
    run(args.frames_dir, args.template_dir, args.output_dir, args.n_views, args.backend,
        args.device)


if __name__ == "__main__":
    main()
