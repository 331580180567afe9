"""CLIP text and vision towers: the port of ``animate3d_tpu/models/clip.py``.

  * :class:`CLIPTextModel`: the SD1.5 text tower (vocab 49408, width 768, 12
    layers, quick-gelu, causal mask of -1e9), returning the last hidden
    state after ``final_layer_norm`` (what SD conditions on), not a pooled
    output;
  * :class:`CLIPVisionModelWithProjection`: the IP-Adapter image encoder
    (OpenCLIP ViT-H/14, width 1280, 32 layers, exact-erf gelu, projection
    1024), returning the projected class token.

The parameter names are the transformers key names (``text_model.encoder.
layers.0.self_attn.q_proj.weight``, ``vision_model.pre_layrnorm.weight``,
the misspelling included), so a released ``text_encoder`` /
``image_encoder`` state dict loads with ``load_state_dict``. The attention
is plain torch (S 77 and S 257 take no kernel in either package): f32
logits, an f32 softmax, probabilities cast back to the input dtype.

:func:`resize_bilinear` is ``jax.image.resize(..., "bilinear")``: a
separable triangle-kernel resample whose kernel widens by the scale when it
downsamples (antialiasing), as the JAX package resizes renders to the
vision tower's 224² before :func:`encode_ip_adapter_images`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from animate3d_tpu_torch.utils import trace


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"

    @staticmethod
    def tiny(**kw) -> "CLIPTextConfig":
        d = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                 intermediate_size=64, max_position_embeddings=16)
        d.update(kw)
        return CLIPTextConfig(**d)


@dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    intermediate_size: int = 5120
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"

    @staticmethod
    def tiny(**kw) -> "CLIPVisionConfig":
        d = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                 image_size=28, patch_size=14, projection_dim=16)
        d.update(kw)
        return CLIPVisionConfig(**d)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return nn.functional.gelu(x)  # transformers "gelu": the exact erf form


class CLIPAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(hidden_size, hidden_size)
        self.k_proj = nn.Linear(hidden_size, hidden_size)
        self.v_proj = nn.Linear(hidden_size, hidden_size)
        self.out_proj = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        b, s, c = x.shape
        h = self.num_heads
        d = c // h
        split = lambda t: t.reshape(b, s, h, d).transpose(1, 2)
        q = split(self.q_proj(x) * d ** -0.5)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
        if mask is not None:
            logits = logits + mask
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, c))


class CLIPMLP(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int, act: str):
        super().__init__()
        self.act = act
        self.fc1 = nn.Linear(hidden_size, intermediate_size)
        self.fc2 = nn.Linear(intermediate_size, hidden_size)

    def forward(self, x):
        return self.fc2(_act(self.act, self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 hidden_act: str, eps: float):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(hidden_size, eps=eps)
        self.self_attn = CLIPAttention(hidden_size, num_heads)
        self.layer_norm2 = nn.LayerNorm(hidden_size, eps=eps)
        self.mlp = CLIPMLP(hidden_size, intermediate_size, hidden_act)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
                             cfg.hidden_act, cfg.layer_norm_eps)
            for _ in range(cfg.num_layers))

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)

    @trace.spanned("clip.text_tower")
    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, S) token ids → (B, S, hidden) last hidden state."""
        tm = self.text_model
        s = input_ids.shape[1]
        x = tm.embeddings.token_embedding(input_ids) + \
            tm.embeddings.position_embedding.weight[None, :s]
        causal = torch.triu(torch.full((s, s), -1e9, device=x.device), diagonal=1)[None, None]
        return tm.final_layer_norm(tm.encoder(x, causal))


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(
            (cfg.image_size // cfg.patch_size) ** 2 + 1, cfg.hidden_size)


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPVisionModelWithProjection(nn.Module):
    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.config = config
        self.vision_model = _VisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim,
                                           bias=False)

    @trace.spanned("clip.vision_tower")
    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalised images → (B, projection_dim) image embeds."""
        vm = self.vision_model
        emb = vm.embeddings
        patches = emb.patch_embedding(pixel_values.permute(0, 3, 1, 2).to(
            emb.patch_embedding.weight.dtype)).flatten(2).transpose(1, 2)
        b = patches.shape[0]
        x = torch.cat([emb.class_embedding.expand(b, 1, -1).to(patches.dtype), patches], 1)
        x = x + emb.position_embedding.weight[None, :x.shape[1]]
        x = vm.encoder(vm.pre_layrnorm(x))
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_clip_image(images_uint8: torch.Tensor) -> torch.Tensor:
    """(B, 224, 224, 3) uint8 → normalised float (the resize is the caller's)."""
    x = images_uint8.float() / 255.0
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)
    return (x - mean) / std


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image``'s triangle kernel, antialiased:
    sample ``(i + 0.5) / scale - 0.5``, kernel width ``max(1 / scale, 1)``,
    columns normalised to sum 1, samples outside the input zeroed; in f32."""
    f32 = dict(dtype=torch.float32, device=device)
    inv_scale = 1.0 / torch.tensor(n_out / n_in, **f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(n_out, **f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, **f32)[:, None]) / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bilinear(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H, W, C) → (B, height, width, C) as ``jax.image.resize(images,
    (B, height, width, C), "bilinear")`` (antialiased when downsampling)."""
    wh = _resize_weights(images.shape[1], height, images.device).to(images.dtype)
    ww = _resize_weights(images.shape[2], width, images.device).to(images.dtype)
    return torch.einsum("bhwc,hy,wx->byxc", images, wh, ww)


def encode_ip_adapter_images(vision_model: CLIPVisionModelWithProjection,
                             images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] → (B, projection_dim) IP-Adapter image
    embeds: :func:`resize_bilinear` to the encoder's size, CLIP
    normalisation, the vision forward."""
    s = vision_model.config.image_size
    if images.shape[1] != s or images.shape[2] != s:
        images = resize_bilinear(images, s, s)
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=images.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=images.device)
    return vision_model((images - mean) / std)
