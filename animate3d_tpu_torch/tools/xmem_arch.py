"""XMem architecture (Cheng & Schwing, ECCV 2022) in plain torch: a copy of
``animate3d_tpu/tools/xmem_arch.py`` (already torch there), whose inference
loop also takes the device to run on.

Architecture-complete reimplementation of the video-object-segmentation
tracker the reference vendors (tools/tracking_anything/tracker/model/
network.py:17-198, modules.py:22-250, cbam.py, group_modules.py,
memory_util.py, aggregate.py) so the released ``XMem-s012.pth`` checkpoint
drops straight in when an environment has it — state-dict key names match
the published checkpoint exactly (the keys XMem's own loader introspects:
``key_proj.key_proj.weight``, ``value_encoder.fuser.block2.conv2.weight``,
``decoder.hidden_update.transform.weight``).

A preprocessing tool of the mesh flow (the tracking CLI's ``xmem``
backend), run on the tracking device.  Multi-object layout: group tensors are
(batch, num_objects, C, H, W).

Defaults: key_dim 64, value_dim 512, hidden_dim 64, multi-object
(value_encoder.conv1 takes image+mask+others = 5 channels).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


# -- resnet backbones (torchvision-compatible naming) ------------------------


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = self.downsample(x) if self.downsample is not None else x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = self.downsample(x) if self.downsample is not None else x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


def _make_layer(block, inplanes, planes, blocks, stride=1):
    downsample = None
    if stride != 1 or inplanes != planes * block.expansion:
        downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * block.expansion, 1, stride=stride,
                      bias=False),
            nn.BatchNorm2d(planes * block.expansion))
    layers = [block(inplanes, planes, stride, downsample)]
    inplanes = planes * block.expansion
    for _ in range(1, blocks):
        layers.append(block(inplanes, planes))
    return nn.Sequential(*layers), inplanes


# -- group helpers (group = per-object channel stack) ------------------------


class GConv2D(nn.Conv2d):
    """Conv over (B, num_objects, C, H, W) by flattening the object axis."""

    def forward(self, g):
        b, num_objects = g.shape[:2]
        out = super().forward(g.flatten(0, 1))
        return out.view(b, num_objects, *out.shape[1:])


def _interp_groups(g, ratio, mode, align_corners=None):
    b, num_objects = g.shape[:2]
    out = F.interpolate(g.flatten(0, 1), scale_factor=ratio, mode=mode,
                        align_corners=align_corners)
    return out.view(b, num_objects, *out.shape[1:])


def upsample_groups(g, ratio=2):
    return _interp_groups(g, ratio, "bilinear", False)


def downsample_groups(g, ratio=0.5):
    return _interp_groups(g, ratio, "area")


class GroupResBlock(nn.Module):
    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.downsample = (None if in_dim == out_dim
                           else GConv2D(in_dim, out_dim, 3, padding=1))
        self.conv1 = GConv2D(in_dim, out_dim, 3, padding=1)
        self.conv2 = GConv2D(out_dim, out_dim, 3, padding=1)

    def forward(self, g):
        out = self.conv1(F.relu(g))
        out = self.conv2(F.relu(out))
        if self.downsample is not None:
            g = self.downsample(g)
        return out + g


def distribute(x, g, method="cat"):
    """Broadcast frame features x (B,C,H,W) onto the object groups of g."""
    num_objects = g.shape[1]
    xe = x.unsqueeze(1).expand(-1, num_objects, -1, -1, -1)
    return torch.cat([xe, g], 2) if method == "cat" else xe + g


# -- CBAM (attention inside the feature fusion block) ------------------------


class _ChannelGate(nn.Module):
    def __init__(self, channels, reduction=16):
        super().__init__()
        self.mlp = nn.Sequential(
            nn.Flatten(),
            nn.Linear(channels, channels // reduction),
            nn.ReLU(),
            nn.Linear(channels // reduction, channels))

    def forward(self, x):
        avg = F.avg_pool2d(x, x.shape[-2:])
        mx = F.max_pool2d(x, x.shape[-2:])
        att = self.mlp(avg) + self.mlp(mx)
        return x * torch.sigmoid(att)[:, :, None, None]


class _SpatialGate(nn.Module):
    def __init__(self):
        super().__init__()
        self.spatial = nn.Sequential()
        self.spatial.conv = nn.Conv2d(2, 1, 7, padding=3)

    def forward(self, x):
        pooled = torch.cat([x.max(1, keepdim=True).values,
                            x.mean(1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.spatial.conv(pooled))


class CBAM(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.ChannelGate = _ChannelGate(channels)
        self.SpatialGate = _SpatialGate()

    def forward(self, x):
        return self.SpatialGate(self.ChannelGate(x))


class FeatureFusionBlock(nn.Module):
    def __init__(self, x_in_dim, g_in_dim, g_mid_dim, g_out_dim):
        super().__init__()
        self.block1 = GroupResBlock(x_in_dim + g_in_dim, g_mid_dim)
        self.attention = CBAM(g_mid_dim)
        self.block2 = GroupResBlock(g_mid_dim, g_out_dim)

    def forward(self, x, g):
        b, num_objects = g.shape[:2]
        g = self.block1(distribute(x, g))
        r = self.attention(g.flatten(0, 1)).view_as(g)
        return self.block2(g + r)


# -- GRU-style hidden state updates ------------------------------------------


def _gru_update(values, h, hidden_dim):
    """XMem's GRU variant: new value generated before the forget gate
    (modules.py:64-72 — kept as-is for weight compatibility)."""
    forget = torch.sigmoid(values[:, :, :hidden_dim])
    update = torch.sigmoid(values[:, :, hidden_dim:hidden_dim * 2])
    new_value = torch.tanh(values[:, :, hidden_dim * 2:])
    return forget * h * (1 - update) + update * new_value


class HiddenReinforcer(nn.Module):
    def __init__(self, g_dim, hidden_dim):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.transform = GConv2D(g_dim + hidden_dim, hidden_dim * 3, 3,
                                 padding=1)

    def forward(self, g, h):
        return _gru_update(self.transform(torch.cat([g, h], 2)), h,
                           self.hidden_dim)


class HiddenUpdater(nn.Module):
    def __init__(self, g_dims, mid_dim, hidden_dim):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.g16_conv = GConv2D(g_dims[0], mid_dim, 1)
        self.g8_conv = GConv2D(g_dims[1], mid_dim, 1)
        self.g4_conv = GConv2D(g_dims[2], mid_dim, 1)
        self.transform = GConv2D(mid_dim + hidden_dim, hidden_dim * 3, 3,
                                 padding=1)

    def forward(self, g, h):
        g = (self.g16_conv(g[0])
             + self.g8_conv(downsample_groups(g[1], 0.5))
             + self.g4_conv(downsample_groups(g[2], 0.25)))
        return _gru_update(self.transform(torch.cat([g, h], 2)), h,
                           self.hidden_dim)


# -- encoders / projection / decoder -----------------------------------------


class KeyEncoder(nn.Module):
    """ResNet50 trunk to stride 16 (network keys: conv1/bn1/res2/layer2/
    layer3 — XMem names layer1 'res2')."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.res2, c = _make_layer(Bottleneck, 64, 64, 3)
        self.layer2, c = _make_layer(Bottleneck, c, 128, 4, stride=2)
        self.layer3, c = _make_layer(Bottleneck, c, 256, 6, stride=2)

    def forward(self, f):
        x = self.maxpool(self.relu(self.bn1(self.conv1(f))))
        f4 = self.res2(x)
        f8 = self.layer2(f4)
        f16 = self.layer3(f8)
        return f16, f8, f4


class KeyProjection(nn.Module):
    def __init__(self, in_dim, key_dim):
        super().__init__()
        self.key_proj = nn.Conv2d(in_dim, key_dim, 3, padding=1)
        self.d_proj = nn.Conv2d(in_dim, 1, 3, padding=1)  # shrinkage
        self.e_proj = nn.Conv2d(in_dim, key_dim, 3, padding=1)  # selection

    def forward(self, x, need_s=True, need_e=True):
        shrinkage = self.d_proj(x) ** 2 + 1 if need_s else None
        selection = torch.sigmoid(self.e_proj(x)) if need_e else None
        return self.key_proj(x), shrinkage, selection


class ValueEncoder(nn.Module):
    """ResNet18 trunk over image+mask+others, fused with key features."""

    def __init__(self, value_dim, hidden_dim, single_object=False):
        super().__init__()
        self.single_object = single_object
        extra = 1 if single_object else 2
        self.conv1 = nn.Conv2d(3 + extra, 64, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1, c = _make_layer(BasicBlock, 64, 64, 2)
        self.layer2, c = _make_layer(BasicBlock, c, 128, 2, stride=2)
        self.layer3, c = _make_layer(BasicBlock, c, 256, 2, stride=2)
        self.fuser = FeatureFusionBlock(1024, 256, value_dim, value_dim)
        self.hidden_reinforce = (HiddenReinforcer(value_dim, hidden_dim)
                                 if hidden_dim > 0 else None)

    def forward(self, image, image_feat_f16, h, masks, others,
                is_deep_update=True):
        if self.single_object:
            g = masks.unsqueeze(2)
        else:
            g = torch.stack([masks, others], 2)
        g = distribute(image, g)
        b, num_objects = g.shape[:2]
        g = g.flatten(0, 1)
        # conv1→bn1→maxpool→relu ordering preserved from the original
        g = self.relu(self.maxpool(self.bn1(self.conv1(g))))
        g = self.layer3(self.layer2(self.layer1(g)))
        g = g.view(b, num_objects, *g.shape[1:])
        g = self.fuser(image_feat_f16, g)
        if is_deep_update and self.hidden_reinforce is not None:
            h = self.hidden_reinforce(g, h)
        return g, h


class UpsampleBlock(nn.Module):
    def __init__(self, skip_dim, g_up_dim, g_out_dim):
        super().__init__()
        self.skip_conv = nn.Conv2d(skip_dim, g_up_dim, 3, padding=1)
        self.out_conv = GroupResBlock(g_up_dim, g_out_dim)

    def forward(self, skip_f, up_g):
        g = upsample_groups(up_g)
        g = distribute(self.skip_conv(skip_f), g, method="add")
        return self.out_conv(g)


class Decoder(nn.Module):
    def __init__(self, val_dim, hidden_dim):
        super().__init__()
        self.fuser = FeatureFusionBlock(1024, val_dim + hidden_dim, 512, 512)
        self.hidden_update = (HiddenUpdater([512, 256, 256 + 1], 256,
                                            hidden_dim)
                              if hidden_dim > 0 else None)
        self.up_16_8 = UpsampleBlock(512, 512, 256)
        self.up_8_4 = UpsampleBlock(256, 256, 256)
        self.pred = nn.Conv2d(256, 1, 3, padding=1)

    def forward(self, f16, f8, f4, hidden_state, memory_readout, h_out=True):
        b, num_objects = memory_readout.shape[:2]
        if self.hidden_update is not None:
            g16 = self.fuser(f16, torch.cat([memory_readout, hidden_state], 2))
        else:
            g16 = self.fuser(f16, memory_readout)
        g8 = self.up_16_8(f8, g16)
        g4 = self.up_8_4(f4, g8)
        logits = self.pred(F.relu(g4.flatten(0, 1)))
        if h_out and self.hidden_update is not None:
            g4 = torch.cat(
                [g4, logits.view(b, num_objects, 1, *logits.shape[-2:])], 2)
            hidden_state = self.hidden_update([g16, g8, g4], hidden_state)
        else:
            hidden_state = None
        logits = F.interpolate(logits, scale_factor=4, mode="bilinear",
                               align_corners=False)
        return hidden_state, logits.view(b, num_objects, *logits.shape[-2:])


# -- memory math -------------------------------------------------------------


def get_similarity(mk, ms, qk, qe):
    """Anisotropic L2 similarity with shrinkage/selection (memory_util.py)."""
    ck = mk.shape[1]
    mk = mk.flatten(2)
    ms = ms.flatten(1).unsqueeze(2) if ms is not None else None
    qk = qk.flatten(2)
    qe = qe.flatten(2) if qe is not None else None
    if qe is not None:
        mk_t = mk.transpose(1, 2)
        a_sq = mk_t.pow(2) @ qe
        two_ab = 2 * (mk_t @ (qk * qe))
        b_sq = (qe * qk.pow(2)).sum(1, keepdim=True)
        sim = -a_sq + two_ab - b_sq
    else:
        a_sq = mk.pow(2).sum(1).unsqueeze(2)
        sim = -a_sq + 2 * (mk.transpose(1, 2) @ qk)
    return sim * ms / math.sqrt(ck) if ms is not None else sim / math.sqrt(ck)


def do_softmax(sim, top_k: Optional[int] = None):
    if top_k is not None and top_k < sim.shape[1]:
        values, indices = torch.topk(sim, k=top_k, dim=1)
        x_exp = (values - values.max(dim=1, keepdim=True).values).exp()
        x_exp = x_exp / x_exp.sum(dim=1, keepdim=True)
        return torch.zeros_like(sim).scatter_(1, indices, x_exp)
    return torch.softmax(sim, dim=1)


def aggregate(prob, dim):
    """Soft aggregation (STM): background as product of (1−p)."""
    new_prob = torch.cat(
        [torch.prod(1 - prob, dim=dim, keepdim=True), prob],
        dim).clamp(1e-7, 1 - 1e-7)
    logits = torch.log(new_prob / (1 - new_prob))
    return logits, F.softmax(logits, dim=dim)


# -- top-level network + inference loop --------------------------------------


class XMemNet(nn.Module):
    def __init__(self, key_dim=64, value_dim=512, hidden_dim=64,
                 single_object=False):
        super().__init__()
        self.key_dim = key_dim
        self.value_dim = value_dim
        self.hidden_dim = hidden_dim
        self.key_encoder = KeyEncoder()
        self.value_encoder = ValueEncoder(value_dim, hidden_dim, single_object)
        self.key_proj = KeyProjection(1024, key_dim)
        self.decoder = Decoder(value_dim, hidden_dim)

    def encode_key(self, frame):
        f16, f8, f4 = self.key_encoder(frame)
        key, shrinkage, selection = self.key_proj(f16)
        return key, shrinkage, selection, f16, f8, f4

    def encode_value(self, frame, f16, h, masks, is_deep_update=True):
        others = torch.zeros_like(masks)  # single tracked object
        return self.value_encoder(frame, f16, h, masks, others, is_deep_update)

    def read_memory(self, qk, qe, mk, ms, mv, top_k=None):
        b, num_objects = mv.shape[:2]
        mv_flat = mv.flatten(1, 2)
        affinity = do_softmax(get_similarity(mk, ms, qk, qe), top_k)
        t = mk.shape[2]
        hq, wq = qk.shape[-2:]
        mem = mv_flat.flatten(2) @ affinity  # (B, no*CV, HWq)
        return mem.view(b, num_objects, self.value_dim, hq, wq)

    def segment(self, multi_scale_features, memory_readout, hidden_state,
                h_out=True):
        hidden_state, logits = self.decoder(*multi_scale_features,
                                            hidden_state, memory_readout,
                                            h_out=h_out)
        prob = torch.sigmoid(logits)
        logits, prob = aggregate(prob, dim=1)
        return hidden_state, logits, prob[:, 1:]


_IM_MEAN = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
_IM_STD = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)


def load_xmem(weights_path: str) -> XMemNet:
    """Build the net and strict-load an XMem checkpoint (dims are read from
    the weights exactly as XMem's loader does, network.py:142-152)."""
    sd = torch.load(weights_path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    key_dim = sd["key_proj.key_proj.weight"].shape[0]
    value_dim = sd["value_encoder.fuser.block2.conv2.weight"].shape[0]
    hidden_dim = (sd["decoder.hidden_update.transform.weight"].shape[0] // 3
                  if "decoder.hidden_update.transform.weight" in sd else 0)
    single_object = sd["value_encoder.conv1.weight"].shape[1] == 4
    net = XMemNet(key_dim, value_dim, hidden_dim, single_object)
    net.load_state_dict(sd)
    net.eval()
    return net


@torch.no_grad()
def xmem_segment_video(frames, template_mask, net: XMemNet,
                       mem_every: int = 5, max_memory: int = 8,
                       top_k: int = 30, device="cpu"):
    """(F, H, W, 3) float [0,1] + (H, W) template → (F, H, W) float masks.

    Inference loop following tracker/inference/inference_core.py semantics:
    frame 0 + template seed the permanent memory; masks propagate via the
    key/value memory readout; every ``mem_every`` frames the predicted mask
    is encoded into working memory (FIFO beyond ``max_memory``). ``net``
    runs where its parameters are; the frames go to ``device``."""
    import numpy as np

    f, h0, w0 = frames.shape[:3]
    # pad to a multiple of 16 for the stride-16 trunk
    ph, pw = (-h0) % 16, (-w0) % 16
    ims = torch.from_numpy(np.ascontiguousarray(
        frames.transpose(0, 3, 1, 2))).float()
    ims = ((ims - _IM_MEAN) / _IM_STD).to(device)
    ims = F.pad(ims, (0, pw, 0, ph))
    tmpl = torch.from_numpy(np.ascontiguousarray(template_mask)).float().to(device)
    tmpl = F.pad(tmpl[None, None], (0, pw, 0, ph))  # (1, 1, H, W)

    mk: List[torch.Tensor] = []
    ms: List[torch.Tensor] = []
    mv: List[torch.Tensor] = []
    hidden = None
    out_masks = []
    for i in range(f):
        frame = ims[i:i + 1]
        key, shrink, sel, f16, f8, f4 = net.encode_key(frame)
        if i == 0:
            hidden = torch.zeros(
                1, 1, net.hidden_dim, *key.shape[-2:], device=key.device)
            v16, hidden = net.encode_value(frame, f16, hidden, tmpl)
            mk, ms, mv = [key], [shrink], [v16]
            out_masks.append(template_mask.astype("float32"))
            continue
        mem = net.read_memory(
            key, sel,
            torch.stack(mk, 2), torch.stack(ms, 2), torch.stack(mv, 3),
            top_k=top_k)
        hidden, logits, prob = net.segment((f16, f8, f4), mem, hidden)
        mask = prob  # (1, 1, H, W): the single tracked object
        out_masks.append(
            (mask[0, 0, :h0, :w0] > 0.5).float().cpu().numpy())
        if i % mem_every == 0:
            v16, hidden = net.encode_value(frame, f16, hidden, mask)
            if len(mk) >= max_memory:
                # keep the permanent template entry, drop the oldest working
                mk.pop(1), ms.pop(1), mv.pop(1)
            mk.append(key), ms.append(shrink), mv.append(v16)
    return np.stack(out_masks)
