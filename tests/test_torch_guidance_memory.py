"""The SDS encode's memory plan (``pipelines/guidance.py::encode_plan``):
its arithmetic on the host, and a mixed plan on a card filled up to the
plan's edge. Imports nothing of JAX, so it runs on a card's host too."""

import numpy as np
import pytest
import torch

from animate3d_tpu_torch.core.device import resolve_device
from animate3d_tpu_torch.models.vae import AutoencoderKL
from animate3d_tpu_torch.pipelines import guidance as TG

HEADROOM = TG.ENCODE_HEADROOM_BYTES


@pytest.mark.parametrize("n_chunks", [1, 3, 8])
def test_encode_plan_leaves_room_for_one_recompute(n_chunks):
    """Over capacities from two chunks short of the headroom to two chunks
    past all of them (refine's 6.40e9-byte chunks on 9.25e9 allocated): the
    kept chunks come first; all are kept only where all fit beside the
    headroom; a plan that recomputes any keeps no more than leaves room for
    one recompute beside the kept and the headroom, and no fewer."""
    cb, allocated = 6_400_057_344, 9_252_623_360
    seen = set()
    for extra in range(-2 * cb, (n_chunks + 2) * cb, cb // 7):
        capacity = allocated + HEADROOM + extra
        plan = TG.encode_plan(n_chunks, cb, (allocated, capacity))
        kept = sum(plan)
        seen.add(kept)
        assert plan == (True,) * kept + (False,) * (n_chunks - kept)
        if kept == n_chunks:
            assert allocated + n_chunks * cb + HEADROOM <= capacity
            continue
        assert allocated + n_chunks * cb + HEADROOM > capacity
        if kept:
            assert allocated + (kept + 1) * cb + HEADROOM <= capacity
        if kept + 1 < n_chunks:
            assert allocated + (kept + 2) * cb + HEADROOM > capacity
    assert seen == ({0, 1} if n_chunks == 1 else set(range(n_chunks - 1)) | {n_chunks})


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.cuda
def test_mixed_plan_fits_a_card_filled_to_its_edge(monkeypatch):
    """The SD1.5 VAE encoder (its widths, seeded weights, f32) on 12 renders
    at 512² in chunks of 4 (about 12.8e9 bytes of activations a chunk).
    The first call recomputes every chunk and learns a chunk's bytes. Then a
    filler tensor leaves the plan 2.1 chunks of room beside its headroom:
    the plan keeps one chunk and recomputes two, and the backward, which
    rebuilds a recomputed chunk while the kept one is still held, stays
    within the plan's count and the card. A plan that kept two would need
    0.9 of a chunk more than the card has. ∂/∂x equals the first call's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = resolve_device("cuda")
    plans = []
    plan = TG.encode_plan

    def recorded(n_chunks, chunk_bytes, memory):
        plans.append((memory, plan(n_chunks, chunk_bytes, memory)))
        return plans[-1][1]

    monkeypatch.setattr(TG, "encode_plan", recorded)
    torch.manual_seed(0)
    vae = AutoencoderKL().to(dev).requires_grad_(False)
    g = TG.AnimateMVGuidance(None, vae.encode, TG.GuidanceConfig(vae_encode_chunk=4), device=dev)
    x = torch.rand(12, 512, 512, 3, device=dev)
    w = torch.randn(12, 64, 64, 8, device=dev)

    def grad():
        xg = x.clone().requires_grad_(True)
        mean, logvar = g._chunked_vae_encode(xg)
        (torch.cat([mean, logvar], -1) * w).sum().backward()
        return xg.grad

    first = grad()
    (cb,) = g._chunk_bytes.values()
    torch.cuda.empty_cache()
    capacity = torch.cuda.get_device_properties(dev).total_memory
    fill = capacity - torch.cuda.memory_allocated(dev) - HEADROOM - int(2.1 * cb)
    filler = torch.empty(fill, dtype=torch.uint8, device=dev)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        mixed = grad()
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        free, total = torch.cuda.mem_get_info(dev)
        outside = total - free - torch.cuda.memory_reserved(dev)
    finally:
        del filler
    (_, learnt), ((allocated, _), kept) = plans
    print(f"chunk {cb} B, decision {allocated} B allocated, peak {peak} B "
          f"({peak - allocated} above it), outside the allocator {outside} B")
    assert learnt == (False,) * 3
    assert kept == (True, False, False)
    assert peak - allocated <= 2 * cb + HEADROOM
    assert _rel_l2(mixed.cpu().numpy(), first.cpu().numpy()) <= 1e-5
