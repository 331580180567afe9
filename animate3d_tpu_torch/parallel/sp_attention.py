"""Sequence-parallel ring attention over the mesh's ``sp`` group: the port of
``animate3d_tpu/parallel/sp_attention.py``.

Every rank keeps its slice of the queries and a running online-softmax state
(max m, sum l, accumulator acc); the K/V slices travel around the ring, one
hop a step (``dist.batch_isend_irecv`` to the next rank, from the previous),
so after ``sp`` steps every query block has seen every key block. The block
attend is plain torch (einsum and ``exp``, no SDPA): in the JAX package it is
an XLA einsum, not a Pallas kernel. The merge is the flash kernels' online
softmax, so the result is dense attention's up to the order of its sums.
Forward only: the ring serves sampling (``cli/inference.py --mesh_sp``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from animate3d_tpu_torch.parallel.mesh import Mesh, all_gather_rows, shard_rows


def _block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """One Q block x K/V block: (max m, exp-sum l, weighted acc) in f32 for
    the online-softmax merge. Shapes (B, H, Sq|Sk, D)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
    return m, l, acc


def _rotate(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` sent to the next rank of the sp ring; the previous rank's returned."""
    group, n, r = mesh.sp_group, mesh.sp, mesh.sp_rank
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, nxt, group),
                                   dist.P2POp(dist.irecv, out, prv, group)])
    for req in reqs:
        req.wait()
    return out


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   mesh: Mesh) -> torch.Tensor:
    """This rank's (B, H, S_local, D) slices of a sequence split over the sp
    group → its slice of the output."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("ring_attention is forward only (sampling)")
    b, h, s, d = q.shape
    m_run = torch.full((b, h, s, 1), -torch.inf, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, h, s, 1), dtype=torch.float32, device=q.device)
    acc_run = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for step in range(mesh.sp):
        m_blk, l_blk, acc_blk = _block_attend(q, k_cur, v_cur, scale)
        m_new = torch.maximum(m_run, m_blk)
        a_run, a_blk = torch.exp(m_run - m_new), torch.exp(m_blk - m_new)
        l_run = l_run * a_run + l_blk * a_blk
        acc_run = acc_run * a_run + acc_blk * a_blk
        m_run = m_new
        if step + 1 < mesh.sp:
            k_cur, v_cur = _rotate(k_cur, mesh), _rotate(v_cur, mesh)
    return (acc_run / torch.clamp(l_run, min=1e-30)).to(q.dtype)


def ring_attention_sharded(mesh: Mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """Merged heads: q / k / v are the global (B, S, H·D) tensors, equal on
    every rank of the sp group. Each rank attends with its slice of S,
    the output slices are gathered: → the global (B, S, H·D)."""
    b, s, c = q.shape
    d = c // num_heads
    if scale is None:
        scale = d ** -0.5
    rows = shard_rows(mesh, s, "sp")

    def local(x):
        return x[:, rows].reshape(b, -1, num_heads, d).transpose(1, 2)

    out = ring_attention(local(q), local(k), local(v), scale, mesh)  # (B, H, S/sp, D)
    out = out.permute(2, 0, 1, 3).contiguous()  # S leading for the gather
    out = all_gather_rows(mesh, out, "sp")  # (S, B, H, D)
    return out.permute(1, 0, 2, 3).reshape(b, s, c)
