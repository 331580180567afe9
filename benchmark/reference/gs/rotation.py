"""Quaternion / rotation-matrix utilities, torch and NumPy.

The port's own copy of ``animate3d_tpu/utils/rotation.py``: quaternions are
(w, x, y, z), ``matrix_to_quat`` is branchless (the four pivot candidates
chosen by ``torch.where``), Euler angles are XYZ-intrinsic (Rz Ry Rx).
"""

from __future__ import annotations

import torch


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion → (..., 3, 3) rotation matrix."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    r, x, y, z = q.unbind(-1)
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix → (..., 4) wxyz quaternion (largest pivot)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-12))

    t0 = safe_sqrt(tr + 1.0) * 2
    q0 = torch.stack([0.25 * t0, (m21 - m12) / t0, (m02 - m20) / t0, (m10 - m01) / t0], -1)
    t1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2
    q1 = torch.stack([(m21 - m12) / t1, 0.25 * t1, (m01 + m10) / t1, (m02 + m20) / t1], -1)
    t2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2
    q2 = torch.stack([(m02 - m20) / t2, (m01 + m10) / t2, 0.25 * t2, (m12 + m21) / t2], -1)
    t3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2
    q3 = torch.stack([(m10 - m01) / t3, (m02 + m20) / t3, (m12 + m21) / t3, 0.25 * t3], -1)

    cond1 = tr > 0
    big0 = (m00 > m11) & (m00 > m22)
    cond2 = ~cond1 & big0
    cond3 = ~cond1 & ~big0 & (m11 > m22)
    q = torch.where(cond3[..., None], q2, q3)
    q = torch.where(cond2[..., None], q1, q)
    q = torch.where(cond1[..., None], q0, q)
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)


def euler_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """XYZ-intrinsic Euler angles (3,) → (3, 3) = Rz @ Ry @ Rx."""
    rx, ry, rz = angles.unbind(-1)
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    return torch.stack([
        torch.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx], -1),
        torch.stack([sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx], -1),
        torch.stack([-sy, cy * sx, cy * cx], -1),
    ], dim=-2)
