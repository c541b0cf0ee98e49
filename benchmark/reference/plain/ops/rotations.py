"""Rotation representation conversions in PyTorch.

Port of sings_tpu/ops/rotations.py (pytorch3d-style conventions):
quaternion (w, x, y, z scalar-first) <-> matrix <-> axis-angle <-> 6D.
Batched over leading dimensions; guarded at singularities like the JAX
version so values agree at identity rotations.
"""
from __future__ import annotations

import torch

from .clip import clip


def _norm(x: torch.Tensor) -> torch.Tensor:
    """|x| floored at 1e-12 with jnp.clip's gradient (half at the floor:
    the radial cotangent of x / |x| moves there)."""
    return clip(torch.linalg.norm(x, dim=-1, keepdim=True), lo=1e-12)


def _safe_sqrt(x, eps=1e-18):
    return torch.sqrt(torch.clamp_min(x, eps))


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) scalar-first quaternion -> (..., 3, 3) rotation matrix."""
    q = quat / _norm(quat)
    w, x, y, z = q.unbind(-1)
    m = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) scalar-first quaternion (largest-pivot
    candidate, branch-free)."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    q_abs = _safe_sqrt(
        torch.stack(
            [
                1.0 + m00 + m11 + m22,
                1.0 + m00 - m11 - m22,
                1.0 - m00 + m11 - m22,
                1.0 - m00 - m11 + m22,
            ],
            dim=-1,
        ).clamp_min(0.0)
    )
    quat_by_w = torch.stack(
        [q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    quat_by_x = torch.stack(
        [m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1)
    quat_by_y = torch.stack(
        [m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1)
    quat_by_z = torch.stack(
        [m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1)
    cand = torch.stack([quat_by_w, quat_by_x, quat_by_y, quat_by_z], dim=-2)
    cand = cand / (2.0 * q_abs[..., None].clamp_min(0.1))

    best = torch.argmax(q_abs, dim=-1)  # first maximum on ties, as jnp
    idx = best[..., None, None].expand(best.shape + (1, 4))
    quat = torch.gather(cand, -2, idx)[..., 0, :]
    return quat / _norm(quat)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3); first-order
    expansion below |v|^2 < 1e-16."""
    sq = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    small_v = sq < 1e-16
    sq_safe = torch.where(small_v, torch.ones_like(sq), sq)
    angle = torch.where(small_v, torch.zeros_like(sq), torch.sqrt(sq_safe))
    safe = angle.clamp_min(1e-12)
    axis = torch.where(small_v, torch.zeros_like(axis_angle),
                       axis_angle / safe)
    s = torch.sin(angle)[..., None]
    c = torch.cos(angle)[..., None]
    x, y, z = axis.unbind(-1)
    zeros = torch.zeros_like(x)
    K = torch.stack(
        [zeros, -z, y, z, zeros, -x, -y, x, zeros], dim=-1
    ).reshape(axis_angle.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=axis_angle.dtype,
                    device=axis_angle.device).expand(K.shape)
    R = eye + s * K + (1 - c) * (K @ K)
    ax, ay, az = axis_angle.unbind(-1)
    K_raw = torch.stack(
        [zeros, -az, ay, az, zeros, -ax, -ay, ax, zeros], dim=-1
    ).reshape(K.shape)
    return torch.where(small_v[..., None], eye + K_raw, R)


def quaternion_to_axis_angle(quat: torch.Tensor) -> torch.Tensor:
    q = quat / _norm(quat)
    q = torch.where(q[..., :1] < 0, -q, q)
    w = q[..., 0].clamp(-1.0, 1.0)
    xyz = q[..., 1:]
    sq = torch.sum(xyz * xyz, dim=-1, keepdim=True)
    small = sq < 1e-14
    norm = torch.where(small, torch.zeros_like(sq),
                       torch.sqrt(torch.where(small, torch.ones_like(sq), sq)))
    angle = 2.0 * torch.atan2(norm[..., 0], w)[..., None]
    scale = torch.where(small, 2.0 / w[..., None].clamp_min(0.5),
                        angle / torch.where(small, torch.ones_like(norm),
                                            norm))
    return xyz * scale


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """First two rows of the rotation matrix, flattened: (..., 6)."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt per Zhou et al. (..., 6) -> (..., 3, 3)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / _norm(a1)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / _norm(a2p)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def axis_angle_to_rotation_6d(axis_angle: torch.Tensor) -> torch.Tensor:
    return matrix_to_rotation_6d(axis_angle_to_matrix(axis_angle))


def rotation_6d_to_axis_angle(d6: torch.Tensor) -> torch.Tensor:
    return matrix_to_axis_angle(rotation_6d_to_matrix(d6))


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def standardize_quaternion(quat: torch.Tensor) -> torch.Tensor:
    """Canonical versor with nonnegative real part."""
    return torch.where(quat[..., :1] < 0, -quat, quat)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Composition of rotations, standardized (pytorch3d convention)."""
    return standardize_quaternion(quaternion_raw_multiply(a, b))
