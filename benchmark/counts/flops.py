"""Analytic float32 operations of a training step and of an animation
frame at the cell's shapes, forward and backward counted once each, no
recomputation (the chunk statistic's second decode is not counted).

Per live gaussian, forward:
  decoders     2 * fan_in * fan_out per layer (a multiply and an add);
  triplane     per plane, bilinear over C channels: 4 corners * C * 2;
               per scale, the Hadamard product of its 3 planes: 2 * C;
  LBS          the blended transform, J joints * 12 entries * 2; the
               point through it, 3 * 3 * 2 + 3; the canonical rotation
               turned with it, 3 * 3 * 3 * 2;
  preprocess   PREPROCESS_OPS: rotation from the quaternion (30), the 3D
               covariance (9 + 54), the view transform of mean and
               covariance (18 + 108), the Jacobian (10), the 2D
               covariance (72), the conic (10), the radius (10), the
               degree-0 colour (6), the depth and cull tests (3);
  regularizers REG_OPS: the laplacian over 8 neighbours of 3 position
               and 3 colour values (8 * 6 * 2), the l2 terms (10), the
               KNN edge term (4);
  and per mesh edge, the mesh-edge term: 8.
A backward costs twice its forward (the input and the weight
gradients), except the triplane's: per plane, the grid gradients
(4 * C * 2), the coordinate gradients (2 coordinates * 4 corners * C *
2) and the product rule (2 * C).
Per photometric channel-pixel of the patches, forward: L1 (3), SSIM's
five maps through the separable 11-tap window (5 * 2 * 11 * 2) and its
formula (20), the gradient pyramid (13); backward twice that. Per pixel
of the frame: the background blend (3 * 2) and the silhouette term (4).
The exact KNN statistic: N_live^2 distances of 8 operations a chunk
(|q|^2 + |p|^2 - 2 q.p: the dot product 5, the rest 3), a K-th of it a
step. Adam: 14 per parameter (first moment 3, second 4, the corrected
direction 4, the learning rate and the add 2, the finite guard 1).
The composite kernels: counts/composite.py's operations at the counted
launch. An animation frame: its share of the pass's one decode, LBS,
preprocess, the composite forward, and the blend and the uint8
conversion (3 * 2 + 3 * 3 per pixel).
"""
from __future__ import annotations

PREPROCESS_OPS = 330
REG_OPS = 8 * 6 * 2 + 10 + 4
MESH_EDGE_OPS = 8
PHOTO_OPS = 3 + 5 * 2 * 11 * 2 + 20 + 13
ADAM_OPS = 14
KNN_OPS = 8


def decoder_fwd(layers: dict) -> int:
    """Per point: layers maps a name to (fan_in, fan_out)."""
    return sum(2 * fi * fo for fi, fo in layers.values())


def triplane_fwd(c: int, scales: int) -> int:
    return scales * (3 * 4 * c * 2 + 2 * c)


def triplane_bwd(c: int, scales: int) -> int:
    return scales * 3 * (4 * c * 2 + 2 * 4 * c * 2 + 2 * c)


def lbs_fwd(joints: int) -> int:
    return joints * 12 * 2 + 3 * 3 * 2 + 3 + 3 * 3 * 3 * 2


def train_step(s: dict) -> float:
    """s: n_live, n_edges, geo, app (decoder layers), c, scales, joints,
    patches, patch, height, width, params (parameter count), k (steps a
    chunk), composite_fwd_ops, composite_bwd_ops."""
    n = s["n_live"]
    dec = decoder_fwd(s["geo"]) + decoder_fwd(s["app"])
    per_point = (3 * (dec + lbs_fwd(s["joints"]) + PREPROCESS_OPS
                      + REG_OPS)
                 + triplane_fwd(s["c"], s["scales"])
                 + triplane_bwd(s["c"], s["scales"]))
    photo = 3 * PHOTO_OPS * s["patches"] * s["patch"] ** 2 * 3
    frame = 3 * (3 * 2 + 4) * s["height"] * s["width"]
    return (n * per_point + 3 * MESH_EDGE_OPS * s["n_edges"] + photo + frame
            + KNN_OPS * n * n / s["k"] + ADAM_OPS * s["params"]
            + s["composite_fwd_ops"] + s["composite_bwd_ops"])


def anim_frame(s: dict) -> float:
    """s: n_live, geo, app, c, scales, joints, frames_per_decode, height,
    width, composite_fwd_ops."""
    n = s["n_live"]
    decode = n * (decoder_fwd(s["geo"]) + decoder_fwd(s["app"])
                  + triplane_fwd(s["c"], s["scales"]))
    return (decode / s["frames_per_decode"]
            + n * (lbs_fwd(s["joints"]) + PREPROCESS_OPS)
            + (3 * 2 + 3 * 3) * s["height"] * s["width"]
            + s["composite_fwd_ops"])
