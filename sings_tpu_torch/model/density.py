"""Density control: hybrid mesh subdivision densify + edge-collapse prune,
and the vanilla 3DGS clone / split / prune (port of
sings_tpu/model/density.py).

Host-side numpy, as in the JAX package, which rewrote the reference's
topology mutation (sings_hybrid.py:1022-1150 densify_and_subdivide,
:1153-1257 prune_and_simplify). The capacity never changes:

  * prune marks slots dead in the `alive` mask (no compaction: slot
    identity is stable, so the optimizer moments of survivors are
    untouched by construction);
  * densify writes new vertices into free slots;
  * the caller zeroes Adam moments only for changed slots
    (train/optim.zero_moments_for_slots).

The edge collapse is the native library of mesh/native.py when it
builds, else mesh/ops.collapse_edges. densify_and_prune_vanilla is
point-based (its new gaussians are not mesh vertices) and draws its
split samples from a numpy RandomState as the JAX package does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..mesh.native import collapse_edges_fast as collapse_edges
from ..mesh.ops import subdivide, unique_edges, vertex_normals

HAND_LABELS = (6, 7)


class DensityResult(NamedTuple):
    changed: bool
    new_xyz: np.ndarray | None        # (C, 3) updated anchor positions
    alive: np.ndarray                 # (C,)
    scaling_multiplier: np.ndarray    # (C, 1)
    lbs_weights: np.ndarray           # (C, J)
    vertex_label: np.ndarray          # (C,)
    anchor_normals: np.ndarray        # (C, 3)
    faces: np.ndarray                 # (Fc, 3)
    face_valid: np.ndarray
    edges: np.ndarray                 # (Ec, 2)
    edge_valid: np.ndarray
    changed_slots: np.ndarray         # (C,) float 1 where moments reset
    num_alive: int


def _live_mesh(buffers_np: dict):
    faces = buffers_np["faces"][buffers_np["face_valid"] > 0.5]
    return faces


def _pack_topology(faces: np.ndarray, face_capacity: int,
                   edge_capacity: int):
    edges = unique_edges(faces)
    if len(faces) > face_capacity or len(edges) > edge_capacity:
        raise CapacityExceeded(len(faces), len(edges))
    f = np.zeros((face_capacity, 3), np.int32)
    f[: len(faces)] = faces
    fv = np.zeros(face_capacity, np.float32)
    fv[: len(faces)] = 1.0
    e = np.zeros((edge_capacity, 2), np.int32)
    e[: len(edges)] = edges
    ev = np.zeros(edge_capacity, np.float32)
    ev[: len(edges)] = 1.0
    return f, fv, e, ev


class CapacityExceeded(Exception):
    def __init__(self, n_faces, n_edges):
        super().__init__(f"faces={n_faces} edges={n_edges}")
        self.n_faces = n_faces
        self.n_edges = n_edges


def densify_and_subdivide(
    buffers_np: dict,
    xyz: np.ndarray,              # (C, 3) current anchor params
    fwd: dict,                    # numpy fwd outputs: xyz_canon, scales_canon, shs, opacity
    *,
    grad_threshold: float = 0.001,
    scale_threshold: float = 0.01,
    max_screen_size: float | None = 20.0,
    max_n_gs: int = 200_000,
    face_capacity: int,
    edge_capacity: int,
) -> DensityResult:
    """Subdivide faces around high-gradient / large gaussians."""
    alive = buffers_np["alive"] > 0.5
    c = alive.shape[0]
    n_alive = int(alive.sum())

    grads = buffers_np["xyz_grad_accum"] / np.maximum(
        buffers_np["grad_denom"], 1e-12)
    grads = np.nan_to_num(grads)
    scales = fwd["scales_canon"][:, 0]

    sel = (grads > grad_threshold) & (scales > scale_threshold)
    if max_screen_size:
        sel |= buffers_np["max_radii2d"] > max_screen_size
    sel &= ~np.isin(buffers_np["vertex_label"], HAND_LABELS)
    sel &= alive

    faces = _live_mesh(buffers_np)
    sel_idx = np.where(sel)[0]
    face_sel = np.isin(faces, sel_idx).any(axis=1)
    sel_face_idx = np.where(face_sel)[0]

    # cap new vertex count (unique midpoint edges) to both the reference
    # max_n_gs budget and our free-slot budget
    e = np.sort(faces[sel_face_idx][:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), 1)
    num_to_add = len(np.unique(e, axis=0)) if len(e) else 0
    num_left = min(max_n_gs - n_alive, c - n_alive)
    if num_left <= 0 or num_to_add == 0:
        return _unchanged(buffers_np, c, n_alive)
    if num_to_add >= num_left:
        face_scores = scales[faces[sel_face_idx]].sum(axis=1)
        order = np.argsort(-face_scores)
        sel_face_idx = sel_face_idx[order[: max(num_left // 3, 0)]]
        if len(sel_face_idx) == 0:
            return _unchanged(buffers_np, c, n_alive)

    # subdivision operates on a compacted live mesh; map live->slot
    live_ids = np.where(alive)[0]
    slot_of_live = live_ids
    live_index = np.full(c, -1, np.int64)
    live_index[live_ids] = np.arange(n_alive)
    faces_l = live_index[faces]

    xyz_canon_l = fwd["xyz_canon"][live_ids]
    mean_scales = scales[live_ids].mean()
    attrs = {
        "vertex_label": buffers_np["vertex_label"][live_ids],
        "lbs_weights": buffers_np["lbs_weights"][live_ids],
        "scales": np.clip(fwd["scales_canon"][live_ids].mean(-1), None,
                          0.008),
        "shs": fwd["shs"][live_ids].reshape(n_alive, -1),
    }
    new_v, new_f, new_attrs = subdivide(xyz_canon_l, faces_l, sel_face_idx,
                                        attrs)
    num_new = len(new_v) - n_alive
    free = np.where(~alive)[0]
    num_new = min(num_new, len(free))
    new_slots = free[:num_new]

    # slot mapping for faces: live index -> slot id; faces touching
    # midpoints that no longer fit in free slots are dropped
    slot_map = np.concatenate([slot_of_live, new_slots])
    new_f = new_f[(new_f < n_alive + num_new).all(axis=1)]
    faces_slots = slot_map[new_f]

    # write back
    out_alive = buffers_np["alive"].copy()
    out_alive[new_slots] = 1.0
    out_xyz = xyz.copy()
    out_xyz[new_slots] = new_v[n_alive: n_alive + num_new]

    out_labels = buffers_np["vertex_label"].copy()
    out_labels[new_slots] = new_attrs["vertex_label"][
        n_alive: n_alive + num_new]
    out_lbsw = buffers_np["lbs_weights"].copy()
    w_new = new_attrs["lbs_weights"][n_alive: n_alive + num_new]
    w_new = w_new / np.maximum(w_new.sum(1, keepdims=True), 1e-12)
    out_lbsw[new_slots] = w_new

    # scaling multiplier: parents rescaled toward the mean, children
    # start at 1 (then trainer rescales from interpolated targets)
    out_mult = buffers_np["scaling_multiplier"].copy()
    ratio = mean_scales / np.maximum(scales, 1e-12)
    out_mult[sel, 0] *= ratio[sel]
    out_mult[new_slots] = 1.0

    f, fv, eo, ev = _pack_topology(faces_slots, face_capacity, edge_capacity)

    # canonical vertex normals for the anchors (stale-until-next-change,
    # like the reference's smpl_mesh.vertex_normals)
    normals = buffers_np["anchor_normals"].copy()
    slot_verts = np.zeros((c, 3), np.float32)
    slot_verts[slot_map] = new_v[: n_alive + num_new]
    vn = vertex_normals(slot_verts, faces_slots)
    normals[out_alive > 0.5] = vn[out_alive > 0.5]

    changed = np.zeros(c, np.float32)
    changed[new_slots] = 1.0

    return DensityResult(
        changed=True, new_xyz=out_xyz, alive=out_alive,
        scaling_multiplier=out_mult, lbs_weights=out_lbsw,
        vertex_label=out_labels, anchor_normals=normals,
        faces=f, face_valid=fv, edges=eo, edge_valid=ev,
        changed_slots=changed, num_alive=n_alive + num_new,
    )


def prune_and_simplify(
    buffers_np: dict,
    xyz: np.ndarray,
    fwd: dict,
    *,
    opacity_threshold: float = 0.005,
    scale_threshold: float = 0.0005,
    dead_grad: float = 0.0005,
    large_scale: float = 0.01,
    prune_max_n_gs_once: int = 5000,
    min_n_gs: int = 100_000,
    collapse_rate: float = 0.5,
    face_capacity: int,
    edge_capacity: int,
) -> DensityResult:
    """Collapse edges between transparent-small / dead-large gaussians."""
    alive = buffers_np["alive"] > 0.5
    c = alive.shape[0]
    n_alive = int(alive.sum())
    if n_alive <= min_n_gs:
        return _unchanged(buffers_np, c, n_alive)

    opacity = fwd["opacity"].reshape(-1)
    scales = fwd["scales"][:, 0]
    grads = np.nan_to_num(
        buffers_np["xyz_grad_accum"] / np.maximum(
            buffers_np["grad_denom"], 1e-12))

    vert_mask = (opacity < opacity_threshold) & (scales < scale_threshold)
    vert_mask |= (scales > large_scale) & (grads < dead_grad)
    vert_mask &= ~np.isin(buffers_np["vertex_label"], HAND_LABELS)
    vert_mask &= alive
    if vert_mask.sum() == 0:
        return _unchanged(buffers_np, c, n_alive)

    faces = _live_mesh(buffers_np)
    sel_idx = np.where(vert_mask)[0]
    face_mask = np.isin(faces, sel_idx).all(axis=1)
    sel_e = np.sort(faces[face_mask][:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), 1)
    if len(sel_e) == 0:
        return _unchanged(buffers_np, c, n_alive)
    uniq, counts = np.unique(sel_e, axis=0, return_counts=True)
    sel_edges = uniq[counts == 2]  # interior edges only
    if len(sel_edges) == 0 or len(sel_edges) > 2 * prune_max_n_gs_once:
        return _unchanged(buffers_np, c, n_alive)

    # collapse on the compacted live mesh
    live_ids = np.where(alive)[0]
    live_index = np.full(c, -1, np.int64)
    live_index[live_ids] = np.arange(n_alive)
    verts_l = fwd["xyz_canon"][live_ids]
    w_l = buffers_np["lbs_weights"][live_ids]
    new_verts, new_faces_l, new_w, prune_mask_l = collapse_edges(
        verts_l, w_l, live_index[sel_edges], live_index[faces],
        collapse_rate=collapse_rate,
    )
    kept_l = np.where(~prune_mask_l)[0]
    faces_slots = live_ids[kept_l[new_faces_l]]

    out_alive = buffers_np["alive"].copy()
    out_alive[live_ids[prune_mask_l]] = 0.0
    out_lbsw = buffers_np["lbs_weights"].copy()
    out_lbsw[live_ids] = w_l  # collapse rewrote survivor weights in place

    f, fv, eo, ev = _pack_topology(faces_slots, face_capacity, edge_capacity)

    normals = buffers_np["anchor_normals"].copy()
    slot_verts = np.zeros((c, 3), np.float32)
    slot_verts[live_ids] = verts_l
    vn = vertex_normals(slot_verts, faces_slots)
    normals[out_alive > 0.5] = vn[out_alive > 0.5]

    changed = np.zeros(c, np.float32)
    changed[live_ids[prune_mask_l]] = 1.0

    return DensityResult(
        changed=True, new_xyz=None, alive=out_alive,
        scaling_multiplier=buffers_np["scaling_multiplier"],
        lbs_weights=out_lbsw,
        vertex_label=buffers_np["vertex_label"],
        anchor_normals=normals,
        faces=f, face_valid=fv, edges=eo, edge_valid=ev,
        changed_slots=changed, num_alive=int(out_alive.sum()),
    )


def _unchanged(buffers_np: dict, c: int, n_alive: int) -> DensityResult:
    return DensityResult(
        changed=False, new_xyz=None, alive=buffers_np["alive"],
        scaling_multiplier=buffers_np["scaling_multiplier"],
        lbs_weights=buffers_np["lbs_weights"],
        vertex_label=buffers_np["vertex_label"],
        anchor_normals=buffers_np["anchor_normals"],
        faces=buffers_np["faces"], face_valid=buffers_np["face_valid"],
        edges=buffers_np["edges"], edge_valid=buffers_np["edge_valid"],
        changed_slots=np.zeros(c, np.float32), num_alive=n_alive,
    )


def densify_and_prune_vanilla(
    buffers_np: dict,
    xyz: np.ndarray,
    fwd: dict,
    *,
    grad_threshold: float = 0.0002,
    min_opacity: float = 0.005,
    percent_dense: float = 0.01,
    densify_extent: float = 1.0,
    max_screen_size: float | None = 20.0,
    max_n_gs: int = 200_000,
    rng: np.random.RandomState | None = None,
) -> DensityResult:
    """Classic 3DGS clone / split / prune: small high-gradient gaussians
    are cloned in place into free slots, large ones split into two
    children drawn from the gaussian (parent pruned, multiplier / 1.6),
    transparent or huge ones pruned. Faces are unchanged."""
    rng = rng or np.random.RandomState(0)
    alive = buffers_np["alive"] > 0.5
    c = alive.shape[0]
    n_alive = int(alive.sum())
    scale_threshold = percent_dense * densify_extent

    grads = np.nan_to_num(
        buffers_np["xyz_grad_accum"] / np.maximum(
            buffers_np["grad_denom"], 1e-12))
    scales = fwd["scales_canon"]
    opacity = fwd["opacity"].reshape(-1)
    max_scale = scales.max(axis=1)

    out_alive = buffers_np["alive"].copy()
    out_xyz = xyz.copy()
    out_mult = buffers_np["scaling_multiplier"].copy()
    out_lbsw = buffers_np["lbs_weights"].copy()
    out_labels = buffers_np["vertex_label"].copy()
    changed = np.zeros(c, np.float32)

    def take_free(k):
        free = np.where(out_alive < 0.5)[0]
        return free[: min(k, len(free))]

    budget = max(max_n_gs - n_alive, 0)

    def copy_into(slots, src, xyz_new, mult):
        out_alive[slots] = 1.0
        out_xyz[slots] = xyz_new
        out_mult[slots] = mult
        out_lbsw[slots] = out_lbsw[src]
        out_labels[slots] = out_labels[src]
        changed[slots] = 1.0

    # clone small high-gradient gaussians in place
    clone_sel = ((grads >= grad_threshold) & (max_scale <= scale_threshold)
                 & alive)
    clone_idx = np.where(clone_sel)[0][:budget]
    slots = take_free(len(clone_idx))
    clone_idx = clone_idx[: len(slots)]
    copy_into(slots, clone_idx, fwd["xyz_canon"][clone_idx],
              out_mult[clone_idx])
    budget -= len(slots)

    # split large high-gradient gaussians: 2 children sampled from the
    # gaussian, the parent pruned
    split_sel = ((grads >= grad_threshold) & (max_scale > scale_threshold)
                 & alive)
    split_idx = np.where(split_sel)[0][: max(budget // 2, 0)]
    if len(split_idx):
        children = np.repeat(split_idx, 2)
        slots = take_free(len(children))
        children = children[: len(slots)]
        samples = rng.randn(len(children), 3) * scales[children]
        copy_into(slots, children, fwd["xyz_canon"][children] + samples,
                  out_mult[children] / (0.8 * 2))
        out_alive[split_idx] = 0.0
        changed[split_idx] = 1.0

    # prune transparent / huge gaussians
    prune = (opacity < min_opacity) & alive
    if max_screen_size:
        prune |= (buffers_np["max_radii2d"] > max_screen_size) & alive
        prune |= (max_scale > 0.1 * densify_extent) & alive
    prune &= out_alive > 0.5
    out_alive[prune] = 0.0
    changed[prune] = 1.0

    return DensityResult(
        changed=bool(changed.any()), new_xyz=out_xyz, alive=out_alive,
        scaling_multiplier=out_mult, lbs_weights=out_lbsw,
        vertex_label=out_labels,
        anchor_normals=buffers_np["anchor_normals"],
        faces=buffers_np["faces"], face_valid=buffers_np["face_valid"],
        edges=buffers_np["edges"], edge_valid=buffers_np["edge_valid"],
        changed_slots=changed, num_alive=int(out_alive.sum()),
    )
