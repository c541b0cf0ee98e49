"""SMPL/SMPL-H body template: the synthetic humanoid and subdivision.

The reference wraps the smplx package and licensed SMPL pickles
(sings/rec/models/modules/smpl_layer.py, smplh_layer.py). The port loads
those when present; the benchmark's cells run without them, so only the
synthetic template is copied here. The template is a plain pytree of
device arrays — all pose math happens in kinematics/lbs.py.

Because the SMPL/SMPLH artifacts are licensed (the reference repo also
only ships placeholder files, data/human_models/*/put_*_here.txt), a
deterministic synthetic humanoid ("tubeman") with the exact SMPL
kinematic tree, 24/52-joint skeletons, smooth skinning weights, shape
dirs, and a closed triangle mesh is provided so every downstream system
(subdivision, LBS, densify/prune, rendering, AMASS animation) runs and
is testable without licensed assets.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..mesh.ops import smooth_taubin, subdivide, unique_edges

# SMPL kinematic tree (public knowledge; reference smpl_layer.py:272)
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 20, 21], dtype=np.int64
)
SMPL_NUM_JOINTS = 24
# SMPLH: 24 body (w/o hands at 22,23) + 15 left + 15 right hand joints
SMPLH_PARENTS = np.concatenate([
    SMPL_PARENTS[:22],
    # left hand chains rooted at wrist 20, right hand at 21
    np.array([20, 22, 23, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35,
              21, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50],
             dtype=np.int64),
])


class BodyTemplate(NamedTuple):
    """Static body-model data (numpy on host; callers device_put)."""

    v_template: np.ndarray    # (V, 3)
    faces: np.ndarray         # (F, 3) int
    edges: np.ndarray         # (E, 2) int unique undirected
    shapedirs: np.ndarray     # (V, 3, n_betas)
    posedirs: np.ndarray | None  # (P, V*3) or None
    j_regressor: np.ndarray   # (J, V)
    parents: np.ndarray       # (J,)
    lbs_weights: np.ndarray   # (V, J)
    vertex_label: np.ndarray  # (V,) int region labels, -1 unknown
    vertex_id: np.ndarray     # (V,) int original-vertex provenance
    name: str                 # 'smpl' | 'smplh' | 'synthetic'
    # MANO hand-PCA data (SMPLH pkls only; smplh_layer.py:182-242):
    # stacked [left, right]. None for SMPL / synthetic-without-hands.
    hands_components: np.ndarray | None = None  # (2, n_comp, 45)
    hands_mean: np.ndarray | None = None        # (2, 45)
    # synthetic templates only: how many trailing shapedirs columns are
    # skeleton-proportion ("bone") dims appended by synthetic_template
    # (see _bone_shapedirs); 0 for licensed SMPL models
    n_bone_betas: int = 0

    @property
    def num_verts(self):
        return self.v_template.shape[0]

    @property
    def num_joints(self):
        return self.parents.shape[0]

    @property
    def num_betas(self):
        return self.shapedirs.shape[-1]


def _tube(p0, p1, radius, n_seg, n_ring):
    """Capped tube from p0 to p1: vertices (n,3), faces (m,3), t in [0,1],
    radial unit directions (n,3) (zero at the cap apexes)."""
    p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    axis = p1 - p0
    length = np.linalg.norm(axis)
    if length < 1e-9:
        axis = np.array([0.0, 0.0, 1.0])
        length = 1e-3
    az = axis / max(length, 1e-9)
    ref = np.array([1.0, 0, 0]) if abs(az[0]) < 0.9 else np.array([0, 1.0, 0])
    ax = np.cross(az, ref)
    ax /= np.linalg.norm(ax)
    ay = np.cross(az, ax)

    ts = np.linspace(0, 1, n_seg)
    thetas = np.arange(n_ring) / n_ring * 2 * np.pi
    verts, tvals, radials = [], [], []
    ring_dirs = (np.cos(thetas)[:, None] * ax
                 + np.sin(thetas)[:, None] * ay)
    for t in ts:
        center = p0 + t * (p1 - p0)
        # taper the caps a little so the body looks blobby, not cylindrical
        r = radius * (0.75 + 0.5 * np.sin(np.pi * min(max(t, 0.08), 0.92)))
        verts.append(center + r * ring_dirs)
        radials.append(ring_dirs)
        tvals.extend([t] * n_ring)
    verts = np.concatenate(verts, axis=0)
    radials = np.concatenate(radials, axis=0)
    faces = []
    for s in range(n_seg - 1):
        for k in range(n_ring):
            a = s * n_ring + k
            b = s * n_ring + (k + 1) % n_ring
            c = a + n_ring
            d = b + n_ring
            faces.append([a, b, d])
            faces.append([a, d, c])
    # end caps
    bot = len(verts)
    verts = np.vstack([verts, p0[None], p1[None]])
    radials = np.vstack([radials, np.zeros((2, 3))])
    tvals.extend([0.0, 1.0])
    top = bot + 1
    for k in range(n_ring):
        faces.append([(k + 1) % n_ring, k, bot])
        off = (n_seg - 1) * n_ring
        faces.append([off + k, off + (k + 1) % n_ring, top])
    return verts, np.asarray(faces, np.int64), np.asarray(tvals), radials


# (joint, child-point, radius, region-label) per body segment; the
# skeleton layout roughly matches SMPL's T-pose joint positions.
_SMPL_JOINT_POS = {
    0: (0.0, 0.0, 0.0),        # pelvis
    1: (0.07, -0.08, 0.0),     # l hip
    2: (-0.07, -0.08, 0.0),    # r hip
    3: (0.0, 0.11, 0.0),       # spine1
    4: (0.10, -0.48, 0.0),     # l knee
    5: (-0.10, -0.48, 0.0),    # r knee
    6: (0.0, 0.25, 0.0),       # spine2
    7: (0.09, -0.88, -0.03),   # l ankle
    8: (-0.09, -0.88, -0.03),  # r ankle
    9: (0.0, 0.31, 0.0),       # spine3
    10: (0.11, -0.94, 0.10),   # l foot
    11: (-0.11, -0.94, 0.10),  # r foot
    12: (0.0, 0.48, 0.0),      # neck
    13: (0.08, 0.41, 0.0),     # l collar
    14: (-0.08, 0.41, 0.0),    # r collar
    15: (0.0, 0.58, 0.02),     # head
    16: (0.17, 0.42, 0.0),     # l shoulder
    17: (-0.17, 0.42, 0.0),    # r shoulder
    18: (0.43, 0.41, 0.0),     # l elbow
    19: (-0.43, 0.41, 0.0),    # r elbow
    20: (0.68, 0.41, 0.0),     # l wrist
    21: (-0.68, 0.41, 0.0),    # r wrist
    22: (0.76, 0.41, 0.0),     # l hand
    23: (-0.76, 0.41, 0.0),    # r hand
}

# segments: (parent joint, child joint, radius, region label)
# region labels follow the reference's 15-region scheme
# (data/human_models/smpl_parsing/region_label_map.json)
_SEGMENTS = [
    (0, 3, 0.11, 8), (3, 6, 0.11, 1), (6, 9, 0.11, 1), (9, 12, 0.055, 1),
    (12, 15, 0.075, 0),
    (13, 16, 0.05, 2), (16, 18, 0.045, 2), (18, 20, 0.035, 4),
    (20, 22, 0.028, 6),
    (14, 17, 0.05, 3), (17, 19, 0.045, 3), (19, 21, 0.035, 5),
    (21, 23, 0.028, 7),
    (1, 4, 0.07, 9), (4, 7, 0.05, 11), (7, 10, 0.035, 13),
    (2, 5, 0.07, 10), (5, 8, 0.05, 12), (8, 11, 0.035, 14),
]


# symmetric bone groups for the skeleton-proportion shape dims: each
# entry = (name, list of _SEGMENTS indices). Stretching a group's bones
# translates everything kinematically downstream, so limb proportions
# (which the fixed _SMPL_JOINT_POS skeleton gets wrong for any real
# subject) become fittable from keypoints (preprocess/refine.py).
_BONE_GROUPS = [
    ("torso", [0, 1, 2, 3]),       # pelvis->spine1->spine2->spine3->neck
    ("head", [4]),                 # neck->head
    ("shoulder_width", [5, 9]),    # collar->shoulder, both sides
    ("upper_arms", [6, 10]),
    ("forearms", [7, 11]),
    ("hands", [8, 12]),
    ("thighs", [13, 16]),
    ("calves", [14, 17]),
    ("feet", [15, 18]),
]
_BONE_STRETCH = 0.15   # fractional bone stretch per unit beta
_HIP_WIDTH = 0.05      # hip half-width shift (m) per unit beta


def _joint_descendants(parents: np.ndarray) -> list[set]:
    """desc[j] = {j} U all kinematic descendants of j."""
    nj = len(parents)
    desc = [{j} for j in range(nj)]
    for j in range(nj - 1, 0, -1):
        desc[int(parents[j])] |= desc[j]
    return desc


def _bone_shapedirs(joints: np.ndarray, seg_slices: list, seg_t: list,
                    nv: int) -> np.ndarray:
    """Skeleton-proportion displacement fields as shapedir columns.

    Per bone group: verts ON a stretched bone move t * bone_vec * a
    (t = position along the bone), verts on kinematically DOWNSTREAM
    segments translate by bone_vec * a — a linear field, so it is
    exact under beta mixing and under subdivision's midpoint
    interpolation (subdivide_template). Joints follow automatically
    because lbs() regresses them from the shaped verts. Last column:
    hip width (legs translate +-x)."""
    desc = _joint_descendants(SMPL_PARENTS[:24])
    n_bone = len(_BONE_GROUPS) + 1
    extra = np.zeros((nv, 3, n_bone), np.float32)
    for g, (_name, segs) in enumerate(_BONE_GROUPS):
        for si in segs:
            pj, cj = _SEGMENTS[si][0], _SEGMENTS[si][1]
            vec = (joints[cj] - joints[pj]) * _BONE_STRETCH
            s0, s1 = seg_slices[si]
            extra[s0:s1, :, g] += seg_t[si][:, None] * vec[None]
            for sj, seg in enumerate(_SEGMENTS):
                if sj != si and seg[0] in desc[cj]:
                    t0, t1 = seg_slices[sj]
                    extra[t0:t1, :, g] += vec[None]
    # hip width: the whole left leg +x, right leg -x
    for sj, seg in enumerate(_SEGMENTS):
        if seg[0] in desc[1]:    # left leg roots at hip joint 1
            t0, t1 = seg_slices[sj]
            extra[t0:t1, 0, -1] += _HIP_WIDTH
        elif seg[0] in desc[2]:  # right leg
            t0, t1 = seg_slices[sj]
            extra[t0:t1, 0, -1] -= _HIP_WIDTH
    return extra


def synthetic_template(
    num_betas: int = 10, *, n_seg: int = 7, n_ring: int = 12,
    hands: bool = False, seed: int = 0, n_bone_betas: int = 0,
    res: float = 1.0,
) -> BodyTemplate:
    """Deterministic synthetic humanoid with SMPL(-H) skeleton.

    Capped tubes per bone, smooth two-joint skinning weights along each
    bone, random-smooth shapedirs, joint regressor reproducing the
    skeleton from the mesh. ~1.6k vertices at default resolution — use
    subdivide_template() to densify like the reference does for SMPL.

    n_bone_betas > 0 appends up to len(_BONE_GROUPS)+1 skeleton-
    proportion shapedir columns AFTER the num_betas requested columns
    (see _bone_shapedirs); total betas = num_betas + n_bone_betas.

    res scales the tube tessellation (n_seg, n_ring) uniformly:
    res=2.0 gives ~4x the vertices (~6.4k) — about the licensed SMPL's
    6890, so two subdivisions land at the reference's ~110k-gaussian
    init (smpl_layer.py:296-353, BASELINE.md) instead of 4x fewer.
    """
    if res != 1.0:
        n_seg = max(2, int(round(n_seg * res)))
        n_ring = max(3, int(round(n_ring * res)))
    rng = np.random.RandomState(seed)
    joints = np.array([_SMPL_JOINT_POS[j] for j in range(24)])

    all_v, all_f, all_w, all_label, all_rad = [], [], [], [], []
    seg_slices, seg_t = [], []
    offset = 0
    for (pj, cj, radius, label) in _SEGMENTS:
        v, f, t, rad = _tube(joints[pj], joints[cj], radius, n_seg, n_ring)
        w = np.zeros((len(v), SMPL_NUM_JOINTS))
        # smooth handoff from parent to child joint along the bone
        s = np.clip((t - 0.3) / 0.4, 0.0, 1.0)
        w[:, pj] = 1.0 - s
        w[:, cj] = s
        all_v.append(v)
        all_f.append(f + offset)
        all_w.append(w)
        all_label.append(np.full(len(v), label, dtype=np.int64))
        all_rad.append(rad)
        seg_slices.append((offset, offset + len(v)))
        seg_t.append(np.asarray(t, np.float32))
        offset += len(v)

    v_template = np.concatenate(all_v).astype(np.float32)
    faces = np.concatenate(all_f)
    lbs_weights = np.concatenate(all_w).astype(np.float32)
    vertex_label = np.concatenate(all_label)
    radials = np.concatenate(all_rad).astype(np.float32)
    nv = len(v_template)

    # joint regressor: weight vertices near each joint
    j_regressor = np.zeros((SMPL_NUM_JOINTS, nv), dtype=np.float32)
    for j in range(SMPL_NUM_JOINTS):
        d = np.linalg.norm(v_template - joints[j][None], axis=1)
        k = np.exp(-(d / 0.06) ** 2)
        if k.sum() < 1e-6:
            k = (d == d.min()).astype(np.float64)
        j_regressor[j] = k / k.sum()

    # interpretable shape directions so silhouettes can actually FIT
    # this template (preprocess/refine.py optimize_betas):
    #   0: global scale, 1: global radial inflation,
    #   2..7: per-region-group radial inflation,
    #   8+: smooth random residual fields
    shapedirs = np.zeros((nv, 3, num_betas), dtype=np.float32)
    shapedirs[:, :, 0] = 0.05 * v_template
    region_groups = [
        None,                 # beta1: all regions
        (0,),                 # head/neck
        (1, 8),               # torso
        (2, 3),               # upper arms
        (4, 5, 6, 7),         # forearms + hands
        (9, 10),              # upper legs
        (11, 12, 13, 14),     # lower legs + feet
    ]
    for gi, group in enumerate(region_groups):
        b = 1 + gi
        if b >= num_betas:
            break
        mask = (np.ones(nv, bool) if group is None
                else np.isin(vertex_label, group))
        shapedirs[mask, :, b] = 0.03 * radials[mask]
    for b in range(1 + len(region_groups), num_betas):
        freqs = rng.randn(3) * 2.0
        phase = v_template @ freqs + rng.rand() * 2 * np.pi
        shapedirs[:, :, b] = (np.sin(phase)[:, None]
                              * (rng.randn(3) * 0.01)[None])

    n_bone = min(int(n_bone_betas), len(_BONE_GROUPS) + 1)
    if n_bone > 0:
        bone_dirs = _bone_shapedirs(joints, seg_slices, seg_t, nv)
        shapedirs = np.concatenate(
            [shapedirs, bone_dirs[:, :, :n_bone]], axis=-1)

    parents = SMPL_PARENTS.copy()
    weights = lbs_weights
    if hands:
        # 52-joint SMPLH skeleton: SMPL's hand joints 22/23 are replaced
        # by 15+15 finger chains rooted at the wrists (20/21). The tube
        # hand weights fold into the wrists; finger joints get zero
        # weights (fingers are not modeled by the tubes).
        parents = SMPLH_PARENTS.copy()
        w22 = lbs_weights.copy()
        w22[:, 20] += w22[:, 22]
        w22[:, 21] += w22[:, 23]
        w22 = w22[:, :22]
        weights = np.concatenate(
            [w22, np.zeros((nv, 30), np.float32)], axis=1)
        jr = np.zeros((52, nv), dtype=np.float32)
        jr[:22] = j_regressor[:22]
        # finger joints regress to the hand-tip vertex neighborhoods
        for j in range(22, 52):
            hand_tip = 22 if j < 37 else 23
            d = np.linalg.norm(v_template - joints[hand_tip][None], axis=1)
            k = np.exp(-(d / 0.05) ** 2)
            jr[j] = k / max(k.sum(), 1e-6)
        j_regressor = jr

    return BodyTemplate(
        v_template=v_template,
        faces=faces,
        edges=unique_edges(faces),
        shapedirs=shapedirs,
        posedirs=None,
        j_regressor=j_regressor,
        parents=parents,
        lbs_weights=weights,
        vertex_label=vertex_label,
        vertex_id=np.arange(nv, dtype=np.int64),
        name="synthetic",
        n_bone_betas=n_bone,
    )


def subdivide_template(tpl: BodyTemplate, num_subdivide: int,
                       smooth: bool = True) -> BodyTemplate:
    """Subdivide the whole template with attribute interpolation.

    Mirrors reference smpl_layer.subdivide_meshes (:296-353) including
    its choices: J_regressor rows renormalized after interpolation,
    posedirs zeroed (the subdivided model runs with disable_posedirs).
    """
    v = tpl.v_template.astype(np.float64)
    faces = tpl.faces
    attrs = {
        "vertex_id": tpl.vertex_id,
        "vertex_label": tpl.vertex_label,
        "lbs_weights": tpl.lbs_weights.astype(np.float64),
        "shapedirs": tpl.shapedirs.reshape(tpl.num_verts, -1).astype(np.float64),
        "J_regressor": tpl.j_regressor.T.astype(np.float64),
    }
    for _ in range(num_subdivide):
        nv_before = len(v)
        v, faces, attrs = subdivide(v, faces, None, attrs)
        if smooth:
            v = smooth_taubin(v, faces)

    nv = len(v)
    jr = attrs["J_regressor"].T
    jr = jr / np.maximum(jr.sum(axis=1, keepdims=True), 1e-12)
    w = attrs["lbs_weights"]
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return tpl._replace(
        v_template=v.astype(np.float32),
        faces=faces,
        edges=unique_edges(faces),
        shapedirs=attrs["shapedirs"].reshape(nv, 3, tpl.num_betas).astype(
            np.float32),
        posedirs=None,
        j_regressor=jr.astype(np.float32),
        lbs_weights=w.astype(np.float32),
        vertex_label=attrs["vertex_label"].astype(np.int64),
        vertex_id=attrs["vertex_id"].astype(np.int64),
    )


def load_template(
    model_type: str = "smplh",
    num_betas: int = 10,
    n_subdivision: int = 0,
    synthetic_res: float = 1.0,
) -> BodyTemplate:
    """The synthetic template (the port's load_template without a
    licensed model), subdivided n_subdivision times."""
    # the synthetic skeleton's limb proportions are fixed guesses;
    # expose them as extra shape dims so the keypoint/silhouette fit
    # (preprocess/refine.py) can correct them per subject
    tpl = synthetic_template(num_betas, hands=(model_type == "smplh"),
                             n_bone_betas=len(_BONE_GROUPS) + 1,
                             res=synthetic_res)
    if n_subdivision > 0:
        tpl = subdivide_template(tpl, n_subdivision, smooth=True)
    return tpl
