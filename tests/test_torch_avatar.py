"""sings_tpu_torch avatar held against sings_tpu: a JAX init_avatar state
goes through JAX save_checkpoint and the port's load_checkpoint; then
get_gs_attrs and avatar_forward_chunk are compared on the same inputs;
the posing's skinning (kinematics/pose.py's plain version) and
avatar_forward's gradients against JAX's, and no template vertex posed.
Shapes of __graft_entry__._tiny_setup (triplane 16/8ch/[1,2]), nested
and plain."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.fields.decoders import DecoderConfig as JDec
from sings_tpu.fields.triplane import TriplaneConfig as JTri
from sings_tpu.kinematics import lbs as jlbs
from sings_tpu.kinematics.body_model import synthetic_template
from sings_tpu.kinematics.poses import predefined_pose
from sings_tpu.kinematics.template import (
    DeviceTemplate as JDT, canonical_pose_cache as jcache,
)
from sings_tpu.model import avatar as jav
from sings_tpu.train.checkpoint import save_checkpoint as jsave
from sings_tpu_torch.fields.decoders import DecoderConfig
from sings_tpu_torch.fields.triplane import TriplaneConfig
from sings_tpu_torch.kinematics import pose as tpose
from sings_tpu_torch.kinematics.template import (
    DeviceTemplate, canonical_pose_cache,
)
from sings_tpu_torch.model import avatar as tav
from sings_tpu_torch.train import checkpoint as tck


def port_config(cfg) -> tav.AvatarConfig:
    return tav.AvatarConfig(**{
        **cfg._asdict(),
        "triplane": TriplaneConfig(*cfg.triplane),
        "decoder": DecoderConfig(*cfg.decoder)})


def tiny_setup(nested=False, isotropic=True):
    """JAX state of the tiny avatar plus the port's template and cache."""
    tpl = synthetic_template(num_betas=10, n_seg=4, n_ring=8)
    n = tpl.num_verts
    cfg = jav.AvatarConfig(
        capacity=((n + 255) // 256) * 256, face_capacity=len(tpl.faces) + 256,
        edge_capacity=len(tpl.edges) + 256, num_frames=8,
        isotropic=isotropic, offset_clamp=0.05, scale_clamp=0.05,
        triplane=JTri(resolution=(16, 16, 16), out_dim=8, multires=(1, 2),
                      nested=nested),
        decoder=JDec(n_features=16, isotropic=isotropic))
    jdt = JDT.from_host(tpl)
    jc = jcache(jdt, jnp.zeros(10), "da_pose")
    smpl = {"global_orient": np.zeros((8, 3), np.float32),
            "body_pose": np.tile(predefined_pose("a_pose"), (8, 1)),
            "transl": np.tile(np.array([[0, 0.25, 3.0]], np.float32), (8, 1)),
            "betas": np.zeros(10, np.float32)}
    state = jav.init_avatar(jax.random.PRNGKey(0), cfg, tpl, jc, smpl)
    tdt = DeviceTemplate.from_host(tpl)
    tc = canonical_pose_cache(tdt, torch.zeros(10), "da_pose")
    return tpl, cfg, jdt, jc, state, tdt, tc


def chunk_inputs(b=3, seed=0):
    rng = np.random.RandomState(seed)
    go = (rng.randn(b, 3) * 0.2).astype(np.float32)
    go[:, 0] += np.pi
    erot = np.stack([np.asarray(jax.numpy.eye(3))] * b).astype(np.float32)
    erot[1] = np.asarray(jav.rotation_6d_to_matrix(
        jnp.asarray(rng.randn(6).astype(np.float32))))
    return {"global_orient": go,
            "body_pose": (rng.randn(b, 69) * 0.3).astype(np.float32),
            "transl": np.tile([[0, 0.25, 3.0]], (b, 1)).astype(np.float32),
            "smpl_scale": rng.uniform(0.9, 1.1, (b, 1)).astype(np.float32),
            "ext_tfs": (rng.randn(b, 3).astype(np.float32) * 0.1, erot,
                        rng.uniform(0.8, 1.2, (b, 1)).astype(np.float32))}


@pytest.mark.parametrize("nested,isotropic", [(True, True), (False, False)])
def test_checkpoint_then_forward_chunk(tmp_path, nested, isotropic):
    tpl, cfg, jdt, jc, state, tdt, tc = tiny_setup(nested, isotropic)
    path = str(tmp_path / "human_final.npz")
    jsave(path, params=state.params, buffers=state.buffers, opt_state={},
          step=7, active_sh_degree=2)
    pcfg = port_config(cfg)
    res = tck.load_checkpoint(path, pcfg, num_joints=tpl.lbs_weights.shape[1])
    assert res["step"] == 7 and res["active_sh_degree"] == 2
    P, B = res["params"], res["buffers"]
    # the checkpoint leaves are exactly the JAX state
    jl = jax.tree_util.tree_leaves((state.params, state.buffers))
    tl = tck.tree_flatten((P, B))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # ... and params_from_numpy gives the same tree
    P2 = tck.params_from_numpy(jax.tree.map(np.asarray, state.params))
    for a, b in zip(tck.tree_flatten(P), tck.tree_flatten(P2)):
        assert torch.equal(a, b)

    gj = jav.get_gs_attrs(state.params, state.buffers, cfg)
    gt = tav.get_gs_attrs(P, B, pcfg)
    for k in ("xyz_canon", "xyz_offsets", "scales", "scales_aux", "opacity",
              "shs", "rot6d_canon"):
        if gj[k] is None:
            assert gt[k] is None
            continue
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]),
                                   atol=2e-6, rtol=1e-5, err_msg=k)

    ch = chunk_inputs()
    kw_j = {k: (tuple(jnp.asarray(x) for x in v) if k == "ext_tfs"
                else jnp.asarray(v)) for k, v in ch.items()}
    kw_t = {k: (tuple(torch.tensor(x) for x in v) if k == "ext_tfs"
                else torch.tensor(v)) for k, v in ch.items()}
    oj = jav.avatar_forward_chunk(state.params, state.buffers, cfg, jdt, jc,
                                  gj, betas=state.params.betas, **kw_j)
    ot = tav.avatar_forward_chunk(P, B, pcfg, tdt, tc, gt, betas=P.betas,
                                  **kw_t)
    for k in ("xyz", "scales", "rotq", "shs", "opacity"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_single_frame_forward_and_roundtrip(tmp_path):
    tpl, cfg, jdt, jc, state, tdt, tc = tiny_setup(nested=True)
    pcfg = port_config(cfg)
    P = tck.params_from_numpy(jax.tree.map(np.asarray, state.params))
    B = tck.buffers_from_numpy(jax.tree.map(np.asarray, state.buffers))
    oj = jav.avatar_forward(state.params, state.buffers, cfg, jdt, jc,
                            dataset_idx=3, smpl_scale=jnp.ones(1))
    ot = tav.avatar_forward(P, B, pcfg, tdt, tc, dataset_idx=3,
                            smpl_scale=torch.ones(1))
    for k in ("xyz", "scales", "rotq"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    # port save -> port load is the identity; a config mismatch raises
    path = str(tmp_path / "human_x.npz")
    tck.save_checkpoint(path, params=P, buffers=B, step=1,
                        active_sh_degree=0)
    res = tck.load_checkpoint(path, pcfg, num_joints=24)
    for a, b in zip(tck.tree_flatten((P, B)),
                    tck.tree_flatten((res["params"], res["buffers"]))):
        assert torch.equal(a, b)
    with pytest.raises(tck.CheckpointShapeMismatch):
        tck.load_checkpoint(path, pcfg._replace(capacity=pcfg.capacity + 256),
                            num_joints=24)
    # the port's own init has the JAX state's layout
    own = tav.init_avatar(torch.Generator().manual_seed(0), pcfg, tpl, tc)
    assert [tuple(x.shape) for x in tck.tree_flatten(own.params)] == [
        tuple(np.shape(x)) for x in jax.tree_util.tree_leaves(state.params)]
    np.testing.assert_array_equal(own.buffers.lbs_weights.numpy(),
                                  np.asarray(state.buffers.lbs_weights))
    np.testing.assert_allclose(own.buffers.anchor_normals.numpy(),
                               np.asarray(state.buffers.anchor_normals),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the skinning of kinematics/pose.py (plain version) against the JAX
# package's per-gaussian posing, and avatar_forward's gradients

def _jax_skin(a, xyz, scales, rot6, w, transl, sscale, ext):
    """avatar_forward_chunk's posing in the JAX package, from A @
    inv_A_t2cano: lbs_extra, smpl_scale, transl, the rotation's
    quaternion, ext_tfs."""
    b, n = a.shape[0], xyz.shape[0]
    xyz_def, lbs_t = jlbs.lbs_extra(a, jnp.broadcast_to(xyz[None], (b, n, 3)),
                                    w)
    sc = jnp.broadcast_to(scales[None], (b, n, 3))
    if sscale is not None:
        xyz_def = xyz_def * sscale[:, None, None]
        sc = sc * sscale[:, None, None]
    xyz_def = xyz_def + transl[:, None, :]
    rotmat = (jnp.broadcast_to(jnp.eye(3), (n, 3, 3)) if rot6 is None
              else jav.rotation_6d_to_matrix(rot6))
    rotq = jav.matrix_to_quaternion(lbs_t[..., :3, :3] @ rotmat[None])
    if ext is not None:
        etrans, erot, escale = ext
        xyz_def = etrans[:, None, :] + escale[:, None, None] * jnp.einsum(
            "bxy,bny->bnx", erot, xyz_def)
        sc = escale[:, None, None] * sc
        rotq = jav.quaternion_multiply(jav.matrix_to_quaternion(erot)[:, None],
                                       rotq)
    return xyz_def, rotq, sc


@pytest.mark.parametrize("nj", [24, 52])
@pytest.mark.parametrize("b,isotropic,scaled,ext", [
    (1, True, True, False), (3, False, True, True), (3, True, False, True),
    (1, False, False, False)])
def test_skin_plain_against_jax(nj, b, isotropic, scaled, ext):
    """xyz, rotq and scales of B frames of gaussians, isotropic or with 6D
    canonical rotations, with and without smpl_scale and ext_tfs; the
    gradients of the transforms, the gaussians and the frame terms."""
    rng = np.random.RandomState(nj + 10 * b)
    n = 300
    a = rng.randn(b, nj, 4, 4).astype(np.float32)
    w = (rng.rand(n, nj) ** 6).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    xs = {"a": a, "xyz": rng.randn(n, 3).astype(np.float32) * 0.3,
          "scales": rng.rand(n, 3).astype(np.float32) * 0.02,
          "rot6": None if isotropic else rng.randn(n, 6).astype(np.float32),
          "transl": rng.randn(b, 3).astype(np.float32),
          "sscale": (rng.rand(b) + 0.5).astype(np.float32) if scaled
          else None}
    if ext:
        xs["etrans"] = rng.randn(b, 3).astype(np.float32) * 0.1
        xs["erot"] = np.asarray(jav.rotation_6d_to_matrix(
            jnp.asarray(rng.randn(b, 6).astype(np.float32))))
        xs["escale"] = (rng.rand(b) * 0.4 + 0.8).astype(np.float32)
    names = [k for k, v in xs.items() if v is not None]
    cots = [rng.randn(b, n, k).astype(np.float32) for k in (3, 4, 3)]

    def jloss(*vals):
        d = dict(zip(names, vals))
        e = (d["etrans"], d["erot"], d["escale"]) if ext else None
        out = _jax_skin(d["a"], d["xyz"], d["scales"], d.get("rot6"),
                        jnp.asarray(w), d["transl"], d.get("sscale"), e)
        return sum(jnp.sum(o * c) for o, c in zip(out, cots)), out

    g_j, out_j = jax.jit(jax.grad(jloss, argnums=tuple(range(len(names))),
                                  has_aux=True))(
        *[jnp.asarray(xs[k]) for k in names])
    lv = {k: torch.tensor(xs[k], requires_grad=True) for k in names}
    frames = tpose.Frames(
        go=torch.zeros(b, 3), bp=torch.zeros(b, 69), go6=False, bp6=False,
        betas=torch.zeros(10), transl=lv["transl"],
        smpl_scale=lv.get("sscale"),
        ext_tfs=(lv["etrans"], lv["erot"], lv["escale"]) if ext else None)
    rotmat = None if isotropic else tav.rotation_6d_to_matrix(lv["rot6"])
    out_t = tpose.skin_plain(lv["a"], frames, lv["xyz"], lv["scales"],
                             rotmat, torch.tensor(w))
    for name, ot, oj in zip(("xyz", "rotq", "scales"), out_t, out_j):
        np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    loss = sum((o * torch.tensor(c)).sum() for o, c in zip(out_t, cots))
    g_t = torch.autograd.grad(loss, [lv[k] for k in names])
    for name, gt, gj in zip(names, g_t, g_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4,
                                   atol=1e-5 * np.abs(gj).max(),
                                   err_msg=name)


def test_forward_gradients_against_jax():
    """avatar_forward of one learned frame (6D rows) with smpl_scale:
    the gradients of xyz, rotq and scales' seeded loss with respect to
    the pose rows, transl, betas and the gaussians' centres, against
    jax.grad of the JAX package's avatar_forward."""
    tpl, cfg, jdt, jc, state, tdt, tc = tiny_setup(nested=True,
                                                   isotropic=False)
    pcfg = port_config(cfg)
    rng = np.random.RandomState(4)
    params = state.params._replace(
        global_orient=state.params.global_orient + jnp.asarray(
            rng.randn(8, 6).astype(np.float32) * 0.2),
        body_pose=state.params.body_pose + jnp.asarray(
            rng.randn(8, 138).astype(np.float32) * 0.2),
        betas=jnp.asarray(rng.randn(10).astype(np.float32) * 0.3))
    n = cfg.capacity
    cots = [rng.randn(n, k).astype(np.float32) for k in (3, 4, 3)]
    names = ("global_orient", "body_pose", "transl", "betas", "xyz")

    def jloss(p):
        out = jav.avatar_forward(p, state.buffers, cfg, jdt, jc,
                                 dataset_idx=3, smpl_scale=jnp.full(1, 1.1))
        return sum(jnp.sum(out[k] * c) for k, c in zip(
            ("xyz", "rotq", "scales"), cots))

    g_j = jax.jit(jax.grad(jloss))(params)
    P = tck.params_from_numpy(jax.tree.map(np.asarray, params))
    B = tck.buffers_from_numpy(jax.tree.map(np.asarray, state.buffers))
    lv = {k: getattr(P, k).clone().requires_grad_(True) for k in names}
    out = tav.avatar_forward(P._replace(**lv), B, pcfg, tdt, tc,
                             dataset_idx=3, smpl_scale=torch.full((1,), 1.1))
    loss = sum((out[k] * torch.tensor(c)).sum() for k, c in zip(
        ("xyz", "rotq", "scales"), cots))
    g_t = torch.autograd.grad(loss, [lv[k] for k in names])
    for name, gt in zip(names, g_t):
        gj = np.asarray(getattr(g_j, name))
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4,
                                   atol=1e-5 * np.abs(gj).max(),
                                   err_msg=name)


def test_forward_poses_no_template_vertex(monkeypatch):
    """avatar_forward and avatar_forward_chunk on CPU tensors pose through
    the plain version: no smpl_forward, lbs or pose blend shapes over the
    template's vertices, no kernel launch. What of the template's vertices
    is left is the joints' regression (lbs.shaped_joints, smpl_forward's
    bits): one shape blend of betas over the vertices a call."""
    from sings_tpu_torch.kinematics import lbs as tlbs
    from sings_tpu_torch.kinematics import template as ttpl

    tpl, cfg, jdt, jc, state, tdt, tc = tiny_setup(nested=False)
    pcfg = port_config(cfg)
    P = tck.params_from_numpy(jax.tree.map(np.asarray, state.params))
    B = tck.buffers_from_numpy(jax.tree.map(np.asarray, state.buffers))

    def refuse(*a, **k):
        raise AssertionError("the template's vertices were posed")

    blends = []
    blend = tlbs.blend_shapes

    def shape_blend(betas, dirs):
        blends.append((tuple(betas.shape), dirs is tdt.shapedirs))
        return blend(betas, dirs)

    monkeypatch.setattr(ttpl, "smpl_forward", refuse)
    monkeypatch.setattr(tlbs, "lbs", refuse)
    monkeypatch.setattr(tlbs, "pose_feature_and_rotmats", refuse)
    monkeypatch.setattr(tlbs, "blend_shapes", shape_blend)
    tpose.reset_launches()
    out = tav.avatar_forward(P, B, pcfg, tdt, tc, dataset_idx=2)
    assert out["xyz"].shape == (pcfg.capacity, 3)
    ch = {k: (tuple(torch.tensor(x) for x in v) if k == "ext_tfs"
              else torch.tensor(v)) for k, v in chunk_inputs().items()}
    gs = tav.get_gs_attrs(P, B, pcfg)
    out = tav.avatar_forward_chunk(P, B, pcfg, tdt, tc, gs, betas=P.betas,
                                   **ch)
    assert out["rotq"].shape == (3, pcfg.capacity, 4)
    assert set(tpose.LAUNCHES.values()) == {0}
    nb = tdt.shapedirs.shape[-1]
    assert blends == [((1, nb), True)] * 2
