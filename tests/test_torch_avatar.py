"""sings_tpu_torch avatar held against sings_tpu: a JAX init_avatar state
goes through JAX save_checkpoint and the port's load_checkpoint; then
get_gs_attrs and avatar_forward_chunk are compared on the same inputs.
Shapes of __graft_entry__._tiny_setup (triplane 16/8ch/[1,2]), nested
and plain."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.fields.decoders import DecoderConfig as JDec
from sings_tpu.fields.triplane import TriplaneConfig as JTri
from sings_tpu.kinematics.body_model import synthetic_template
from sings_tpu.kinematics.poses import predefined_pose
from sings_tpu.kinematics.template import (
    DeviceTemplate as JDT, canonical_pose_cache as jcache,
)
from sings_tpu.model import avatar as jav
from sings_tpu.train.checkpoint import save_checkpoint as jsave
from sings_tpu_torch.fields.decoders import DecoderConfig
from sings_tpu_torch.fields.triplane import TriplaneConfig
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
