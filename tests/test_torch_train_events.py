"""The training loop's host events held against sings_tpu's Trainer.

JAX's unbound Trainer methods run on a stub that holds a tiny JAX
avatar; the port's run on a stub that holds the same state carried
over. Compared: a density event (_apply_density_result, with its
zero_moments_for_slots, _reset_opacity and laplacian rebuild, then
_rescale_new_scales) on the same DensityResult, and two steps of the
validation's test-time pose refinement (_val_pose_refine, panel layout;
the JAX package's Pallas kernels in interpret mode).
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sings_tpu.model.density as jdensity
from sings_tpu.config.core import load_config as jload_config
from sings_tpu.config.defaults import (
    DEFAULT_POSITION_REGIONS_W, DEFAULTS as JDEFAULTS, parse_region_weights,
)
from sings_tpu.fields.decoders import DecoderConfig as JDec
from sings_tpu.fields.triplane import TriplaneConfig as JTri
from sings_tpu.kinematics.body_model import load_template as jload_template
from sings_tpu.kinematics.template import (
    DeviceTemplate as JDT, canonical_pose_cache as jcache,
)
from sings_tpu.model import avatar as jav
from sings_tpu.ops.graphics import make_camera as jcam
from sings_tpu.train import optim as joptim
from sings_tpu.train.trainer import Trainer as JTrainer
from sings_tpu_torch.config.core import load_config
from sings_tpu_torch.config.defaults import DEFAULTS
from sings_tpu_torch.fields.decoders import DecoderConfig
from sings_tpu_torch.fields.triplane import TriplaneConfig
from sings_tpu_torch.kinematics.body_model import load_template
from sings_tpu_torch.kinematics.template import (
    DeviceTemplate, canonical_pose_cache,
)
from sings_tpu_torch.model.avatar import AvatarConfig
from sings_tpu_torch.ops.graphics import make_camera as tcam
from sings_tpu_torch.train import checkpoint as tck
from sings_tpu_torch.train.trainer import Trainer
from sings_tpu_torch.tree import tree_leaves
from test_torch_train_loop import RECIPE, _density_inputs, _round_up

HW = 48
RASTER = dict(tile=16, chunk=8, max_span=3, main_width=4, pair_cap=4,
              layout="panel")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    """A tiny avatar (synthetic template at res 0.5, no subdivision)
    built by the JAX package with splats of ~2 cm at opacity 0.8, the
    port's copy of it, both templates and canonical caches, a random
    Adam state, 48x48 targets and the recipe config in both packages."""
    tmp = str(tmp_path_factory.mktemp("models"))
    rng = np.random.RandomState(4)
    tpl = jload_template(os.path.join(tmp, "smplh"), "smplh", num_betas=10,
                         n_subdivision=0, synthetic_res=0.5)
    cap = _round_up(int(tpl.num_verts * 2.0), 256)
    tri = JTri(resolution=(16, 16, 16), out_dim=8, multires=(1, 2),
               nested=True)
    jcfg = jav.AvatarConfig(
        capacity=cap, face_capacity=_round_up(cap * 3, 256),
        edge_capacity=_round_up(cap * 4, 256), num_frames=4,
        num_betas=tpl.num_betas, sh_degree=0, disable_posedirs=True,
        body_template="smplh", triplane=tri,
        decoder=JDec(n_features=tri.feat_dim), offset_clamp=0.05,
        scale_clamp=0.05)
    betas = np.zeros(tpl.num_betas, np.float32)
    jdt = JDT.from_host(tpl)
    jc = jcache(jdt, jnp.asarray(betas), "da_pose")
    smpl = {"betas": betas,
            "global_orient": np.tile([[np.pi, 0, 0]], (4, 1)),
            "body_pose": (rng.randn(4, 69) * 0.05).astype(np.float32),
            "transl": np.tile([[0, 0.2, 4.0]], (4, 1)).astype(np.float32)}
    st = jav.init_avatar(jax.random.PRNGKey(3), jcfg, tpl, jc, smpl)
    p = st.params
    params = p._replace(
        geometry_dec=dict(p.geometry_dec, scales1={
            "w": p.geometry_dec["scales1"]["w"] * 0.01,
            "b": jnp.full((1,), np.log(np.expm1(0.02)), jnp.float32)}),
        appearance_dec=dict(p.appearance_dec, opacity={
            "w": p.appearance_dec["opacity"]["w"] * 0.01,
            "b": jnp.full((1,), np.log(4.0), jnp.float32)}))
    tx = joptim.make_optimizer(joptim.LRConfig(), joptim.TrainFlags())
    opt = jax.tree.map(
        lambda x: jnp.asarray(rng.rand(*x.shape).astype(np.float32))
        if x.dtype == jnp.float32 else x + 3, tx.init(params))
    ttpl = load_template(os.path.join(tmp, "smplh"), "smplh", num_betas=10,
                         n_subdivision=0, synthetic_res=0.5)
    tdt = DeviceTemplate.from_host(ttpl)
    K = np.array([[60.0, 0, HW / 2], [0, 60.0, HW / 2], [0, 0, 1]])
    images = rng.rand(4, 3, HW, HW).astype(np.float32)
    masks = np.zeros((4, HW, HW), np.float32)
    masks[:, 6:44, 16:32] = 1.0
    return types.SimpleNamespace(
        tpl=tpl, jcfg=jcfg, n=tpl.num_verts,
        state=st._replace(params=params), opt=opt, jdt=jdt, jcache=jc,
        tcfg=AvatarConfig(**{**jcfg._asdict(),
                             "triplane": TriplaneConfig(*tri),
                             "decoder": DecoderConfig(*jcfg.decoder)}),
        tdt=tdt, tcache=canonical_pose_cache(tdt, torch.tensor(betas),
                                             "da_pose"),
        smpl=smpl, K=K, images=images, masks=masks,
        jrecipe=jload_config(JDEFAULTS, RECIPE),
        trecipe=load_config(DEFAULTS, RECIPE))


def _stubs(s, params, buffers):
    """JAX's and the port's Trainer stubs over the same state, with the
    methods the event calls bound to them."""
    lap_w = parse_region_weights(None, DEFAULT_POSITION_REGIONS_W)
    j = types.SimpleNamespace(
        cfg=s.jrecipe, params=params,
        buffers=s.state.buffers._replace(
            **{k: jnp.asarray(v) for k, v in buffers.items()}),
        opt_state=s.opt, avatar_cfg=s.jcfg, template=s.jdt, cache=s.jcache,
        mesh=None, lap_pos_w=jnp.asarray(lap_w), _lap_pad=None)
    t = types.SimpleNamespace(
        cfg=s.trecipe, params=tck.params_from_numpy(_np(params)),
        buffers=tck.buffers_from_numpy(_np(j.buffers)),
        opt_state=tck.adam_state_from_numpy(_np(s.opt)), avatar_cfg=s.tcfg,
        template=s.tdt, cache=s.tcache, device=torch.device("cpu"),
        lap_pos_w=torch.tensor(lap_w), _lap_pad=None)
    for stub, cls in ((j, JTrainer), (t, Trainer)):
        for name in ("_reset_opacity", "_rebuild_laplacians", "_fwd_numpy"):
            setattr(stub, name, types.MethodType(getattr(cls, name), stub))
    return j, t


def test_density_event_matches_jax(state):
    """A densify's DensityResult applied by both Trainers: the buffers
    and new positions exactly, the Adam moments zeroed at the same slots
    (count kept), the opacity reset and the laplacian rebuilt; then the
    new slots' scale multipliers from _rescale_new_scales."""
    s = state
    b, xyz, fwd = _density_inputs(s, 5)
    res = jdensity.densify_and_subdivide(
        b, xyz, fwd, grad_threshold=0.001, scale_threshold=0.005,
        max_screen_size=20, max_n_gs=200000,
        face_capacity=s.jcfg.face_capacity,
        edge_capacity=s.jcfg.edge_capacity)
    assert res.changed and res.new_xyz is not None and res.num_alive > s.n
    new_mask = res.changed_slots > 0.5
    # opacity logits on both sides of 0, so that the reset moves some
    p = s.state.params
    params = p._replace(appearance_dec=dict(p.appearance_dec, opacity={
        "w": p.appearance_dec["opacity"]["w"],
        "b": jnp.zeros((1,), jnp.float32)}))
    j, t = _stubs(s, params, {k: b[k] for k in (
        "xyz_grad_accum", "grad_denom", "max_radii2d")})
    JTrainer._apply_density_result(j, res)
    Trainer._apply_density_result(t, res)

    jb, tb = _np(j.buffers), t.buffers
    for f in jb._fields:
        want, got = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        if f == "opacity_offset":
            # decoded from the triplane: the same f32 ops in another order
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    off = np.asarray(jb.opacity_offset)
    assert 0 < (off > 0).sum() < off.size  # the reset raised some
    assert int(tb.alive.sum()) == res.num_alive
    np.testing.assert_array_equal(t.params.xyz.numpy(),
                                  np.asarray(j.params.xyz))
    want = tck.adam_state_from_numpy(_np(j.opt_state))
    assert int(t.opt_state.count) == int(want.count) == 3
    for a, w in zip(tree_leaves((t.opt_state.mu, t.opt_state.nu)),
                    tree_leaves((want.mu, want.nu))):
        np.testing.assert_array_equal(a.numpy(), w.numpy())
    assert float(t.opt_state.mu.xyz[torch.tensor(new_mask)].abs().max()) == 0
    for a, w in zip(t.region_lap, tck.region_laplacian_from_numpy(
            j.region_lap)):
        np.testing.assert_array_equal(a.numpy(), w.numpy())
    assert t._lap_pad == j._lap_pad

    JTrainer._rescale_new_scales(j, new_mask, fwd)
    Trainer._rescale_new_scales(t, new_mask, fwd)
    want = np.asarray(j.buffers.scaling_multiplier)
    got = t.buffers.scaling_multiplier.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(got[~new_mask], want[~new_mask])
    assert np.abs(want[new_mask, 0] - 1.0).max() > 1e-3


def test_val_pose_refine_matches_jax(state):
    """Two steps of the validation's pose refinement from the same frame
    0 data: Adam at lr 2e-3 on (global_orient, body_pose, transl) of the
    frozen avatar against the masked MSE, through the panel layout."""
    s = state
    j = types.SimpleNamespace(
        params=s.state.params, buffers=s.state.buffers, avatar_cfg=s.jcfg,
        template=s.jdt, cache=s.jcache, active_sh_degree=0,
        camera=jcam(np.eye(4), HW, HW, K=s.K),
        images=jnp.asarray(s.images), masks=jnp.asarray(s.masks),
        raster_kw=dict(RASTER, interpret=True))
    t = types.SimpleNamespace(
        params=tck.params_from_numpy(_np(s.state.params)),
        buffers=tck.buffers_from_numpy(_np(s.state.buffers)),
        avatar_cfg=s.tcfg, template=s.tdt, cache=s.tcache,
        active_sh_degree=0, camera=tcam(np.eye(4), HW, HW, K=s.K),
        images=torch.tensor(s.images), masks=torch.tensor(s.masks),
        raster_kw=RASTER, device=torch.device("cpu"))
    for name in ("_pose_tensors", "_render_pose"):
        setattr(t, name, types.MethodType(getattr(Trainer, name), t))
    data = {"global_orient": s.smpl["global_orient"][0].astype(np.float32),
            "body_pose": s.smpl["body_pose"][0],
            "betas": s.smpl["betas"], "transl": s.smpl["transl"][0]}
    want = JTrainer._val_pose_refine(j, data, 0, 2)
    got = Trainer._val_pose_refine(t, data, 0, 2)

    # which pose entries the masked MSE really depends on: the port's
    # gradient at the starting pose (Adam turns any nonzero gradient
    # into a step of ~lr, so entries whose gradient is rounding noise
    # may step either way in either package)
    pose = {k: torch.tensor(np.asarray(data[k], np.float32)).requires_grad_()
            for k in ("global_orient", "body_pose", "transl")}
    full = t._pose_tensors(dict(data, **{k: v.detach()
                                         for k, v in pose.items()}))
    img, _ = t._render_pose(dict(full, **pose), t.camera, torch.zeros(3))
    m = t.masks[0][None]
    loss = (((img - t.images[0]) * m) ** 2).sum() / (m.sum() * 3)
    grads = dict(zip(pose, torch.autograd.grad(loss, list(pose.values()))))
    top = max(float(g.abs().max()) for g in grads.values())
    lr = 2e-3
    n_real = 0
    for k in ("global_orient", "body_pose", "transl"):
        start = np.asarray(data[k], np.float32)
        step_g, step_w = got[k] - start, want[k] - start
        real = grads[k].abs().numpy() > 1e-5 * top
        n_real += int(real.sum())
        np.testing.assert_allclose(step_g[real], step_w[real], atol=1e-6,
                                   err_msg=k)
        # an Adam step moves an entry by about lr at most
        assert np.abs(step_g).max() <= 2.1 * lr, k
        assert np.abs(step_w).max() <= 2.1 * lr, k
    assert n_real > 10
    assert np.abs(got["transl"] - s.smpl["transl"][0]).max() > lr
