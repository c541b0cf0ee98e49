"""The port's training step held against sings_tpu's make_train_step.

A tiny synthetic-template avatar (synthetic_res 0.5, no subdivision,
16^3 nested triplane at multires [1, 2], 48x48 frames, chunk 8) is
built by the JAX package, warmed by one JAX step so the Adam moments
are not zero, and carried into the port (params, buffers, Adam state,
region laplacian). Both packages then take the same step(s) at step
2000 (every gate open, laplacian ramp at 1) with the same random draws
(JAX's, handed to the port): one step, and a K = 3 chunk with the
chunk-head KNN statistic. Compared: every loss term, the gradients
(recovered from the first Adam moments), the new parameters and the
density buffers, at the tolerances stated below. Also the non-finite
guard, the train-mode Trainer at tiny size, and its LPIPS loss with
random features.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.config.defaults import (
    DEFAULT_COLOR_REGIONS_W, DEFAULT_POSITION_REGIONS_W, parse_region_weights,
)
from sings_tpu.fields.decoders import DecoderConfig as JDec
from sings_tpu.fields.triplane import TriplaneConfig as JTri
from sings_tpu.kinematics.body_model import load_template as jload_template
from sings_tpu.kinematics.template import (
    DeviceTemplate as JDT, canonical_pose_cache as jcache,
)
from sings_tpu.losses import photometric as jph
from sings_tpu.losses import regularizers as jreg
from sings_tpu.model import avatar as jav
from sings_tpu.ops.graphics import make_camera as jcam
from sings_tpu.train import optim as joptim
from sings_tpu.train import step as jstep
from sings_tpu_torch.fields.decoders import DecoderConfig
from sings_tpu_torch.fields.triplane import TriplaneConfig
from sings_tpu_torch.kinematics.body_model import load_template
from sings_tpu_torch.kinematics.template import (
    DeviceTemplate, canonical_pose_cache,
)
from sings_tpu_torch.losses.photometric import PhotometricWeights
from sings_tpu_torch.losses.regularizers import L2NormConfig
from sings_tpu_torch.model.avatar import AvatarConfig
from sings_tpu_torch.ops.graphics import make_camera as tcam
from sings_tpu_torch.train import optim as toptim
from sings_tpu_torch.train import step as tstep
from sings_tpu_torch.train.checkpoint import (
    adam_state_from_numpy, buffers_from_numpy, params_from_numpy,
    region_laplacian_from_numpy,
)
from sings_tpu_torch.tree import tree_leaves
from test_torch_losses import jax_step_draws

HW = 48
STEP = 2000
L2 = dict(lambda_xyz_offsets=0.001, lambda_scales_diff=0.005,
          max_scale_threshold=0.005, lambda_max_scale=0.01,
          min_opacity_threshold=0.2, lambda_min_opacity=0.001)
RASTER = dict(tile=16, chunk=8, max_span=3, main_width=4, pair_cap=4)
# loss terms: the same f32 arithmetic in another order
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class Setup:
    """Both packages' step inputs from one JAX state."""

    def __init__(self, tmp):
        rng = np.random.RandomState(0)
        tpl = jload_template(os.path.join(tmp, "smplh"), "smplh",
                             num_betas=10, n_subdivision=0,
                             synthetic_res=0.5)
        cap = _round_up(int(tpl.num_verts * 2.0), 256)
        tri = JTri(resolution=(16, 16, 16), out_dim=8, multires=(1, 2),
                   nested=True)
        self.jcfg = jav.AvatarConfig(
            capacity=cap, face_capacity=_round_up(cap * 3, 256),
            edge_capacity=_round_up(cap * 4, 256), num_frames=4,
            num_betas=tpl.num_betas, sh_degree=0, init_scale_multiplier=0.25,
            disable_posedirs=True, body_template="smplh", triplane=tri,
            decoder=JDec(n_features=tri.feat_dim),
            offset_clamp=0.05, scale_clamp=0.05)
        self.tcfg = AvatarConfig(**{
            **self.jcfg._asdict(),
            "triplane": TriplaneConfig(*tri),
            "decoder": DecoderConfig(*self.jcfg.decoder)})
        self.jdt = JDT.from_host(tpl)
        betas = np.zeros(tpl.num_betas, np.float32)
        self.jcache = jcache(self.jdt, jnp.asarray(betas), "da_pose")
        ttpl = load_template(os.path.join(tmp, "smplh"), "smplh",
                             num_betas=10, n_subdivision=0,
                             synthetic_res=0.5)
        self.tdt = DeviceTemplate.from_host(ttpl)
        self.tcache = canonical_pose_cache(self.tdt, torch.tensor(betas),
                                           "da_pose")
        smpl = {"betas": betas,
                "global_orient": np.tile([[np.pi, 0, 0]], (4, 1)),
                "body_pose": (rng.randn(4, 69) * 0.05).astype(np.float32),
                "transl": np.tile([[0, 0.2, 4.0]], (4, 1)).astype(np.float32)}
        state = jav.init_avatar(jax.random.PRNGKey(3), self.jcfg, tpl,
                                self.jcache, smpl)
        p = state.params
        geo = dict(p.geometry_dec, scales1={
            "w": p.geometry_dec["scales1"]["w"] * 0.01,
            "b": jnp.full((1,), np.log(np.expm1(0.02)), jnp.float32)})
        app = dict(p.appearance_dec, opacity={
            "w": p.appearance_dec["opacity"]["w"] * 0.01,
            "b": jnp.full((1,), np.log(4.0), jnp.float32)})
        self.params = p._replace(geometry_dec=geo, appearance_dec=app)
        self.buffers = state.buffers
        K = np.array([[60.0, 0, HW / 2], [0, 60.0, HW / 2], [0, 0, 1]])
        self.jcam = jcam(np.eye(4), HW, HW, K=K)
        self.tcam = tcam(np.eye(4), HW, HW, K=K)
        self.rgb = rng.rand(4, 3, HW, HW).astype(np.float32)
        self.mask = np.zeros((4, HW, HW), np.float32)
        self.mask[:, 6:44, 16:32] = 1.0

        pw = dict(l1=0.8, ssim=0.2, lpips=0.0, num_patches=4, patch_size=16,
                  grad_pyramid=0.2)
        jw = jstep.LossWeights(
            photometric=jph.PhotometricWeights(**pw), silhouette=1.0,
            l2=jreg.L2NormConfig(**L2), mesh_edge=1e4, gaussian_connect=5e3,
            lap_position_strength=1000.0, lap_color_strength=5.0,
            lap_impose_from=1000)
        tw = tstep.LossWeights(
            photometric=PhotometricWeights(**pw), silhouette=1.0,
            l2=L2NormConfig(**L2), mesh_edge=1e4, gaussian_connect=5e3,
            lap_position_strength=1000.0, lap_color_strength=5.0,
            lap_impose_from=1000)
        sc = dict(opt_geo_from=300, opt_app_from=500, opacity_norm_from=12000,
                  knn_backend="chunk", lap_shared=True)
        self.jstep_cfg = jstep.StepConfig(weights=jw, **sc)
        self.tstep_cfg = tstep.StepConfig(weights=tw, **sc)
        lr = joptim.LRConfig(position_max_steps=16000, appearance=5e-4,
                             geometry=5e-4, vembed=5e-4)
        flags = joptim.TrainFlags(optim_pose=True, optim_betas=False,
                                  optim_trans=True)
        self.jtx = joptim.make_optimizer(lr, flags)
        self.ttx = toptim.make_optimizer(toptim.LRConfig(*lr),
                                         toptim.TrainFlags(*flags))
        self.opt_state = self.jtx.init(self.params)

        b = self.buffers
        edges = np.asarray(b.edges)[np.asarray(b.edge_valid) > 0.5]
        labels = np.where(np.asarray(b.alive) > 0.5,
                          np.asarray(b.vertex_label), -1)
        w_pos = parse_region_weights(None, DEFAULT_POSITION_REGIONS_W)
        self.w_pos, self.w_col = w_pos, parse_region_weights(
            None, DEFAULT_COLOR_REGIONS_W)
        self.jlap = jreg.build_region_laplacian(edges, labels, w_pos,
                                                num_regions=15, pad_to=8)
        self.jbody = jstep.make_train_step(
            self.jcfg, self.jstep_cfg, self.jdt, self.jcam, self.jtx, None,
            dict(RASTER, interpret=True))
        self.tbody = tstep.make_train_step(
            self.tcfg, self.tstep_cfg, self.tdt, self.tcam, self.ttx, None,
            RASTER)

    def jbatch(self, i):
        return {"rgb": jnp.asarray(self.rgb[i]),
                "mask": jnp.asarray(self.mask[i]),
                "idx": jnp.asarray(i), "smpl_scale": jnp.ones((1,))}

    def tbatch(self, i):
        return {"rgb": torch.tensor(self.rgb[i]),
                "mask": torch.tensor(self.mask[i]), "idx": i,
                "smpl_scale": torch.ones((1,))}

    def port_state(self, params, buffers, opt_state):
        return (params_from_numpy(_np(params)), buffers_from_numpy(
            _np(buffers)), adam_state_from_numpy(_np(opt_state)),
            region_laplacian_from_numpy(self.jlap))

    def jlaps(self):
        return (self.jlap, self.jlap, jnp.asarray(self.w_pos),
                jnp.asarray(self.w_col))

    def tlaps(self, lap):
        return (lap, lap, torch.tensor(self.w_pos), torch.tensor(self.w_col))

    def draws(self, key, i):
        return jax_step_draws(key, self.mask[i],
                              self.jstep_cfg.weights.photometric)[1]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    s = Setup(str(tmp_path_factory.mktemp("models")))
    # one JAX step first, so the carried-over Adam moments are not zero
    jit_body = jax.jit(s.jbody)
    p, b, o, m, _ = jit_body(s.params, s.buffers, s.opt_state, s.jcache,
                             s.jbatch(1), jax.random.PRNGKey(100),
                             jnp.asarray(STEP - 1), jnp.asarray(0),
                             *s.jlaps())
    assert float(m["skipped"]) == 0.0
    s.params, s.buffers, s.opt_state = p, b, o
    s.jit_body = jit_body
    return s


def _check_metrics(mt, mj, names=None):
    for k in names or mj:
        np.testing.assert_allclose(np.asarray(mt[k]), np.asarray(mj[k]),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)


def _grads_from_moments(mu_new, mu_old, steps=1):
    """g of the last update: mu_new = 0.9 mu_old + 0.1 g."""
    return (mu_new - 0.9 * mu_old) / 0.1


def _check_state(s, got, want, old_opt, param_atol):
    tp, tb, to = got
    jp, jb, jo = want
    jadam = adam_state_from_numpy(_np(jo))
    told = adam_state_from_numpy(_np(old_opt))
    assert int(to.count) == int(jadam.count)
    # gradients, recovered from the first moments: the rasterizer's
    # tolerance (tests/test_rasterizer.py), atol 2e-4 * max|g|, rtol 2e-3
    for a, b, o in zip(tree_leaves(to.mu), tree_leaves(jadam.mu),
                       tree_leaves(told.mu)):
        ga = _grads_from_moments(a.numpy(), o.numpy())
        gb = _grads_from_moments(b.numpy(), o.numpy())
        scale = max(1e-6, float(np.abs(gb).max()))
        np.testing.assert_allclose(ga, gb, atol=2e-4 * scale, rtol=2e-3)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=param_atol)
    np.testing.assert_array_equal(tb.max_radii2d.numpy(),
                                  np.asarray(jb.max_radii2d))
    np.testing.assert_array_equal(tb.grad_denom.numpy(),
                                  np.asarray(jb.grad_denom))
    acc = np.asarray(jb.xyz_grad_accum)
    np.testing.assert_allclose(tb.xyz_grad_accum.numpy(), acc,
                               atol=2e-4 * acc.max(), rtol=2e-3)
    assert acc.max() > 0


def test_one_step_matches_jax(setup):
    s = setup
    key = jax.random.PRNGKey(7)
    jp, jb, jo, jm, jr = s.jit_body(s.params, s.buffers, s.opt_state,
                                    s.jcache, s.jbatch(2), key,
                                    jnp.asarray(STEP), jnp.asarray(0),
                                    *s.jlaps())
    tp, tb, to, lap = s.port_state(s.params, s.buffers, s.opt_state)
    tp, tb, to, tm, tr = s.tbody(tp, tb, to, s.tcache, s.tbatch(2), None,
                                 STEP, 0, *s.tlaps(lap),
                                 draws=s.draws(key, 2))
    assert sorted(tm) == sorted(jm)
    _check_metrics(tm, jm)
    assert float(tm["skipped"]) == 0.0 and float(tm["connect"]) > 0
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-5)
    # one Adam update moves an element by up to ~lr (5e-4) times
    # m_hat / sqrt(v_hat), which amplifies gradient rounding where the
    # moments are small: the updates agree to 1% of lr
    _check_state(s, (tp, tb, to), (jp, jb, jo), s.opt_state, 5e-6)


def test_scan_of_three_steps_matches_jax(setup):
    s = setup
    k = 3
    jscan = jstep.make_train_scan(
        s.jbody, lambda p, b: jreg.edge_stat(jav.get_canon_xyz(p, b, s.jcfg),
                                             b.alive, k=9))
    rngs = jax.random.split(jax.random.PRNGKey(11), k)
    frames = [3, 0, 2]
    jb_ = {"rgb": jnp.asarray(s.rgb[frames]),
           "mask": jnp.asarray(s.mask[frames]),
           "idx": jnp.asarray(frames), "smpl_scale": jnp.ones((k, 1))}
    tp, tb, to, lap = s.port_state(s.params, s.buffers, s.opt_state)
    old_opt = jax.tree.map(np.asarray, s.opt_state)
    jp, jb, jo, jl, jsk, jm = jscan(
        jax.tree.map(jnp.array, s.params), jax.tree.map(jnp.array, s.buffers),
        jax.tree.map(jnp.array, s.opt_state), s.jcache, jb_, rngs,
        jnp.asarray(STEP), jnp.asarray(0), *s.jlaps())
    from sings_tpu_torch.losses.regularizers import edge_stat
    from sings_tpu_torch.model.avatar import get_canon_xyz

    tscan = tstep.make_train_scan(
        s.tbody, lambda p, b: edge_stat(get_canon_xyz(p, b, s.tcfg),
                                        b.alive, k=9))
    tb_ = {"rgb": torch.tensor(s.rgb[frames]),
           "mask": torch.tensor(s.mask[frames]), "idx": frames,
           "smpl_scale": torch.ones((k, 1))}
    draws = [s.draws(r, f) for r, f in zip(rngs, frames)]
    tp, tb, to, tl, tsk, tm = tscan(tp, tb, to, s.tcache, tb_, None, STEP, 0,
                                    *s.tlaps(lap), draws=draws)
    assert tl.shape == (3,) and tsk.tolist() == [0.0, 0.0, 0.0]
    _check_metrics(tm, jm)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOSS_RTOL)
    # three updates, each within 1% of lr (see test_one_step_matches_jax)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1.5e-5)
    np.testing.assert_array_equal(tb.grad_denom.numpy(),
                                  np.asarray(jb.grad_denom))
    acc = np.asarray(jb.xyz_grad_accum)
    np.testing.assert_allclose(tb.xyz_grad_accum.numpy(), acc,
                               atol=2e-4 * acc.max(), rtol=2e-3)
    assert int(to.count) == int(np.asarray(jo[0].count)) == \
        int(old_opt[0].count) + 3


def test_nonfinite_step_is_skipped(setup):
    s = setup
    tp, tb, to, lap = s.port_state(s.params, s.buffers, s.opt_state)
    batch = s.tbatch(0)
    batch["rgb"] = batch["rgb"] * float("nan")
    gen = torch.Generator().manual_seed(0)
    np_, nb, no, m, _ = s.tbody(tp, tb, to, s.tcache, batch, gen, STEP, 0,
                                *s.tlaps(lap))
    assert float(m["skipped"]) == 1.0
    for a, b in zip(tree_leaves((np_, no)), tree_leaves((tp, to))):
        assert torch.equal(a, b)
    for f in ("max_radii2d", "xyz_grad_accum", "grad_denom"):
        assert torch.equal(getattr(nb, f), getattr(tb, f))
    # a good batch still updates, drawing from the generator
    np_, nb, no, m, _ = s.tbody(tp, tb, to, s.tcache, s.tbatch(0), gen,
                                STEP, 0, *s.tlaps(lap))
    assert float(m["skipped"]) == 0.0 and np.isfinite(float(m["loss"]))
    assert int(no.count) == int(to.count) + 1
    assert not torch.equal(np_.xyz, tp.xyz)


def _tiny_trainer_cfg(tmp_path, extra=()):
    from sings_tpu_torch.config.core import load_config
    from sings_tpu_torch.config.defaults import DEFAULTS

    return load_config(DEFAULTS, None, [
        f"output_path={tmp_path}", "exp_name=t", "dataset.name=kit",
        "seed=0", "human.sh_degree=0", "human.n_subdivision=0",
        "human.optim_pose=True", "human.optim_trans=True",
        "human.kplanes.output_coordinate_dim=8",
        "human.kplanes.resolution=[16,16,16]", "human.kplanes.multires=[1,2]",
        "human.loss.patch_size=16", "human.loss.grad_pyramid_w=0.2",
        "human.loss.silhouette_w=1.0", "tpu.random_lpips_factor=0.0",
        "tpu.synthetic_res=0.5", f"tpu.smpl_model_dir={tmp_path}/models",
        "tpu.triplane_nested=True", "tpu.raster.pair_cap=4",
        "tpu.auto_fit_synthetic=False", "train.init_steps=3",
        "tpu.inner_steps=2", *extra])


def _tiny_kit(frames=4):
    from sings_tpu_torch.data.kit import TrainingKit, get_data_splits

    rng = np.random.RandomState(0)
    K = np.array([[60.0, 0, HW / 2], [0, 60.0, HW / 2], [0, 0, 1]])
    masks = np.zeros((frames, HW, HW), np.float32)
    masks[:, 6:44, 16:32] = 1.0
    smpl = {"betas": np.zeros(10, np.float32),
            "body_pose": (rng.randn(frames, 69) * 0.05).astype(np.float32),
            "global_orient": np.tile([[np.pi, 0, 0]], (frames, 1)).astype(
                np.float32),
            "transl": np.tile([[0, 0.2, 4.0]], (frames, 1)).astype(
                np.float32)}
    train, val = get_data_splits(frames)
    return TrainingKit(images=rng.rand(frames, 3, HW, HW).astype(np.float32),
                       masks=masks, smpl=smpl,
                       camera=tcam(np.eye(4), HW, HW, K=K),
                       train_split=train, val_split=val, name="kit")


def test_trainer_train_mode_builds_and_scans(tmp_path):
    from sings_tpu_torch.train.trainer import Trainer

    tr = Trainer(_tiny_trainer_cfg(tmp_path), mode="train", device="cpu",
                 kit=_tiny_kit())
    assert tr.inner_steps == 2 and tr.step_cfg.knn_backend == "chunk"
    assert tr.step_cfg.lap_shared and tr.step_cfg.opacity_norm_from == 12000
    w = tr.step_cfg.weights
    assert w.photometric.lpips == 0.0 and w.photometric.patch_size == 16
    assert w.silhouette == 1.0 and w.photometric.grad_pyramid == 0.2
    assert tr.raster_kw["chunk"] == 8 and tr.raster_kw["pair_cap"] == 4
    assert tr.region_lap.neighbors.shape[0] == tr.avatar_cfg.capacity
    assert int(tr.opt_state.count) == 0  # fresh after the pre-fit
    frames = list(tr.kit.train_split[:2])
    batches = {"rgb": tr.images[frames], "mask": tr.masks[frames],
               "idx": frames, "smpl_scale": torch.ones((2, 1))}
    p, b, o, losses, skipped, m = tr.train_scan(
        tr.params, tr.buffers, tr.opt_state, tr.cache, batches,
        tr.step_generator, STEP, 0, tr.region_lap, tr.region_lap,
        tr.lap_pos_w, tr.lap_color_w)
    assert torch.isfinite(losses).all() and skipped.tolist() == [0.0, 0.0]
    assert int(o.count) == 2 and float(b.xyz_grad_accum.max()) > 0
    for name in ("xyz", "triplane", "geometry_dec", "appearance_dec",
                 "body_pose", "transl"):
        before = tree_leaves(getattr(tr.params, name))
        after = tree_leaves(getattr(p, name))
        assert any(not torch.equal(x, y) for x, y in zip(before, after)), \
            name
    assert torch.equal(p.betas, tr.params.betas)  # optim_betas False


def test_trainer_train_loop_and_lpips_are_later_slices(tmp_path, capsys):
    """The training loop is ported (tests/test_torch_train_loop.py): a
    run already at its last step trains no step and ends with the final
    checkpoint and validation. The LPIPS training loss is ported too:
    with random features (no tpu.lpips_weights) the Trainer scales
    lpips_w 1.0 by random_lpips_factor 0.05, says so as the JAX
    Trainer does, and a step has a finite, positive LPIPS term."""
    from sings_tpu_torch.train.trainer import Trainer

    cfg = _tiny_trainer_cfg(tmp_path, ["train.init_steps=0",
                                       "train.num_steps=0"])
    tr = Trainer(cfg, mode="train", device="cpu", kit=_tiny_kit(),
                 image_writer=lambda path, img: None)
    result = tr.train()
    assert tr.step == 0 and int(tr.opt_state.count) == 0
    assert np.isfinite(result["psnr"]) and np.isfinite(result["lpips"])
    assert os.path.exists(os.path.join(tr.logdir_ckpt, "human_final.npz"))
    cfg = _tiny_trainer_cfg(tmp_path / "b", ["tpu.random_lpips_factor=0.05",
                                             "train.init_steps=0"])
    tr = Trainer(cfg, mode="train", device="cpu", kit=_tiny_kit())
    assert "[lpips] no pretrained weights: scaling lpips_w 1.0 -> 0.05" in \
        capsys.readouterr().out
    assert tr.step_cfg.weights.photometric.lpips == 0.05
    frames = list(tr.kit.train_split[:1])
    batches = {"rgb": tr.images[frames], "mask": tr.masks[frames],
               "idx": frames, "smpl_scale": torch.ones((1, 1))}
    _, _, o, losses, skipped, m = tr.train_scan(
        tr.params, tr.buffers, tr.opt_state, tr.cache, batches,
        tr.step_generator, STEP, 0, tr.region_lap, tr.region_lap,
        tr.lap_pos_w, tr.lap_color_w)
    assert skipped.tolist() == [0.0] and int(o.count) == 1
    lp = float(m["photo_lpips_patch"][0])
    assert np.isfinite(lp) and lp > 0 and torch.isfinite(losses).all()


def test_chip_smoke_train_dotlist_is_the_recipe():
    """chip_smoke.py's training keys equal configs/human_complex.yaml's;
    the region weights the recipe spells out equal the defaults the
    port falls back to."""
    import importlib.util

    from sings_tpu.config.core import load_config as jload_config
    from sings_tpu.config.defaults import DEFAULTS as JDEFAULTS
    from sings_tpu_torch.config import defaults as tdefaults
    from sings_tpu_torch.config.core import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    got = load_config(tdefaults.DEFAULTS, None, smoke.HUMAN_COMPLEX_DOTLIST
                      + smoke.HUMAN_COMPLEX_TRAIN_DOTLIST)
    want = jload_config(JDEFAULTS,
                        os.path.join(root, "configs", "human_complex.yaml"))

    def get(cfg, key):
        for part in key.split("."):
            cfg = cfg.get(part)
        return cfg

    for item in smoke.HUMAN_COMPLEX_TRAIN_DOTLIST:
        key = item.split("=")[0]
        assert get(got, key) == get(want, key), key
    lap = want.human.loss.laplacian
    np.testing.assert_array_equal(
        tdefaults.parse_region_weights(lap.position_regions_w, {}),
        tdefaults.parse_region_weights(
            None, tdefaults.DEFAULT_POSITION_REGIONS_W))
    np.testing.assert_array_equal(
        tdefaults.parse_region_weights(lap.color_regions_w, {}),
        tdefaults.parse_region_weights(
            None, tdefaults.DEFAULT_COLOR_REGIONS_W))
    assert "tpu.inner_steps=8" in smoke.BENCH_TRAIN_DOTLIST
    assert get(want, "tpu.inner_steps") in (None, 8)
    assert smoke.RECIPE_INIT_STEPS == get(want, "train.init_steps")
