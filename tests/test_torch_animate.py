"""The port's animation slice end to end, held against sings_tpu.

sings_tpu_torch.cli.animate.main runs on a tiny run directory (YAML
config, PNG kit, checkpoint written by the JAX package) through a
capturing writer. The frames are compared with the JAX composition
get_gs_attrs -> avatar_forward_chunk -> rasterize (Pallas, interpret)
-> round(clip * 255) on the same inputs: float renders at 2e-5, uint8
frames within one level (both round half to even).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.config.core import load_config as jload_config
from sings_tpu.config.defaults import DEFAULTS as JDEFAULTS
from sings_tpu.data.anim import load_anim_dataset as jload_anim
from sings_tpu.fields.decoders import DecoderConfig
from sings_tpu.fields.triplane import TriplaneConfig
from sings_tpu.kinematics.body_model import load_template
from sings_tpu.kinematics.template import DeviceTemplate, canonical_pose_cache
from sings_tpu.model import avatar as jav
from sings_tpu.ops.rasterizer.api import rasterize as jrasterize
from sings_tpu.train.checkpoint import save_checkpoint as jsave
from sings_tpu.train.step import sh_degree_mask as jmask

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 64
RASTER = dict(tile=16, chunk=8, max_span=3, main_width=4, pair_cap=4)

CONFIG_YAML = """\
seed: 0
bg_color: white
anim_cfg_path: {anim}
dataset: {{root_dir: {kits}, name: kit}}
human:
  sh_degree: 0
  n_subdivision: 0
  disable_posedirs: true
  body_template: smplh
  kplanes: {{output_coordinate_dim: 8, resolution: [16, 16, 16],
            multires: [1, 2]}}
  attribute_control: {{isotropic: true, init_scale_multiplier: 0.25}}
tpu:
  synthetic_res: 0.5
  smpl_model_dir: {models}
  triplane_nested: true
  raster: {{pair_cap: 4}}
"""


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def make_run_dir(tmp_path):
    """Kit (4 PNG frames, 2 after the skip), custom motion (4 frames, 3
    after motion_end -1), config_train.yaml, and a JAX checkpoint."""
    from PIL import Image

    rng = np.random.RandomState(0)
    kit = tmp_path / "kits" / "kit"
    (kit / "images").mkdir(parents=True)
    (kit / "masks").mkdir()
    (kit / "score_demo_video").mkdir()
    for i in range(4):
        Image.fromarray(rng.randint(0, 255, (HW, HW, 3), np.uint8)).save(
            kit / "images" / f"{i:04d}.png")
        Image.fromarray(np.full((HW, HW), 255, np.uint8)).save(
            kit / "masks" / f"{i:04d}.png")
    np.savez(kit / "score_demo_video" / "poses.npz",
             betas=np.zeros(10, np.float32),
             body_pose=(rng.randn(4, 69) * 0.1).astype(np.float32),
             global_orient=np.tile([[np.pi, 0, 0]], (4, 1)).astype(np.float32),
             transl=np.tile([[0, 0.2, 4.0]], (4, 1)).astype(np.float32))
    np.savez(kit / "score_demo_video" / "cameras.npz",
             intrinsic=np.array([[80.0, 0, 32], [0, 80.0, 32], [0, 0, 1]]),
             extrinsic=np.eye(4), height=HW, width=HW)
    pose = np.zeros((4, 72), np.float32)
    pose[:, 0] = np.pi
    pose[:, 3 * 16 + 2] = np.linspace(-1.0, 0.2, 4)
    pose[:, 3 * 1] = np.linspace(0.0, 0.6, 4)
    np.savez(tmp_path / "motion.npz", body_pose=pose,
             transl=(rng.randn(4, 3) * 0.05).astype(np.float32))
    (tmp_path / "anim.yaml").write_text(
        f"motion_src: {tmp_path / 'motion.npz'}\nmotion_type: custom\n"
        "motion_start: 0\nmotion_end: -1\nmotion_skip: 1\n"
        f"render_size: [{HW}, {HW}]\nfx: 625\nfy: 625\n")
    run = tmp_path / "run"
    (run / "ckpt").mkdir(parents=True)
    (run / "config_train.yaml").write_text(CONFIG_YAML.format(
        anim=tmp_path / "anim.yaml", kits=tmp_path / "kits",
        models=tmp_path / "models"))

    # the JAX state the trainer's config implies
    cfg = jload_config(JDEFAULTS, str(run / "config_train.yaml"),
                       ["eval=True"])
    tpl = load_template(str(tmp_path / "models" / "smplh"), "smplh",
                        num_betas=10, n_subdivision=0, synthetic_res=0.5)
    cap = _round_up(min(200000, int(tpl.num_verts * 2.0)), 256)
    tri = TriplaneConfig(resolution=(16, 16, 16), out_dim=8, multires=(1, 2),
                         nested=True)
    acfg = jav.AvatarConfig(
        capacity=cap, face_capacity=_round_up(cap * 3, 256),
        edge_capacity=_round_up(cap * 4, 256), num_frames=2,
        num_betas=tpl.num_betas, sh_degree=0, init_scale_multiplier=0.25,
        disable_posedirs=True, body_template="smplh", triplane=tri,
        decoder=DecoderConfig(n_features=tri.feat_dim),
        offset_clamp=0.05, scale_clamp=0.05)
    dt = DeviceTemplate.from_host(tpl)
    cache = canonical_pose_cache(dt, jnp.zeros(tpl.num_betas), "da_pose")
    smpl = {"betas": np.zeros(tpl.num_betas, np.float32),
            "global_orient": np.tile([[np.pi, 0, 0]], (2, 1)),
            "body_pose": np.zeros((2, 69), np.float32),
            "transl": np.zeros((2, 3), np.float32)}
    state = jav.init_avatar(jax.random.PRNGKey(3), acfg, tpl, cache, smpl)
    p = state.params
    # decoded scales ~1.5 cm and opacity ~0.8, like a pre-fit avatar
    geo = dict(p.geometry_dec, scales1={
        "w": p.geometry_dec["scales1"]["w"] * 0.01,
        "b": jnp.full((1,), np.log(np.expm1(0.015)), jnp.float32)})
    app = dict(p.appearance_dec, opacity={
        "w": p.appearance_dec["opacity"]["w"] * 0.01,
        "b": jnp.full((1,), np.log(4.0), jnp.float32)})
    params = p._replace(geometry_dec=geo, appearance_dec=app)
    jsave(str(run / "ckpt" / "human_final.npz"), params=params,
          buffers=state.buffers, opt_state={}, step=5, active_sh_degree=1)
    return run, cfg, acfg, dt, cache, params, state.buffers


def jax_frames(tmp_path, cfg, acfg, dt, cache, params, buffers, chunk_size):
    ds = jload_anim(str(tmp_path / "motion.npz"), "custom", 0, -1, 1,
                    (HW, HW), fx=625.0, fy=625.0)
    gs = jav.get_gs_attrs(params, buffers, acfg)
    renders = []
    for start in range(0, ds.num_frames, chunk_size):
        ch = ds.get_chunk(start, start + chunk_size)
        out = jav.avatar_forward_chunk(
            params, buffers, acfg, dt, cache, gs,
            global_orient=jnp.asarray(ch["global_orient"]),
            body_pose=jnp.asarray(ch["body_pose"]), betas=params.betas,
            transl=jnp.asarray(ch["transl"]),
            smpl_scale=jnp.asarray(ch["smpl_scale"]),
            ext_tfs=tuple(jnp.asarray(x) for x in ch["ext_tfs"]))
        for b in range(ch["body_pose"].shape[0]):
            pkg = jrasterize(
                out["xyz"][b], out["scales"][b], out["rotq"][b],
                out["opacity"][b][:, 0],
                out["shs"][b] * jmask(jnp.asarray(1))[None, :, None],
                ds.camera, sh_degree=3, bg=jnp.ones(3),
                alive=buffers.alive > 0.5, backend="pallas", interpret=True,
                **RASTER)
            renders.append(np.asarray(pkg["render"]))
    return renders


def test_cli_animate_matches_jax(tmp_path):
    from sings_tpu_torch.cli.animate import main
    from sings_tpu_torch.config.core import load_config
    from sings_tpu_torch.config.defaults import DEFAULTS
    from sings_tpu_torch.model.avatar import get_gs_attrs
    from sings_tpu_torch.ops.rasterizer.api import rasterize
    from sings_tpu_torch.train.trainer import Trainer

    run, cfg, acfg, dt, cache, params, buffers = make_run_dir(tmp_path)
    frames = {}

    def writer(imgs, start):
        for j in range(imgs.shape[0]):
            frames[start + j] = imgs[j]

    fps = main(["-o", str(run), "--chunk", "2", "--device", "cpu"],
               writer=writer)
    assert fps > 0 and sorted(frames) == [0, 1, 2]

    want = jax_frames(tmp_path, cfg, acfg, dt, cache, params, buffers, 2)
    assert len(want) == 3
    for i, w in enumerate(want):
        w8 = np.round(np.clip(w, 0, 1).transpose(1, 2, 0) * 255).astype(
            np.uint8)
        assert frames[i].shape == (HW, HW, 3) and frames[i].dtype == np.uint8
        diff = np.abs(frames[i].astype(int) - w8.astype(int))
        assert diff.max() <= 1, (i, diff.max())
        assert w8.std() > 1.0  # the avatar is in frame

    # float renders of the same trainer state at the rasterize tolerance
    tcfg = load_config(DEFAULTS, str(run / "config_train.yaml"),
                       ["eval=True"])
    tcfg.logdir = str(run)
    tr = Trainer(tcfg, mode="anim", device="cpu")
    assert tr.active_sh_degree == 1 and tr.step == 5
    with torch.no_grad():
        gs = get_gs_attrs(tr.params, tr.buffers, tr.avatar_cfg)
        posed = tr.pose_chunk(gs, tr.anim_dataset.get_chunk(0, 2))
        for b in range(2):
            got = rasterize(*tr.frame_gaussians(posed, b),
                            tr.anim_dataset.camera, sh_degree=3,
                            bg=tr.bg_color, alive=tr.buffers.alive > 0.5,
                            **tr.raster_kw)["render"]
            np.testing.assert_allclose(got.numpy(), want[b], atol=2e-5)


# keys of the config tree that the animation path reads
ANIM_KEYS = [
    "seed", "bg_color", "human.sh_degree", "human.n_subdivision",
    "human.disable_posedirs", "human.body_template", "human.canon_pose_type",
    "human.kplanes.resolution", "human.kplanes.output_coordinate_dim",
    "human.kplanes.multires", "human.attribute_control.isotropic",
    "human.attribute_control.thickness_factor",
    "human.attribute_control.fixed_opacity",
    "human.attribute_control.init_opacity",
    "human.attribute_control.init_scale_multiplier",
    "human.density_control.max_n_gaussians", "human.ckpt",
    "tpu.synthetic_res", "tpu.capacity_mult", "tpu.triplane_nested",
    "tpu.raster.tile", "tpu.raster.chunk", "tpu.raster.max_span",
    "tpu.raster.max_pairs", "tpu.raster.main_width",
    "tpu.raster.tail_capacity", "tpu.raster.pair_cap",
    "tpu.raster.scan_roll", "tpu.raster.layout",
    "dataset.downscale", "dataset.max_frames", "dataset.pad_frames_to",
]


def _get(cfg, key):
    for part in key.split("."):
        cfg = cfg.get(part) if isinstance(cfg, dict) else None
    return cfg


def test_chip_smoke_dotlist_is_the_recipe():
    from sings_tpu_torch.config.core import load_config
    from sings_tpu_torch.config.defaults import DEFAULTS

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    got = load_config(DEFAULTS, None, smoke.HUMAN_COMPLEX_DOTLIST)
    want = jload_config(JDEFAULTS,
                        os.path.join(ROOT, "configs", "human_complex.yaml"))
    for key in ANIM_KEYS:
        assert _get(got, key) == _get(want, key), key
    # the setting the offset/scale clamps read comes from the template,
    # and neither tree overrides them
    for key in ("tpu.offset_clamp", "tpu.scale_clamp",
                "tpu.auto_fit_synthetic"):
        assert _get(got, key) is None and _get(want, key) is None, key
