"""sings_tpu_torch stands alone: importing it and every submodule pulls
in neither jax, optax, sings_tpu nor the JAX experiment scripts under
scripts/; entry points want CUDA and say so."""
import importlib.util
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import sings_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sings_tpu_torch.__path__,
                                               "sings_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "optax", "sings_tpu",
                                    "scripts")
             or k.startswith("exp_"))
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_sings_tpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().split(" ", 1)
    assert int(n) >= 60 and bad == "[]", res.stdout
    for name in ("sings_tpu_torch.losses.photometric",
                 "sings_tpu_torch.losses.regularizers",
                 "sings_tpu_torch.ops.ssim", "sings_tpu_torch.ops.knn",
                 "sings_tpu_torch.ops.schedules",
                 "sings_tpu_torch.train.optim", "sings_tpu_torch.tree",
                 "sings_tpu_torch.model.density",
                 "sings_tpu_torch.mesh.native",
                 "sings_tpu_torch.losses.lpips",
                 "sings_tpu_torch.train.logging_util",
                 "sings_tpu_torch.export.ply",
                 "sings_tpu_torch.cli.train",
                 "sings_tpu_torch.ops.timing",
                 "sings_tpu_torch.ops.scan_bench",
                 "sings_tpu_torch.ops.rasterizer.variants",
                 "sings_tpu_torch.scripts._scene",
                 "sings_tpu_torch.scripts.exp_bwd_moments",
                 "sings_tpu_torch.scripts.exp_cumsum_kernel",
                 "sings_tpu_torch.scripts.exp_bwd_variants",
                 "sings_tpu_torch.ops.projection",
                 "sings_tpu_torch.preprocess.refine",
                 "sings_tpu_torch.preprocess.fit",
                 "sings_tpu_torch.preprocess.frames",
                 "sings_tpu_torch.preprocess.masks",
                 "sings_tpu_torch.cli.refine",
                 "sings_tpu_torch.ops.grid_grad",
                 "sings_tpu_torch.ops.bilinear",
                 "sings_tpu_torch.ops.clip",
                 "sings_tpu_torch.ops.profiling",
                 "sings_tpu_torch.ops.rasterizer.multi",
                 "sings_tpu_torch.dist.train_cases",
                 "sings_tpu_torch.train.trainer_cases",
                 "sings_tpu_torch.cli.train_batch"):
        assert importlib.util.find_spec(name) is not None, name


def test_entry_points_default_to_cuda(tmp_path):
    from sings_tpu_torch.cli.animate import main
    from sings_tpu_torch.cli.refine import main as refine_main
    from sings_tpu_torch.cli.train import main as train_main
    from sings_tpu_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    (tmp_path / "config_train.yaml").write_text("seed: 0\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-o", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main([f"output_path={tmp_path}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        refine_main(["--kit", str(tmp_path)])
    from sings_tpu_torch.cli.train_batch import main as batch_main

    for mode in ([], ["--simultaneous"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            batch_main(["--cases", "a", "b", f"output_path={tmp_path}"]
                       + mode)
    from sings_tpu_torch.scripts import (
        exp_bwd_moments, exp_bwd_variants, exp_cumsum_kernel,
    )
    for script in (exp_bwd_moments, exp_bwd_variants, exp_cumsum_kernel):
        with pytest.raises(RuntimeError, match="CUDA"):
            script.main([])


def test_train_mode_is_a_later_slice(tmp_path, monkeypatch):
    """Training no longer waits for a later slice: the synthetic-template
    fit is ported, and on a kit without keypoints it runs the
    silhouette-only refine and caches the result (it raised before);
    unknown modes are still refused. (The name is the test's history.)"""
    import types

    import numpy as np

    from sings_tpu_torch.config.core import load_config
    from sings_tpu_torch.config.defaults import DEFAULTS
    from sings_tpu_torch.data.kit import TrainingKit
    from sings_tpu_torch.kinematics.body_model import load_template
    from sings_tpu_torch.ops.graphics import make_camera
    from sings_tpu_torch.preprocess import refine
    from sings_tpu_torch.train.trainer import Trainer

    tpl = load_template(None, "smpl", num_betas=10, synthetic_res=0.5)
    masks = np.zeros((2, 32, 32), np.float32)
    masks[:, 4:28, 12:20] = 1.0
    smpl = {"betas": np.zeros(tpl.num_betas, np.float32),
            "global_orient": np.tile([[np.pi, 0, 0]], (2, 1)).astype(
                np.float32),
            "body_pose": np.zeros((2, 69), np.float32),
            "transl": np.tile([[0, 0.2, 4.0]], (2, 1)).astype(np.float32)}
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]])
    kit = TrainingKit(images=np.zeros((2, 3, 32, 32), np.float32),
                      masks=masks, smpl=smpl,
                      camera=make_camera(np.eye(4), 32, 32, K=K),
                      train_split=[0], val_split=[1], name="kit")
    stub = types.SimpleNamespace(
        tpl=tpl, logdir=str(tmp_path), kit=kit, camera=kit.camera,
        device=torch.device("cpu"),
        cfg=load_config(DEFAULTS, None, ["tpu.synthetic_fit_steps=1"]))
    ran = []
    for name in ("fit_skeleton", "refine_smpl"):
        def wrapped(*a, _fn=getattr(refine, name), _name=name, **k):
            ran.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(refine, name, wrapped)
    Trainer._fit_synthetic_body(stub)
    assert ran == ["refine_smpl"]
    cache = np.load(os.path.join(str(tmp_path), "synthetic_fit.npz"))
    assert cache["betas"].shape == (tpl.num_betas,)
    with pytest.raises(NotImplementedError, match="mode='eval'"):
        Trainer(load_config(DEFAULTS), mode="eval", device="cpu")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Run alone (no port beside it) or without CUDA, it exits non-zero
    and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
