"""Default configuration tree (reference sings/rec/defaults/config.py).

Values follow the reference defaults; recipe YAMLs override per case
(see configs/ at the repo root for the ported human_complex recipe).
TPU-specific additions live under `tpu.*`: capacity planning, raster
kernel knobs, and mesh-axis names for distribution.
"""

DEFAULTS = {
    "seed": 0,
    "mode": "human",
    "output_path": "output",
    "exp_name": "test",
    "eval": False,
    "bg_color": "white",
    "anim_cfg_path": None,
    "logdir": "",
    "logdir_ckpt": "",

    "dataset": {
        # relative to the working directory; recipes and the CLI set
        # the real kit location
        "root_dir": "data/training_kits",
        "batch": "",
        "name": "f_2",
        "seq": "",
        "downscale": 1,
        "max_frames": None,
        # simultaneous multi-case pool: pad per-frame pose params to
        # this many frames (0 = off; set automatically by CasePool)
        "pad_frames_to": 0,
    },

    "train": {
        "batch_size": 1,
        "num_steps": 30000,
        "init_steps": 500,
        "save_ckpt_interval": 4000,
        "val_interval": 2000,
        "viz_interval": 2000,
        "anim_interval": 2000,
        "save_progress_images": False,
        "progress_save_interval": 100,
    },

    "human": {
        "name": "sings_hybrid",
        "ckpt": None,
        "sh_degree": 3,
        "n_subdivision": 0,
        "disable_posedirs": False,
        "optim_pose": False,
        "optim_betas": False,
        "optim_trans": False,
        "canon_nframes": 60,
        "canon_pose_type": "da_pose",
        "body_template": "smpl",
        "feature_dim": 32,
        "kplanes": {
            "grid_dimensions": 2,
            "input_coordinate_dim": 3,
            "output_coordinate_dim": 32,
            "resolution": [64, 64, 64],
            "multires": [1, 2, 4],
        },
        "opt_geo_from": 1000,
        "opt_geo_until": 14000,
        "opt_app_from": 1000,
        "opt_app_until": 15000,

        "lr": {
            "position_init": 0.00016,
            "position_final": 0.0000016,
            "position_delay_mult": 0.01,
            "position_max_steps": 30000,
            "smpl_spatial": 2.0,
            "smpl_pose": 0.0001,
            "smpl_betas": 0.0001,
            "smpl_trans": 0.0001,
            "appearance": 1e-3,
            "geometry": 1e-3,
            "vembed": 1e-3,
            "mlp_max_steps": 16000,
        },

        "loss": {
            "ssim_w": 0.2,
            "l1_w": 0.8,
            "lpips_w": 1.0,
            "num_patches": 4,
            "patch_size": 128,
            "use_patches": 1,
            # weight-free multi-scale gradient L1 on the masked patches
            # (losses/photometric.py::grad_pyramid_distance) — in-env
            # substitute for pretrained-LPIPS texture gradients; not in
            # the reference (deviation documented in PARITY.md)
            "grad_pyramid_w": 0.0,
            "grad_pyramid_levels": 3,
            # alpha-vs-mask supervision, mean (1-T - mask)^2 (not in
            # the reference — PARITY.md; targets the boundary-ring
            # error term). 0 = off
            "silhouette_w": 0.0,
            "mesh_edge": 1e4,
            "gaussian_connect": 5e3,
            "l2_norm": {
                "lambda_xyz_offsets": 0.005,
                "lambda_scales_diff": 0.005,
                "lambda_max_scale": 0.001,
                "max_scale_threshold": 0.008,
                "lambda_min_opacity": 0.0001,
                "min_opacity_threshold": 0.2,
            },
            "laplacian": {
                "type": "standard",
                "regional": True,
                "color_strength": 5.0,
                "color_regions_w": None,     # region-name -> weight dict
                "position_strength": 1000.0,
                "position_regions_w": None,
                "impose_from_iter": 1000,
            },
        },

        "density_control": {
            "strategy": "hybrid",
            "max_n_gaussians": 200000,
            "min_n_gaussians": 100000,
            "hybrid": {
                "densify_interval": 2000,
                "densify_from_iter": 1999,
                "densify_until_iter": 12000,
                "densify_grad_threshold": 0.001,
                "densify_scale_threshold": 0.01,
                "densify_render_size_threshold": 20,
                "prune_interval": 2000,
                "prune_from_iter": 1999,
                "prune_until_iter": 12000,
                "prune_opacity_threshold": 0.005,
                "prune_scale_threshold": 0.0005,
                "prune_collapse_rate": 0.5,
                "prune_max_n_gs_once": 5000,
            },
        },

        "attribute_control": {
            "isotropic": True,
            "thickness_factor": 1.0,
            "fixed_opacity": False,
            "init_opacity": 0.8,
            "init_scale_multiplier": 0.8,
        },
    },

    # TPU-native knobs (no reference equivalent)
    "tpu": {
        "raster": {
            "tile": 16,
            "chunk": 128,
            "max_span": 3,
            "max_pairs": None,
            "main_width": 4,       # backward-glue prefix table width
            "tail_capacity": None,  # wide-gaussian tail rows (None: N//4)
            # per-gaussian surviving-pair budget (tiles.py pair_cap);
            # None = full max_span^2 enumeration
            "pair_cap": None,
            # the JAX package's chunk cumsum in the composite kernels:
            # False = MXU triangular matmul, True = VPU pltpu.roll scan
            # (same numerics to f32 reassociation). The port reads no
            # such switch: its kernels have one scan for both
            "scan_roll": False,
            # "tiled" = tile-major kernel output + XLA relayout;
            # "panel" = 128px-wide image-layout panels with cross-tile
            # chunk-0 prefetch (pallas_kernels.py panel section)
            "layout": "tiled",
        },
        "capacity_margin": 1.25,   # slot headroom over current gaussians
        # synthetic-template tessellation multiplier: 2.0 ~= 4x verts,
        # matching the licensed SMPL's 6890 so n_subdivision=2 lands at
        # the reference's ~110k-gaussian init (kept 1.0 in DEFAULTS so
        # tests stay small; recipes override)
        "synthetic_res": 1.0,
        # KNN edge-statistic backend: "dense" | "window" | "auto".
        # auto currently resolves to dense (exact O(N^2)); the window
        # backend measures ~85% true-NN recall / ~5-7% mean statistic
        # error on dense surface clouds (see trainer.py, tests/test_ops)
        # and stays opt-in until fixed
        "knn_backend": "auto",
        # report psnr_masked_aligned: val poses corrected by the global
        # canonical-frame drift estimated from TRAIN frames only
        # (learned vs preprocess-fit poses — a gauge transform, no val
        # information; see trainer._val_gauge_alignment)
        "val_gauge_align": True,
        # nested triplane grids (res*mult + 1 points): 3x fewer gather
        # rows + single Morton-keyed multires backward reduction
        # (fields/triplane.py). Changes grid parameter shapes vs the
        # reference (PARITY.md); recipes enable it, default stays
        # reference-shaped
        "triplane_nested": False,
        # region-laplacian apply backend, the JAX package's key: "gather"
        # (neighbour tables) | "banded" (its TPU matrix-unit layout of the
        # same laplacian) | "auto". The port builds the gather laplacian
        # for all three (faster on the card than a band); any other value
        # raises
        "laplacian_backend": "auto",
        # scale applied to loss.lpips_w when only RANDOM-FEATURE LPIPS
        # is available (no pretrained weights). The r4 ablation measured
        # the random-feature term 0.3-0.6 dB WORSE than no perceptual
        # term at 0.05x and 0.5x (work/ablate_perceptual/summary.json);
        # recipes set 0.0 and use grad_pyramid + silhouette instead
        "random_lpips_factor": 0.05,
        # test-time val-frame pose refinement steps (0 = off, the
        # reference protocol); >0 adds psnr_masked_refined to val
        "val_pose_refine_steps": 0,
        # gaussian-buffer capacity = capacity_mult * template verts
        # (clamped to density_control.max_n_gaussians)
        "capacity_mult": 2.0,
        "inner_steps": 8,          # train steps fused per dispatch (lax.scan)
        # (dp, gs) device mesh for multi-chip training (dist/shard.py):
        # dp shards frames (one optimizer update averages dp frames),
        # gs shards gaussian decode + image strips. dp*gs==1 -> the
        # single-chip jitted step.
        # balance_strips: pair-balanced gs-strip heights from the
        # training masks' row histogram (docs/SCALING.md mitigation 2);
        # equal-height strips when false
        "mesh": {"dp": 1, "gs": 1, "balance_strips": False},
        "lpips_weights": None,     # optional npz of pretrained VGG-LPIPS
        # licensed SMPL(-H) pickles; absent -> synthetic template
        "smpl_model_dir": "data/human_models",
        "parsing_dir": "data/human_models/smpl_parsing",
    },
}

# region weights used when the YAML leaves them unset
DEFAULT_POSITION_REGIONS_W = {
    "head-neck": 0.5, "spine": 0.75, "leftUpArm": 1.0, "rightUpArm": 1.0,
    "leftDownArm": 1.0, "rightDownArm": 1.0, "leftHand": 1.5,
    "rightHand": 1.5, "hips": 1.0, "leftUpLeg": 1.0, "rightUpLeg": 1.0,
    "leftDownLeg": 1.0, "rightDownLeg": 1.0, "leftFoot": 0.75,
    "rightFoot": 0.75,
}
DEFAULT_COLOR_REGIONS_W = {
    "head-neck": 0.0, "spine": 0.0, "leftUpArm": 0.0, "rightUpArm": 0.0,
    "leftDownArm": 1.0, "rightDownArm": 1.0, "leftHand": 1.0,
    "rightHand": 1.0, "hips": 0.0, "leftUpLeg": 0.0, "rightUpLeg": 0.0,
    "leftDownLeg": 0.0, "rightDownLeg": 0.0, "leftFoot": 0.0,
    "rightFoot": 0.0,
}

REGION_LABEL_MAP = {
    "head-neck": 0, "spine": 1, "leftUpArm": 2, "rightUpArm": 3,
    "leftDownArm": 4, "rightDownArm": 5, "leftHand": 6, "rightHand": 7,
    "hips": 8, "leftUpLeg": 9, "rightUpLeg": 10, "leftDownLeg": 11,
    "rightDownLeg": 12, "leftFoot": 13, "rightFoot": 14,
}


def parse_region_weights(weight_dict: dict | None, default: dict):
    """Region-name dict -> label-indexed array
    (reference smpl_parsing.parse_weights:35-41)."""
    import numpy as np

    d = weight_dict if weight_dict else default
    w = np.ones(len(REGION_LABEL_MAP), np.float32)
    for region, label in REGION_LABEL_MAP.items():
        w[label] = d[region]
    return w
