"""The training step's analytic float32 operations (counts/flops.py)
over the traced window's time per step at the fp32 peak."""
from counts import composite, flops, launches, peaks


def read(run):
    tr = run.state.trainer
    f, b = launches.fwd_counts(run), launches.bwd_counts(run)
    if f is None or b is None or not run.units:
        return None
    acfg = tr.avatar_cfg
    w = tr.step_cfg.weights.photometric
    params = sum(x.numel() for x in _leaves(tr.params))
    fwd_ops, _ = composite.fwd(f["walked"], f["n_tiles"], f["tile"])
    bwd_ops, _ = composite.bwd(b["walked"], b["composited"], b["n_tiles"],
                               b["tile"], b["grad_cap"])
    ops = flops.train_step({
        "n_live": int(tr.buffers.alive.sum()),
        "n_edges": int(tr.buffers.edge_valid.sum()),
        "geo": _layers(tr.params.geometry_dec),
        "app": _layers(tr.params.appearance_dec),
        "c": acfg.triplane.out_dim, "scales": len(acfg.triplane.multires),
        "joints": tr.buffers.lbs_weights.shape[1],
        "patches": w.num_patches, "patch": w.patch_size,
        "height": tr.camera.height, "width": tr.camera.width,
        "params": params, "k": tr.inner_steps,
        "composite_fwd_ops": fwd_ops, "composite_bwd_ops": bwd_ops})
    per_step_s = run.trace.window_s / run.units
    run.lines.append(f"[counts] training step: {ops:.6e} fp32 operations")
    return 100.0 * ops / (per_step_s * peaks.H100_FP32_FLOPS)


def _layers(dec: dict) -> dict:
    return {k: tuple(v["w"].shape) for k, v in dec.items()}


def _leaves(tree):
    from sings_tpu_torch.tree import tree_leaves

    return tree_leaves(tree)
