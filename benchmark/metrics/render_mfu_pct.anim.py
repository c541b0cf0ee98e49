"""An animation frame's analytic float32 operations (counts/flops.py)
over the traced window's time per frame at the fp32 peak."""
from counts import composite, flops, launches, peaks


def read(run):
    tr = run.state.trainer
    f = launches.fwd_counts(run)
    if f is None or not run.units:
        return None
    acfg = tr.avatar_cfg
    cam = tr.anim_dataset.camera
    fwd_ops, _ = composite.fwd(f["walked"], f["n_tiles"], f["tile"])
    ops = flops.anim_frame({
        "n_live": int(tr.buffers.alive.sum()),
        "geo": {k: tuple(v["w"].shape)
                for k, v in tr.params.geometry_dec.items()},
        "app": {k: tuple(v["w"].shape)
                for k, v in tr.params.appearance_dec.items()},
        "c": acfg.triplane.out_dim, "scales": len(acfg.triplane.multires),
        "joints": tr.buffers.lbs_weights.shape[1],
        "frames_per_decode": tr.anim_dataset.num_frames,
        "height": cam.height, "width": cam.width,
        "composite_fwd_ops": fwd_ops})
    per_frame_s = run.trace.window_s / run.units
    run.lines.append(f"[counts] animation frame: {ops:.6e} fp32 operations")
    return 100.0 * ops / (per_frame_s * peaks.H100_FP32_FLOPS)
