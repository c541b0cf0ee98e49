"""The LPIPS term's share of its bound: a step's VGG16 convolution
operations (counts/lpips.py: the forward of both sides' patches and
the predicted ones' input gradient) at the fp32 peak, over the device
time per step under losses.lpips and bwd:losses.lpips
(lpips_device_ms.options). None where the program has no such span."""
from counts import lpips, peaks, spans


def read(run):
    ms = spans.span_ms_per_unit(spans.read(run),
                                ("losses.lpips", "bwd:losses.lpips"))
    if not ms:
        return None
    w = run.state.trainer.step_cfg.weights.photometric
    ops = lpips.step_ops(w.num_patches, w.patch_size)
    run.lines.append(f"[counts] LPIPS a step: {ops:.6e} fp32 operations")
    return 100.0 * ops / peaks.H100_FP32_FLOPS / (ms * 1e-3)
