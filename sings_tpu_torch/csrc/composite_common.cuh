// Per-pair alpha and termination rule shared by composite_fwd.cu and
// composite_bwd.cu, so that the backward walk stops exactly where the
// forward walk stopped (a pair near the 1e-4 threshold must not get a
// gradient that its forward never composited).
//
// Rules (_chunk_alpha and the flag lines of the TPU kernels in
// sings_tpu/ops/rasterizer/pallas_kernels.py): in tile-local
// coordinates, power = -0.5 (a dx^2 + c dy^2) - b dx dy with
// dx = mean_x - px; alpha = min(0.99, op * exp(power)); the pair is
// skipped when power > 0 or alpha < 1/255. A pair that is not skipped
// composites while T * (1 - alpha) >= 1e-4; the first that fails ends
// the pixel's walk for the rest of its chunk-aligned window.
//
// Shared-memory window layout: [row][chunk] with rows 0 mean_x |
// 1 mean_y | 2..4 conic a, b, c | 5..7 rgb | 8 opacity.
#pragma once

namespace composite {

constexpr int kUsedRows = 9;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

struct PairAlpha {
  float alpha;  // clamped alpha
  float gv;     // exp(power), the unclamped gaussian falloff
  float dx;     // mean_x - px, tile-local
  float dy;
};

// Alpha of window pair k at pixel (px, py) of the tile with origin
// (ox, oy). Returns false when the pair is skipped at this pixel.
__device__ __forceinline__ bool pair_alpha(const float* sm, int chunk, int k,
                                           float ox, float oy, float px,
                                           float py, PairAlpha* out) {
  const float mx = sm[k] - ox;
  const float my = sm[chunk + k] - oy;
  const float ca = sm[2 * chunk + k];
  const float cb = sm[3 * chunk + k];
  const float cc = sm[4 * chunk + k];
  const float op = sm[8 * chunk + k];
  const float dx = mx - px;
  const float dy = my - py;
  const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
  const float gv = expf(power);
  const float alpha = fminf(0.99f, op * gv);
  out->alpha = alpha;
  out->gv = gv;
  out->dx = dx;
  out->dy = dy;
  return !(power > 0.0f || alpha < kAlphaMin);
}

// Termination test of a pair that is not skipped: writes the
// transmittance after it and returns whether the pair composites.
__device__ __forceinline__ bool pair_composites(float T, float alpha,
                                                float* t_after) {
  *t_after = T * (1.0f - alpha);
  return *t_after >= kTEps;
}

// Stage the window's 9 used feature rows in shared memory; pairs
// outside the tile's segment [start, end) read as zero. All threads of
// the block take part; the caller synchronises afterwards.
__device__ __forceinline__ void stage_window(float* sm,
                                             const float* __restrict__ feats,
                                             long long stride, int win,
                                             int start, int end, int chunk) {
  for (int i = threadIdx.x; i < kUsedRows * chunk; i += blockDim.x) {
    const int row = i / chunk;
    const int idx = win + (i - row * chunk);
    sm[i] = (idx >= start && idx < end) ? feats[row * stride + idx] : 0.0f;
  }
}

}  // namespace composite
