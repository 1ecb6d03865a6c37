// Kernel A — tile_table_forward: the binned, capped forward rasterizer.
//
// Replaces two TPU kernels of the JAX package, which compute the same
// function on the same pre-gathered [T, K, 16] table:
//   gaussianimage_plus_tpu/kernels/raster_pallas.py      _run_fwd / _make_fwd_kernel
//   gaussianimage_plus_tpu/kernels/raster_flat_pallas.py rasterize_prepared_flat
// For each 16x16 tile t and each pixel p it sums, over the tile's first
// counts[t] table rows in slot order,
//   rgb * min(1, opac * exp(-sigma)),  sigma = w . phi(p) (tile-local coords)
// skipping rows with sigma < 0, alpha < 1/255 or valid == 0 (reference
// forward.cu:650-668). The output is the unclamped [H, W, 3] image; the
// ragged edge of the tile grid is masked.
//
// Design: one block per tile, 256 threads, one pixel each. The block stages
// the tile's live rows into shared memory in chunks of 64 and computes each
// row's six quadratic coefficients w once (the JAX expressions,
// raster_pallas.py:105-111); every thread then runs the rows in slot order
// with plain float32 FMAs. No tensor cores: sigma is a rank-6 dot product per
// (row, pixel), and TF32 would flip the sigma >= 0 gate.
//
// Bound on this card: per (member, pixel) pair one exp and ~10 FMAs, so the
// kernel is bound by operations (SFU exp and FP32 FMA issue), not by the
// table bytes, which are read once per tile (64 B a row).
//
// Arithmetic contract with the plain PyTorch version
// (core/render_tiled.py blend_table_tiles): built with -fmad=false, so w is
// one rounding per operation, and sigma is the explicit fmaf chain below in
// this order. The kernel allocates nothing, runs on the caller's stream and
// does not synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;   // threads per block
constexpr int kCols = 16;
constexpr int kChunk = 64;              // rows staged per pass
constexpr int kRow = 12;                // staged floats per row (11 used)

__device__ __forceinline__ void stage_row(const float* __restrict__ src,
                                          float tx0, float ty0,
                                          float* __restrict__ dst) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];  // c1 c2 c3 mx
  const float4 b = reinterpret_cast<const float4*>(src)[1];  // my r g b
  const float4 c = reinterpret_cast<const float4*>(src)[2];  // opac ...
  const float4 d = reinterpret_cast<const float4*>(src)[3];  // ... valid
  const float c1 = a.x, c2 = a.y, c3 = a.z;
  const float lmx = a.w - tx0;
  const float lmy = b.x - ty0;
  dst[0] = 0.5f * c1;
  dst[1] = 0.5f * c3;
  dst[2] = c2;
  dst[3] = -(c1 * lmx + c2 * lmy);
  dst[4] = -(c2 * lmx + c3 * lmy);
  dst[5] = 0.5f * c1 * lmx * lmx + 0.5f * c3 * lmy * lmy + c2 * lmx * lmy;
  dst[6] = b.y;
  dst[7] = b.z;
  dst[8] = b.w;
  dst[9] = c.x;
  dst[10] = d.w;
}

__global__ void __launch_bounds__(kPix)
tile_table_forward_kernel(const float* __restrict__ raw,
                          const int* __restrict__ counts,
                          float* __restrict__ out,
                          int K, int tb_x, int H, int W) {
  __shared__ float rows[kChunk][kRow];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int tx = t % tb_x, ty = t / tb_x;
  const float tx0 = static_cast<float>(tx * kBlock);
  const float ty0 = static_cast<float>(ty * kBlock);
  const float px = static_cast<float>(p % kBlock);
  const float py = static_cast<float>(p / kBlock);
  const float pxy = px * py, px2 = px * px, py2 = py * py;

  int n = counts[t];
  n = n < 0 ? 0 : (n > K ? K : n);
  const float* base = raw + static_cast<size_t>(t) * K * kCols;
  const float thresh = 1.0f / 255.0f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int m = min(kChunk, n - c0);
    if (p < m) stage_row(base + static_cast<size_t>(c0 + p) * kCols, tx0, ty0, rows[p]);
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float* r = rows[j];
      if (!(r[10] > 0.f)) continue;            // sentinel row (uniform branch)
      float s = r[5];
      s = fmaf(r[4], py, s);
      s = fmaf(r[3], px, s);
      s = fmaf(r[2], pxy, s);
      s = fmaf(r[1], py2, s);
      s = fmaf(r[0], px2, s);
      const float alpha = fminf(1.0f, r[9] * expf(-s));
      if (s >= 0.f && alpha >= thresh) {
        acc_r = fmaf(alpha, r[6], acc_r);
        acc_g = fmaf(alpha, r[7], acc_g);
        acc_b = fmaf(alpha, r[8], acc_b);
      }
    }
    __syncthreads();
  }

  const int x = tx * kBlock + (p % kBlock);
  const int y = ty * kBlock + (p / kBlock);
  if (x < W && y < H) {
    float* o = out + (static_cast<size_t>(y) * W + x) * 3;
    o[0] = acc_r;
    o[1] = acc_g;
    o[2] = acc_b;
  }
}

}  // namespace

extern "C" int tile_table_forward(const float* raw, const int* counts, float* out,
                                  int T, int K, int tb_x, int H, int W,
                                  void* stream) {
  if (T > 0) {
    tile_table_forward_kernel<<<T, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        raw, counts, out, K, tb_x, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
