// Kernel D — tile_table_backward: the backward of the binned, capped render.
//
// Replaces, in the JAX package's VJP of rasterize_pallas
// (gaussianimage_plus_tpu/kernels/raster_pallas.py _rp_bwd :405-465):
//   _run_bwd / _make_bwd_kernel (:241-261, body :151-204), TPU kernel #2: the
//     per-(tile, slot) gradient payload over the gathered [T, K, 16] table;
//   the occupancy-tiered 9-channel scatter-add (:426-440) and the inverse-map
//     _gather_grads (:364-402): the per-Gaussian sum of that payload.
// Per (tile t, slot s < counts[t]) it sums over the tile's pixels, where the
// forward's gate holds (sigma >= 0, alpha >= 1/255, valid), the reference's
// gradient (backward.cu:1297-1320):
//   v_alpha = rgb . v_out            v_rgb  += alpha * v_out
//   v_sigma = -(opac * vis) * v_alpha   (through the saturated min)
//   v_opac += vis * v_alpha          M[f]   += v_sigma * phi_f(p)
// with phi = [px^2, py^2, px*py, px, py, 1] in tile-local coordinates, and
// turns the six moments into v_conic (half off-diagonal) and v_xy
// (raster_pallas.py:189-197). Output: out [N, 9] = per Gaussian, the sum of
// its payload rows [v_xy(2), v_conic(3), v_rgb(3), v_opac] over the tiles
// whose first counts[t] slots hold it.
//
// Design, two kernels on one stream (blocks run in parallel, so a sum across
// tiles needs a second pass):
//   stage 1, one block per tile: the tile's cotangent goes into shared memory
//     once; each of the 8 warps takes the tile's slots in turn, its lanes
//     stride the 256 pixels (8 each), and a fixed butterfly of shuffles sums
//     the ten partials; lane 0 writes the slot's payload row [T, K, 9].
//   stage 2, one thread per Gaussian: it walks the tiles of its tile bbox
//     (tile_bbox of the projected radii, the binner's membership rectangle) in
//     row-major order, binary-searches its id among the tile's ascending,
//     front-packed ids[t, :counts[t]], and adds the payload row where found.
// No float atomics: every sum runs in a fixed order, so two launches give the
// same bits. The walk is exact for any bbox size, so the JAX package's
// gather_tiles budget and its scatter fallback have no counterpart here.
//
// Bound on this card: operations in stage 1 — the gate (5 FMAs, an exp, a
// product and a min: 13) at every (slot, pixel) pair on the image and 26 more
// float32 operations at each pair that passes it (as kernel C); stage 2 is
// bytes: the ids it searches and the payload rows it adds. No tensor cores:
// TF32 would flip the sigma >= 0 gate.
//
// Arithmetic contract with the plain PyTorch version
// (kernels/raster_binned.py tile_table_backward_plain, core/render_tiled.py
// tile_payload): -fmad=false, and w and sigma are kernel A's expressions and
// explicit fmaf chain, so a slot passes the gate here exactly when it
// contributed to kernel A's image. The kernels allocate nothing (the wrapper
// passes the payload scratch), run on the caller's stream and do not
// synchronise; the C entry point returns the first cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;
constexpr int kCols = 16;
constexpr int kWarp = 32;
constexpr int kWarps = 8;                   // warps per stage-1 block
constexpr int kPixPerLane = kPix / kWarp;   // 8
constexpr int kPay = 9;                     // payload columns
constexpr int kGatherThreads = 128;

// Butterfly sum: every lane ends with the same value, in a fixed order.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarp * kWarps)
tile_payload_kernel(const float* __restrict__ raw,
                    const int* __restrict__ counts,
                    const float* __restrict__ v_img,
                    float* __restrict__ payload,
                    int K, int tb_x, int H, int W) {
  __shared__ float vo[kPix][3];   // the tile's cotangent, zero off the image
  const int t = blockIdx.x;
  const int tx = t % tb_x, ty = t / tb_x;
  for (int p = threadIdx.x; p < kPix; p += blockDim.x) {
    const int x = tx * kBlock + p % kBlock;
    const int y = ty * kBlock + p / kBlock;
    const bool in = x < W && y < H;
    const float* src = v_img + (static_cast<size_t>(y) * W + x) * 3;
    vo[p][0] = in ? src[0] : 0.f;
    vo[p][1] = in ? src[1] : 0.f;
    vo[p][2] = in ? src[2] : 0.f;
  }
  __syncthreads();

  int n = counts[t];
  n = n < 0 ? 0 : (n > K ? K : n);
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const float tx0 = static_cast<float>(tx * kBlock);
  const float ty0 = static_cast<float>(ty * kBlock);
  const float thresh = 1.0f / 255.0f;
  // this lane's pixels: p = lane + 32 k -> px = lane % 16, py = lane / 16 + 2 k
  const int pxi = lane % kBlock;
  const float px = static_cast<float>(pxi);
  const float px2 = px * px;
  const bool col_in = tx * kBlock + pxi < W;

  for (int s = warp; s < n; s += kWarps) {
    const float4* row = reinterpret_cast<const float4*>(
        raw + (static_cast<size_t>(t) * K + s) * kCols);
    const float4 a = row[0];   // c1 c2 c3 mx
    const float4 b = row[1];   // my r g b
    const float4 o = row[2];   // opac ...
    const float4 d = row[3];   // ... valid
    const float c1 = a.x, c2 = a.y, c3 = a.z, opac = o.x;
    const float lmx = a.w - tx0;
    const float lmy = b.x - ty0;
    // kernel A's stage_row expressions, one rounding per operation
    const float w0 = 0.5f * c1, w1 = 0.5f * c3, w2 = c2;
    const float w3 = -(c1 * lmx + c2 * lmy);
    const float w4 = -(c2 * lmx + c3 * lmy);
    const float w5 = 0.5f * c1 * lmx * lmx + 0.5f * c3 * lmy * lmy + c2 * lmx * lmy;
    const bool valid = d.w > 0.f;            // uniform across the warp
    float s_r = 0.f, s_g = 0.f, s_b = 0.f, s_o = 0.f;
    float m_xx = 0.f, m_yy = 0.f, m_xy = 0.f, m_x = 0.f, m_y = 0.f, m_1 = 0.f;
#pragma unroll
    for (int k = 0; k < kPixPerLane; ++k) {
      const int pyi = lane / kBlock + 2 * k;
      if (!valid || !col_in || ty * kBlock + pyi >= H) continue;   // zero cotangent
      const float* v = vo[pyi * kBlock + pxi];
      const float v0 = v[0], v1 = v[1], v2 = v[2];
      const float py = static_cast<float>(pyi);
      const float pxy = px * py, py2 = py * py;
      float sg = w5;
      sg = fmaf(w4, py, sg);
      sg = fmaf(w3, px, sg);
      sg = fmaf(w2, pxy, sg);
      sg = fmaf(w1, py2, sg);
      sg = fmaf(w0, px2, sg);
      const float vis = expf(-sg);
      const float alpha = fminf(1.0f, opac * vis);
      if (!(sg >= 0.f && alpha >= thresh)) continue;
      const float v_alpha = b.y * v0 + b.z * v1 + b.w * v2;
      s_r = fmaf(alpha, v0, s_r);
      s_g = fmaf(alpha, v1, s_g);
      s_b = fmaf(alpha, v2, s_b);
      const float v_sigma = -(opac * vis) * v_alpha;
      s_o = fmaf(vis, v_alpha, s_o);
      m_xx = fmaf(v_sigma, px2, m_xx);
      m_yy = fmaf(v_sigma, py2, m_yy);
      m_xy = fmaf(v_sigma, pxy, m_xy);
      m_x = fmaf(v_sigma, px, m_x);
      m_y = fmaf(v_sigma, py, m_y);
      m_1 += v_sigma;
    }
    s_r = warp_sum(s_r);
    s_g = warp_sum(s_g);
    s_b = warp_sum(s_b);
    s_o = warp_sum(s_o);
    const float Sxx = warp_sum(m_xx), Syy = warp_sum(m_yy), Sxy = warp_sum(m_xy);
    const float Sx = warp_sum(m_x), Sy = warp_sum(m_y), S1 = warp_sum(m_1);
    if (lane == 0) {
      const float mom_x = lmx * S1 - Sx;
      const float mom_y = lmy * S1 - Sy;
      float* dst = payload + (static_cast<size_t>(t) * K + s) * kPay;
      dst[0] = c1 * mom_x + c2 * mom_y;
      dst[1] = c2 * mom_x + c3 * mom_y;
      dst[2] = 0.5f * (lmx * lmx * S1 - 2.0f * lmx * Sx + Sxx);
      dst[3] = 0.5f * (lmx * lmy * S1 - lmx * Sy - lmy * Sx + Sxy);
      dst[4] = 0.5f * (lmy * lmy * S1 - 2.0f * lmy * Sy + Syy);
      dst[5] = s_r;
      dst[6] = s_g;
      dst[7] = s_b;
      dst[8] = s_o;
    }
  }
}

__global__ void __launch_bounds__(kGatherThreads)
payload_gather_kernel(const int* __restrict__ ids,
                      const int* __restrict__ counts,
                      const int4* __restrict__ bbox,
                      const float* __restrict__ payload,
                      float* __restrict__ out,
                      int N, int K, int tb_x, int tb_y) {
  const int g = blockIdx.x * kGatherThreads + threadIdx.x;
  if (g >= N) return;
  const int4 bb = bbox[g];                   // xmin xmax ymin ymax (tiles)
  const int x0 = max(bb.x, 0), x1 = min(bb.y, tb_x);
  const int y0 = max(bb.z, 0), y1 = min(bb.w, tb_y);
  float acc[kPay];
#pragma unroll
  for (int i = 0; i < kPay; ++i) acc[i] = 0.f;
  for (int ty = y0; ty < y1; ++ty) {
    for (int tx = x0; tx < x1; ++tx) {
      const int t = ty * tb_x + tx;
      int n = counts[t];
      n = n < 0 ? 0 : (n > K ? K : n);
      const int* row = ids + static_cast<size_t>(t) * K;
      int lo = 0, hi = n;                    // first slot whose id >= g
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (row[mid] < g) lo = mid + 1; else hi = mid;
      }
      if (lo < n && row[lo] == g) {
        const float* p = payload + (static_cast<size_t>(t) * K + lo) * kPay;
#pragma unroll
        for (int i = 0; i < kPay; ++i) acc[i] += p[i];
      }
    }
  }
  float* dst = out + static_cast<size_t>(g) * kPay;
#pragma unroll
  for (int i = 0; i < kPay; ++i) dst[i] = acc[i];
}

}  // namespace

extern "C" int tile_table_backward(const float* raw, const int* counts, const int* ids,
                                   const int* bbox, const float* v_img, float* payload,
                                   float* out, int T, int K, int N, int tb_x, int tb_y,
                                   int H, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T > 0 && K > 0) {
    tile_payload_kernel<<<T, kWarp * kWarps, 0, st>>>(raw, counts, v_img, payload,
                                                       K, tb_x, H, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (N > 0) {
    const int blocks = (N + kGatherThreads - 1) / kGatherThreads;
    payload_gather_kernel<<<blocks, kGatherThreads, 0, st>>>(
        ids, counts, reinterpret_cast<const int4*>(bbox), payload, out, N, K, tb_x, tb_y);
  }
  return static_cast<int>(cudaGetLastError());
}
