// Kernel D — tile_table_backward: the backward of the binned, capped render.
//
// Replaces, in the JAX package's VJP of rasterize_pallas
// (gaussianimage_plus_tpu/kernels/raster_pallas.py _rp_bwd :405-465):
//   _run_bwd / _make_bwd_kernel (:241-261, body :151-204), TPU kernel #2: the
//     per-(tile, slot) gradient payload over the gathered [T, K, 16] table
//     (here read through the slot ids from the [N+1, 16] attribute table);
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
// Design, three kernels on one stream (blocks run in parallel, so a sum
// across tiles needs a second pass):
//   stage 0, one block: start[t], the exclusive sum of the clamped counts,
//     which numbers the live (tile, slot) pairs tile-major.
//   stage 1, a persistent grid walking those numbers 32 live slots at a
//     time (a binary search in start finds a slot's tile; the slot's row is
//     table[ids[t, s]], the same L2-resident rows kernel A reads):
//     8 threads per slot, thread j summing the pixels j, j + 8, ... (32, in
//     a fixed order, unrolled for independent work in flight); the ten
//     partials of a slot's 8 threads meet in a fixed 3-step butterfly of
//     shuffles, and the slot's payload row [T, K, 9] is written. So every
//     block holds 32 live slots whatever the tiles' occupancy (a tile of 159
//     slots spreads over five blocks), and the cross-lane sum is 30
//     shuffles for 32 pixels of work. The pixel loop is unrolled, so each
//     thread's pixel features are constants. The cotangent is read through L1,
//     where the 8 threads of a slot and the slots of one tile share it.
//   stage 2, one warp per Gaussian: lane l takes the tiles l, l + 32, ... of
//     the Gaussian's tile bbox (tile_bbox of the projected radii, the
//     binner's membership rectangle) in row-major order, binary-searches
//     the Gaussian's id among the tile's ascending, front-packed
//     ids[t, :counts[t]] and adds the payload row where found; a fixed
//     butterfly then sums the 32 lanes. The searches of one Gaussian run in
//     parallel, so a bbox of 81 tiles costs three searches, not 81 in a row.
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
// passes the payload and slot-offset scratch), run on the caller's stream and
// do not synchronise; the C entry point returns the first cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;
constexpr int kCols = 16;
constexpr int kWarp = 32;
constexpr int kScanThreads = 1024;          // stage 0
constexpr int kScanLoads = 8;               // counts in flight per stage-0 thread
constexpr int kSlotThreads = 8;             // stage-1 threads per live slot
constexpr int kSlotsPerBlock = 32;
constexpr int kThreads = kSlotThreads * kSlotsPerBlock;
constexpr int kPixPerThread = kPix / kSlotThreads;   // 32
constexpr int kPart = 10;                   // partial sums per slot
constexpr int kPay = 9;                     // payload columns
constexpr int kGatherWarps = 8;             // stage-2 Gaussians per block

__device__ __forceinline__ int live_count(const int* counts, int t, int K) {
  const int n = counts[t];
  return n < 0 ? 0 : (n > K ? K : n);
}

// start[t] = live slots in the tiles before t (counts clamped to [0, K]);
// start[T] = all live slots. One block scans 1024 tiles at a time.
__global__ void __launch_bounds__(kScanThreads)
slot_start_kernel(const int* __restrict__ counts, int* __restrict__ start, int T, int K) {
  __shared__ int warp_sum[kScanThreads / kWarp];
  __shared__ int carry;
  const int i = threadIdx.x, lane = i % kWarp, warp = i / kWarp;
  if (i == 0) carry = 0;
  for (int base0 = 0; base0 < T; base0 += kScanLoads * kScanThreads) {
    int n[kScanLoads];
#pragma unroll
    for (int k = 0; k < kScanLoads; ++k) {    // issue the loads together
      const int t = base0 + k * kScanThreads + i;
      n[k] = t < T ? live_count(counts, t, K) : 0;
    }
#pragma unroll
    for (int k = 0; k < kScanLoads; ++k) {
      int x = n[k];                          // inclusive sum within the warp
#pragma unroll
      for (int off = 1; off < kWarp; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      __syncthreads();                       // the previous round read warp_sum and carry
      if (lane == kWarp - 1) warp_sum[warp] = x;
      __syncthreads();
      if (warp == 0) {                       // inclusive sum over the warps
        int w = warp_sum[lane];
#pragma unroll
        for (int off = 1; off < kWarp; off <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, w, off);
          if (lane >= off) w += y;
        }
        warp_sum[lane] = w;
      }
      __syncthreads();
      const int excl = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + x - n[k];
      const int t = base0 + k * kScanThreads + i;
      if (t < T) start[t] = excl;
      __syncthreads();
      if (i == kScanThreads - 1) carry = excl + n[k];
    }
  }
  __syncthreads();
  if (i == 0) start[T] = carry;
}

__global__ void __launch_bounds__(kThreads, 4)
tile_payload_kernel(const float* __restrict__ table,
                    const int* __restrict__ ids,
                    const int* __restrict__ start,
                    const float* __restrict__ v_img,
                    float* __restrict__ payload,
                    int T, int N, int K, int tb_x, int H, int W) {
  const int n_items = start[T];
  const int ls = threadIdx.x / kSlotThreads, sub = threadIdx.x % kSlotThreads;
  const float thresh = 1.0f / 255.0f;
  // this thread's pixels p = sub + 8 k: columns sub and sub + 8, row k / 2
  const float pxa = static_cast<float>(sub), pxb = static_cast<float>(sub + kSlotThreads);
  const float px2a = pxa * pxa, px2b = pxb * pxb;
  for (int base = blockIdx.x * kSlotsPerBlock; base < n_items;
       base += gridDim.x * kSlotsPerBlock) {     // uniform across the block
    const int it = base + ls;
    float acc[kPart];
#pragma unroll
    for (int k = 0; k < kPart; ++k) acc[k] = 0.f;
    float c1 = 0.f, c2 = 0.f, c3 = 0.f, lmx = 0.f, lmy = 0.f;
    size_t flat = 0;
    if (it < n_items) {
      int lo = 0, hi = T;                    // the tile: start[t] <= it < start[t + 1]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (start[mid] <= it) lo = mid; else hi = mid;
      }
      const int t = lo;
      flat = static_cast<size_t>(t) * K + (it - start[t]);
      const int tx = t % tb_x, ty = t / tb_x;
      const float tx0 = static_cast<float>(tx * kBlock);
      const float ty0 = static_cast<float>(ty * kBlock);
      int id = ids[flat];
      id = static_cast<unsigned>(id) > static_cast<unsigned>(N) ? N : id;   // else the sentinel
      const float4* row = reinterpret_cast<const float4*>(table + static_cast<size_t>(id) * kCols);
      const float4 a = row[0];   // c1 c2 c3 mx
      const float4 b = row[1];   // my r g b
      const float4 o = row[2];   // opac ...
      const float4 d = row[3];   // ... valid
      c1 = a.x; c2 = a.y; c3 = a.z;
      const float opac = o.x;
      lmx = a.w - tx0;
      lmy = b.x - ty0;
      // kernel A's stage_row expressions, one rounding per operation
      const float w0 = 0.5f * c1, w1 = 0.5f * c3, w2 = c2;
      const float w3 = -(c1 * lmx + c2 * lmy);
      const float w4 = -(c2 * lmx + c3 * lmy);
      const float w5 = 0.5f * c1 * lmx * lmx + 0.5f * c3 * lmy * lmy + c2 * lmx * lmy;
      const int h_in = H - ty * kBlock;      // rows on the image
      const bool in_a = sub < W - tx * kBlock, in_b = sub + kSlotThreads < W - tx * kBlock;
      const float* va = v_img + (static_cast<size_t>(ty * kBlock) * W + tx * kBlock + sub) * 3;
      const float* vb = va + kSlotThreads * 3;
      if (d.w > 0.f) {
#pragma unroll
        for (int k = 0; k < kPixPerThread; ++k) {
          const bool second = k % 2 != 0;
          const int pyi = k / 2;
          if (!(second ? in_b : in_a) || pyi >= h_in) continue;   // zero cotangent
          const float* v = (second ? vb : va) + static_cast<size_t>(pyi) * W * 3;
          const float v0 = __ldg(v), v1 = __ldg(v + 1), v2 = __ldg(v + 2);
          const float px = second ? pxb : pxa, px2 = second ? px2b : px2a;
          const float py = static_cast<float>(pyi), py2 = py * py;
          const float pxy = px * py;
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
          acc[0] = fmaf(alpha, v0, acc[0]);
          acc[1] = fmaf(alpha, v1, acc[1]);
          acc[2] = fmaf(alpha, v2, acc[2]);
          const float v_sigma = -(opac * vis) * v_alpha;
          acc[3] = fmaf(vis, v_alpha, acc[3]);
          acc[4] = fmaf(v_sigma, px2, acc[4]);
          acc[5] = fmaf(v_sigma, py2, acc[5]);
          acc[6] = fmaf(v_sigma, pxy, acc[6]);
          acc[7] = fmaf(v_sigma, px, acc[7]);
          acc[8] = fmaf(v_sigma, py, acc[8]);
          acc[9] += v_sigma;
        }
      }
    }
    // fixed butterfly over the slot's 8 threads: each ends with the sums
#pragma unroll
    for (int k = 0; k < kPart; ++k) {
#pragma unroll
      for (int off = kSlotThreads / 2; off > 0; off >>= 1)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    }
    if (it < n_items && sub == 0) {
      const float Sxx = acc[4], Syy = acc[5], Sxy = acc[6], Sx = acc[7], Sy = acc[8], S1 = acc[9];
      const float mom_x = lmx * S1 - Sx;
      const float mom_y = lmy * S1 - Sy;
      float* dst = payload + flat * kPay;
      dst[0] = c1 * mom_x + c2 * mom_y;
      dst[1] = c2 * mom_x + c3 * mom_y;
      dst[2] = 0.5f * (lmx * lmx * S1 - 2.0f * lmx * Sx + Sxx);
      dst[3] = 0.5f * (lmx * lmy * S1 - lmx * Sy - lmy * Sx + Sxy);
      dst[4] = 0.5f * (lmy * lmy * S1 - 2.0f * lmy * Sy + Syy);
      dst[5] = acc[0];
      dst[6] = acc[1];
      dst[7] = acc[2];
      dst[8] = acc[3];
    }
  }
}

__global__ void __launch_bounds__(kWarp * kGatherWarps)
payload_gather_kernel(const int* __restrict__ ids,
                      const int* __restrict__ counts,
                      const int4* __restrict__ bbox,
                      const float* __restrict__ payload,
                      float* __restrict__ out,
                      int N, int K, int tb_x, int tb_y) {
  const int g = blockIdx.x * kGatherWarps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (g >= N) return;                        // uniform across the warp
  const int4 bb = bbox[g];                   // xmin xmax ymin ymax (tiles)
  const int x0 = max(bb.x, 0), x1 = min(bb.y, tb_x);
  const int y0 = max(bb.z, 0), y1 = min(bb.w, tb_y);
  const int bw = max(x1 - x0, 0);
  const int area = bw * max(y1 - y0, 0);
  float acc[kPay];
#pragma unroll
  for (int i = 0; i < kPay; ++i) acc[i] = 0.f;
  for (int j = lane; j < area; j += kWarp) {
    const int t = (y0 + j / bw) * tb_x + x0 + j % bw;
    int n = counts[t];
    n = n < 0 ? 0 : (n > K ? K : n);
    const int* row = ids + static_cast<size_t>(t) * K;
    int lo = 0, hi = n;                      // first slot whose id >= g
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
  // fixed butterfly: every lane ends with the same sums
#pragma unroll
  for (int i = 0; i < kPay; ++i) {
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  float mine = acc[0];
#pragma unroll
  for (int i = 1; i < kPay; ++i) mine = lane == i ? acc[i] : mine;
  if (lane < kPay) out[static_cast<size_t>(g) * kPay + lane] = mine;
}

// Stage 1's persistent grid on this device: as many blocks as the card keeps
// resident at once, found once per device.
cudaError_t resident_blocks(int* blocks) {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tile_payload_kernel,
                                                            kThreads, 0)) != cudaSuccess)
    return err;
  *blocks = max(1, sms * per_sm);
  if (dev < kDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

}  // namespace

extern "C" int tile_table_backward(const float* table, const int* counts, const int* ids,
                                   const int* bbox, const float* v_img, float* payload,
                                   int* start, float* out, int T, int K, int N, int tb_x,
                                   int tb_y, int H, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T > 0 && K > 0) {
    slot_start_kernel<<<1, kScanThreads, 0, st>>>(counts, start, T, K);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    int resident = 0;
    if ((err = resident_blocks(&resident)) != cudaSuccess) return static_cast<int>(err);
    const int blocks = min(resident, (T * K + kSlotsPerBlock - 1) / kSlotsPerBlock);
    tile_payload_kernel<<<blocks, kThreads, 0, st>>>(table, ids, start, v_img, payload, T, N,
                                                      K, tb_x, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (N > 0) {
    const int blocks = (N + kGatherWarps - 1) / kGatherWarps;
    payload_gather_kernel<<<blocks, kWarp * kGatherWarps, 0, st>>>(
        ids, counts, reinterpret_cast<const int4*>(bbox), payload, out, N, K, tb_x, tb_y);
  }
  return static_cast<int>(cudaGetLastError());
}
