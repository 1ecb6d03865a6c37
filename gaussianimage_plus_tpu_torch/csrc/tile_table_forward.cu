// Kernel A — tile_table_forward: the binned, capped forward rasterizer.
//
// Replaces two TPU kernels of the JAX package, which compute the same
// function on the same pre-gathered [T, K, 16] table:
//   gaussianimage_plus_tpu/kernels/raster_pallas.py      _run_fwd / _make_fwd_kernel
//   gaussianimage_plus_tpu/kernels/raster_flat_pallas.py rasterize_prepared_flat
// For each 16x16 tile t and each pixel p it sums, over the tile's first
// counts[t] slots in slot order, the row table[ids[t, s]]'s
//   rgb * min(1, opac * exp(-sigma)),  sigma = w . phi(p) (tile-local coords)
// skipping rows with sigma < 0, alpha < 1/255 or valid == 0 (reference
// forward.cu:650-668). The output is the unclamped [H, W, 3] image; the
// ragged edge of the tile grid is masked. A slot id outside [0, N] reads the
// all-zero sentinel row N.
//
// Inputs: the [N+1, 16] attribute table and the [T, K] int32 slot ids, not
// the TPU's gathered [T, K, 16] table (25 MB at 768x512, 176 MB at
// 2040x1344, which the gather took 0.24 and 1.73 ms to write). The table is
// 64 B a Gaussian (320 KB at 5,000, 1.28 MB at 20,000) and stays in the
// 50 MB L2, so a block loads its tile's rows through the ids itself.
//
// Design: one block of 128 threads a tile; a thread owns 2 pixels of one
// column, so a warp owns a 16x4 band of the tile. The block starts the loads
// of counts[t] and of its first 128 slot ids together, then each thread
// loads one row (four 16-byte loads) and stages its six quadratic
// coefficients w (the JAX expressions, raster_pallas.py:105-111), its
// colour, opacity and smax = log(255 opac) + 0.01 into shared memory, 128
// rows a pass. Each thread runs the rows two at a time: the sigmas of both
// rows at its 2 pixels are computed first, then, row by row in slot order,
// the exp and the colour sums, unless no pixel of the warp has sigma <=
// smax (one __any_sync a row, so the whole warp takes the same branch).
// Past smax, opac exp(-sigma) < e^-0.01 / 255, far beyond exp's 2-ulp
// error, so a skipped row could not have passed the alpha >= 1/255 gate.
// An invalid row's constant term is staged as NaN, so its sigma is NaN, it
// fails sigma >= 0 and the row loop has no data-dependent exit.
//
// Why this shape (scripts/torch_tile_forward_split.py, device time on an
// H100 80GB HBM3 at 700 W, PERF.md §6): the earlier schedule, one block of
// 256 threads a tile and one pixel a thread, took 0.024 ms at the fit state, of
// which counts, loads and the image write took 0.0056 ms; the rest was the
// row loop, run one row at a time, and the fit state's fullest tiles (153
// live slots, 18 on average) set its length. Four pixels a thread with the
// skip does well at kodim01 (0.0195 ms; 65 slots a tile on average, and the
// skip saves the exp where a Gaussian misses a warp's band) and is fastest
// at 2040x1344 (0.0265; 10,752 tiles, more of them resident at once), but
// a fullest tile's 153 rows then run four pixels deep in each of only two
// warps, and the fit state slows to 0.027 ms. One pixel a thread and eight
// rows in flight is fastest at the fit state (0.0158) and slowest at 2K
// (0.046). Two pixels a thread, two rows in flight and the warp-wide skip
// are the fastest at kodim01 (0.0187 ms) and within 0.0027 ms of the best
// at the fit state (0.0185) and 0.0037 ms at 2K (0.0302): one schedule for
// every state.
//
// Bound on this card: operations, per (slot, pixel) pair on the image 5
// FMAs for sigma, one exp, the opacity product, the min and 3 FMAs for the
// colour sums (19 float32 operations), except at 2040x1344, where the 33 MB
// image it writes is the larger term. No tensor cores: sigma is a rank-6
// dot product per (row, pixel), and TF32 would flip the sigma >= 0 gate.
//
// Arithmetic contract with the plain PyTorch version
// (core/render_tiled.py blend_table_tiles): built with -fmad=false, so w is
// one rounding per operation, and sigma is the explicit fmaf chain below in
// this order; each pixel's colour sums run over its rows in slot order, so
// the kernel is bit-equal to its plain version. The kernel allocates
// nothing, runs on the caller's stream and does not synchronise; the C entry
// point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;
constexpr int kPixPerThread = 2;        // pixels of one column a thread
constexpr int kThreads = kPix / kPixPerThread;
constexpr int kChunk = kThreads;        // rows staged per pass, one a thread
constexpr int kUnroll = 2;              // rows in flight a thread
constexpr int kCols = 16;
constexpr int kRow = 12;                // staged floats per row (11 used)

// w0..w5, r, g, b, opac, smax: one rounding per operation (-fmad=false)
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
  // invalid: sigma is NaN. Overwritten here, not selected above: the select
  // cost 8% at the fit state on the H100.
  if (!(d.w > 0.f)) dst[5] = __int_as_float(0x7fffffff);
  dst[10] = logf(255.0f * c.x) + 0.01f;   // NaN or -inf where opac <= 0: never passes
}

// rows [j, j + U) of the staged chunk at the thread's pixels
template <int U>
__device__ __forceinline__ void blend_rows(const float (*rows)[kRow], int j, float px, float px2,
                                           const float* py, const float* pxy, const float* py2,
                                           float (*acc)[3]) {
  const float thresh = 1.0f / 255.0f;
  float s[U][kPixPerThread];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float4 lo = *reinterpret_cast<const float4*>(rows[j + u]);      // w0 w1 w2 w3
    const float2 hi = *reinterpret_cast<const float2*>(rows[j + u] + 4);  // w4 w5
#pragma unroll
    for (int i = 0; i < kPixPerThread; ++i) {
      float v = hi.y;
      v = fmaf(hi.x, py[i], v);
      v = fmaf(lo.w, px, v);
      v = fmaf(lo.z, pxy[i], v);
      v = fmaf(lo.y, py2[i], v);
      s[u][i] = fmaf(lo.x, px2, v);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {                  // slot order
    const float2 rg = *reinterpret_cast<const float2*>(rows[j + u] + 6);  // r g
    const float4 c = *reinterpret_cast<const float4*>(rows[j + u] + 8);   // b opac smax -
    bool need = false;
#pragma unroll
    for (int i = 0; i < kPixPerThread; ++i) need |= s[u][i] <= c.z;
    if (__any_sync(0xffffffffu, need)) {        // the same branch for the whole warp
#pragma unroll
      for (int i = 0; i < kPixPerThread; ++i) {
        const float alpha = fminf(1.0f, c.y * expf(-s[u][i]));
        if (s[u][i] >= 0.f && alpha >= thresh) {
          acc[i][0] = fmaf(alpha, rg.x, acc[i][0]);
          acc[i][1] = fmaf(alpha, rg.y, acc[i][1]);
          acc[i][2] = fmaf(alpha, c.x, acc[i][2]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
tile_table_forward_kernel(const float* __restrict__ table,
                          const int* __restrict__ ids,
                          const int* __restrict__ counts,
                          float* __restrict__ out,
                          int N, int K, int tb_x, int H, int W) {
  __shared__ __align__(16) float rows[kChunk][kRow];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int tx = t % tb_x, ty = t / tb_x;
  const float tx0 = static_cast<float>(tx * kBlock);
  const float ty0 = static_cast<float>(ty * kBlock);
  const int col = p % kBlock, row0 = (p / kBlock) * kPixPerThread;
  const float px = static_cast<float>(col), px2 = px * px;
  float py[kPixPerThread], pxy[kPixPerThread], py2[kPixPerThread], acc[kPixPerThread][3];
#pragma unroll
  for (int i = 0; i < kPixPerThread; ++i) {
    py[i] = static_cast<float>(row0 + i);
    pxy[i] = px * py[i];
    py2[i] = py[i] * py[i];
    acc[i][0] = acc[i][1] = acc[i][2] = 0.f;
  }
  const int* tids = ids + static_cast<size_t>(t) * K;
  int id = p < K ? tids[p] : N;          // in flight beside counts[t]
  int n = counts[t];
  n = n < 0 ? 0 : (n > K ? K : n);

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int m = min(kChunk, n - c0);
    if (p < m) {
      if (c0 > 0) id = tids[c0 + p];
      id = static_cast<unsigned>(id) > static_cast<unsigned>(N) ? N : id;   // else the sentinel
      stage_row(table + static_cast<size_t>(id) * kCols, tx0, ty0, rows[p]);
    }
    __syncthreads();
    int j = 0;
    for (; j + kUnroll <= m; j += kUnroll) blend_rows<kUnroll>(rows, j, px, px2, py, pxy, py2, acc);
    for (; j < m; ++j) blend_rows<1>(rows, j, px, px2, py, pxy, py2, acc);
    __syncthreads();
  }

  const int x = tx * kBlock + col;
  if (x < W) {
#pragma unroll
    for (int i = 0; i < kPixPerThread; ++i) {
      const int y = ty * kBlock + row0 + i;
      if (y < H) {
        float* o = out + (static_cast<size_t>(y) * W + x) * 3;
        o[0] = acc[i][0];
        o[1] = acc[i][1];
        o[2] = acc[i][2];
      }
    }
  }
}

}  // namespace

extern "C" int tile_table_forward(const float* table, const int* ids, const int* counts,
                                  float* out, int T, int N, int K, int tb_x, int H, int W,
                                  void* stream) {
  if (T > 0) {
    tile_table_forward_kernel<<<T, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        table, ids, counts, out, N, K, tb_x, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
