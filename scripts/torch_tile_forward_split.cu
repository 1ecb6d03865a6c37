// Variants of kernel A (csrc/tile_table_forward.cu) for
// scripts/torch_tile_forward_split.py: where the kernel's time goes, and
// which schedule suits the card. Not part of the package; every variant
// computes kernel A's function (or, for the split, a part of its work).
//
// parent<MODE, IDS>: kernel A's earlier schedule (one block of 256
//   threads a tile, one pixel a thread, rows staged 64 at a time, one row at
//   a time with a data-dependent skip of invalid rows). IDS = false reads the
//   gathered [T, K, 16] table, IDS = true the [N+1, 16] table through the
//   slot ids. MODE: kFull the kernel; kEmpty only counts[t] and the image
//   write; kLoads counts, ids and rows staged, no blend; kArith synthetic
//   rows staged from registers (no row loads) and the full blend.
// multi<P, U, SKIP, MODE>: through the slot ids, 256 / P threads a tile,
//   each thread P pixels of one column (so a warp covers a band of 16 x 2P
//   pixels), the row loop unrolled U rows at a time (the U
//   rows' sigma and alpha in flight together, the colour sums still in slot
//   order), invalid rows folded into the gate (their constant term is NaN,
//   so sigma is NaN and sigma >= 0 fails). SKIP: a row's exp and sums run
//   only where some pixel of the thread has sigma <= smax, the row's bound
//   log(255 opac) + 0.01 past which alpha < 1/255 for certain.
// multi<1, U, group skip>: as multi<1, U>, but the U rows' exps and sums are
//   skipped only when no lane of the warp has a pixel with sigma <= smax in
//   any of them (a warp-uniform branch, so the U rows stay in flight).
// hybrid<L>: a block of 256 threads owns 4 consecutive tiles. A tile of at
//   most L live slots is blended by its own 64 threads as multi<4, 2, skip>
//   (named barriers per 64-thread group); then each tile of more than L
//   slots is blended by all 256 threads as multi<1, 4>, one after another.
// uniform<P, U, G>: as multi<P, U>, with the skip decided once per warp and
//   row (__any_sync over the warp's pixels, so every lane takes the same
//   branch and the U rows' sigmas are all computed before it); a block walks
//   G consecutive tiles, one after another.
//
// All built with -fmad=false, as the package: each variant's kFull output
// is bit-equal to kernel A's plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;
constexpr int kCols = 16;
constexpr int kRow = 12;
enum Mode { kFull = 0, kEmpty = 1, kLoads = 2, kArith = 3 };

__device__ __forceinline__ int guard(int id, int N) {
  return static_cast<unsigned>(id) > static_cast<unsigned>(N) ? N : id;
}

// kernel A's stage_row: one rounding per operation (-fmad=false)
__device__ __forceinline__ void stage_row(const float* __restrict__ src, float tx0, float ty0,
                                          bool fold, float* __restrict__ dst) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  const float4 c = reinterpret_cast<const float4*>(src)[2];
  const float4 d = reinterpret_cast<const float4*>(src)[3];
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
  if (fold) {
    if (!(d.w > 0.f)) dst[5] = __int_as_float(0x7fffffff);
    dst[10] = logf(255.0f * c.x) + 0.01f;
  } else {
    dst[10] = d.w;
  }
}

__device__ __forceinline__ void synthetic_row(int t, int j, float* dst) {
  const float f = static_cast<float>((t * 131 + j * 17) & 255) * (1.0f / 256.0f);
  dst[0] = 0.02f + 0.01f * f;
  dst[1] = 0.03f - 0.01f * f;
  dst[2] = 0.005f * f;
  dst[3] = -0.3f * f;
  dst[4] = -0.2f;
  dst[5] = 1.0f + f;
  dst[6] = f;
  dst[7] = 0.5f;
  dst[8] = 1.0f - f;
  dst[9] = 1.0f;
  dst[10] = 1.0f;
}

template <int MODE, bool IDS>
__global__ void __launch_bounds__(kPix)
parent_kernel(const float* __restrict__ src, const int* __restrict__ ids,
              const int* __restrict__ counts, float* __restrict__ out,
              int N, int K, int tb_x, int H, int W, int T) {
  constexpr int kChunk = 64;
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
  const float thresh = 1.0f / 255.0f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  if (MODE == kEmpty) {
    acc_r = static_cast<float>(n);
  } else {
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      const int m = min(kChunk, n - c0);
      if (p < m) {
        if (MODE == kArith) {
          synthetic_row(t, c0 + p, rows[p]);
        } else if (IDS) {
          const int id = guard(ids[static_cast<size_t>(t) * K + c0 + p], N);
          stage_row(src + static_cast<size_t>(id) * kCols, tx0, ty0, false, rows[p]);
        } else {
          stage_row(src + (static_cast<size_t>(t) * K + c0 + p) * kCols, tx0, ty0, false, rows[p]);
        }
      }
      __syncthreads();
      if (MODE == kLoads) {
        acc_r += rows[p % m][5];
      } else {
        for (int j = 0; j < m; ++j) {
          const float* r = rows[j];
          if (!(r[10] > 0.f)) continue;
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
      }
      __syncthreads();
    }
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

// U rows [j, j + U) of the staged chunk, in slot order per pixel
template <int P, int U, bool SKIP>
__device__ __forceinline__ void blend_rows(const float (*rows)[kRow], int j, float px, float px2,
                                           const float* py, const float* pxy, const float* py2,
                                           float (*acc)[3]) {
  const float thresh = 1.0f / 255.0f;
  float s[U][P];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float4 lo = *reinterpret_cast<const float4*>(rows[j + u]);      // w0 w1 w2 w3
    const float2 hi = *reinterpret_cast<const float2*>(rows[j + u] + 4);  // w4 w5
#pragma unroll
    for (int i = 0; i < P; ++i) {
      float v = hi.y;
      v = fmaf(hi.x, py[i], v);
      v = fmaf(lo.w, px, v);
      v = fmaf(lo.z, pxy[i], v);
      v = fmaf(lo.y, py2[i], v);
      s[u][i] = fmaf(lo.x, px2, v);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float4 c = *reinterpret_cast<const float4*>(rows[j + u] + 6 + 2);  // b opac smax pad
    const float2 rg = *reinterpret_cast<const float2*>(rows[j + u] + 6);
    bool any = true;
    if (SKIP) {
      any = false;
#pragma unroll
      for (int i = 0; i < P; ++i) any |= s[u][i] <= c.z;
    }
    if (any) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
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

template <int P, int U, bool SKIP, int MODE>
__global__ void __launch_bounds__(kPix / P)
multi_kernel(const float* __restrict__ table, const int* __restrict__ ids,
             const int* __restrict__ counts, float* __restrict__ out,
             int N, int K, int tb_x, int H, int W, int T) {
  constexpr int kThreads = kPix / P;
  constexpr int kChunk = kThreads;
  __shared__ __align__(16) float rows[kChunk][kRow];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int tx = t % tb_x, ty = t / tb_x;
  const float tx0 = static_cast<float>(tx * kBlock);
  const float ty0 = static_cast<float>(ty * kBlock);
  const int col = p % kBlock, row0 = (p / kBlock) * P;
  const float px = static_cast<float>(col), px2 = px * px;
  float py[P], pxy[P], py2[P], acc[P][3];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    py[i] = static_cast<float>(row0 + i);
    pxy[i] = px * py[i];
    py2[i] = py[i] * py[i];
    acc[i][0] = acc[i][1] = acc[i][2] = 0.f;
  }
  const int* tids = ids + static_cast<size_t>(t) * K;
  int id = p < K ? tids[p] : N;          // in flight beside counts[t]
  int n = counts[t];
  n = n < 0 ? 0 : (n > K ? K : n);
  if (MODE == kEmpty) {
    acc[0][0] = static_cast<float>(n + id);
  } else {
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      const int m = min(kChunk, n - c0);
      if (c0 > 0 && p < m) id = tids[c0 + p];
      if (p < m) {
        if (MODE == kArith) synthetic_row(t, c0 + p, rows[p]);
        else stage_row(table + static_cast<size_t>(guard(id, N)) * kCols, tx0, ty0, true, rows[p]);
      }
      __syncthreads();
      if (MODE == kLoads) {
        acc[0][0] += rows[p % m][5];
      } else {
        int j = 0;
        for (; j + U <= m; j += U) blend_rows<P, U, SKIP>(rows, j, px, px2, py, pxy, py2, acc);
        for (; j < m; ++j) blend_rows<P, 1, SKIP>(rows, j, px, px2, py, pxy, py2, acc);
      }
      __syncthreads();
    }
  }
  const int x = tx * kBlock + col;
  if (x < W) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
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

// one pixel a thread, U rows: their exps and sums skipped when no lane of
// the warp needs any of them
template <int U>
__device__ __forceinline__ void blend_rows_group_skip(const float (*rows)[kRow], int j, float px,
                                                      float px2, float py, float pxy, float py2,
                                                      float* acc) {
  const float thresh = 1.0f / 255.0f;
  float s[U];
  bool need = false;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float* r = rows[j + u];
    float v = r[5];
    v = fmaf(r[4], py, v);
    v = fmaf(r[3], px, v);
    v = fmaf(r[2], pxy, v);
    v = fmaf(r[1], py2, v);
    s[u] = fmaf(r[0], px2, v);
    need |= s[u] <= r[10];
  }
  if (__any_sync(0xffffffffu, need)) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float* r = rows[j + u];
      const float alpha = fminf(1.0f, r[9] * expf(-s[u]));
      if (s[u] >= 0.f && alpha >= thresh) {
        acc[0] = fmaf(alpha, r[6], acc[0]);
        acc[1] = fmaf(alpha, r[7], acc[1]);
        acc[2] = fmaf(alpha, r[8], acc[2]);
      }
    }
  }
}

template <int U>
__global__ void __launch_bounds__(kPix)
group_skip_kernel(const float* __restrict__ table, const int* __restrict__ ids,
                  const int* __restrict__ counts, float* __restrict__ out,
                  int N, int K, int tb_x, int H, int W, int T) {
  __shared__ __align__(16) float rows[kPix][kRow];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int tx = t % tb_x, ty = t / tb_x;
  const float tx0 = static_cast<float>(tx * kBlock);
  const float ty0 = static_cast<float>(ty * kBlock);
  const float px = static_cast<float>(p % kBlock);
  const float py = static_cast<float>(p / kBlock);
  const float pxy = px * py, px2 = px * px, py2 = py * py;
  const int* tids = ids + static_cast<size_t>(t) * K;
  int id = p < K ? tids[p] : N;
  int n = counts[t];
  n = n < 0 ? 0 : (n > K ? K : n);
  float acc[3] = {0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < n; c0 += kPix) {
    const int m = min(kPix, n - c0);
    if (p < m) {
      if (c0 > 0) id = tids[c0 + p];
      stage_row(table + static_cast<size_t>(guard(id, N)) * kCols, tx0, ty0, true, rows[p]);
    }
    __syncthreads();
    int j = 0;
    for (; j + U <= m; j += U) blend_rows_group_skip<U>(rows, j, px, px2, py, pxy, py2, acc);
    for (; j < m; ++j) blend_rows_group_skip<1>(rows, j, px, px2, py, pxy, py2, acc);
    __syncthreads();
  }
  const int x = tx * kBlock + (p % kBlock);
  const int y = ty * kBlock + (p / kBlock);
  if (x < W && y < H) {
    float* o = out + (static_cast<size_t>(y) * W + x) * 3;
    o[0] = acc[0];
    o[1] = acc[1];
    o[2] = acc[2];
  }
}

constexpr int kGroups = 4;                      // tiles a hybrid block
constexpr int kGroupThreads = kPix / kGroups;   // 64

__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kGroupThreads) : "memory");
}

template <int L>
__global__ void __launch_bounds__(kPix)
hybrid_kernel(const float* __restrict__ table, const int* __restrict__ ids,
              const int* __restrict__ counts, float* __restrict__ out,
              int N, int K, int tb_x, int H, int W, int T) {
  __shared__ __align__(16) float rows[kPix][kRow];   // 4 groups x 64 rows, or 256 rows
  __shared__ int n_of[kGroups];
  const int p = threadIdx.x, g = p / kGroupThreads, q = p % kGroupThreads;
  const int t = blockIdx.x * kGroups + g;
  int n = 0, id = N;
  if (t < T) {
    if (q < K) id = ids[static_cast<size_t>(t) * K + q];
    n = counts[t];
    n = n < 0 ? 0 : (n > K ? K : n);
  }
  if (q == 0) n_of[g] = n;
  if (t < T && n <= L) {                        // uniform across the group
    constexpr int P = 4;
    const int tx = t % tb_x, ty = t / tb_x;
    const float tx0 = static_cast<float>(tx * kBlock);
    const float ty0 = static_cast<float>(ty * kBlock);
    const int col = q % kBlock, row0 = (q / kBlock) * P;
    const float px = static_cast<float>(col), px2 = px * px;
    float py[P], pxy[P], py2[P], acc[P][3];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      py[i] = static_cast<float>(row0 + i);
      pxy[i] = px * py[i];
      py2[i] = py[i] * py[i];
      acc[i][0] = acc[i][1] = acc[i][2] = 0.f;
    }
    float (*grows)[kRow] = rows + g * kGroupThreads;
    for (int c0 = 0; c0 < n; c0 += kGroupThreads) {
      const int m = min(kGroupThreads, n - c0);
      if (q < m) {
        if (c0 > 0) id = ids[static_cast<size_t>(t) * K + c0 + q];
        stage_row(table + static_cast<size_t>(guard(id, N)) * kCols, tx0, ty0, true, grows[q]);
      }
      group_sync(g);
      int j = 0;
      for (; j + 2 <= m; j += 2) blend_rows<P, 2, true>(grows, j, px, px2, py, pxy, py2, acc);
      for (; j < m; ++j) blend_rows<P, 1, true>(grows, j, px, px2, py, pxy, py2, acc);
      group_sync(g);
    }
    const int x = tx * kBlock + col;
    if (x < W) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
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
  __syncthreads();
  for (int h = 0; h < kGroups; ++h) {           // uniform across the block
    const int nh = n_of[h];
    if (nh <= L) continue;
    const int th = blockIdx.x * kGroups + h;
    const int tx = th % tb_x, ty = th / tb_x;
    const float tx0 = static_cast<float>(tx * kBlock);
    const float ty0 = static_cast<float>(ty * kBlock);
    const float px = static_cast<float>(p % kBlock);
    const float py = static_cast<float>(p / kBlock);
    const float pxy = px * py, px2 = px * px, py2 = py * py;
    float acc[1][3] = {{0.f, 0.f, 0.f}};
    for (int c0 = 0; c0 < nh; c0 += kPix) {
      const int m = min(kPix, nh - c0);
      if (p < m) {
        const int idh = guard(ids[static_cast<size_t>(th) * K + c0 + p], N);
        stage_row(table + static_cast<size_t>(idh) * kCols, tx0, ty0, true, rows[p]);
      }
      __syncthreads();
      int j = 0;
      for (; j + 4 <= m; j += 4) blend_rows<1, 4, false>(rows, j, px, px2, &py, &pxy, &py2, acc);
      for (; j < m; ++j) blend_rows<1, 1, false>(rows, j, px, px2, &py, &pxy, &py2, acc);
      __syncthreads();
    }
    const int x = tx * kBlock + (p % kBlock);
    const int y = ty * kBlock + (p / kBlock);
    if (x < W && y < H) {
      float* o = out + (static_cast<size_t>(y) * W + x) * 3;
      o[0] = acc[0][0];
      o[1] = acc[0][1];
      o[2] = acc[0][2];
    }
  }
}

template <int P, int U>
__device__ __forceinline__ void blend_rows_uniform(const float (*rows)[kRow], int j, float px,
                                                   float px2, const float* py, const float* pxy,
                                                   const float* py2, float (*acc)[3]) {
  const float thresh = 1.0f / 255.0f;
  float s[U][P];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float4 lo = *reinterpret_cast<const float4*>(rows[j + u]);
    const float2 hi = *reinterpret_cast<const float2*>(rows[j + u] + 4);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      float v = hi.y;
      v = fmaf(hi.x, py[i], v);
      v = fmaf(lo.w, px, v);
      v = fmaf(lo.z, pxy[i], v);
      v = fmaf(lo.y, py2[i], v);
      s[u][i] = fmaf(lo.x, px2, v);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float2 rg = *reinterpret_cast<const float2*>(rows[j + u] + 6);
    const float4 c = *reinterpret_cast<const float4*>(rows[j + u] + 8);
    bool any = false;
#pragma unroll
    for (int i = 0; i < P; ++i) any |= s[u][i] <= c.z;
    if (__any_sync(0xffffffffu, any)) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
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

template <int P, int U, int G>
__global__ void __launch_bounds__(kPix / P)
uniform_kernel(const float* __restrict__ table, const int* __restrict__ ids,
               const int* __restrict__ counts, float* __restrict__ out,
               int N, int K, int tb_x, int H, int W, int T) {
  constexpr int kThreads = kPix / P;
  __shared__ __align__(16) float rows[kThreads][kRow];
  const int p = threadIdx.x;
  const int col = p % kBlock, row0 = (p / kBlock) * P;
  const float px = static_cast<float>(col), px2 = px * px;
  float py[P], pxy[P], py2[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    py[i] = static_cast<float>(row0 + i);
    pxy[i] = px * py[i];
    py2[i] = py[i] * py[i];
  }
  for (int g = 0; g < G; ++g) {
    const int t = blockIdx.x * G + g;
    if (t >= T) break;                          // uniform across the block
    const int tx = t % tb_x, ty = t / tb_x;
    const float tx0 = static_cast<float>(tx * kBlock);
    const float ty0 = static_cast<float>(ty * kBlock);
    float acc[P][3];
#pragma unroll
    for (int i = 0; i < P; ++i) acc[i][0] = acc[i][1] = acc[i][2] = 0.f;
    const int* tids = ids + static_cast<size_t>(t) * K;
    int id = p < K ? tids[p] : N;
    int n = counts[t];
    n = n < 0 ? 0 : (n > K ? K : n);
    for (int c0 = 0; c0 < n; c0 += kThreads) {
      const int m = min(kThreads, n - c0);
      if (p < m) {
        if (c0 > 0) id = tids[c0 + p];
        stage_row(table + static_cast<size_t>(guard(id, N)) * kCols, tx0, ty0, true, rows[p]);
      }
      __syncthreads();
      int j = 0;
      for (; j + U <= m; j += U) blend_rows_uniform<P, U>(rows, j, px, px2, py, pxy, py2, acc);
      for (; j < m; ++j) blend_rows_uniform<P, 1>(rows, j, px, px2, py, pxy, py2, acc);
      __syncthreads();
    }
    const int x = tx * kBlock + col;
    if (x < W) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
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
}

typedef void (*Kern)(const float*, const int*, const int*, float*, int, int, int, int, int, int);

struct Variant {
  const char* name;
  Kern fn;
  int threads;
  int tiles_per_block;
};

const Variant kVariants[] = {
    {"parent raw", parent_kernel<kFull, false>, kPix, 1},
    {"parent raw, counts and image write only", parent_kernel<kEmpty, false>, kPix, 1},
    {"parent raw, loads only", parent_kernel<kLoads, false>, kPix, 1},
    {"parent raw, arithmetic only", parent_kernel<kArith, false>, kPix, 1},
    {"parent ids", parent_kernel<kFull, true>, kPix, 1},
    {"ids P1 U4", multi_kernel<1, 4, false, kFull>, kPix, 1},
    {"ids P2 U2", multi_kernel<2, 2, false, kFull>, kPix / 2, 1},
    {"ids P4 U1", multi_kernel<4, 1, false, kFull>, kPix / 4, 1},
    {"ids P4 U2", multi_kernel<4, 2, false, kFull>, kPix / 4, 1},
    {"ids P1 U4 skip", multi_kernel<1, 4, true, kFull>, kPix, 1},
    {"ids P2 U2 skip", multi_kernel<2, 2, true, kFull>, kPix / 2, 1},
    {"ids P4 U1 skip", multi_kernel<4, 1, true, kFull>, kPix / 4, 1},
    {"ids P4 U2 skip", multi_kernel<4, 2, true, kFull>, kPix / 4, 1},
    {"ids P4 U2, counts, ids and image write only", multi_kernel<4, 2, false, kEmpty>, kPix / 4, 1},
    {"ids P4 U2, loads only", multi_kernel<4, 2, false, kLoads>, kPix / 4, 1},
    {"ids P4 U2, arithmetic only", multi_kernel<4, 2, false, kArith>, kPix / 4, 1},
    {"ids P1 U4 group skip", group_skip_kernel<4>, kPix, 1},
    {"ids P1 U8", multi_kernel<1, 8, false, kFull>, kPix, 1},
    {"hybrid L32", hybrid_kernel<32>, kPix, kGroups},
    {"hybrid L48", hybrid_kernel<48>, kPix, kGroups},
    {"hybrid L64", hybrid_kernel<64>, kPix, kGroups},
    {"hybrid L96", hybrid_kernel<96>, kPix, kGroups},
    {"hybrid L128", hybrid_kernel<128>, kPix, kGroups},
    {"uniform P1 U4", uniform_kernel<1, 4, 1>, kPix, 1},
    {"uniform P1 U8", uniform_kernel<1, 8, 1>, kPix, 1},
    {"uniform P2 U2", uniform_kernel<2, 2, 1>, kPix / 2, 1},
    {"uniform P2 U4", uniform_kernel<2, 4, 1>, kPix / 2, 1},
    {"uniform P4 U2", uniform_kernel<4, 2, 1>, kPix / 4, 1},
    {"uniform P1 U4, 2 tiles a block", uniform_kernel<1, 4, 2>, kPix, 2},
    {"uniform P1 U4, 4 tiles a block", uniform_kernel<1, 4, 4>, kPix, 4},
    {"uniform P2 U2, 4 tiles a block", uniform_kernel<2, 2, 4>, kPix / 2, 4},
    {"uniform P4 U2, 4 tiles a block", uniform_kernel<4, 2, 4>, kPix / 4, 4},
};

}  // namespace

extern "C" int variant_count() { return static_cast<int>(sizeof(kVariants) / sizeof(kVariants[0])); }

extern "C" const char* variant_name(int v) { return kVariants[v].name; }

// src: the gathered [T, K, 16] table for "parent raw", else the [N+1, 16] table
extern "C" int run_variant(int v, const float* src, const int* ids, const int* counts, float* out,
                           int T, int N, int K, int tb_x, int H, int W, void* stream) {
  if (T > 0) {
    const Variant& var = kVariants[v];
    const int blocks = (T + var.tiles_per_block - 1) / var.tiles_per_block;
    var.fn<<<blocks, var.threads, 0, static_cast<cudaStream_t>(stream)>>>(src, ids, counts, out,
                                                                       N, K, tb_x, H, W, T);
  }
  return static_cast<int>(cudaGetLastError());
}
