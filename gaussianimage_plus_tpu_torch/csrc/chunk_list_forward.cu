// Kernel B — chunk_list_forward: the cap-free chunk-list forward rasterizer.
//
// Replaces two TPU kernels of the JAX package that compute the same function
// (they differ only in the TPU vector-register layout of the table):
//   gaussianimage_plus_tpu/kernels/raster_list_pallas.py
//     rasterize_list_pallas   / _make_list_kernel    (row-major, kc = 64)
//     rasterize_list_t_pallas / _make_list_t_kernel  (lane-major, kc = 128)
// Tile t visits the chunks lst[t, :cnt[t]] and then the residual interval
// [lo2[t], hi2[t]) of the row-major [Np, 16] attribute table, kc rows per
// chunk, and re-tests each row's membership: the tile lies inside the row's
// [xmin, xmax) x [ymin, ymax) tile bbox and the row is valid. Members blend
// exactly as in kernel A (reference forward.cu:650-668), in ascending row
// order. The output is the unclamped [H, W, 3] image, ragged edge masked.
//
// Design: one block per tile, 256 threads, one pixel each. For each visited
// chunk the first kc threads stage one row each into shared memory — the
// membership flag and the six quadratic coefficients w (raster_pallas.py:
// 105-111 expressions) — then every thread runs the chunk's rows. The
// lane-major transpose of list_t is a TPU layout and is not carried over.
// No tensor cores (see kernel A).
//
// Bound on this card: operations — one exp and ~10 FMAs per (member, pixel)
// pair; the table is read once per visit (80 B a row with its bbox).
//
// Arithmetic contract with the plain PyTorch version (kernels/raster_list.py
// chunk_list_forward_plain, which blends with core/render_tiled.py): the same
// as kernel A — -fmad=false, and sigma is the same explicit fmaf chain. The
// kernel allocates nothing, runs on the caller's stream and does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;   // threads per block
constexpr int kCols = 16;
constexpr int kMaxChunk = 128;
constexpr int kRow = 12;                // staged floats per row (11 used)

__global__ void __launch_bounds__(kPix)
chunk_list_forward_kernel(const float* __restrict__ table,
                          const float* __restrict__ bbox,
                          const int* __restrict__ lst,
                          const int* __restrict__ cnt,
                          const int* __restrict__ lo2,
                          const int* __restrict__ hi2,
                          float* __restrict__ out,
                          int nch, int kc, int lmax, int tb_x, int H, int W) {
  __shared__ float rows[kMaxChunk][kRow];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int tx = t % tb_x, ty = t / tb_x;
  const float txf = static_cast<float>(tx), tyf = static_cast<float>(ty);
  const float tx0 = txf * static_cast<float>(kBlock);
  const float ty0 = tyf * static_cast<float>(kBlock);
  const float px = static_cast<float>(p % kBlock);
  const float py = static_cast<float>(p / kBlock);
  const float pxy = px * py, px2 = px * px, py2 = py * py;
  const float thresh = 1.0f / 255.0f;

  int n_list = cnt[t];
  n_list = n_list < 0 ? 0 : (n_list > lmax ? lmax : n_list);
  const int lo = lo2[t];
  const int n_visit = n_list + max(0, hi2[t] - lo);
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;

  for (int v = 0; v < n_visit; ++v) {
    const int c = v < n_list ? lst[static_cast<size_t>(t) * lmax + v] : lo + (v - n_list);
    if (c < 0 || c >= nch) continue;         // uniform across the block
    if (p < kc) {
      const size_t row = static_cast<size_t>(c) * kc + p;
      const float4* src = reinterpret_cast<const float4*>(table + row * kCols);
      const float4 a = src[0];   // c1 c2 c3 mx
      const float4 b = src[1];   // my r g b
      const float4 o = src[2];   // opac ...
      const float4 d = src[3];   // ... valid
      const float4 bb = reinterpret_cast<const float4*>(bbox)[row];  // xmin xmax ymin ymax
      const bool member = (txf >= bb.x) && (txf < bb.y) && (tyf >= bb.z) &&
                          (tyf < bb.w) && (d.w > 0.f);
      float* dst = rows[p];
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
      dst[9] = o.x;
      dst[10] = member ? 1.f : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kc; ++j) {
      const float* r = rows[j];
      if (!(r[10] > 0.f)) continue;            // not a member (uniform branch)
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

extern "C" int chunk_list_forward(const float* table, const float* bbox,
                                  const int* lst, const int* cnt,
                                  const int* lo2, const int* hi2, float* out,
                                  int T, int nch, int kc, int lmax, int tb_x,
                                  int H, int W, void* stream) {
  if (kc < 1 || kc > kMaxChunk) return static_cast<int>(cudaErrorInvalidValue);
  if (T > 0) {
    chunk_list_forward_kernel<<<T, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        table, bbox, lst, cnt, lo2, hi2, out, nch, kc, lmax, tb_x, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
