// Kernel B — chunk_list_forward: the cap-free chunk-list forward rasterizer.
//
// Replaces two TPU kernels of the JAX package that compute the same function
// (they differ only in the TPU vector-register layout of the table):
//   gaussianimage_plus_tpu/kernels/raster_list_pallas.py
//     rasterize_list_pallas   / _make_list_kernel    (row-major, kc = 64)
//     rasterize_list_t_pallas / _make_list_t_kernel  (lane-major, kc = 128)
// and, through its chunk-enumeration arguments, the dense, sweep and range
// forwards of raster_dense_pallas.py. Tile t visits the chunks
// lst[t, :cnt[t]] and then the residual interval [lo2[t], hi2[t]) of the
// row-major [Np, 16] attribute table, kc rows per chunk, and re-tests each
// row's membership: the tile lies inside the row's [xmin, xmax) x
// [ymin, ymax) tile bbox and the row is valid. Members blend exactly as in
// kernel A (reference forward.cu:650-668), in visiting order, which is
// ascending row order for every enumeration the port builds. The output is
// the unclamped [H, W, 3] image, ragged edge masked.
//
// Design: one block per tile, 256 threads, one pixel each. The visited rows
// are one flat sequence (chunk after chunk), taken 256 at a time: each
// thread tests one row (bbox first, the table row only for a row inside the
// bbox), a warp ballot and a per-warp prefix in shared memory compact the
// members, and each member stages its quadratic coefficients w (the
// raster_pallas.py:105-111 expressions), colour and opacity as float4s into
// a shared list, in visiting order. The blend then loops over members only.
// The list holds kList members: when the next pass might not fit, the list
// is blended and emptied first, so a tile may hold any number of members
// and none is dropped. The next pass's bbox loads, and the current pass's
// table-row loads, are issued before that blend, so their latency hides
// behind it. The lane-major transpose of list_t is a TPU layout and is not
// carried over. No tensor cores (see kernel A).
//
// Bound on this card: operations — one exp and ~10 FMAs per (member, pixel)
// pair; the table is read once per visit (16 B of bbox a row, 64 B more for
// a row inside the bbox).
//
// Arithmetic contract with the plain PyTorch version (kernels/raster_list.py
// chunk_list_forward_plain, which blends with core/render_tiled.py): the same
// as kernel A — -fmad=false, and sigma is the same explicit fmaf chain. The
// kernel allocates nothing, runs on the caller's stream and does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;   // threads per block, rows per pass
constexpr int kWarps = kPix / 32;
constexpr int kCols = 16;
constexpr int kMaxChunk = 128;
constexpr int kList = 2 * kPix;         // staged members before a blend

struct Tile {
  const int* lst;   // this tile's chunk list
  int n_list;       // listed chunks visited
  int lo;           // residual interval, clipped to [0, nch)
  int n_rows;       // visited rows in all
  int kc;
};

// Table row of visited row i of the tile, or -1 past the end or in a chunk
// outside the table.
__device__ __forceinline__ int visited_row(const Tile& v, int i, int nch) {
  if (i >= v.n_rows) return -1;
  const int k = i / v.kc;
  const int c = k < v.n_list ? v.lst[k] : v.lo + (k - v.n_list);
  return (c >= 0 && c < nch) ? c * v.kc + (i - k * v.kc) : -1;
}

// At most 40 registers a thread, so that six blocks share an SM.
__global__ void __launch_bounds__(kPix, 6)
chunk_list_forward_kernel(const float* __restrict__ table,
                          const float* __restrict__ bbox,
                          const int* __restrict__ lst,
                          const int* __restrict__ cnt,
                          const int* __restrict__ lo2,
                          const int* __restrict__ hi2,
                          float* __restrict__ out,
                          int nch, int kc, int lmax, int tb_x, int H, int W) {
  __shared__ float4 s_w[kList];   // w0 w1 w2 w3
  __shared__ float4 s_v[kList];   // w4 w5 r g
  __shared__ float2 s_c[kList];   // b opac
  __shared__ int s_warp[kWarps];  // members of each warp in this pass
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p % 32, warp = p / 32;
  const int tx = t % tb_x, ty = t / tb_x;
  const float txf = static_cast<float>(tx), tyf = static_cast<float>(ty);
  const float tx0 = txf * static_cast<float>(kBlock);
  const float ty0 = tyf * static_cast<float>(kBlock);
  const float px = static_cast<float>(p % kBlock);
  const float py = static_cast<float>(p / kBlock);
  const float pxy = px * py, px2 = px * px, py2 = py * py;
  const float thresh = 1.0f / 255.0f;

  Tile v;
  v.lst = lst + static_cast<size_t>(t) * lmax;
  v.n_list = min(max(cnt[t], 0), lmax);
  v.lo = max(lo2[t], 0);
  v.kc = kc;
  v.n_rows = (v.n_list + max(0, min(hi2[t], nch) - v.lo)) * kc;
  const float4* bbox4 = reinterpret_cast<const float4*>(bbox);

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  auto blend = [&](int n) {
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 w = s_w[j];
      const float4 u = s_v[j];
      const float2 c = s_c[j];
      float s = u.y;
      s = fmaf(u.x, py, s);
      s = fmaf(w.w, px, s);
      s = fmaf(w.z, pxy, s);
      s = fmaf(w.y, py2, s);
      s = fmaf(w.x, px2, s);
      const float alpha = fminf(1.0f, c.y * expf(-s));
      if (s >= 0.f && alpha >= thresh) {
        acc_r = fmaf(alpha, u.z, acc_r);
        acc_g = fmaf(alpha, u.w, acc_g);
        acc_b = fmaf(alpha, c.x, acc_b);
      }
    }
  };

  int row = visited_row(v, p, nch);
  float4 bb = row >= 0 ? bbox4[row] : make_float4(0.f, 0.f, 0.f, 0.f);
  int staged = 0;                          // uniform across the block
  for (int base = 0; base < v.n_rows; base += kPix) {
    const bool in_box = row >= 0 && txf >= bb.x && txf < bb.y && tyf >= bb.z && tyf < bb.w;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a, o = a, d = a;
    if (in_box) {
      const float4* src = reinterpret_cast<const float4*>(table + static_cast<size_t>(row) * kCols);
      a = src[0];   // c1 c2 c3 mx
      b = src[1];   // my r g b
      o = src[2];   // opac ...
      d = src[3];   // ... valid
    }
    const int row_next = visited_row(v, base + kPix + p, nch);
    const float4 bb_next = row_next >= 0 ? bbox4[row_next] : make_float4(0.f, 0.f, 0.f, 0.f);
    if (staged > kList - kPix) {           // this pass might not fit: blend first
      blend(staged);
      staged = 0;
      __syncthreads();
    }
    const bool member = in_box && d.w > 0.f;
    const unsigned ballot = __ballot_sync(0xffffffffu, member);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int pos = staged;
    for (int k = 0; k < kWarps; ++k) {
      const int n = s_warp[k];
      pos += k < warp ? n : 0;
      staged += n;
    }
    if (member) {
      pos += __popc(ballot & ((1u << lane) - 1u));
      const float c1 = a.x, c2 = a.y, c3 = a.z;
      const float lmx = a.w - tx0;
      const float lmy = b.x - ty0;
      const float w3 = -(c1 * lmx + c2 * lmy);
      const float w4 = -(c2 * lmx + c3 * lmy);
      const float w5 = 0.5f * c1 * lmx * lmx + 0.5f * c3 * lmy * lmy + c2 * lmx * lmy;
      s_w[pos] = make_float4(0.5f * c1, 0.5f * c3, c2, w3);
      s_v[pos] = make_float4(w4, w5, b.y, b.z);
      s_c[pos] = make_float2(b.w, o.x);
    }
    __syncthreads();
    row = row_next;
    bb = bb_next;
  }
  blend(staged);

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
