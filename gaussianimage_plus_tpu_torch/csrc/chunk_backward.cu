// Kernel C — chunk_backward: the cap-free backward of the chunk-list render.
//
// Replaces three TPU kernels of the JAX package that compute one function
// (they differ only in how the TPU enumerates the (Gaussian, tile) pairs):
//   gaussianimage_plus_tpu/kernels/raster_list_pallas.py
//     list_backward(layout="rows")  / _make_list_bwd_kernel    (#6, kc 64)
//     list_backward(layout="lanes") / _make_list_t_bwd_kernel  (#7, kc 128)
//   gaussianimage_plus_tpu/kernels/raster_dense_pallas.py
//     dense_backward / _make_bwd_kernel  (#9, the exact fallback of #7)
// For every valid row g of the row-major [Np, 16] attribute table and every
// tile t of its [xmin, xmax) x [ymin, ymax) tile bbox (the rows and bbox
// that kernel B reads), it sums over the tile's pixels, where the forward's
// gate holds (sigma >= 0, alpha >= 1/255), the reference's gradient
// (backward.cu:1297-1320):
//   v_alpha = rgb . v_out            v_rgb  += alpha * v_out
//   v_sigma = -(opac * vis) * v_alpha   (through the saturated min)
//   v_opac += vis * v_alpha
//   v_conic = 0.5 * sum v_sigma * [dx^2, dx dy, dy^2]   (half off-diagonal)
//   v_xy    = -[c1 c2; c2 c3] . sum v_sigma * [dx, dy]
// with (dx, dy) the pixel's offset from the Gaussian's centre. Output: the
// payload [Np, 16] = [v_xy(2), v_conic(3), v_rgb(3), v_opac, 0 x 7].
//
// Design: a block of kWarps warps owns kRows consecutive rows. It numbers
// their (row, bbox tile) pairs row by row (a prefix of the rows' bbox areas)
// and gives each warp an equal contiguous share of them, so a row with a
// large bbox is split over several warps and a launch lasts as long as the
// busiest block's mean share, not as long as the largest bbox. Within a
// pair the lanes stride the tile's 256 pixels (8 each) and read the
// cotangent image through L1/L2 (4.7 MB at 768x512: it fits in L2). Each
// lane keeps nine sums over all the pairs of a row that its warp holds, in
// the Gaussian-centred offsets (dx, dy), so the moments need no per-tile
// conversion and one butterfly of shuffles per (warp, row) reduces them,
// where the earlier design ran ten per tile. The warps' partial sums meet in
// shared memory and are added in warp order, so no float atomics are used:
// every sum runs in a fixed order, and two launches on the same inputs give
// the same bits. A lane issues its pixels' cotangent loads for a tile
// before any gate, whatever sigma is, so that their latency hides behind
// the gate; the exp and the sums run only where 0 <= sigma <= smax for some
// lane, with smax = log(255 opac) + 1e-3: past it expf (2 ulp) and the
// product cannot reach 1/255, so the skip drops no pair that passes the
// gate. The TPU's per-chunk tile-block lists and its MTB
// fallback are a TPU layout and are not carried over.
//
// Bound on this card: operations — the gate (5 FMAs, an exp, a product and
// a min: 13) at every (member, pixel) pair on the image, and 26 more float32
// operations at each pair that passes it; bytes are the table, bbox and
// payload (<1 MB) and the image (read once from memory). No tensor cores:
// TF32 would flip the sigma >= 0 gate.
//
// Arithmetic contract with the plain PyTorch version (kernels/raster_list.py
// chunk_backward_plain, core/render_tiled.py tile_payload): -fmad=false, and
// w and sigma are kernel B's expressions and explicit fmaf chain in
// tile-local coordinates, so a pair passes the gate here exactly when it
// contributed to the forward; the sums run in another order and form (the
// plain version converts tile-local moments per tile), within 1e-4 of each
// payload column's largest entry. The kernel allocates nothing, runs on the
// caller's stream and does not synchronise; the C entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;
constexpr int kCols = 16;
constexpr int kSums = 9;
constexpr int kWarp = 32;
constexpr int kWarps = 4;                   // warps per block
constexpr int kRows = 8;                    // table rows per block
constexpr int kPixPerLane = kPix / kWarp;   // 8
static_assert(kRows <= kWarp, "one lane per row sets up the pair numbering");

// Butterfly sum: every lane ends with the same value, in a fixed order.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A row's bbox tiles on the grid: the forward's member test
// (txf >= xmin && txf < xmax) on integer tiles; an invalid row has none.
struct Span {
  int x0, y0, w, h;
};

__device__ __forceinline__ Span row_span(const float* table, const float* bbox, int g,
                                         int tb_x, int tb_y) {
  const float4 bb = reinterpret_cast<const float4*>(bbox)[g];  // xmin xmax ymin ymax
  Span s;
  s.x0 = max(0, static_cast<int>(ceilf(bb.x)));
  s.y0 = max(0, static_cast<int>(ceilf(bb.z)));
  s.w = max(0, min(tb_x, static_cast<int>(ceilf(bb.y))) - s.x0);
  s.h = max(0, min(tb_y, static_cast<int>(ceilf(bb.w))) - s.y0);
  if (!(table[static_cast<size_t>(g) * kCols + kCols - 1] > 0.f)) s.w = s.h = 0;
  return s;
}

__global__ void __launch_bounds__(kWarp * kWarps, 6)
chunk_backward_kernel(const float* __restrict__ table,
                      const float* __restrict__ bbox,
                      const float* __restrict__ v_img,
                      float* __restrict__ out,
                      int Np, int tb_x, int tb_y, int H, int W) {
  __shared__ float s_part[kRows][kWarps][kSums]; // each warp's sums per row
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int r0 = blockIdx.x * kRows;

  // every warp numbers the block's pairs itself (one lane per row), so no
  // barrier stands before the work
  int start = 0;
  {
    int area = 0;
    if (lane < kRows && r0 + lane < Np) {
      const Span s = row_span(table, bbox, r0 + lane, tb_x, tb_y);
      area = s.w * s.h;
    }
    start = area;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, start, off);
      if (lane >= off) start += v;
    }
    start -= area;                           // exclusive: the first pair of row `lane`
  }
  const int total = __shfl_sync(0xffffffffu, start, kRows);
  const int j0 = warp * total / kWarps;
  const int j1 = (warp + 1) * total / kWarps;
  const float thresh = 1.0f / 255.0f;
  // this lane's pixels: p = lane + 32 k -> px = lane % 16, py = lane / 16 + 2 k
  const int pxi = lane % kBlock;
  const float px = static_cast<float>(pxi);
  const float px2 = px * px;

  // the warp writes its sums for every row: zeros where it holds no pair
  for (int rr = 0; rr < kRows; ++rr) {
    const int first = __shfl_sync(0xffffffffu, start, rr);
    const int last = __shfl_sync(0xffffffffu, start, rr + 1);
    if (lane < kSums && max(first, j0) >= min(last, j1)) s_part[rr][warp][lane] = 0.f;
  }
  int r = 0;                                 // the block's row of pair j (warp-uniform)
  while (r < kRows - 1 && __shfl_sync(0xffffffffu, start, r + 1) <= j0) ++r;
  int j = j0;
  while (j < j1) {
    // the warp's pairs of row r: [j, jr)
    const int g = r0 + r;
    const int first = __shfl_sync(0xffffffffu, start, r);
    const int jr = min(j1, __shfl_sync(0xffffffffu, start, r + 1));
    if (jr <= j) {                           // a row without pairs
      ++r;
      continue;
    }
    const Span sp = row_span(table, bbox, g, tb_x, tb_y);
    const float4* row = reinterpret_cast<const float4*>(table + static_cast<size_t>(g) * kCols);
    const float4 a = row[0];   // c1 c2 c3 mx
    const float4 b = row[1];   // my r g b
    const float opac = row[2].x;
    const float c1 = a.x, c2 = a.y, c3 = a.z;
    const float w0 = 0.5f * c1, w1 = 0.5f * c3, w2 = c2;
    const float smax = static_cast<float>(log(255.0 * static_cast<double>(opac))) + 1e-3f;
    float s_r = 0.f, s_g = 0.f, s_b = 0.f, s_o = 0.f;
    float m_xx = 0.f, m_xy = 0.f, m_yy = 0.f, m_x = 0.f, m_y = 0.f;
    const int i0 = j - first;
    int tx = sp.x0 + i0 % sp.w, ty = sp.y0 + i0 / sp.w;
    for (; j < jr; ++j) {
      const float lmx = a.w - static_cast<float>(tx) * static_cast<float>(kBlock);
      const float lmy = b.x - static_cast<float>(ty) * static_cast<float>(kBlock);
      const float w3 = -(c1 * lmx + c2 * lmy);
      const float w4 = -(c2 * lmx + c3 * lmy);
      const float w5 = 0.5f * c1 * lmx * lmx + 0.5f * c3 * lmy * lmy + c2 * lmx * lmy;
      const float dx = px - lmx;
      const int x = tx * kBlock + pxi;
      // the tile's cotangent loads and sigmas first, all independent; zero
      // cotangent off the image, so a pixel there adds nothing
      const int y0 = ty * kBlock + lane / kBlock;       // this lane's first row
      const int rows = x < W ? min(kPixPerLane, (H - y0 + 1) / 2) : 0;
      const float* vo = v_img + (static_cast<size_t>(y0) * W + x) * 3;
      const size_t step = static_cast<size_t>(2 * W) * 3;
      float v0[kPixPerLane], v1[kPixPerLane], v2[kPixPerLane], sg[kPixPerLane];
#pragma unroll
      for (int k = 0; k < kPixPerLane; ++k) {
        v0[k] = v1[k] = v2[k] = 0.f;
        if (k < rows) {
          v0[k] = __ldg(vo + k * step);
          v1[k] = __ldg(vo + k * step + 1);
          v2[k] = __ldg(vo + k * step + 2);
        }
        const float py = static_cast<float>(lane / kBlock + 2 * k);
        const float pxy = px * py, py2 = py * py;
        float s = w5;
        s = fmaf(w4, py, s);
        s = fmaf(w3, px, s);
        s = fmaf(w2, pxy, s);
        s = fmaf(w1, py2, s);
        sg[k] = fmaf(w0, px2, s);
      }
#pragma unroll
      for (int k = 0; k < kPixPerLane; ++k) {
        const float s = sg[k];
        if (!(s >= 0.f && s <= smax)) continue;
        const float vis = expf(-s);
        const float alpha = fminf(1.0f, opac * vis);
        if (!(alpha >= thresh)) continue;
        const float v_alpha = fmaf(b.w, v2[k], fmaf(b.z, v1[k], b.y * v0[k]));
        s_r = fmaf(alpha, v0[k], s_r);
        s_g = fmaf(alpha, v1[k], s_g);
        s_b = fmaf(alpha, v2[k], s_b);
        s_o = fmaf(vis, v_alpha, s_o);
        const float v_sigma = -(opac * vis) * v_alpha;
        const float dy = static_cast<float>(lane / kBlock + 2 * k) - lmy;
        const float vdx = v_sigma * dx, vdy = v_sigma * dy;
        m_xx = fmaf(vdx, dx, m_xx);
        m_xy = fmaf(vdx, dy, m_xy);
        m_yy = fmaf(vdy, dy, m_yy);
        m_x += vdx;
        m_y += vdy;
      }
      if (++tx == sp.x0 + sp.w) {
        tx = sp.x0;
        ++ty;
      }
    }
    s_r = warp_sum(s_r);
    s_g = warp_sum(s_g);
    s_b = warp_sum(s_b);
    s_o = warp_sum(s_o);
    m_xx = warp_sum(m_xx);
    m_xy = warp_sum(m_xy);
    m_yy = warp_sum(m_yy);
    m_x = warp_sum(m_x);
    m_y = warp_sum(m_y);
    if (lane == 0) {
      float* p = s_part[r][warp];
      p[0] = -(c1 * m_x + c2 * m_y);
      p[1] = -(c2 * m_x + c3 * m_y);
      p[2] = 0.5f * m_xx;
      p[3] = 0.5f * m_xy;
      p[4] = 0.5f * m_yy;
      p[5] = s_r;
      p[6] = s_g;
      p[7] = s_b;
      p[8] = s_o;
    }
    ++r;
  }
  __syncthreads();

  // one thread per (row, column): the warps' sums in warp order
  for (int i = threadIdx.x; i < kRows * kCols; i += kWarp * kWarps) {
    const int rr = i / kCols, col = i % kCols;
    if (r0 + rr >= Np) continue;
    float v = 0.f;
    if (col < kSums) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += s_part[rr][w][col];
    }
    out[static_cast<size_t>(r0) * kCols + i] = v;
  }
}

}  // namespace

extern "C" int chunk_backward(const float* table, const float* bbox, const float* v_img,
                              float* out, int Np, int tb_x, int tb_y, int H, int W,
                              void* stream) {
  if (Np > 0) {
    const int blocks = (Np + kRows - 1) / kRows;
    chunk_backward_kernel<<<blocks, kWarp * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
        table, bbox, v_img, out, Np, tb_x, tb_y, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
