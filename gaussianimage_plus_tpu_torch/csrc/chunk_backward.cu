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
//   v_opac += vis * v_alpha          M[f]   += v_sigma * phi_f(p)
// with phi = [px^2, py^2, px*py, px, py, 1] in tile-local coordinates, and
// turns the six moments M into v_conic (half off-diagonal) and v_xy with
// that tile's lmx, lmy (the JAX body's per-tile moment form). Output: the
// payload [Np, 16] = [v_xy(2), v_conic(3), v_rgb(3), v_opac, 0 x 7].
//
// Design: one warp per row. The warp walks the row's bbox tiles in
// row-major order; its lanes stride the tile's 256 pixels (8 each), read
// the cotangent image through L1/L2 (4.7 MB at 768x512, it fits in L2),
// and a butterfly of shuffles sums the ten per-tile partials in a fixed
// order. So no per-chunk tile-block list is needed (the TPU's lists and its
// MTB fallback are a TPU layout and are not carried over), and no float
// atomics are used: every sum runs in a fixed order, and two launches on the
// same inputs give the same bits. A row with a big bbox makes its warp run
// long; the card holds every warp of a Kodak-size table at once, so the
// launch lasts as long as the largest bbox.
//
// Bound on this card: operations — the gate (5 FMAs, an exp, a product and
// a min: 13) at every (member, pixel) pair on the image, and 26 more float32
// operations at each pair that passes it; bytes
// are the table, bbox and payload (<1 MB) and the image (read once from
// memory). No tensor cores: TF32 would flip the sigma >= 0 gate.
//
// Arithmetic contract with the plain PyTorch version (kernels/raster_list.py
// chunk_backward_plain, core/render_tiled.py tile_payload): -fmad=false, and
// w and sigma are kernel B's expressions and explicit fmaf chain, so a pair
// passes the gate here exactly when it contributed to the forward. The
// kernel allocates nothing, runs on the caller's stream and does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;
constexpr int kCols = 16;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kPixPerLane = kPix / kWarp;   // 8

// Butterfly sum: every lane ends with the same value, in a fixed order.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
chunk_backward_kernel(const float* __restrict__ table,
                      const float* __restrict__ bbox,
                      const float* __restrict__ v_img,
                      float* __restrict__ out,
                      int Np, int tb_x, int tb_y, int H, int W) {
  const int lane = threadIdx.x % kWarp;
  const int g = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (g >= Np) return;                       // the whole warp leaves together
  const float4* row = reinterpret_cast<const float4*>(table + static_cast<size_t>(g) * kCols);
  const float4 a = row[0];   // c1 c2 c3 mx
  const float4 b = row[1];   // my r g b
  const float4 o = row[2];   // opac ...
  const float4 d = row[3];   // ... valid
  const float4 bb = reinterpret_cast<const float4*>(bbox)[g];  // xmin xmax ymin ymax
  const float thresh = 1.0f / 255.0f;
  const float c1 = a.x, c2 = a.y, c3 = a.z, opac = o.x;
  const float w0 = 0.5f * c1, w1 = 0.5f * c3, w2 = c2;
  // the forward's member test (txf >= xmin && txf < xmax) on integer tiles
  const int x0 = max(0, static_cast<int>(ceilf(bb.x)));
  const int x1 = min(tb_x, static_cast<int>(ceilf(bb.y)));
  const int y0 = max(0, static_cast<int>(ceilf(bb.z)));
  const int y1 = min(tb_y, static_cast<int>(ceilf(bb.w)));
  const bool valid = d.w > 0.f;
  // this lane's pixels: p = lane + 32 k -> px = lane % 16, py = lane / 16 + 2 k
  const int pxi = lane % kBlock;
  const float px = static_cast<float>(pxi);
  const float px2 = px * px;

  float acc[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) acc[i] = 0.f;

  for (int ty = y0; valid && ty < y1; ++ty) {
    for (int tx = x0; tx < x1; ++tx) {
      const float lmx = a.w - static_cast<float>(tx) * static_cast<float>(kBlock);
      const float lmy = b.x - static_cast<float>(ty) * static_cast<float>(kBlock);
      const float w3 = -(c1 * lmx + c2 * lmy);
      const float w4 = -(c2 * lmx + c3 * lmy);
      const float w5 = 0.5f * c1 * lmx * lmx + 0.5f * c3 * lmy * lmy + c2 * lmx * lmy;
      const int x = tx * kBlock + pxi;
      float s_r = 0.f, s_g = 0.f, s_b = 0.f, s_o = 0.f;
      float m_xx = 0.f, m_yy = 0.f, m_xy = 0.f, m_x = 0.f, m_y = 0.f, m_1 = 0.f;
#pragma unroll
      for (int k = 0; k < kPixPerLane; ++k) {
        const int pyi = lane / kBlock + 2 * k;
        const int y = ty * kBlock + pyi;
        if (x >= W || y >= H) continue;      // zero cotangent off the image
        const float* vo = v_img + (static_cast<size_t>(y) * W + x) * 3;
        const float v0 = vo[0], v1 = vo[1], v2 = vo[2];
        const float py = static_cast<float>(pyi);
        const float pxy = px * py, py2 = py * py;
        float s = w5;
        s = fmaf(w4, py, s);
        s = fmaf(w3, px, s);
        s = fmaf(w2, pxy, s);
        s = fmaf(w1, py2, s);
        s = fmaf(w0, px2, s);
        const float vis = expf(-s);
        const float alpha = fminf(1.0f, opac * vis);
        if (!(s >= 0.f && alpha >= thresh)) continue;
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
      const float v_con_x = 0.5f * (lmx * lmx * S1 - 2.0f * lmx * Sx + Sxx);
      const float v_con_y = 0.5f * (lmx * lmy * S1 - lmx * Sy - lmy * Sx + Sxy);
      const float v_con_z = 0.5f * (lmy * lmy * S1 - 2.0f * lmy * Sy + Syy);
      const float mom_x = lmx * S1 - Sx;
      const float mom_y = lmy * S1 - Sy;
      acc[0] += c1 * mom_x + c2 * mom_y;
      acc[1] += c2 * mom_x + c3 * mom_y;
      acc[2] += v_con_x;
      acc[3] += v_con_y;
      acc[4] += v_con_z;
      acc[5] += s_r;
      acc[6] += s_g;
      acc[7] += s_b;
      acc[8] += s_o;
    }
  }

  if (lane == 0) {
    float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(g) * kCols);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    dst[2] = make_float4(acc[8], 0.f, 0.f, 0.f);
    dst[3] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace

extern "C" int chunk_backward(const float* table, const float* bbox, const float* v_img,
                              float* out, int Np, int tb_x, int tb_y, int H, int W,
                              void* stream) {
  if (Np > 0) {
    const int blocks = (Np + kWarpsPerBlock - 1) / kWarpsPerBlock;
    chunk_backward_kernel<<<blocks, kWarp * kWarpsPerBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        table, bbox, v_img, out, Np, tb_x, tb_y, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
