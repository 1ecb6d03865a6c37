// Kernel E — tile_bin: capped per-tile member lists in ascending id order.
//
// Replaces gaussianimage_plus_tpu/kernels/binning_pallas.py
// bin_gaussians_pallas (:92-139, body _make_kernel :43-89), TPU kernel #13.
// For each tile t (y-major, t = ty * tb_x + tx) its members are the Gaussians
// g whose [xmin, xmax) x [ymin, ymax) tile bbox holds the tile (invalid rows
// carry an empty bbox); the kernel writes the first `cap` of them in
// ascending id order to ids[t, :], zero past the count, and
// count[t] = min(#members, cap) — the TileBins of core/binning.py's 'top_k'
// selection, integer for integer.
//
// Design: one warp per tile scans the [N, 4] int32 bbox table in id order,
// 32 ids at a time: each lane tests one id, __ballot_sync gathers the member
// flags, and a member's slot is the tile's running count plus the __popc of
// the lower lanes' flags, so the members are compacted in order with no sort
// and no atomics. The scan stops once `cap` members are found (the count is
// then cap, whatever follows). The TPU kernel's prefix sum and one-hot
// selection as matrix products are a TPU layout and are not carried over.
//
// Bound on this card: the T x N bbox tests (4 integer compares each) for the
// ids scanned, or the bytes: the bbox table (16 B a row, read from L2 by every
// warp, from memory once) and the ids and counts written.
//
// The kernel allocates nothing, runs on the caller's stream and does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;   // tiles per block

__global__ void __launch_bounds__(kWarp * kWarps)
tile_bin_kernel(const int4* __restrict__ bbox, int* __restrict__ ids,
                int* __restrict__ count, int N, int T, int tb_x, int cap) {
  const int lane = threadIdx.x % kWarp;
  const int t = blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (t >= T) return;                        // the whole warp leaves together
  const int tx = t % tb_x, ty = t / tb_x;
  const unsigned lower = (1u << lane) - 1u;  // lanes below this one
  int* dst = ids + static_cast<size_t>(t) * cap;
  int n = 0;                                 // members found so far (uniform)
  for (int base = 0; base < N && n < cap; base += kWarp) {
    const int g = base + lane;
    bool member = false;
    if (g < N) {
      const int4 b = bbox[g];                // xmin xmax ymin ymax
      member = tx >= b.x && tx < b.y && ty >= b.z && ty < b.w;
    }
    const unsigned flags = __ballot_sync(0xffffffffu, member);
    if (member) {
      const int slot = n + __popc(flags & lower);
      if (slot < cap) dst[slot] = g;
    }
    n += __popc(flags);
  }
  n = n < cap ? n : cap;
  for (int s = n + lane; s < cap; s += kWarp) dst[s] = 0;
  if (lane == 0) count[t] = n;
}

}  // namespace

extern "C" int tile_bin(const int* bbox, int* ids, int* count, int N, int T, int tb_x,
                        int cap, void* stream) {
  if (T > 0 && cap > 0) {
    const int blocks = (T + kWarps - 1) / kWarps;
    tile_bin_kernel<<<blocks, kWarp * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const int4*>(bbox), ids, count, N, T, tb_x, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
