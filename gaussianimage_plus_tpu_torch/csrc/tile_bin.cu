// Kernel E — tile_bin: capped per-tile member lists in ascending id order.
//
// Replaces gaussianimage_plus_tpu/kernels/binning_pallas.py
// bin_gaussians_pallas (:92-139, body _make_kernel :43-89), TPU kernel #13.
// For each tile t (y-major, t = ty * tb_x + tx) its members are the Gaussians
// g whose [xmin, xmax) x [ymin, ymax) tile bbox holds the tile (invalid rows
// carry the empty bbox (1, 0, 1, 0)); the kernel writes the first `cap` of
// them in ascending id order to ids[t, :], zero past the count, and
// count[t] = min(#members, cap) — the TileBins of core/binning.py's 'top_k'
// selection, integer for integer.
//
// Design: a separable filter in one pass. A block owns a window of kWarps x
// TPW tiles of one tile row ty, TPW tiles a warp: 1, or 4 on grids of
// kBigGrid tiles and more, where every block's read of the whole table from
// L2 bounds the launch and four times fewer blocks read it. It reads the [N, 4] int32 bbox table in id
// order, kBatch ids a batch (coalesced 16-byte rows, the next batch's loads
// in flight while this one is compacted), and keeps the ids whose bbox holds
// row ty and overlaps the window: each warp tests kSlices slices of 32 ids,
// a ballot gives each slice's member flags, every warp scans the block's 32
// slice counts with shuffles, and each member lands in a shared list at its
// rank, with its x range clipped to the window. Then the warp of each tile
// tests only x over that short list and appends its members at its running
// count plus the __popc of the lower lanes' flags. So the ids stay in
// ascending order with no sort and no atomics, and the x test runs on about
// one id in ten of the table (one row of 32 and a window of the row, at the
// 768x512 fit state). A block stops once each of its tiles holds `cap`
// members (the count is then cap, whatever follows). The TPU kernel's prefix
// sum and one-hot selection as matrix products are a TPU layout and are not
// carried over.
//
// Bound on this card: the bytes — the bbox table (16 B a row, read from
// memory once; each block reads it from L2) and the ids and counts written;
// the bbox tests of one warp per tile over every id would take the operations
// bound, and the filter does fewer.
//
// The kernel allocates nothing, runs on the caller's stream and does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;                     // warps per block
constexpr int kThreads = kWarp * kWarps;
constexpr int kSlices = 4;                    // 32-id slices per warp per batch
constexpr int kBatch = kThreads * kSlices;    // ids per batch
constexpr int kSliceCount = kWarps * kSlices; // slices per batch (32: one per lane)
// Tiles from which a warp takes 4. Device ms a launch, TPW 1 / TPW 4, on an
// H100 80GB HBM3 at 700 W (scripts/torch_tile_bin_tpw.py): 1536 tiles (the
// 768x512 states) 0.0076-0.0084 / 0.0172-0.0233; 4096 tiles 0.0145 /
// 0.0154; 6144 tiles 0.0284 / 0.0228; 10752 tiles (the 2K state) 0.0742 /
// 0.0421. The switch lies between 4096 and 6144 tiles.
constexpr int kBigGrid = 5120;
static_assert(kSliceCount == kWarp, "a warp scans one slice count per lane");

// Warp w of the block owns the TPW tiles from tx0 + w * TPW.
template <int TPW>
__global__ void __launch_bounds__(kThreads)
tile_bin_kernel(const int4* __restrict__ bbox, int* __restrict__ ids,
                int* __restrict__ count, int N, int tb_x, int cap) {
  __shared__ int2 s_list[kBatch];       // (id, x range in the window) of this batch's hits
  __shared__ int s_cnt[kSliceCount];    // hits per slice
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int ty = blockIdx.y;
  const int tx0 = blockIdx.x * kWarps * TPW;
  const int tx1 = min(tx0 + kWarps * TPW, tb_x);
  const unsigned lower = (1u << lane) - 1u;  // lanes below this one
  int n[TPW];                                // members found so far per tile (warp-uniform)
  bool done = true;
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    n[i] = 0;
    done &= !(tx0 + warp * TPW + i < tx1);
  }

  // slice s = warp + kWarps * h of a batch holds ids base + 32 s + lane
  int4 cur[kSlices];
#pragma unroll
  for (int h = 0; h < kSlices; ++h) {
    const int g = (warp + kWarps * h) * kWarp + lane;
    cur[h] = g < N ? bbox[g] : make_int4(1, 0, 1, 0);
  }
  for (int base = 0; base < N; base += kBatch) {
    unsigned flags[kSlices];
    int2 entry[kSlices];
#pragma unroll
    for (int h = 0; h < kSlices; ++h) {
      const int4 b = cur[h];                 // xmin xmax ymin ymax (empty past N)
      const bool hit = ty >= b.z && ty < b.w && b.x < tx1 && b.y > tx0 && b.x < b.y;
      flags[h] = __ballot_sync(0xffffffffu, hit);
      const int lo = max(b.x, tx0) - tx0, hi = min(b.y, tx1) - tx0;
      entry[h] = make_int2(base + (warp + kWarps * h) * kWarp + lane, lo | (hi << 16));
    }
    // the next batch's rows, in flight while this one is compacted
#pragma unroll
    for (int h = 0; h < kSlices; ++h) {
      const int g = base + kBatch + (warp + kWarps * h) * kWarp + lane;
      cur[h] = g < N ? bbox[g] : make_int4(1, 0, 1, 0);
    }
    if (lane == 0) {
#pragma unroll
      for (int h = 0; h < kSlices; ++h) s_cnt[warp + kWarps * h] = __popc(flags[h]);
    }
    // every tile of the block full: stop (the barrier also orders the last
    // batch's reads of s_list before this batch's writes)
    if (__syncthreads_and(done)) break;
    const int c = s_cnt[lane];
    int incl = c;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    const int total = __shfl_sync(0xffffffffu, incl, kWarp - 1);
    const int excl = incl - c;
#pragma unroll
    for (int h = 0; h < kSlices; ++h) {
      const int start = __shfl_sync(0xffffffffu, excl, warp + kWarps * h);
      if ((flags[h] >> lane) & 1u) s_list[start + __popc(flags[h] & lower)] = entry[h];
    }
    __syncthreads();
    done = true;
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int rel = warp * TPW + i;        // the tile's column in the window
      if (tx0 + rel >= tx1) continue;
      int* dst = ids + (static_cast<size_t>(ty) * tb_x + tx0 + rel) * cap;
      for (int i0 = 0; i0 < total && n[i] < cap; i0 += kWarp) {
        const int j = i0 + lane;
        bool member = false;
        int g = 0;
        if (j < total) {
          const int2 e = s_list[j];
          member = rel >= (e.y & 0xffff) && rel < (e.y >> 16);
          g = e.x;
        }
        const unsigned f = __ballot_sync(0xffffffffu, member);
        if (member) {
          const int slot = n[i] + __popc(f & lower);
          if (slot < cap) dst[slot] = g;
        }
        n[i] += __popc(f);
      }
      done &= n[i] >= cap;
    }
  }
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int tx = tx0 + warp * TPW + i;
    if (tx >= tx1) continue;
    const size_t t = static_cast<size_t>(ty) * tb_x + tx;
    const int m = n[i] < cap ? n[i] : cap;
    for (int s = m + lane; s < cap; s += kWarp) ids[t * cap + s] = 0;
    if (lane == 0) count[t] = m;
  }
}

}  // namespace

extern "C" int tile_bin(const int* bbox, int* ids, int* count, int N, int T, int tb_x,
                        int cap, void* stream) {
  if (T > 0 && cap > 0 && tb_x > 0) {
    const auto* b = reinterpret_cast<const int4*>(bbox);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T >= kBigGrid) {
      const dim3 grid((tb_x + 4 * kWarps - 1) / (4 * kWarps), T / tb_x);
      tile_bin_kernel<4><<<grid, kThreads, 0, st>>>(b, ids, count, N, tb_x, cap);
    } else {
      const dim3 grid((tb_x + kWarps - 1) / kWarps, T / tb_x);
      tile_bin_kernel<1><<<grid, kThreads, 0, st>>>(b, ids, count, N, tb_x, cap);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
