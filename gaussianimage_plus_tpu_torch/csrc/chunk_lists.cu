// Kernel F — chunk_lists: each tile's member chunks, as kernel B reads them.
//
// Replaces no TPU kernel. The JAX package enumerates the chunk lists in XLA
// (gaussianimage_plus_tpu/kernels/raster_list_pallas.py _member_matrix
// :125-135 and _chunk_lists :138-166), and the port did the same in ATen
// (kernels/raster_list.py _bbox_members + _lists_and_members): a dense
// [T, Np] membership of float bbox compares, an `any` over each chunk of kc
// rows and a `topk`. At 2040x1344 that is 10,752 x 20,096 booleans through
// ~9 broadcast operations a step, most of a graphed training step, to list
// about two member chunks a tile. The lists need none of it: a row's bbox
// covers a few tiles.
//
// Output, integer for integer what _lists_and_members returns: for tile t
// (t = ty * tb_x + tx), its member chunks are the chunks c that hold a valid
// row r (table[r, 15] > 0, c = r / kc) whose float tile bbox holds the tile
// (tx >= xmin, tx < xmax, ty >= ymin, ty < ymax). lst[t] lists the first lmax
// of them in ascending order, zero past them; cnt[t] = min(count, lmax);
// members[t] = count; and where count > lmax, lo2[t] is the (lmax+1)-th
// member and hi2[t] the last member + 1 (the residual interval kernel B
// walks), else both are 0.
//
// Design, two stages on the caller's stream, one C entry point:
//   0. cudaMemsetAsync zeroes the [T, nch] byte scratch `mark`.
//   1. chunk_mark_kernel: a warp owns 32 consecutive rows. Each lane turns
//      its row's float bbox into the integer tile rectangle kernel C's
//      row_span takes (x0 = ceil(xmin), x1 = ceil(xmax), clipped to the
//      grid: the float test on integer tiles), then the warp walks the 32
//      rectangles in turn, its lanes striding over each one's tiles and
//      storing 1 to mark[t, r / kc]. Stores of one value race benignly, so
//      no atomics are used, and a row over the whole grid costs its warp
//      T / 32 stores a lane, not one thread T.
//   2. chunk_compact_kernel: a warp owns a tile and reads its nch marks in
//      ascending chunk order, 32 a ballot; each member's list slot is the
//      running count plus the __popc of the lower lanes' marks.
// No [T, Np] tensor exists, nothing is sorted, nothing syncs with the host,
// and every shape is fixed by (T, nch, lmax): the stages are captured into
// the trainer's CUDA graph with the rest of a step.
//
// Bound on this card: its bytes — the bbox and valid column read (20 B a
// row), the marks written and read (T * nch bytes each way: 1.69 MB at 2K)
// and the lists written ((lmax + 4) * 4 B a tile); the operations are a few
// integer ones a (row, bbox tile) pair.
//
// The kernels allocate nothing (the wrapper allocates `mark` and the lists),
// run on the caller's stream and do not synchronise; the C entry point
// returns the first cudaError_t of its memset and launches.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 16;
constexpr int kWarp = 32;
constexpr int kWarps = 8;                  // warps per block
constexpr int kThreads = kWarp * kWarps;
constexpr unsigned kAll = 0xffffffffu;

// A row's bbox tiles on the grid: [x0, x0 + w) x [y0, y0 + h). For integer
// tx, tx >= xmin holds exactly when tx >= ceil(xmin), and tx < xmax when
// tx < ceil(xmax); the bounds are clipped to the grid in float first, so an
// infinite or huge bbox converts safely. A NaN bound fails every compare of
// the float test, so such a row, like an invalid one, has no tile.
struct Rect {
  int x0, y0, w, h;
};

__device__ __forceinline__ Rect row_rect(const float* table, const float* bbox, int r,
                                         int tb_x, int tb_y) {
  const float4 bb = reinterpret_cast<const float4*>(bbox)[r];  // xmin xmax ymin ymax
  Rect s{0, 0, 0, 0};
  if (!(table[static_cast<size_t>(r) * kCols + kCols - 1] > 0.f) || isnan(bb.x) ||
      isnan(bb.y) || isnan(bb.z) || isnan(bb.w))
    return s;
  const float fx = static_cast<float>(tb_x), fy = static_cast<float>(tb_y);
  s.x0 = static_cast<int>(ceilf(fminf(fmaxf(bb.x, 0.f), fx)));
  s.y0 = static_cast<int>(ceilf(fminf(fmaxf(bb.z, 0.f), fy)));
  s.w = max(0, static_cast<int>(ceilf(fminf(fmaxf(bb.y, 0.f), fx))) - s.x0);
  s.h = max(0, static_cast<int>(ceilf(fminf(fmaxf(bb.w, 0.f), fy))) - s.y0);
  return s;
}

__global__ void __launch_bounds__(kThreads)
chunk_mark_kernel(const float* __restrict__ table, const float* __restrict__ bbox,
                  unsigned char* __restrict__ mark, int rows, int nch, int kc,
                  int tb_x, int tb_y) {
  const int lane = threadIdx.x % kWarp;
  const int r0 = (blockIdx.x * kWarps + threadIdx.x / kWarp) * kWarp;
  if (r0 >= rows) return;                    // warp-uniform
  Rect s{0, 0, 0, 0};
  if (r0 + lane < rows) s = row_rect(table, bbox, r0 + lane, tb_x, tb_y);
  const int n = min(kWarp, rows - r0);
  for (int j = 0; j < n; ++j) {
    const int w = __shfl_sync(kAll, s.w, j);
    const int area = w * __shfl_sync(kAll, s.h, j);
    const int x0 = __shfl_sync(kAll, s.x0, j);
    const int y0 = __shfl_sync(kAll, s.y0, j);
    unsigned char* m = mark + (r0 + j) / kc;
    for (int i = lane; i < area; i += kWarp) {
      const int t = (y0 + i / w) * tb_x + x0 + i % w;
      m[static_cast<size_t>(t) * nch] = 1;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
chunk_compact_kernel(const unsigned char* __restrict__ mark, int* __restrict__ lst,
                     int* __restrict__ cnt, int* __restrict__ lo2, int* __restrict__ hi2,
                     int* __restrict__ members, int T, int nch, int lmax) {
  const int lane = threadIdx.x % kWarp;
  const int t = blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (t >= T) return;                        // warp-uniform
  const unsigned char* m = mark + static_cast<size_t>(t) * nch;
  int* out = lst + static_cast<size_t>(t) * lmax;
  int count = 0, lo = 0, last = -1;          // warp-uniform
  for (int c0 = 0; c0 < nch; c0 += kWarp) {
    const int c = c0 + lane;
    const bool on = c < nch && m[c] != 0;
    const unsigned bits = __ballot_sync(kAll, on);
    if (bits == 0) continue;
    const int pos = count + __popc(bits & ((1u << lane) - 1u));
    if (on && pos < lmax) out[pos] = c;
    const int next = count + __popc(bits);
    if (count <= lmax && lmax < next)        // the (lmax+1)-th member is in this batch
      lo = c0 + __ffs(__ballot_sync(kAll, on && pos == lmax)) - 1;
    count = next;
    last = c0 + kWarp - 1 - __clz(bits);
  }
  for (int i = count + lane; i < lmax; i += kWarp) out[i] = 0;
  if (lane == 0) {
    const bool over = count > lmax;
    cnt[t] = min(count, lmax);
    lo2[t] = over ? lo : 0;
    hi2[t] = over ? last + 1 : 0;
    members[t] = count;
  }
}

}  // namespace

// table [rows, 16] and bbox [rows, 4] float32 (rows <= nch * kc; the rows past
// them hold no member), mark [T, nch] bytes of scratch, lst [T, lmax] and
// cnt, lo2, hi2, members [T] int32 written; T = tb_x * tb_y.
extern "C" int chunk_lists(const float* table, const float* bbox, unsigned char* mark,
                           int* lst, int* cnt, int* lo2, int* hi2, int* members, int rows,
                           int nch, int kc, int lmax, int tb_x, int tb_y, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = tb_x * tb_y;
  if (T <= 0 || nch <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(mark, 0, static_cast<size_t>(T) * nch, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > 0) {
    const int warps = (rows + kWarp - 1) / kWarp;
    chunk_mark_kernel<<<(warps + kWarps - 1) / kWarps, kThreads, 0, st>>>(
        table, bbox, mark, rows, nch, kc, tb_x, tb_y);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chunk_compact_kernel<<<(T + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      mark, lst, cnt, lo2, hi2, members, T, nch, lmax);
  return static_cast<int>(cudaGetLastError());
}
