// Kernels B2 and B3 of the port: the binned tile rasterizer and its
// G-buffer form, for Hopper (sm_90a).
//
// B2 replaces rustexp_tpu/ops/raster_pallas.py::_attr_tile_kernel (the
// Pallas kernel that raster_attrs_pallas launches through pl.pallas_call).
// Python wrapper: rustexp_tpu_torch/ops/raster_bins.py::
// raster_attrs_bins_cuda; its plain PyTorch version,
// raster_attrs_bins_plain, sits beside it. B3 replaces _tile_kernel
// (raster_gbuffer_pallas's pallas_call): the same race, storing the
// winner's barycentrics b0, b1, b2 instead of planes. Wrapper:
// raster_gbuffer_bins_cuda; plain version: raster_gbuffer_bins_plain.
//
// What it computes. The frame is cut into 32x128 tiles. Bin t holds
// counts[t] triangle records in submission order: setup_i (A0 A1 B0 B1 C0
// C1 S min_x min_y max_x max_y tri) and setup_f (bias0 bias1 bias2 z0 z10
// z20 inv_a2, then the 3(n2+n3) attribute channels). For every pixel of
// the tile and every slot s < counts[t], in slot order: 28.4 fixed-point
// edge functions in wrapping int32, the sign-OR inside test plus the
// triangle's AABB, barycentrics f32(e - bias) * inv_a2 rounded once, z by
// the 2-MAD lerp, and a strict depth race: a fragment wins when z < z_cur,
// so an earlier slot keeps a tie and a fragment at z >= 1.0 never beats the
// clear (z = 1.0, slot = -1, planes 0). Output: z, the winning slot, and
// the winner's n2 2-MAD and n3 3-weight attribute planes. B3 outputs z,
// the winning slot and the winner's b0, b1, b2 (0 where nobody wins): five
// words per pixel, every tile written.
//
// B2's design. The TPU grid walks a tile's bin chunks in order on one core
// and carries z in VMEM. Here each pixel's race is independent of every
// other pixel's, so any split of the pixels across threads is exact and
// needs no atomics: a block owns one 8-row strip of a tile (4 blocks per
// tile, 256 blocks at 512x512 against the card's 132 SMs), a thread owns
// one column of that strip (8 pixels), and every thread walks all of the
// tile's slots in order with (z, slot) in registers. The race channels of
// the records (12 int + 7 float, 76 B a slot) are staged STAGE slots at a
// time in shared memory and read as broadcasts. The race carries no
// planes: with n3 = 6 that would be 10 more registers per pixel.
// Afterwards each thread re-evaluates its winners' planes from the winning
// record in device memory, with the same formula on the same integers, so
// they have the same bits as planes carried through the race.
//
// B3's design. The walk in slot order with a strict z < z_cur keeps the
// first of the least z: a lexicographic minimum over (z, slot), so it may
// run in any order and be merged. A block owns a 4 x 32 rectangle of one
// tile (32 a tile; the grid covers every tile, so each output word is
// written once) and its 2 warps take the tile's slots dealt round-robin, 32
// a load (one a lane). A lane reads its slot's AABB; a ballot keeps the
// slots whose box meets the rectangle (a warp-uniform cull), whose race
// channels the lanes then read and stage in shared memory; the warp races
// them one by one over the rectangle, each lane a column, the rows off the
// box masked (no branch between rows), in slot order within the warp. The
// warps' winners merge on (z, slot) by float compares: z < z', or z == z'
// and slot < slot', from the clear (1.0, -1), so NaN never wins, z >= 1.0
// never beats the clear and +0.0 and -0.0 tie, the earlier slot keeping
// the pixel with its own zero. Then each pixel's b0, b1, b2 are evaluated
// once, from its winner's record. Two warps, not four, because most tiles
// hold few slots: on an H100 at Killeroo 1024x1024 (13.5 live slots a
// tile), 4 warps took 0.0178 ms, 2 warps 0.0139 and the strip kernel
// 0.0146; 4 warps win where tiles are crowded (TorusKnot 512x512, 75 a
// tile: 0.0102 against 2 warps' 0.0144).
//
// Bound. The least work is the writes: (2 + n2 + n3) words per pixel,
// 12.6 MB at CubeP 512x512, about 3.8 us at 3.35 TB/s (B3: 5 words, 5.2
// MB); the records read are small (12 + 7 + 3(n2+n3) words per live slot),
// and the edge, box and depth test, about 32 INT32/FP32 operations per
// (slot, pixel of its box), stays below the writes even at hundreds of
// slots per tile (TorusKnotP). B2 tests more pairs than that minimum: each
// slot at every pixel of the strip in whose rows and columns its AABB lies,
// so with many slots per tile its time is that test loop on the FP32 and
// INT32 pipes. To keep it short, its slot loop reads no device memory,
// skips a slot for the whole block when its AABB misses the block's rows,
// and per thread when it misses the thread's column. B3 tests each slot
// whose box meets a 4 x 32 rectangle at the rectangle's 128 pixels, and
// reads each slot's box once per rectangle of its tile (32 reads).
//
// Rounding. Built with -fmad=false, and every product and sum of a sealed
// chain is also spelled __fmul_rn/__fadd_rn, so no FMA can form: each op
// rounds once, as in the reference and the JAX package's sealed CPU chains.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int ROWS = 8;                // rows of a tile that one block owns
constexpr int STRIPS = TILE_H / ROWS;  // blocks per tile
constexpr int THREADS = TILE_W;        // one thread per column of the strip
constexpr int STAGE = 256;             // slots staged in shared memory per pass
constexpr int I_CH = 12;  // A0 A1 B0 B1 C0 C1 S min_x min_y max_x max_y tri
constexpr int F_CH = 7;   // bias0 bias1 bias2 z0 z10 z20 inv_a2, then planes

__device__ __forceinline__ float lerp_2mad(float q0, float q10, float q20,
                                           float b2, float b0) {
  return __fadd_rn(__fadd_rn(q0, __fmul_rn(q10, b2)), __fmul_rn(q20, b0));
}

__device__ __forceinline__ float lerp_3w(float qb1, float qb2, float qb0,
                                         float b1, float b2, float b0) {
  return __fadd_rn(__fadd_rn(__fmul_rn(qb1, b1), __fmul_rn(qb2, b2)),
                   __fmul_rn(qb0, b0));
}

// f32(e - bias) * inv_a2: integer de-bias, then the one f32 rounding.
__device__ __forceinline__ float bary(uint32_t e, int bias, float inv_a2) {
  return __fmul_rn(__int2float_rn(static_cast<int32_t>(
                       e - static_cast<uint32_t>(bias))), inv_a2);
}

// The (z, slot) race of one thread's column of an 8-row strip over the
// tile's slots, in slot order: B2's step 1. gi/gf point at the
// tile's bin; records are fch floats apart in gf. Every thread of the
// block calls it (it stages records in si/sf between barriers).
__device__ __forceinline__ void strip_race(const int* __restrict__ gi,
                                           const float* __restrict__ gf,
                                           int fch, int count, int y0, int x,
                                           int* si, float* sf,
                                           float (&z)[ROWS],
                                           int (&slot)[ROWS]) {
  const uint32_t xf = static_cast<uint32_t>(x) << 4;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    z[k] = 1.0f;
    slot[k] = -1;
  }
  for (int base = 0; base < count; base += STAGE) {
    const int n = min(STAGE, count - base);
    __syncthreads();  // nobody reads the previous stage any more
    for (int k = threadIdx.x; k < n * I_CH; k += THREADS)
      si[k] = gi[static_cast<size_t>(base) * I_CH + k];
    for (int k = threadIdx.x; k < n * F_CH; k += THREADS) {
      const int p = k / F_CH;
      sf[k] = gf[static_cast<size_t>(base + p) * fch + (k - p * F_CH)];
    }
    __syncthreads();

    for (int p = 0; p < n; ++p) {
      const int* ri = si + p * I_CH;
      const float* rf = sf + p * F_CH;
      const int mny = ri[8], mxy = ri[10];
      if (mxy <= y0 || mny >= y0 + ROWS) continue;  // misses the strip
      const int mnx = ri[7], mxx = ri[9];
      if (x < mnx || x >= mxx) continue;            // misses the column
      // int32 edge math in uint32: the same wraparound, without the
      // undefined behaviour of signed overflow.
      const uint32_t A0 = ri[0], A1 = ri[1], B0 = ri[2], B1 = ri[3];
      const uint32_t C0 = ri[4], C1 = ri[5], S = ri[6];
      const int bias0 = static_cast<int>(rf[0]);
      const int bias2 = static_cast<int>(rf[2]);
      const float z0 = rf[3], z10 = rf[4], z20 = rf[5], inv_a2 = rf[6];
      const uint32_t ex0 = A0 * xf + C0, ex1 = A1 * xf + C1;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int y = y0 + k;
        const uint32_t yf = static_cast<uint32_t>(y) << 4;
        // e = A*xf + B*yf + C; wrapping addition is associative
        const uint32_t e0 = ex0 + B0 * yf;
        const uint32_t e1 = ex1 + B1 * yf;
        const uint32_t e2 = S - e0 - e1;
        const bool inside = static_cast<int32_t>(e0 | e1 | e2) >= 0;
        if (inside && y >= mny && y < mxy) {
          const float zi = lerp_2mad(z0, z10, z20, bary(e2, bias2, inv_a2),
                                     bary(e0, bias0, inv_a2));
          if (zi < z[k]) {  // strict: the earlier slot keeps a tie
            z[k] = zi;
            slot[k] = base + p;
          }
        }
      }
    }
  }
}

// The barycentrics (b0, b1, b2) of record (ri, rf) at pixel (x, y).
__device__ __forceinline__ void record_bary(const int* __restrict__ ri,
                                            const float* __restrict__ rf,
                                            int x, int y, float& b0,
                                            float& b1, float& b2) {
  const uint32_t xf = static_cast<uint32_t>(x) << 4;
  const uint32_t yf = static_cast<uint32_t>(y) << 4;
  const uint32_t e0 = static_cast<uint32_t>(ri[0]) * xf +
                      static_cast<uint32_t>(ri[2]) * yf +
                      static_cast<uint32_t>(ri[4]);
  const uint32_t e1 = static_cast<uint32_t>(ri[1]) * xf +
                      static_cast<uint32_t>(ri[3]) * yf +
                      static_cast<uint32_t>(ri[5]);
  const uint32_t e2 = static_cast<uint32_t>(ri[6]) - e0 - e1;
  const float inv_a2 = rf[6];
  b0 = bary(e0, static_cast<int>(rf[0]), inv_a2);
  b1 = bary(e1, static_cast<int>(rf[1]), inv_a2);
  b2 = bary(e2, static_cast<int>(rf[2]), inv_a2);
}

template <int N2, int N3>
__global__ void __launch_bounds__(THREADS)
bins_raster_kernel(const int* __restrict__ counts,
                   const int* __restrict__ setup_i,
                   const float* __restrict__ setup_f,
                   float* __restrict__ z_out, int* __restrict__ slot_out,
                   float* __restrict__ lin_out, int cap, int ntx, int h,
                   int w) {
  constexpr int NP = N2 + N3;
  constexpr int FCH = F_CH + 3 * NP;
  static_assert(NP > 0, "at least one attribute plane");
  __shared__ int si[STAGE * I_CH];
  __shared__ float sf[STAGE * F_CH];

  const int tile = blockIdx.x / STRIPS;
  const int y0 = (tile / ntx) * TILE_H + (blockIdx.x % STRIPS) * ROWS;
  const int x = (tile % ntx) * TILE_W + threadIdx.x;
  const int count = min(max(counts[tile], 0), cap);
  const int* gi = setup_i + static_cast<size_t>(tile) * cap * I_CH;
  const float* gf = setup_f + static_cast<size_t>(tile) * cap * FCH;

  // Step 1: the (z, slot) race over the tile's slots, in slot order.
  float z[ROWS];
  int slot[ROWS];
  strip_race(gi, gf, FCH, count, y0, x, si, sf, z, slot);

  // Step 2: the winners' planes, re-evaluated from the winning record.
  // Each tile row is 128 consecutive words: the stores coalesce.
  const size_t plane = static_cast<size_t>(h) * w;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int y = y0 + k;
    const size_t i = static_cast<size_t>(y) * w + x;
    z_out[i] = z[k];
    slot_out[i] = slot[k];
    if (slot[k] < 0) {
#pragma unroll
      for (int a = 0; a < NP; ++a) lin_out[a * plane + i] = 0.0f;
      continue;
    }
    const float* rf = gf + static_cast<size_t>(slot[k]) * FCH;
    float b0, b1, b2;
    record_bary(gi + static_cast<size_t>(slot[k]) * I_CH, rf, x, y, b0, b1,
                b2);
#pragma unroll
    for (int a = 0; a < N2; ++a)
      lin_out[a * plane + i] =
          lerp_2mad(rf[F_CH + a], rf[F_CH + N2 + a], rf[F_CH + 2 * N2 + a],
                    b2, b0);
    constexpr int OFF = F_CH + 3 * N2;
#pragma unroll
    for (int a = 0; a < N3; ++a)
      lin_out[(N2 + a) * plane + i] =
          lerp_3w(rf[OFF + a], rf[OFF + N3 + a], rf[OFF + 2 * N3 + a], b1,
                  b2, b0);
  }
}

template <int N2, int N3>
cudaError_t launch(const void* counts, const void* setup_i,
                   const void* setup_f, void* z, void* slot, void* lin,
                   int n_tiles, int cap, int ntx, int h, int w,
                   cudaStream_t stream) {
  bins_raster_kernel<N2, N3><<<n_tiles * STRIPS, THREADS, 0, stream>>>(
      static_cast<const int*>(counts), static_cast<const int*>(setup_i),
      static_cast<const float*>(setup_f), static_cast<float*>(z),
      static_cast<int*>(slot), static_cast<float*>(lin), cap, ntx, h, w);
  return cudaGetLastError();
}

// B3's block: a RECT_H x RECT_W rectangle of one tile (a lane a column)
// and NWARP warps, each racing its share of the tile's slots.
constexpr int RECT_H = 4;
constexpr int RECT_W = 32;
constexpr int NWARP = 2;
constexpr int B3_THREADS = NWARP * 32;
constexpr int RECTS_X = TILE_W / RECT_W;
constexpr int RECTS = (TILE_H / RECT_H) * RECTS_X;
static_assert(TILE_H % RECT_H == 0 && TILE_W % RECT_W == 0 && RECT_W == 32,
              "rectangle shape");
constexpr unsigned FULL = 0xffffffffu;

// What a warp stages of one slot whose box meets its rectangle: A0 A1 B0
// B1 | C0 C1 S slot | bias0 bias2 min_x max_x | z0 z10 z20 inv_a2 (bits)
// | first row, end row (within the rectangle). 20 words: eight lanes'
// 16-byte stores fall in distinct banks.
struct Staged {
  int4 q[5];
};

// B3: the G-buffer form, z, bin slot and barycentrics b0, b1, b2 (planes
// of b [3, h, w]) of the winner; the clear (1.0, -1, 0) where no slot
// wins. Records are fch floats apart (fch >= 7). The grid is (tiles,
// RECTS).
__global__ void __launch_bounds__(B3_THREADS)
bins_gbuffer_kernel(const int* __restrict__ counts,
                    const int* __restrict__ setup_i,
                    const float* __restrict__ setup_f,
                    float* __restrict__ z_out, int* __restrict__ slot_out,
                    float* __restrict__ b_out, int cap, int fch, int ntx,
                    int h, int w) {
  // The race's stage, then (after a barrier) the warps' winners.
  __shared__ union {
    Staged stage[NWARP][32];
    struct {
      float z[NWARP][RECT_H][32];
      int slot[NWARP][RECT_H][32];
    } part;
  } sm;

  const int tile = blockIdx.x;
  const int ty = tile / ntx, tx = tile - ty * ntx;
  const int ry = blockIdx.y / RECTS_X, rx = blockIdx.y - ry * RECTS_X;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = tx * TILE_W + rx * RECT_W, y0 = ty * TILE_H + ry * RECT_H;
  const int x = x0 + lane;
  const uint32_t xf = static_cast<uint32_t>(x) << 4;
  const int count = min(max(counts[tile], 0), cap);
  const int* gi = setup_i + static_cast<size_t>(tile) * cap * I_CH;
  const float* gf = setup_f + static_cast<size_t>(tile) * cap * fch;

  float z[RECT_H];
  int slot[RECT_H];
#pragma unroll
  for (int k = 0; k < RECT_H; ++k) {
    z[k] = 1.0f;
    slot[k] = -1;
  }

  // Warp w takes slots w, w + NWARP, ..., 32 at a time: neighbouring slots
  // tend to lie side by side on the screen, so dealing them out spreads
  // the slots that meet the rectangle over the warps. Within a warp the
  // slots rise, so a strict compare keeps the first of a tie.
  Staged* st = sm.stage[warp];
  for (int g = warp; g < count; g += 32 * NWARP) {
    const int s = g + lane * NWARP;
    bool hit = false;
    if (s < count) {
      const int* ri = gi + static_cast<size_t>(s) * I_CH;
      const int mnx = __ldg(ri + 7), mny = __ldg(ri + 8);
      const int mxx = __ldg(ri + 9), mxy = __ldg(ri + 10);
      hit = mnx < x0 + RECT_W && mxx > x0 && mny < y0 + RECT_H && mxy > y0;
      if (hit) {
        const float* rf = gf + static_cast<size_t>(s) * fch;
        Staged t;
        t.q[0] = make_int4(__ldg(ri), __ldg(ri + 1), __ldg(ri + 2),
                           __ldg(ri + 3));
        t.q[1] = make_int4(__ldg(ri + 4), __ldg(ri + 5), __ldg(ri + 6), s);
        t.q[2] = make_int4(static_cast<int>(__ldg(rf)),
                           static_cast<int>(__ldg(rf + 2)), mnx, mxx);
        t.q[3] = make_int4(__float_as_int(__ldg(rf + 3)),
                           __float_as_int(__ldg(rf + 4)),
                           __float_as_int(__ldg(rf + 5)),
                           __float_as_int(__ldg(rf + 6)));
        t.q[4] = make_int4(max(mny - y0, 0), min(mxy - y0, RECT_H), 0, 0);
        st[lane] = t;
      }
    }
    unsigned m = __ballot_sync(FULL, hit);
    __syncwarp();
    while (m) {
      const Staged t = st[__ffs(m) - 1];
      m &= m - 1;
      // int32 edge math in uint32: the same wraparound, without the
      // undefined behaviour of signed overflow.
      const uint32_t A0 = t.q[0].x, A1 = t.q[0].y;
      const uint32_t B0 = t.q[0].z, B1 = t.q[0].w;
      const uint32_t C0 = t.q[1].x, C1 = t.q[1].y, S = t.q[1].z;
      const int sl = t.q[1].w;
      const int bias0 = t.q[2].x, bias2 = t.q[2].y;
      const bool in_x = x >= t.q[2].z && x < t.q[2].w;
      const float z0 = __int_as_float(t.q[3].x);
      const float z10 = __int_as_float(t.q[3].y);
      const float z20 = __int_as_float(t.q[3].z);
      const float inv_a2 = __int_as_float(t.q[3].w);
      const int k_lo = t.q[4].x, k_hi = t.q[4].y;
      const uint32_t ex0 = A0 * xf + C0, ex1 = A1 * xf + C1;
      // Every row of the rectangle, those off the box masked: no branch
      // between rows, so their chains interleave.
#pragma unroll
      for (int k = 0; k < RECT_H; ++k) {
        const uint32_t yf = static_cast<uint32_t>(y0 + k) << 4;
        // e = A*xf + B*yf + C; wrapping addition is associative
        const uint32_t e0 = ex0 + B0 * yf;
        const uint32_t e1 = ex1 + B1 * yf;
        const uint32_t e2 = S - e0 - e1;
        const bool inside = static_cast<int32_t>(e0 | e1 | e2) >= 0;
        const float zi = lerp_2mad(z0, z10, z20, bary(e2, bias2, inv_a2),
                                   bary(e0, bias0, inv_a2));
        const bool in_box = in_x && k >= k_lo && k < k_hi;
        const float zm =
            (inside && in_box) ? zi : __int_as_float(0x7f800000);
        if (zm < z[k]) {  // strict: the earlier slot keeps a tie
          z[k] = zm;
          slot[k] = sl;
        }
      }
    }
    __syncwarp();
  }

  __syncthreads();  // no warp reads its stage any more
#pragma unroll
  for (int k = 0; k < RECT_H; ++k) {
    sm.part.z[warp][k][lane] = z[k];
    sm.part.slot[warp][k][lane] = slot[k];
  }
  __syncthreads();

  // Merge the warps' winners: the least z, and of equal z (float
  // equality: -0.0 == +0.0) the lowest slot, as the walk in slot order
  // keeps the first; the clear's slot -1 keeps a z of 1.0. Then the
  // winner's barycentrics, once. Each rectangle row is 32 consecutive
  // words: the stores coalesce.
  const size_t plane = static_cast<size_t>(h) * w;
  for (int k = warp; k < RECT_H; k += NWARP) {
    float zb = sm.part.z[0][k][lane];
    int sb = sm.part.slot[0][k][lane];
#pragma unroll
    for (int v = 1; v < NWARP; ++v) {
      const float zv = sm.part.z[v][k][lane];
      const int sv = sm.part.slot[v][k][lane];
      if (zv < zb || (zv == zb && sv < sb)) {
        zb = zv;
        sb = sv;
      }
    }
    const int y = y0 + k;
    float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f;
    if (sb >= 0)
      record_bary(gi + static_cast<size_t>(sb) * I_CH,
                  gf + static_cast<size_t>(sb) * fch, x, y, b0, b1, b2);
    const size_t i = static_cast<size_t>(y) * w + x;
    z_out[i] = zb;  // the winner's own bits; 1.0 where none won
    slot_out[i] = sb;
    b_out[i] = b0;
    b_out[plane + i] = b1;
    b_out[2 * plane + i] = b2;
  }
}

}  // namespace

// Launch B2 on `stream`. Pointers are device pointers: counts i32
// [n_tiles], setup_i i32 [n_tiles, cap, 12], setup_f f32 [n_tiles, cap,
// 7 + 3(n2+n3)]; z f32, slot i32 and lin f32 [n2+n3] planes, each [h, w],
// all written. Returns the CUDA error code of the launch (0 = ok).
extern "C" int rb_bins_raster(const void* counts, const void* setup_i,
                              const void* setup_f, void* z, void* slot,
                              void* lin, int n_tiles, int cap, int tile_h,
                              int tile_w, int n2, int n3, int h, int w,
                              void* stream) {
  if (tile_h != TILE_H || tile_w != TILE_W || h % TILE_H != 0 ||
      w % TILE_W != 0 || n_tiles != (h / TILE_H) * (w / TILE_W) || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  const int ntx = w / TILE_W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n2 == 4 && n3 == 0)  // per-vertex shading: 1/w and RGB
    err = launch<4, 0>(counts, setup_i, setup_f, z, slot, lin, n_tiles, cap,
                       ntx, h, w, st);
  else if (n2 == 4 && n3 == 6)  // per-pixel: + world positions and normals
    err = launch<4, 6>(counts, setup_i, setup_f, z, slot, lin, n_tiles, cap,
                       ntx, h, w, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

// Launch B3 on `stream`. Pointers are device pointers: counts i32
// [n_tiles], setup_i i32 [n_tiles, cap, 12], setup_f f32 [n_tiles, cap,
// fch] (fch >= 7); z f32 and slot i32 [h, w], b f32 [3, h, w], all
// written. Returns the CUDA error code of the launch (0 = ok).
extern "C" int rb_bins_gbuffer(const void* counts, const void* setup_i,
                               const void* setup_f, void* z, void* slot,
                               void* b, int n_tiles, int cap, int fch,
                               int tile_h, int tile_w, int h, int w,
                               void* stream) {
  if (tile_h != TILE_H || tile_w != TILE_W || h % TILE_H != 0 ||
      w % TILE_W != 0 || n_tiles != (h / TILE_H) * (w / TILE_W) || cap < 0 ||
      fch < F_CH)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  bins_gbuffer_kernel<<<dim3(n_tiles, RECTS), B3_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<const int*>(setup_i),
      static_cast<const float*>(setup_f), static_cast<float*>(z),
      static_cast<int*>(slot), static_cast<float*>(b), cap, fch, w / TILE_W,
      h, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rustexp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
