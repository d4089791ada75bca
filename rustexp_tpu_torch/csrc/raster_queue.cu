// Kernels B1 and B7 of the port: the flat-queue tile rasterizer and its
// depth race alone, for Hopper (sm_90a); and kernel T, the flat queue's
// per-frame transform, triangle setup and channel table (at the end).
//
// B1 replaces rustexp_tpu/ops/raster_queue.py::_queue_kernel (the Pallas
// kernel that raster_attrs_queue launches through pl.pallas_call). Python
// wrapper: rustexp_tpu_torch/ops/raster_queue.py::raster_attrs_queue_cuda;
// its plain PyTorch version, raster_attrs_queue_plain, sits beside it.
// B7 replaces _queue_kernel_zslot (raster_zslot_queue's pallas_call): the
// same kernel template with no planes, for the deferred frame, whose shade
// re-evaluates the winner's planes once per pixel. Wrapper:
// raster_zslot_queue_cuda; plain version: raster_zslot_queue_plain.
//
// What it computes. The queue is a list of chunks of CHUNK (tile, triangle)
// pairs; scal[c] = (ty, tx, first, count, global_ty) names chunk c's 16x128
// output tile. The chunks of one tile are consecutive and the tiles come in
// order (ty * ntx + tx ascending), as build_queue lays them out. For every
// pair and every pixel of its tile: 28.4 fixed-point edge functions in
// wrapping int32, the sign-OR inside test plus the triangle's AABB,
// barycentrics f32(e - bias) * inv_a2 rounded once, z by the 2-MAD lerp,
// and a depth race on (z, triangle id): a fragment wins when z < z_cur, or
// z == z_cur and tri < tri_cur, walking the tile's pairs in queue order (so
// the first of two equal keys, a triangle sitting in two slots, keeps the
// pixel). Winners store z and their queue slot; B1's also store the n2
// 2-MAD plus n3 3-weight planes. The race reads a pair's 12 int channels
// and float channels 0-6; B7's rows_f may carry more, fch a pair.
//
// The design. The walk is a lexicographic minimum over (z, tri, slot), so
// it may run in any order and be merged. A block owns a 4 x 32 rectangle
// of one tile (16 a tile; the grid covers every tile of the frame, so each
// output word is written once, by one grid), finds its tile's chunks by a
// search of scal, and its 4 warps race the tile's pairs dealt out
// round-robin in queue order (neighbouring pairs tend to lie side by side on
// the screen, so this spreads the pairs that meet the rectangle over the
// warps). A warp loads 32 pairs at once (one a lane; the rows are
// channel-major per chunk), keeps those whose AABB meets the rectangle,
// stages them in shared memory and races them one by one over the rectangle,
// each lane a column, the rows off the box masked, the race state in
// registers. The block then merges its warps' winners on (z, tri, slot); B1
// evaluates each pixel's planes once, for its winner, from rows_f at the
// winning slot: the same operations on the same pair give the same bits as
// a walk that carried the planes.
//
// Bound. Bytes: every output plane written once (z, slot and B1's n2 + n3
// planes over h + 16 rows) and each live pair's race channels read once.
// The work is the (pair, pixel) tests inside the pairs' boxes, here rounded
// up to a box row of the rectangle's width, and B1's one plane evaluation
// per won pixel. What it costs besides is latency: each block waits on the
// search of scal, its pairs' loads and (B1) its winners' loads in turn.
//
// Rounding. Built with -fmad=false, and every product and sum of a sealed
// chain is also spelled __fmul_rn/__fadd_rn, so no FMA can form: each op
// rounds once, as in the reference and the JAX package's sealed CPU chains.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 16;
constexpr int TILE_W = 128;
constexpr int CHUNK = 128;
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

// A block: an RECT_H x RECT_W rectangle of one tile (a lane a column) and
// NWARP warps, each racing its share of the tile's pairs. B1 and B7 share
// the shape: for B7 it won a sweep of 2 and 4 warps and 4 to 16 rows
// (PERF.md section 6), fewer warps or taller rectangles losing on crowded
// tiles.
constexpr int RECT_H = 4;
constexpr int RECT_W = 32;
constexpr int NWARP = 4;
constexpr int THREADS = NWARP * 32;
constexpr int RECTS_X = TILE_W / RECT_W;
constexpr int RECTS = (TILE_H / RECT_H) * RECTS_X;
static_assert(TILE_H % RECT_H == 0 && NWARP >= 2, "block shape");

// What a warp stages of one pair that may cover its rectangle: A0 A1 B0
// B1 | C0 C1 S tri | bias0 bias2 min_x max_x | z0 z10 z20 inv_a2 (bits)
// | first row, end row (within the rectangle), slot. 20 words: eight
// lanes' 16-byte stores fall in distinct banks.
struct Staged {
  int4 q[5];
};

// The winner's n2 + n3 planes at pixel (xf, y), from rows_f at its slot
// sb (0 where no pair won), stored `plane` words apart from `out`.
template <int N2, int N3>
__device__ __forceinline__ void store_planes(const int* __restrict__ rows_i,
                                             const float* __restrict__ rows_f,
                                             int sb, uint32_t xf, int y,
                                             float* __restrict__ out,
                                             size_t plane) {
  constexpr int NP = N2 + N3;
  constexpr int FCH = F_CH + 3 * NP;
  float lin[NP];
#pragma unroll
  for (int a = 0; a < NP; ++a) lin[a] = 0.0f;
  if (sb >= 0) {
    const int c = sb / CHUNK, p = sb % CHUNK;
    const int* gi = rows_i + static_cast<size_t>(c) * I_CH * CHUNK + p;
    const float* gf = rows_f + static_cast<size_t>(c) * FCH * CHUNK + p;
    const uint32_t yf = static_cast<uint32_t>(y) << 4;
    const float inv_a2 = __ldg(gf + 6 * CHUNK);
    const uint32_t e0 = static_cast<uint32_t>(__ldg(gi + 0 * CHUNK)) * xf +
                        static_cast<uint32_t>(__ldg(gi + 4 * CHUNK)) +
                        static_cast<uint32_t>(__ldg(gi + 2 * CHUNK)) * yf;
    const uint32_t e1 = static_cast<uint32_t>(__ldg(gi + 1 * CHUNK)) * xf +
                        static_cast<uint32_t>(__ldg(gi + 5 * CHUNK)) +
                        static_cast<uint32_t>(__ldg(gi + 3 * CHUNK)) * yf;
    const uint32_t e2 = static_cast<uint32_t>(__ldg(gi + 6 * CHUNK)) - e0 - e1;
    const float b0 = bary(e0, static_cast<int>(__ldg(gf)), inv_a2);
    const float b1 = bary(e1, static_cast<int>(__ldg(gf + CHUNK)), inv_a2);
    const float b2 = bary(e2, static_cast<int>(__ldg(gf + 2 * CHUNK)), inv_a2);
#pragma unroll
    for (int a = 0; a < N2; ++a)
      lin[a] = lerp_2mad(__ldg(gf + (F_CH + a) * CHUNK),
                         __ldg(gf + (F_CH + N2 + a) * CHUNK),
                         __ldg(gf + (F_CH + 2 * N2 + a) * CHUNK), b2, b0);
    constexpr int OFF = F_CH + 3 * N2;
#pragma unroll
    for (int a = 0; a < N3; ++a)
      lin[N2 + a] = lerp_3w(__ldg(gf + (OFF + a) * CHUNK),
                            __ldg(gf + (OFF + N3 + a) * CHUNK),
                            __ldg(gf + (OFF + 2 * N3 + a) * CHUNK), b1, b2,
                            b0);
  }
#pragma unroll
  for (int a = 0; a < NP; ++a) out[a * plane] = lin[a];
}

// B1 for N2 + N3 > 0 planes, B7 for none (lin_out unused). rows_f's
// chunks are fch channels apart: for B1 the compile-time F_CH + 3 * (N2 +
// N3), for B7 the argument (its rows_f may carry the planes it ignores).
template <int N2, int N3>
__global__ void __launch_bounds__(THREADS)
queue_raster_kernel(const int* __restrict__ scal,
                    const int* __restrict__ rows_i,
                    const float* __restrict__ rows_f,
                    float* __restrict__ z_out, int* __restrict__ slot_out,
                    float* __restrict__ lin_out, int s_cap, int fch_arg,
                    int hp, int w) {
  constexpr int NP = N2 + N3;
  const int fch = NP > 0 ? F_CH + 3 * NP : fch_arg;
  __shared__ int s_seg[2], s_lo, s_hi;
  // The race's stage, then (after a barrier) the warps' winners.
  __shared__ union {
    Staged stage[NWARP][32];
    struct {
      float z[NWARP][RECT_H][32];
      int tri[NWARP][RECT_H][32];
      int slot[NWARP][RECT_H][32];
    } part;
  } sm;

  const int ntx = w / TILE_W;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  const int ry = blockIdx.y / RECTS_X, rx = blockIdx.y - ry * RECTS_X;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = tx * TILE_W + rx * RECT_W;
  const int x = x0 + lane;
  const uint32_t xf = static_cast<uint32_t>(x) << 4;

  // The tile's chunks. Builders lay the chunks out in tile order (key ty *
  // ntx + tx ascending; build_queue puts its pad chunks, ty = nty, last),
  // so the tile's segment [s_seg[0], s_seg[1]) comes from two searches:
  // warp 0 finds the first key >= the tile's, warp 1 the first key past
  // it, each narrowing by 32 a round (one load a lane; two rounds up to
  // 1,024 chunks). Then the segment's chunks that hold pairs give the ends
  // of the race, the last one's count packed under its index (s_cap <
  // 2^23, count <= 128); its chunks share the tile's global row.
  const int tile = blockIdx.x;
  if (threadIdx.x == 0) {
    s_lo = INT_MAX;
    s_hi = -1;
  }
  if (warp < 2) {
    const int target = tile + warp;
    int lo = 0, hi = s_cap;  // keys before lo are < target, from hi on >=
    for (;;) {
      const int n = hi - lo, s = (n + 31) / 32;
      const int c = lo + lane * s;
      const bool less =
          lane * s < n && scal[5 * c] * ntx + scal[5 * c + 1] < target;
      const int k = __popc(__ballot_sync(0xffffffffu, less));
      if (k == 0 || s <= 1) {
        lo += k * s;
        break;
      }
      hi = min(lo + k * s, hi);
      lo += (k - 1) * s + 1;
    }
    if (lane == 0) s_seg[warp] = lo;
  }
  __syncthreads();
  for (int c = s_seg[0] + threadIdx.x; c < s_seg[1]; c += THREADS) {
    const int cnt = scal[5 * c + 3];
    if (cnt > 0) {
      atomicMin(&s_lo, c);
      atomicMax(&s_hi, c << 8 | min(cnt, CHUNK));
    }
  }
  __syncthreads();
  const bool busy = s_hi >= 0;
  const int c_lo = s_lo, c_hi = s_hi >> 8, cnt_hi = s_hi & 0xff;
  const int gty = busy ? scal[5 * c_lo + 4] : 0;

  // The clear. tri starts at INT32_MAX, so a fragment at exactly z == 1.0
  // beats it: the JAX kernel's quirk (raster_queue.py:717-724), kept for
  // frame parity; the reference's own depth test is strict (ROADMAP C).
  float z[RECT_H];
  int tri[RECT_H];
  int slot[RECT_H];
#pragma unroll
  for (int k = 0; k < RECT_H; ++k) {
    z[k] = 1.0f;
    tri[k] = INT_MAX;
    slot[k] = -1;
  }

  // Pixel rows come from the global row gty, output rows from ty.
  const int y0 = gty * TILE_H + ry * RECT_H;
  if (busy) {
    // The tile's pairs as virtual slots v = (c - c_lo) * CHUNK + p (a
    // slot past its chunk's count holds no pair). Warp w takes every
    // NWARP-th, from w on, in queue order: neighbouring pairs tend to lie
    // side by side on the screen, so dealing them out spreads the pairs
    // that meet the rectangle over the warps.
    const int n_v = (c_hi - c_lo) * CHUNK + cnt_hi;
    Staged* st = sm.stage[warp];
    for (int g = warp; g < n_v; g += 32 * NWARP) {
      const int v = g + lane * NWARP;
      bool hit = false;
      if (v < n_v) {
        const int c = c_lo + v / CHUNK, p = v % CHUNK;
        const int* sc = scal + 5 * c;
        const int* gi = rows_i + static_cast<size_t>(c) * I_CH * CHUNK + p;
        const float* gf = rows_f + static_cast<size_t>(c) * fch * CHUNK + p;
        // every channel the race reads, loaded together
        int ci[I_CH];
#pragma unroll
        for (int ch = 0; ch < I_CH; ++ch) ci[ch] = __ldg(gi + ch * CHUNK);
        float cf[F_CH];
#pragma unroll
        for (int ch = 0; ch < F_CH; ++ch) cf[ch] = __ldg(gf + ch * CHUNK);
        const int mnx = ci[7], mny = ci[8], mxx = ci[9], mxy = ci[10];
        hit = p < min(sc[3], CHUNK) && mnx < x0 + RECT_W && mxx > x0 &&
              mny < y0 + RECT_H && mxy > y0;
        if (hit) {
          Staged s;
          s.q[0] = make_int4(ci[0], ci[1], ci[2], ci[3]);
          s.q[1] = make_int4(ci[4], ci[5], ci[6], ci[11]);
          s.q[2] = make_int4(static_cast<int>(cf[0]), static_cast<int>(cf[2]),
                             mnx, mxx);
          s.q[3] = make_int4(__float_as_int(cf[3]), __float_as_int(cf[4]),
                             __float_as_int(cf[5]), __float_as_int(cf[6]));
          s.q[4] = make_int4(max(mny - y0, 0), min(mxy - y0, RECT_H),
                             c * CHUNK + p, 0);
          st[lane] = s;
        }
      }
      unsigned m = __ballot_sync(0xffffffffu, hit);
      __syncwarp();
      // A warp's pairs in queue order: a strict compare keeps the first of
      // a tie.
      while (m) {
        const Staged s = st[__ffs(m) - 1];
        m &= m - 1;
        // int32 edge math in uint32: the same wraparound, without the
        // undefined behaviour of signed overflow.
        const uint32_t A0 = s.q[0].x, A1 = s.q[0].y;
        const uint32_t B0 = s.q[0].z, B1 = s.q[0].w;
        const uint32_t C0 = s.q[1].x, C1 = s.q[1].y, S = s.q[1].z;
        const int tp = s.q[1].w;
        const int bias0 = s.q[2].x, bias2 = s.q[2].y;
        const bool in_x = x >= s.q[2].z && x < s.q[2].w;
        const float z0 = __int_as_float(s.q[3].x);
        const float z10 = __int_as_float(s.q[3].y);
        const float z20 = __int_as_float(s.q[3].z);
        const float inv_a2 = __int_as_float(s.q[3].w);
        const int k_lo = s.q[4].x, k_hi = s.q[4].y, sl = s.q[4].z;
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
          if (zm < z[k] || (zm == z[k] && tp < tri[k])) {
            z[k] = zm;
            tri[k] = tp;
            slot[k] = sl;
          }
        }
      }
      __syncwarp();
    }
  }

  __syncthreads();  // no warp reads its stage any more
#pragma unroll
  for (int k = 0; k < RECT_H; ++k) {
    sm.part.z[warp][k][lane] = z[k];
    sm.part.tri[warp][k][lane] = tri[k];
    sm.part.slot[warp][k][lane] = slot[k];
  }
  __syncthreads();

  // Merge the warps' winners: the least (z, tri), and of equal ones the
  // lowest slot, as a walk in queue order keeps the first (within a warp
  // the race ran in slot order); then (B1) evaluate the winner's planes
  // once. Each rectangle row is 32 consecutive words: the stores coalesce.
  for (int k = warp; k < RECT_H; k += NWARP) {
    float zb = sm.part.z[0][k][lane];
    int tb = sm.part.tri[0][k][lane];
    int sb = sm.part.slot[0][k][lane];
#pragma unroll
    for (int v = 1; v < NWARP; ++v) {
      const float zv = sm.part.z[v][k][lane];
      const int tv = sm.part.tri[v][k][lane];
      const int sv = sm.part.slot[v][k][lane];
      if (zv < zb || (zv == zb && (tv < tb || (tv == tb && sv < sb)))) {
        zb = zv;
        tb = tv;
        sb = sv;
      }
    }
    const size_t i =
        static_cast<size_t>(ty * TILE_H + ry * RECT_H + k) * w + x;
    z_out[i] = zb;  // the winner's own bits; 1.0 where none won
    slot_out[i] = sb;
    if constexpr (NP > 0)
      store_planes<N2, N3>(rows_i, rows_f, sb, xf, y0 + k, lin_out + i,
                           static_cast<size_t>(hp) * w);
  }
}

template <int N2, int N3>
cudaError_t launch(const void* scal, const void* rows_i, const void* rows_f,
                   void* z, void* slot, void* lin, int s_cap, int fch, int hp,
                   int w, cudaStream_t stream) {
  const dim3 grid((hp / TILE_H) * (w / TILE_W), RECTS);
  queue_raster_kernel<N2, N3><<<grid, THREADS, 0, stream>>>(
      static_cast<const int*>(scal), static_cast<const int*>(rows_i),
      static_cast<const float*>(rows_f), static_cast<float*>(z),
      static_cast<int*>(slot), static_cast<float*>(lin), s_cap, fch, hp, w);
  return cudaGetLastError();
}

// The checks both entries share: the queue's and the frame's shapes.
bool bad_shapes(int s_cap, int chunk, int tile_h, int tile_w, int hp, int w) {
  return chunk != CHUNK || tile_h != TILE_H || tile_w != TILE_W ||
         w % TILE_W != 0 || hp % TILE_H != 0 || hp <= 0 || w <= 0 ||
         s_cap < 0 || s_cap >= (1 << 23);
}

// ---------------------------------------------------------------------------
// Kernel T: the flat queue's transform, triangle setup and channel table.
//
// It replaces no Pallas kernel: the JAX package's transform_corners_planar,
// setup_triangles_planar, the planar 2-MAD and 3-weight channels
// (rustexp_tpu/raster/pipeline.py:300, :535-570) and pack_table
// (rustexp_tpu/ops/raster_queue.py:632) are plain XLA. Here they were some
// 200 eager launches over [T] planes a render, which the host paid for;
// this is one. Python wrapper: rustexp_tpu_torch/ops/raster_queue.py::
// queue_setup_cuda; the plain chain it repeats op for op is
// raster/pipeline.py's transform_corners_planar, setup_triangles_planar
// and queue_attr_channels, then pack_table.
//
// What it computes, a thread a triangle t: each corner's world position
// (ndim, fixed-order 4x4 products), clip coordinates (the world-to-viewport
// matrix, passed by value), 1/w and the viewport x, y, z; the 28.4 snap
// (saturating truncation, NaN to 0), the band's post-snap y shift, the
// edge gradients and constants with the fill biases, the 2-area cull and
// the clipped pixel AABB in wrapping int32 (unsigned arithmetic, as torch's
// int32 ops wrap), 1/(2 area) by IEEE division; then, with a table, the
// 2-MAD channels (1/w and the colour over w: baked corner colours, or the
// per-vertex colours gathered through tris) and the 3-weight channels
// (world position and normal over w, N3 = 6; the normal, N3 = 3). It
// writes TriSetupP's 20 word planes ([20, T], valid as T bytes after them)
// and the [T + 1, CH] channel table pack_table builds, its last row zero.
//
// Bound: bytes. A triangle reads 120 (its corners' planes) and writes 81
// (the setup) plus 4 CH (its table row), 361 in the per-pixel form (CH =
// 40), against some 150 ops; at T = 2,304, 0.83 MB, 0.25 us at 3.35 TB/s.
// What it costs is its launch and the latency of one pass. A block
// stages its rows of the table in shared memory and writes them as one
// contiguous run.
constexpr int SETUP_THREADS = 128;
constexpr int SETUP_PLANES = 20;  // TriSetupP's word planes before valid

// Kernel T's arguments, by value (Python: ops/raster_queue.py _SetupArgs).
// Device pointers: cp3 f32 [3, 4, T], cn3 and cc3 f32 [3, 3, T], colors
// f32 [V, 3] and tris i32 [T, 3] (vertex colours only), ndim f32 [4, 4],
// it33 f32 [3, 3], table f32 [T + 1, CH] (null: the setup alone), planes
// [20, T] words then T bytes. m: the world-to-viewport matrix, row-major.
struct SetupArgs {
  const float* cp3;
  const float* cn3;
  const float* cc3;
  const float* colors;
  const int* tris;
  const float* ndim;
  const float* it33;
  float* table;
  int* planes;
  int n_tris;
  int w;
  int h;
  int y_shift;
  float m[16];
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

// core/colors.py trunc_i32: toward zero, saturating, NaN -> 0.
__device__ __forceinline__ int32_t trunc_i32(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return INT_MAX;
  if (x <= -2147483648.0f) return INT_MIN;
  return static_cast<int32_t>(x);
}

// Row r of a fixed-order 4x4 product: ((m0 v0 + m1 v1) + m2 v2) + m3 v3.
__device__ __forceinline__ float mv4_row(const float* m, const float* v) {
  float s = __fmul_rn(m[0], v[0]);
  s = __fadd_rn(s, __fmul_rn(m[1], v[1]));
  s = __fadd_rn(s, __fmul_rn(m[2], v[2]));
  return __fadd_rn(s, __fmul_rn(m[3], v[3]));
}

__device__ __forceinline__ float mv3_row(const float* m, const float* v) {
  float s = __fmul_rn(m[0], v[0]);
  s = __fadd_rn(s, __fmul_rn(m[1], v[1]));
  return __fadd_rn(s, __fmul_rn(m[2], v[2]));
}

// The fill convention's edge bias: dy > 0, or dy == 0 and dx > 0.
__device__ __forceinline__ int32_t fill_bias(int32_t dy, int32_t dx) {
  return (dy > 0 || (dy == 0 && dx > 0)) ? 1 : 0;
}

// N3: the 3-weight channels (0, 3 normals, 6 world positions and normals);
// VCOL: the 2-MAD colours are per vertex (colors[tris]), else cc3's.
template <int N3, bool VCOL>
__global__ void __launch_bounds__(SETUP_THREADS)
queue_setup_kernel(const SetupArgs a) {
  constexpr int CH = I_CH + F_CH + 3 * (4 + N3);
  __shared__ float stage[SETUP_THREADS * CH];
  const int T = a.n_tris;
  const int t0 = blockIdx.x * SETUP_THREADS;
  const int t = t0 + threadIdx.x;

  if (t < T) {
    float nd[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) nd[k] = __ldg(a.ndim + k);
    float iw[3], vx[3], vy[3], vz[3], world[3][4];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float p[4], clip[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        p[k] = __ldg(a.cp3 + static_cast<size_t>(j * 4 + k) * T + t);
#pragma unroll
      for (int r = 0; r < 4; ++r) world[j][r] = mv4_row(nd + 4 * r, p);
#pragma unroll
      for (int r = 0; r < 4; ++r) clip[r] = mv4_row(a.m + 4 * r, world[j]);
      iw[j] = __fdiv_rn(1.0f, clip[3]);
      vx[j] = __fmul_rn(clip[0], iw[j]);
      vy[j] = __fmul_rn(clip[1], iw[j]);
      vz[j] = __fmul_rn(clip[2], iw[j]);
    }

    // setup_triangles_planar
    const int32_t ysh = static_cast<int32_t>(
        static_cast<uint32_t>(a.y_shift) << 4);
    int32_t x[3], y[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      x[j] = trunc_i32(__fmul_rn(vx[j], 16.0f));
      y[j] = wsub(trunc_i32(__fmul_rn(vy[j], 16.0f)), ysh);
    }
    const int32_t dx10 = wsub(x[1], x[0]), dy01 = wsub(y[0], y[1]);
    const int32_t dx21 = wsub(x[2], x[1]), dy12 = wsub(y[1], y[2]);
    const int32_t dx02 = wsub(x[0], x[2]), dy20 = wsub(y[2], y[0]);
    const int32_t area2 = wsub(wmul(wsub(x[1], x[0]), wsub(y[2], y[0])),
                               wmul(wsub(y[1], y[0]), wsub(x[2], x[0])));
    const bool front = area2 > 0;
    const float inv_a2 =
        front ? __fdiv_rn(1.0f, __int2float_rn(max(area2, 1))) : 0.0f;
    const int32_t e0a = fill_bias(dy01, dx10);
    const int32_t e1a = fill_bias(dy12, dx21);
    const int32_t e2a = fill_bias(dy20, dx02);
    const int32_t C0 = wadd(wadd(wsub(wmul(x[0], y[1]), wmul(y[0], x[1])),
                                 e0a), 1);
    const int32_t C1 = wadd(wadd(wsub(wmul(x[1], y[2]), wmul(y[1], x[2])),
                                 e1a), 1);
    const int32_t C2 = wadd(wadd(wsub(wmul(x[2], y[0]), wmul(y[2], x[0])),
                                 e2a), 1);
    const int32_t min_x =
        max(wadd(min(x[0], min(x[1], x[2])), 0xF) >> 4, 0);
    const int32_t min_y =
        max(wadd(min(y[0], min(y[1], y[2])), 0xF) >> 4, 0);
    const int32_t max_x =
        min(wadd(max(x[0], max(x[1], x[2])), 0xF) >> 4, a.w);
    const int32_t max_y =
        min(wadd(max(y[0], max(y[1], y[2])), 0xF) >> 4, a.h);
    const bool valid = front && max_x > min_x && max_y > min_y;
    const float bias0 = static_cast<float>(e0a + 1);
    const float bias1 = static_cast<float>(e1a + 1);
    const float bias2 = static_cast<float>(e2a + 1);
    const float z10 = __fsub_rn(vz[1], vz[0]);
    const float z20 = __fsub_rn(vz[2], vz[0]);

    // TriSetupP's planes, in its field order
    const int32_t words[SETUP_PLANES] = {
        dy01, dy12, dx10, dx21, C0, C1, C2, dy20, dx02,
        __float_as_int(bias0), __float_as_int(bias1), __float_as_int(bias2),
        __float_as_int(inv_a2), __float_as_int(vz[0]), __float_as_int(z10),
        __float_as_int(z20), min_x, min_y, max_x, max_y};
#pragma unroll
    for (int k = 0; k < SETUP_PLANES; ++k)
      a.planes[static_cast<size_t>(k) * T + t] = words[k];
    reinterpret_cast<unsigned char*>(
        a.planes + static_cast<size_t>(SETUP_PLANES) * T)[t] = valid;

    if (a.table != nullptr) {
      // pack_table's row: 12 int channels as bits, 7 floats, then the
      // attribute channels (base, d10, d20 of 1/w and RGB/w; then each
      // corner's 3-weight values times its 1/w)
      float* row = stage + threadIdx.x * CH;
      const int32_t ich[I_CH] = {dy01, dy12, dx10, dx21, C0, C1,
                                 wadd(wadd(C0, C1), C2), min_x, min_y,
                                 max_x, max_y, t};
#pragma unroll
      for (int k = 0; k < I_CH; ++k) row[k] = __int_as_float(ich[k]);
      const float fch[F_CH] = {bias0, bias1, bias2, vz[0], z10, z20, inv_a2};
#pragma unroll
      for (int k = 0; k < F_CH; ++k) row[I_CH + k] = fch[k];
      float q[3][4];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        q[j][0] = 1.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if constexpr (VCOL)
            q[j][k + 1] = __ldg(a.colors + 3 * static_cast<size_t>(
                                               __ldg(a.tris + 3 * t + j)) +
                                k);
          else
            q[j][k + 1] =
                __ldg(a.cc3 + static_cast<size_t>(j * 3 + k) * T + t);
        }
      }
      float* ch = row + I_CH + F_CH;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float base = __fmul_rn(q[0][c], iw[0]);
        ch[c] = base;
        ch[4 + c] = __fsub_rn(__fmul_rn(q[1][c], iw[1]), base);
        ch[8 + c] = __fsub_rn(__fmul_rn(q[2][c], iw[2]), base);
      }
      if constexpr (N3 > 0) {
        float it[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) it[k] = __ldg(a.it33 + k);
        float* c3 = ch + 12;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float nv[3];
#pragma unroll
          for (int k = 0; k < 3; ++k)
            nv[k] = __ldg(a.cn3 + static_cast<size_t>(j * 3 + k) * T + t);
          if constexpr (N3 == 6) {
#pragma unroll
            for (int k = 0; k < 3; ++k)
              *c3++ = __fmul_rn(world[j][k], iw[j]);
          }
#pragma unroll
          for (int r = 0; r < 3; ++r)
            *c3++ = __fmul_rn(mv3_row(it + 3 * r, nv), iw[j]);
        }
      }
    }
  }

  if (a.table != nullptr) {  // the same for every thread of the grid
    __syncthreads();
    const int n = max(0, min(SETUP_THREADS, T - t0)) * CH;
    float* dst = a.table + static_cast<size_t>(t0) * CH;
    for (int i = threadIdx.x; i < n; i += SETUP_THREADS) dst[i] = stage[i];
    if (blockIdx.x == gridDim.x - 1)  // the empty slot's all-zero row
      for (int i = threadIdx.x; i < CH; i += SETUP_THREADS)
        a.table[static_cast<size_t>(T) * CH + i] = 0.0f;
  }
}

template <int N3, bool VCOL>
cudaError_t launch_setup(const SetupArgs& a, cudaStream_t stream) {
  const int blocks = max(1, (a.n_tris + SETUP_THREADS - 1) / SETUP_THREADS);
  queue_setup_kernel<N3, VCOL><<<blocks, SETUP_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launch B1 on `stream` (one grid). Pointers are device pointers: scal
// i32 [s_cap, 5] in tile order, rows_i i32 [s_cap, 12, chunk], rows_f f32
// [s_cap, 7 + 3(n2+n3), chunk]; z f32, slot i32 and lin f32 [n2+n3]
// planes, each [hp, w], all written: z 1.0, slot -1 and planes 0 where no
// pair won.
// Returns the CUDA error code of the launch (0 = ok).
extern "C" int rq_queue_raster(const void* scal, const void* rows_i,
                               const void* rows_f, void* z, void* slot,
                               void* lin, int s_cap, int chunk, int tile_h,
                               int tile_w, int n2, int n3, int hp, int w,
                               void* stream) {
  if (bad_shapes(s_cap, chunk, tile_h, tile_w, hp, w))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int fch = F_CH + 3 * (n2 + n3);
  cudaError_t err;
  if (n2 == 4 && n3 == 0)  // per-vertex shading: 1/w and RGB
    err = launch<4, 0>(scal, rows_i, rows_f, z, slot, lin, s_cap, fch, hp, w,
                       st);
  else if (n2 == 4 && n3 == 3)  // per-pixel: + normals
    err = launch<4, 3>(scal, rows_i, rows_f, z, slot, lin, s_cap, fch, hp, w,
                       st);
  else if (n2 == 4 && n3 == 6)  // per-pixel: + world positions and normals
    err = launch<4, 6>(scal, rows_i, rows_f, z, slot, lin, s_cap, fch, hp, w,
                       st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

// Launch B7 on `stream` (one grid). Pointers are device pointers: scal i32
// [s_cap, 5] in tile order, rows_i i32 [s_cap, 12, chunk], rows_f f32
// [s_cap, fch, chunk] (fch >= 7; channels 0-6 are read); z f32 and slot
// i32, each [hp, w], all written: z 1.0 and slot -1 where no pair won.
// Returns the CUDA error code of the launch (0 = ok).
extern "C" int rq_queue_zslot(const void* scal, const void* rows_i,
                              const void* rows_f, void* z, void* slot,
                              int s_cap, int chunk, int tile_h, int tile_w,
                              int fch, int hp, int w, void* stream) {
  if (bad_shapes(s_cap, chunk, tile_h, tile_w, hp, w) || fch < F_CH)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<0, 0>(
      scal, rows_i, rows_f, z, slot, nullptr, s_cap, fch, hp, w,
      static_cast<cudaStream_t>(stream)));
}

// Launch kernel T on `stream` (one grid): TriSetupP's planes always, the
// channel table when args->table is set. n3 = -1: the setup alone (table
// null); 0: vertex colours through tris (the V modes); 3 or 6: the baked
// corner colours and the 3-weight channels. Returns the CUDA error code
// of the launch (0 = ok).
extern "C" int rq_queue_setup(const void* args, int n3, void* stream) {
  const SetupArgs& a = *static_cast<const SetupArgs*>(args);
  if (a.n_tris < 0 || a.n_tris >= (1 << 24) || a.w <= 0 || a.h <= 0 ||
      a.planes == nullptr || (n3 < 0) != (a.table == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n3 == -1)
    err = launch_setup<0, false>(a, st);
  else if (n3 == 0)
    err = launch_setup<0, true>(a, st);
  else if (n3 == 3)
    err = launch_setup<3, false>(a, st);
  else if (n3 == 6)
    err = launch_setup<6, false>(a, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

extern "C" const char* rustexp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
