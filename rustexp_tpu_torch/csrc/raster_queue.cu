// Kernel B1 of the port: the flat-queue tile rasterizer, for Hopper (sm_90a).
//
// Replaces rustexp_tpu/ops/raster_queue.py::_queue_kernel (the Pallas
// kernel that raster_attrs_queue launches through pl.pallas_call). Python
// wrapper: rustexp_tpu_torch/ops/raster_queue.py::raster_attrs_queue_cuda;
// its plain PyTorch version, raster_attrs_queue_plain, sits beside it.
//
// What it computes. The queue is a list of chunks of CHUNK (tile, triangle)
// pairs; scal[c] = (ty, tx, first, count, global_ty) names chunk c's 16x128
// output tile. The chunks of one tile are consecutive and the first of them
// has first == 1. For every pair and every pixel of its tile: 28.4
// fixed-point edge functions in wrapping int32, the sign-OR inside test
// plus the triangle's AABB, barycentrics f32(e - bias) * inv_a2 rounded
// once, z by the 2-MAD lerp, and a depth race on (z, triangle id): a
// fragment wins when z < z_cur, or z == z_cur and tri < tri_cur. Winners
// store z, their queue slot and the n2 2-MAD plus n3 3-weight planes.
//
// Design. The TPU grid walks chunks in order on one core. Here one block
// per chunk with first == 1 owns that tile and walks the tile's chunks in
// queue order, so the race runs in the same order with no atomics; the
// other blocks exit at once. 256 threads hold 8 pixels each (one column,
// every other row) and keep the race state in registers. Each chunk's pair
// constants (12 int and 7 + 3(n2+n3) float channels x 128 pairs, at most
// 20 KB) are staged in shared memory and read as broadcasts.
//
// Bound. INT32/FP32 issue per (pair, pixel): about 25 operations for the
// edge, box and depth test, plus 2 or 3 per attribute plane on a win. With
// the constants in shared memory the pair loop reads no device memory, so
// what is left is that arithmetic, spread over one block per occupied tile
// (at most 128 at 512x512, fewer than the card's 132 SMs can hold).
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
constexpr int THREADS = 256;
constexpr int ROW_STEP = THREADS / TILE_W;  // rows one pass of the block covers
constexpr int PX = TILE_H / ROW_STEP;       // pixels per thread
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

template <int N2, int N3>
__global__ void __launch_bounds__(THREADS)
queue_raster_kernel(const int* __restrict__ scal,
                    const int* __restrict__ rows_i,
                    const float* __restrict__ rows_f,
                    float* __restrict__ z_out, int* __restrict__ slot_out,
                    float* __restrict__ lin_out, int s_cap, int hp, int w) {
  constexpr int NP = N2 + N3;
  constexpr int FCH = F_CH + 3 * NP;
  static_assert(NP > 0, "at least one attribute plane");
  __shared__ int si[I_CH * CHUNK];
  __shared__ float sf[FCH * CHUNK];

  const int c0 = blockIdx.x;
  if (scal[5 * c0 + 2] != 1) return;  // walked by its tile's first block
  const int ty = scal[5 * c0 + 0];
  const int tx = scal[5 * c0 + 1];
  const int row0 = threadIdx.x / TILE_W;
  const int x = tx * TILE_W + threadIdx.x % TILE_W;
  const uint32_t xf = static_cast<uint32_t>(x) << 4;

  // The clear. tri starts at INT32_MAX, so a fragment at exactly z == 1.0
  // beats it: the JAX kernel's quirk (raster_queue.py:717-724), kept for
  // frame parity; the reference's own depth test is strict (ROADMAP C).
  float z[PX];
  int tri[PX];
  int slot[PX];
  float lin[PX][NP];
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    z[k] = 1.0f;
    tri[k] = INT_MAX;
    slot[k] = -1;
#pragma unroll
    for (int a = 0; a < NP; ++a) lin[k][a] = 0.0f;
  }

  for (int c = c0; c < s_cap; ++c) {
    const int* sc = scal + 5 * c;
    if (c != c0 && (sc[2] != 0 || sc[0] != ty || sc[1] != tx)) break;
    const int cnt = min(max(sc[3], 0), CHUNK);
    const int gty = sc[4];
    __syncthreads();  // nobody reads the previous chunk's constants any more
    const int* gi = rows_i + static_cast<size_t>(c) * I_CH * CHUNK;
    const float* gf = rows_f + static_cast<size_t>(c) * FCH * CHUNK;
    for (int k = threadIdx.x; k < I_CH * CHUNK; k += THREADS) si[k] = gi[k];
    for (int k = threadIdx.x; k < FCH * CHUNK; k += THREADS) sf[k] = gf[k];
    __syncthreads();

    for (int p = 0; p < cnt; ++p) {
      // int32 edge math in uint32: the same wraparound, without the
      // undefined behaviour of signed overflow.
      const uint32_t A0 = si[0 * CHUNK + p], A1 = si[1 * CHUNK + p];
      const uint32_t B0 = si[2 * CHUNK + p], B1 = si[3 * CHUNK + p];
      const uint32_t C0 = si[4 * CHUNK + p], C1 = si[5 * CHUNK + p];
      const uint32_t S = si[6 * CHUNK + p];
      const int mnx = si[7 * CHUNK + p], mny = si[8 * CHUNK + p];
      const int mxx = si[9 * CHUNK + p], mxy = si[10 * CHUNK + p];
      const int tp = si[11 * CHUNK + p];
      const int bias0 = static_cast<int>(sf[0 * CHUNK + p]);
      const int bias1 = static_cast<int>(sf[1 * CHUNK + p]);
      const int bias2 = static_cast<int>(sf[2 * CHUNK + p]);
      const float z0 = sf[3 * CHUNK + p], z10 = sf[4 * CHUNK + p];
      const float z20 = sf[5 * CHUNK + p], inv_a2 = sf[6 * CHUNK + p];
      const bool in_x = x >= mnx && x < mxx;
      const uint32_t ex0 = A0 * xf + C0, ex1 = A1 * xf + C1;
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        const int y = gty * TILE_H + row0 + k * ROW_STEP;
        const uint32_t yf = static_cast<uint32_t>(y) << 4;
        // e = A*xf + B*yf + C; wrapping addition is associative
        const uint32_t e0 = ex0 + B0 * yf;
        const uint32_t e1 = ex1 + B1 * yf;
        const uint32_t e2 = S - e0 - e1;
        const bool inside = static_cast<int32_t>(e0 | e1 | e2) >= 0;
        const bool in_box = in_x && y >= mny && y < mxy;
        const float b0 = bary(e0, bias0, inv_a2);
        const float b2 = bary(e2, bias2, inv_a2);
        const float zi = lerp_2mad(z0, z10, z20, b2, b0);
        const float zm = (inside && in_box) ? zi : __int_as_float(0x7f800000);
        if (zm < z[k] || (zm == z[k] && tp < tri[k])) {
          const float b1 = bary(e1, bias1, inv_a2);
          z[k] = zm;
          tri[k] = tp;
          slot[k] = c * CHUNK + p;
#pragma unroll
          for (int a = 0; a < N2; ++a)
            lin[k][a] = lerp_2mad(sf[(F_CH + a) * CHUNK + p],
                                  sf[(F_CH + N2 + a) * CHUNK + p],
                                  sf[(F_CH + 2 * N2 + a) * CHUNK + p], b2, b0);
          constexpr int OFF = F_CH + 3 * N2;
#pragma unroll
          for (int a = 0; a < N3; ++a)
            lin[k][N2 + a] = lerp_3w(sf[(OFF + a) * CHUNK + p],
                                     sf[(OFF + N3 + a) * CHUNK + p],
                                     sf[(OFF + 2 * N3 + a) * CHUNK + p],
                                     b1, b2, b0);
        }
      }
    }
  }

  // Each tile row is 128 consecutive words: the stores coalesce.
  const size_t plane = static_cast<size_t>(hp) * w;
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const size_t i =
        static_cast<size_t>(ty * TILE_H + row0 + k * ROW_STEP) * w + x;
    z_out[i] = z[k];
    slot_out[i] = slot[k];
#pragma unroll
    for (int a = 0; a < NP; ++a) lin_out[a * plane + i] = lin[k][a];
  }
}

template <int N2, int N3>
cudaError_t launch(const void* scal, const void* rows_i, const void* rows_f,
                   void* z, void* slot, void* lin, int s_cap, int hp, int w,
                   cudaStream_t stream) {
  queue_raster_kernel<N2, N3><<<s_cap, THREADS, 0, stream>>>(
      static_cast<const int*>(scal), static_cast<const int*>(rows_i),
      static_cast<const float*>(rows_f), static_cast<float*>(z),
      static_cast<int*>(slot), static_cast<float*>(lin), s_cap, hp, w);
  return cudaGetLastError();
}

}  // namespace

// Launch B1 on `stream`. Pointers are device pointers: scal i32 [s_cap, 5],
// rows_i i32 [s_cap, 12, chunk], rows_f f32 [s_cap, 7 + 3(n2+n3), chunk];
// z f32, slot i32 (prefilled with -1 by the caller) and lin f32 [n2+n3]
// planes, each [hp, w]. Returns the CUDA error code of the launch (0 = ok).
extern "C" int rq_queue_raster(const void* scal, const void* rows_i,
                               const void* rows_f, void* z, void* slot,
                               void* lin, int s_cap, int chunk, int tile_h,
                               int tile_w, int n2, int n3, int hp, int w,
                               void* stream) {
  if (chunk != CHUNK || tile_h != TILE_H || tile_w != TILE_W ||
      w % TILE_W != 0 || hp % TILE_H != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (s_cap <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n2 == 4 && n3 == 0)  // per-vertex shading: 1/w and RGB
    err = launch<4, 0>(scal, rows_i, rows_f, z, slot, lin, s_cap, hp, w, st);
  else if (n2 == 4 && n3 == 3)  // per-pixel: + normals
    err = launch<4, 3>(scal, rows_i, rows_f, z, slot, lin, s_cap, hp, w, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

extern "C" const char* rustexp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
