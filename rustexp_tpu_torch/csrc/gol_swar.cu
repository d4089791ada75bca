// Kernel B4 of the port: k Game of Life generations on the bit-packed grid
// (SWAR, 32 cells per word), for Hopper (sm_90a).
//
// Replaces rustexp_tpu/ops/gol_bits.py::_swar_kernel (the Pallas kernel
// that multi_step_packed launches through pl.pallas_call). Python wrapper:
// rustexp_tpu_torch/ops/gol_bits.py::multi_step_packed_cuda; its plain
// PyTorch version, multi_step_packed_plain, sits beside it.
//
// What it computes. The packed grid is [wn, cn] uint32 on a torus: bit b of
// word [w, c] is cell [32w + b, c]. One generation, as _gen_bits does it:
// the row above and below come from in-word shifts with the boundary bit
// taken from the word above or below, a carry-save adder gives the vertical
// 3-sum per cell as two bits (s1, s0), three such sums of neighbouring
// columns give the 4-bit 3x3 box count, and the cell lives when box == 3 or
// (alive and box == 4). Pure bit logic: bit-equal to the plain version.
//
// Bound. 18 integer instructions per word and generation: 2 funnel shifts
// for the rows above and below and 16 three-input logic ops (LOP3) for the
// adders and the rule (the SASS of the generation loop), on the integer
// pipe's 64 lanes per SM per clock; the exchange below adds 4 shuffles and
// 4 selects a word. The packed grid crosses device memory once per launch
// (512 KB at 2048^2, which stays in the 50 MB L2), so the operations bound
// it.
//
// Design. One thread owns one column of a tile and holds R word rows of it
// in registers. The rows above and below are in the same thread
// (__funnelshift_l/r with the word above or below, wrapping inside the R
// rows). The left and right neighbours' vertical sums (s0, s1) come by warp
// shuffle; only each warp's lanes 0 and 31 publish theirs in shared memory,
// double-buffered, so a generation has one barrier; every lane loads an
// edge entry and selects, so no branch splits the warp. Two forms, which the
// caller's plan (gol_bits._b4_plan) picks:
//
//  (a) "resident", small grids (wn <= 8 word rows, cn a multiple of 32 and
//      at most 1,024): the whole grid stays in the registers of one block
//      of cn threads for all k generations, in ONE launch. R = wn, so the
//      wrap inside a thread is the torus's, and so is the wrap from the
//      last warp to the first: no halo, no recompute, no relaunch. (Spread
//      over a cluster of 2, 4 or 8 CTAs that read each other's edges
//      through distributed shared memory, 256^2 took 0.97, 0.86 and 0.88
//      us a generation on an H100 against 0.51 on one block: the cluster
//      barrier costs more than the SMs it adds.)
//  (b) "tiled", any other 32-row-aligned grid: a block holds a B_ROWS x
//      B_COLS word tile of the torus (read with wrap-around: one halo word
//      row above and below, B_HC halo columns left and right) and steps it
//      B_GENS generations with the wrap taken inside the tile. The wrong
//      wrap at the tile's edge spoils one more cell row and one more column
//      each generation; a halo word row is 32 cell rows and B_HC = B_GENS
//      columns, so the B_IR x B_IC interior is still exact, and the block
//      writes it. k generations take ceil(k / B_GENS) launches,
//      ping-ponging between the output and a scratch grid the wrapper
//      allocates, the last one into the output. At 2048^2 the grid is 10 x
//      13 = 130 blocks of 8 warps (two on each scheduler of an SM), and
//      each computes (7 * 256) / (5 * 224) = 1.6 times its interior.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int B_ROWS = 7;    // form (b): word rows a thread holds
constexpr int B_COLS = 256;  // form (b): tile columns, one thread each
constexpr int B_HW = 1;      // form (b): halo word rows on each side
constexpr int B_HC = 16;     // form (b): halo columns on each side
constexpr int B_GENS = 16;   // form (b): generations per launch
constexpr int B_IR = B_ROWS - 2 * B_HW;  // interior word rows a block writes
constexpr int B_IC = B_COLS - 2 * B_HC;  // interior columns a block writes
static_assert(B_GENS <= 32 * B_HW && B_GENS <= B_HC, "the halo absorbs B_GENS");
constexpr int A_MAX_ROWS = 8;  // form (a): most word rows (256 cell rows)
constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int wrap(int x, int n) {
  const int m = x % n;
  return m < 0 ? m + n : m;
}

// The rule from the three columns' vertical sums: l = left, m = own,
// q = right, each (s0, s1); x = the cell words.
__device__ __forceinline__ uint32_t rule(uint32_t l0, uint32_t l1,
                                         uint32_t m0, uint32_t m1,
                                         uint32_t q0, uint32_t q1,
                                         uint32_t x) {
  // box bit 0 and the carry into the 2s column
  const uint32_t b0 = l0 ^ m0 ^ q0;
  const uint32_t c0 = (l0 & m0) | (q0 & (l0 ^ m0));
  // 2s column: l1 + m1 + q1 + c0 (0..4) -> bits b1, b2, b3
  const uint32_t sa = l1 ^ m1, ca = l1 & m1;
  const uint32_t sb = q1 ^ c0, cb = q1 & c0;
  const uint32_t b1 = sa ^ sb, c2 = sa & sb;
  const uint32_t b2 = ca ^ cb ^ c2;
  const uint32_t b3 = (ca & cb) | (c2 & (ca ^ cb));
  const uint32_t eq3 = b0 & b1 & ~(b2 | b3);
  const uint32_t eq4 = b2 & ~(b0 | b1 | b3);
  return eq3 | (x & eq4);
}

// One block steps `gens` generations of the tile whose word row 0 is
// r0 = blockIdx.y * ir - hw and whose column 0 is c0 = blockIdx.x * ic - hc,
// then writes the rows [hw, R - hw) and columns [hc, blockDim.x - hc) that
// lie on the grid.
template <int R, bool TILED>
__global__ void __launch_bounds__(TILED ? B_COLS : MAX_THREADS)
swar_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
            int wn, int cn, int gens, int ir, int ic, int hw, int hc) {
  // (s0, s1) of each warp's lane 0 (side 0) and lane 31 (side 1), by
  // generation parity
  __shared__ uint2 edges[2][MAX_WARPS][2][R];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // lane 0 reads its left neighbour's side 1, lane 31 its right one's side
  // 0; the first and last warps wrap to each other. Lanes 1-30 read the
  // right neighbour's entry and ignore it.
  const bool left = lane == 0, right = lane == 31;
  const int nb_warp = (warp + (left ? nwarps - 1 : 1)) % nwarps;
  const uint2* nb = &edges[0][nb_warp][left ? 1 : 0][0];
  constexpr int BUF = MAX_WARPS * 2 * R;  // buffer 1 after buffer 0

  const int r0 = blockIdx.y * ir - hw;
  const int c0 = blockIdx.x * ic - hc;
  const int gc = wrap(c0 + static_cast<int>(threadIdx.x), cn);
  uint32_t p[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    p[r] = in[static_cast<size_t>(wrap(r0 + r, wn)) * cn + gc];

  for (int t = 0; t < gens; ++t) {
    const int buf = t & 1;
    uint32_t s0[R], s1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // bit b of up is cell [32w + b - 1]: the row above
      const uint32_t up = __funnelshift_l(p[(r + R - 1) % R], p[r], 1);
      const uint32_t down = __funnelshift_r(p[r], p[(r + 1) % R], 1);
      s0[r] = up ^ p[r] ^ down;
      s1[r] = (up & p[r]) | (down & (up ^ p[r]));
    }
    if (left || right) {
      uint2* e = &edges[buf][warp][right][0];
#pragma unroll
      for (int r = 0; r < R; ++r) e[r] = make_uint2(s0[r], s1[r]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint2 e = nb[buf * BUF + r];
      const uint32_t u0 = __shfl_up_sync(FULL, s0[r], 1);
      const uint32_t u1 = __shfl_up_sync(FULL, s1[r], 1);
      const uint32_t d0 = __shfl_down_sync(FULL, s0[r], 1);
      const uint32_t d1 = __shfl_down_sync(FULL, s1[r], 1);
      p[r] = rule(left ? e.x : u0, left ? e.y : u1, s0[r], s1[r],
                  right ? e.x : d0, right ? e.y : d1, p[r]);
    }
  }

  const int col = c0 + static_cast<int>(threadIdx.x);
  if (static_cast<int>(threadIdx.x) < hc ||
      static_cast<int>(threadIdx.x) >= static_cast<int>(blockDim.x) - hc ||
      col >= cn)
    return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int gr = r0 + r;  // never negative for r >= hw
    if (r >= hw && r < R - hw && gr < wn)
      out[static_cast<size_t>(gr) * cn + col] = p[r];
  }
}

template <int R>
void launch_resident(const uint32_t* in, uint32_t* out, int cn, int k,
                     cudaStream_t st) {
  swar_kernel<R, false><<<1, cn, 0, st>>>(in, out, R, cn, k, R, cn, 0, 0);
}

}  // namespace

// Launch B4 on `stream`: k generations of the packed [wn, cn] uint32 grid
// `in` (device pointer, left unchanged) into `out`. form 1 is (a), the
// resident grid (wn <= 8, cn a multiple of 32 and at most 1,024): one
// launch. form 0 is (b), the tiles: ceil(k / 16) launches through
// `scratch`, a second [wn, cn] uint32 buffer. `*launched` counts the grid
// launches made. Returns the CUDA error code (0 = ok).
extern "C" int gs_swar(const void* in, void* out, void* scratch, int wn,
                       int cn, int k, int form, void* stream,
                       int* launched) {
  *launched = 0;
  if (wn <= 0 || cn <= 0 || k < 0 || (form != 0 && form != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* src = static_cast<const uint32_t*>(in);
  if (form == 1) {
    if (wn > A_MAX_ROWS || cn % 32 || cn > MAX_THREADS)
      return static_cast<int>(cudaErrorInvalidValue);
    uint32_t* dst = static_cast<uint32_t*>(out);
    switch (wn) {
      case 1: launch_resident<1>(src, dst, cn, k, st); break;
      case 2: launch_resident<2>(src, dst, cn, k, st); break;
      case 3: launch_resident<3>(src, dst, cn, k, st); break;
      case 4: launch_resident<4>(src, dst, cn, k, st); break;
      case 5: launch_resident<5>(src, dst, cn, k, st); break;
      case 6: launch_resident<6>(src, dst, cn, k, st); break;
      case 7: launch_resident<7>(src, dst, cn, k, st); break;
      case 8: launch_resident<8>(src, dst, cn, k, st); break;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    *launched = 1;
    return 0;
  }
  const dim3 grid((cn + B_IC - 1) / B_IC, (wn + B_IR - 1) / B_IR);
  const int launches = (k + B_GENS - 1) / B_GENS;
  for (int l = 0; l < launches; ++l) {
    // alternate so that the last launch writes `out`
    uint32_t* to = static_cast<uint32_t*>(
        (launches - 1 - l) % 2 == 0 ? out : scratch);
    const int gens = k - l * B_GENS < B_GENS ? k - l * B_GENS : B_GENS;
    swar_kernel<B_ROWS, true><<<grid, B_COLS, 0, st>>>(
        src, to, wn, cn, gens, B_IR, B_IC, B_HW, B_HC);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    src = to;
  }
  return 0;
}

extern "C" const char* rustexp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
