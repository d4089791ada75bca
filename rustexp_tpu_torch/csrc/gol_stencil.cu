// Kernel B8 of the port: k fused Game of Life generations of the f32 torus
// stencil, for Hopper (sm_90a).
//
// Replaces rustexp_tpu/ops/gol_stencil.py::_gol_pallas_kernel (the Pallas
// kernel that multi_step_pallas launches through pl.pallas_call). Python
// wrapper: rustexp_tpu_torch/ops/gol_stencil.py::multi_step_pallas_cuda;
// its plain PyTorch version, multi_step_pallas_plain, sits beside it.
//
// What it computes. The grid is [rows, cols] f32 cells of 0 or 1 on a
// torus, any rows, cols >= 1. One generation: the vertical 3-sum rs = g +
// g[r-1] + g[r+1], then nb = rs + rs[c-1] + rs[c+1] - g, and the cell
// lives when nb == 3 or (g == 1 and nb == 2). All values are small
// integers, so every f32 sum is exact and any exact count gives the plain
// version's bits: here the cells are bits and the count is a carry-save
// adder, as in kernel B4 (csrc/gol_swar.cu); the output is 1.0f or 0.0f.
//
// Design. The TPU kernel keeps the whole grid in VMEM for all k generations
// in one grid step. A Hopper block cannot hold a 256x256 f32 grid, and no
// block can wait for another inside a launch, so each launch runs up to
// `halo` generations on tiles. A block is one warp and owns a 32 x 32 tile
// of the torus: its interior of (32 - 2 halo)^2 cells plus `halo` cells on
// each side. Lane c loads column c of the tile (the torus wrap taken once,
// here: neighbouring lanes read neighbouring words of a row) and packs its
// 32 rows into one register, bit r = row r. A generation is then a few
// instructions for the lane's 32 cells: the rows above and below are the
// word shifted by one (zeros past the tile's edge), a carry-save adder
// gives the vertical 3-sum as two bit planes (s0, s1), the left and right
// columns' planes come from the neighbouring lanes by four warp shuffles
// (the edge lanes get their own: past the tile's edge), and B4's rule
// gives the next word. No shared memory, no barrier, no index arithmetic
// in the loop. The wrong values at the tile's edge spoil one more ring of
// cells per generation, so after `halo` generations the interior is still
// exact, and the lanes [halo, 32 - halo) store its rows [halo, 32 - halo).
// k generations take ceil(k / halo) launches, ping-ponging between the
// output and a scratch grid the wrapper allocates, the last one into the
// output; the wrapper's plan (gol_stencil._b8_plan) picks halo <= 8 so
// that the launches share the generations evenly. At 512x512 and halo 7
// a launch is 29 x 29 = 841 blocks, at 256x256 and halo 8 16 x 16 = 256,
// against the card's 132 SMs.
//
// Bound. A generation of 32 packed cells is 18 integer instructions
// (kernel B4's count: 2 shifts and 16 three-input logic ops) on the
// integer pipe's 64 lanes per SM and clock; the f32 grid read once and
// written once governs at these sizes. The tiles read (32 / (32 - 2
// halo))^2 times the grid, from the 50 MB L2 after the first launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;      // a tile is TILE x TILE cells, one warp
constexpr int MAX_HALO = 8;   // generations per launch at most
constexpr unsigned FULL = 0xffffffffu;

// The rule from the three columns' vertical sums: l = left, m = own,
// q = right, each (s0, s1); x = the cell words (csrc/gol_swar.cu).
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

// One block steps `gens` (<= halo) generations of the tile whose row 0 is
// r0 = blockIdx.y * inner - halo and whose column 0 is c0 = blockIdx.x *
// inner - halo (inner = TILE - 2 halo), then writes its interior cells
// that lie on the grid.
__global__ void __launch_bounds__(TILE)
stencil_kernel(const float* __restrict__ in, float* __restrict__ out,
               int rows, int cols, int gens, int halo) {
  const int lane = threadIdx.x;
  const int inner = TILE - 2 * halo;
  const int r0 = static_cast<int>(blockIdx.y) * inner - halo;
  const int c0 = static_cast<int>(blockIdx.x) * inner - halo;

  // The torus wrap, once: the lane's column and the tile's first row.
  int gc = (c0 + lane) % cols;
  if (gc < 0) gc += cols;
  int gr = r0 % rows;
  if (gr < 0) gr += rows;
  uint32_t p = 0;
#pragma unroll
  for (int r = 0; r < TILE; ++r) {
    p |= static_cast<uint32_t>(
             __ldg(in + static_cast<size_t>(gr) * cols + gc) == 1.0f)
         << r;
    gr = gr + 1 == rows ? 0 : gr + 1;
  }

  for (int t = 0; t < gens; ++t) {
    const uint32_t up = p << 1;    // bit r: the cell in row r - 1
    const uint32_t down = p >> 1;  // bit r: the cell in row r + 1
    const uint32_t s0 = up ^ p ^ down;
    const uint32_t s1 = (up & p) | (down & (up ^ p));
    const uint32_t l0 = __shfl_up_sync(FULL, s0, 1);
    const uint32_t l1 = __shfl_up_sync(FULL, s1, 1);
    const uint32_t q0 = __shfl_down_sync(FULL, s0, 1);
    const uint32_t q1 = __shfl_down_sync(FULL, s1, 1);
    p = rule(l0, l1, s0, s1, q0, q1, p);
  }

  const int col = c0 + lane;  // never negative for lane >= halo
  if (lane < halo || lane >= TILE - halo || col >= cols) return;
#pragma unroll
  for (int r = 0; r < TILE; ++r) {
    const int row = r0 + r;
    if (r >= halo && r < TILE - halo && row < rows)
      out[static_cast<size_t>(row) * cols + col] = (p >> r) & 1u ? 1.0f
                                                                 : 0.0f;
  }
}

}  // namespace

// Launch B8 on `stream`: k generations of the [rows, cols] f32 grid `in`
// (device pointer, left unchanged) into `out`, `halo` (1..8) generations a
// launch: ceil(k / halo) launches through `scratch`, a second [rows, cols]
// f32 buffer (unused for one launch). `*launched` counts the grid launches
// made. Returns the CUDA error code (0 = ok).
extern "C" int gs_stencil(const void* in, void* out, void* scratch, int rows,
                          int cols, int k, int halo, void* stream,
                          int* launched) {
  *launched = 0;
  if (rows <= 0 || cols <= 0 || k < 0 || halo < 1 || halo > MAX_HALO)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int inner = TILE - 2 * halo;
  const dim3 grid((cols + inner - 1) / inner, (rows + inner - 1) / inner);
  const int launches = (k + halo - 1) / halo;
  const float* src = static_cast<const float*>(in);
  for (int l = 0; l < launches; ++l) {
    // alternate so that the last launch writes `out`
    float* dst = static_cast<float*>((launches - 1 - l) % 2 == 0 ? out
                                                                 : scratch);
    const int gens = k - l * halo < halo ? k - l * halo : halo;
    stencil_kernel<<<grid, TILE, 0, st>>>(src, dst, rows, cols, gens, halo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    src = dst;
  }
  return 0;
}

extern "C" const char* rustexp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
