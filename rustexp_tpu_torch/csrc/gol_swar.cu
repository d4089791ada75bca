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
// Design. The TPU kernel keeps the whole packed grid in VMEM for all k
// generations in one grid step. On the H100 a 256x256 grid packs into 8 KB
// and would fit one block, but 2048x2048 packs into 512 KB, more than a
// block's 227 KB, and no block can wait for another inside a launch. So
// every size takes one form: each launch runs up to GENS = 32 generations
// on tiles. A block loads an SR x SC word tile of the torus (its IR x IC
// interior, one halo word row above and below, HC halo columns left and
// right, read with wrap-around) into shared memory and steps it there with
// the wrap taken inside the tile. The wrong wrap at the tile's edge spoils
// one more cell row and one more column per generation; a halo word row is
// 32 cell rows and HC = 32 columns, so after 32 generations the interior is
// still exact (the same whole-word halo argument as the JAX package's
// multi_step_packed_banded). k generations take ceil(k / 32) launches,
// ping-ponging between the output and a scratch grid the wrapper
// allocates, the last one into the output. Each generation is two passes
// with a barrier after each: the vertical (s1, s0) of every word into two
// more tiles, then the box count and the rule in place (a thread reads only
// its own word of the grid in that pass).
//
// Bound. About 45 INT32 operations per packed word and generation; the
// packed grid crosses device memory once per launch (512 KB at 2048^2,
// which stays in the 50 MB L2). So the operations bound it; the tiles
// recompute (SR*SC)/(IR*IC) = 1.78 times the words.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int SR = 8;                 // tile word rows in shared memory
constexpr int SC = 256;               // tile columns in shared memory
constexpr int HW = 1;                 // halo word rows on each side
constexpr int HC = 32;                // halo columns on each side
constexpr int GENS = 32;              // generations per launch
constexpr int IR = SR - 2 * HW;       // interior word rows a block writes
constexpr int IC = SC - 2 * HC;       // interior columns a block writes
constexpr int THREADS = 512;
static_assert(GENS <= 32 * HW && GENS <= HC, "the halo absorbs GENS");

__device__ __forceinline__ int wrap(int x, int n) {
  const int m = x % n;
  return m < 0 ? m + n : m;
}

__global__ void __launch_bounds__(THREADS)
swar_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
            int wn, int cn, int gens) {
  __shared__ uint32_t p[SR * SC];
  __shared__ uint32_t s0[SR * SC];
  __shared__ uint32_t s1[SR * SC];
  const int r0 = blockIdx.y * IR - HW;
  const int c0 = blockIdx.x * IC - HC;

  for (int i = threadIdx.x; i < SR * SC; i += THREADS) {
    const int r = i / SC, c = i % SC;
    p[i] = in[static_cast<size_t>(wrap(r0 + r, wn)) * cn + wrap(c0 + c, cn)];
  }
  __syncthreads();

  for (int t = 0; t < gens; ++t) {
    for (int i = threadIdx.x; i < SR * SC; i += THREADS) {
      const int r = i / SC, c = i % SC;
      const uint32_t x = p[i];
      const uint32_t above = p[((r + SR - 1) % SR) * SC + c];
      const uint32_t below = p[((r + 1) % SR) * SC + c];
      // bit b of up is cell [32w + b - 1]: the row above
      const uint32_t up = (x << 1) | (above >> 31);
      const uint32_t down = (x >> 1) | (below << 31);
      s0[i] = up ^ x ^ down;
      s1[i] = (up & x) | (down & (up ^ x));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < SR * SC; i += THREADS) {
      const int r = i / SC, c = i % SC;
      const int li = r * SC + (c + SC - 1) % SC, ri = r * SC + (c + 1) % SC;
      const uint32_t l0 = s0[li], l1 = s1[li], r0_ = s0[ri], r1 = s1[ri];
      const uint32_t m0 = s0[i], m1 = s1[i];
      // box bit 0 and the carry into the 2s column
      const uint32_t b0 = l0 ^ m0 ^ r0_;
      const uint32_t c0_ = (l0 & m0) | (r0_ & (l0 ^ m0));
      // 2s column: l1 + m1 + r1 + c0 (0..4) -> bits b1, b2, b3
      const uint32_t sa = l1 ^ m1, ca = l1 & m1;
      const uint32_t sb = r1 ^ c0_, cb = r1 & c0_;
      const uint32_t b1 = sa ^ sb, c2 = sa & sb;
      const uint32_t b2 = ca ^ cb ^ c2;
      const uint32_t b3 = (ca & cb) | (c2 & (ca ^ cb));
      const uint32_t eq3 = b0 & b1 & ~(b2 | b3);
      const uint32_t eq4 = b2 & ~(b0 | b1 | b3);
      p[i] = eq3 | (p[i] & eq4);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < IR * IC; i += THREADS) {
    const int r = HW + i / IC, c = HC + i % IC;
    const int gr = r0 + r, gc = c0 + c;  // never negative
    if (gr < wn && gc < cn)
      out[static_cast<size_t>(gr) * cn + gc] = p[r * SC + c];
  }
}

}  // namespace

// Launch B4 on `stream`: k generations of the packed [wn, cn] uint32 grid
// `in` (device pointer, left unchanged) into `out`; `scratch` is a second
// [wn, cn] uint32 buffer. `*launched` counts the grid launches made.
// Returns the CUDA error code (0 = ok).
extern "C" int gs_swar(const void* in, void* out, void* scratch, int wn,
                       int cn, int k, void* stream, int* launched) {
  *launched = 0;
  if (wn <= 0 || cn <= 0 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((cn + IC - 1) / IC, (wn + IR - 1) / IR);
  const int launches = (k + GENS - 1) / GENS;
  const uint32_t* src = static_cast<const uint32_t*>(in);
  for (int l = 0; l < launches; ++l) {
    // alternate so that the last launch writes `out`
    uint32_t* dst = static_cast<uint32_t*>(
        (launches - 1 - l) % 2 == 0 ? out : scratch);
    const int gens = k - l * GENS < GENS ? k - l * GENS : GENS;
    swar_kernel<<<grid, THREADS, 0, st>>>(src, dst, wn, cn, gens);
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
