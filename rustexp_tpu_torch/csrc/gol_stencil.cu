// Kernel B8 of the port: k fused Game of Life generations of the f32 torus
// stencil, for Hopper (sm_90a).
//
// Replaces rustexp_tpu/ops/gol_stencil.py::_gol_pallas_kernel (the Pallas
// kernel that multi_step_pallas launches through pl.pallas_call). Python
// wrapper: rustexp_tpu_torch/ops/gol_stencil.py::multi_step_pallas_cuda;
// its plain PyTorch version, multi_step_pallas_plain, sits beside it.
//
// What it computes. The grid is [rows, cols] f32 cells of 0 or 1 on a
// torus. One generation: the vertical 3-sum rs = g + g[r-1] + g[r+1], then
// nb = rs + rs[c-1] + rs[c+1] - g, and the cell lives when nb == 3 or
// (g == 1 and nb == 2). All values are small integers, so every sum is
// exact in f32 and the result is bit-equal to the plain version.
//
// Design. The TPU kernel keeps the whole grid in VMEM for all k generations
// in one grid step. A Hopper block has 227 KB of shared memory, less than
// one 256x256 f32 grid, and no block can wait for another inside a launch.
// So each launch runs up to HALO generations on tiles: a block loads a
// SR x SC tile of the torus (its IR x IC interior plus HALO cells on each
// side, read with wrap-around from device memory) into shared memory,
// steps it there with the wrap taken inside the tile, and writes back the
// interior. The wrong wrap at the tile's edge spoils one more ring of cells
// per generation, so after HALO generations the interior is still exact.
// k generations take ceil(k / HALO) launches, ping-ponging between the
// output and a scratch grid the wrapper allocates, the last one into the
// output. Each generation is two passes over the tile with a barrier after
// each: the vertical sums into a second tile, then the rule in place (a
// thread reads only its own cell of g in that pass).
//
// Bound. Per cell and generation about 11 FP32 operations (5 adds, 3
// compares, and, or, select); the grid crosses device memory once per
// launch, which stays in the 50 MB L2 at these sizes. So the operations
// bound it; the tiles recompute (SR*SC)/(IR*IC) = 1.52 times the cells.

#include <cuda_runtime.h>

namespace {

constexpr int SR = 64;                // tile rows in shared memory
constexpr int SC = 128;               // tile columns in shared memory
constexpr int HALO = 8;               // generations per launch = halo cells
constexpr int IR = SR - 2 * HALO;     // interior rows a block writes
constexpr int IC = SC - 2 * HALO;     // interior columns a block writes
constexpr int THREADS = 512;
constexpr int SMEM = 2 * SR * SC * static_cast<int>(sizeof(float));

__device__ __forceinline__ int wrap(int x, int n) {
  const int m = x % n;
  return m < 0 ? m + n : m;
}

__global__ void __launch_bounds__(THREADS)
stencil_kernel(const float* __restrict__ in, float* __restrict__ out,
               int rows, int cols, int gens) {
  extern __shared__ float smem[];
  float* g = smem;              // the tile's cells
  float* rs = smem + SR * SC;   // its vertical 3-sums
  const int r0 = blockIdx.y * IR - HALO;
  const int c0 = blockIdx.x * IC - HALO;

  for (int i = threadIdx.x; i < SR * SC; i += THREADS) {
    const int r = i / SC, c = i % SC;
    g[i] = in[static_cast<size_t>(wrap(r0 + r, rows)) * cols +
              wrap(c0 + c, cols)];
  }
  __syncthreads();

  for (int t = 0; t < gens; ++t) {
    for (int i = threadIdx.x; i < SR * SC; i += THREADS) {
      const int r = i / SC, c = i % SC;
      rs[i] = g[i] + g[((r + SR - 1) % SR) * SC + c] +
              g[((r + 1) % SR) * SC + c];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < SR * SC; i += THREADS) {
      const int r = i / SC, c = i % SC;
      const float cell = g[i];
      const float nb = rs[i] + rs[r * SC + (c + SC - 1) % SC] +
                       rs[r * SC + (c + 1) % SC] - cell;
      g[i] = (nb == 3.0f || (cell == 1.0f && nb == 2.0f)) ? 1.0f : 0.0f;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < IR * IC; i += THREADS) {
    const int r = HALO + i / IC, c = HALO + i % IC;
    const int gr = r0 + r, gc = c0 + c;  // never negative
    if (gr < rows && gc < cols)
      out[static_cast<size_t>(gr) * cols + gc] = g[r * SC + c];
  }
}

}  // namespace

// Launch B8 on `stream`: k generations of the [rows, cols] f32 grid `in`
// (device pointer, left unchanged) into `out`; `scratch` is a second
// [rows, cols] f32 buffer. `*launched` counts the grid launches made.
// Returns the CUDA error code (0 = ok).
extern "C" int gs_stencil(const void* in, void* out, void* scratch, int rows,
                          int cols, int k, void* stream, int* launched) {
  *launched = 0;
  if (rows <= 0 || cols <= 0 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      stencil_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((cols + IC - 1) / IC, (rows + IR - 1) / IR);
  const int launches = (k + HALO - 1) / HALO;
  const float* src = static_cast<const float*>(in);
  for (int l = 0; l < launches; ++l) {
    // alternate so that the last launch writes `out`
    float* dst = static_cast<float*>((launches - 1 - l) % 2 == 0 ? out
                                                                 : scratch);
    const int gens = k - l * HALO < HALO ? k - l * HALO : HALO;
    stencil_kernel<<<grid, THREADS, SMEM, st>>>(src, dst, rows, cols, gens);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    src = dst;
  }
  return 0;
}

extern "C" const char* rustexp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
