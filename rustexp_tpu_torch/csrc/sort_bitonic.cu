// Kernel B6 of the port: the bitonic key-value sort, for Hopper (sm_90a).
//
// Replaces rustexp_tpu/ops/sort_bitonic.py::_make_kernel and
// ::_make_kernel_loop (the two Pallas kernels that _run_network launches
// through pl.pallas_call; they run the same network, unrolled or in a
// loop). Python wrapper: rustexp_tpu_torch/ops/sort_bitonic.py::
// sort_kv_cuda; its plain PyTorch version, sort_kv_plain, sits beside it.
//
// What it computes. n = 2^p >= 256 elements, each an int32 key, an int32
// idx and nv 32-bit payload words. The network sorts by the lexicographic
// pair (key, idx): with distinct idx (positions) the result is the unique
// sorted order, equal to a stable argsort of the key followed by gathers,
// bit for bit. Stage k = 2, 4, ..., n has substages j = k/2, ..., 1; in
// each, element i with bit j clear and its partner i ^ j compare, and the
// pair is put in ascending order where i & k == 0, descending elsewhere.
// Payloads move with their keys.
//
// Design. On the TPU the array is a [n/128, 128] tile and the partner is
// fetched by rolls along lanes or sublanes; those are Mosaic's artefacts.
// Here the partner is i ^ j. Substages with j < L (L = 1024, or n when
// smaller) stay inside one L-element segment, so a block of L/2 threads
// loads the segment's keys, idx and payloads into shared memory, runs those
// substages there with a barrier between them, and stores it back: one
// launch sorts every segment (stages k <= L), and after the global
// substages of each later stage one launch runs its j < L tail. A substage
// with j >= L pairs elements of different segments, and no block can wait
// for another inside a launch, so each is one launch over device memory,
// one thread per pair, in place. At n = 131,072: 1 + 28 + 7 = 36 launches
// for the 153 substages.
//
// Bound. The least traffic is every array read once and written once:
// (2 + nv) * n * 4 bytes each way, 7.3 MB in all at n = 131,072 with five
// payloads, about 2.2 us at 3.35 TB/s. This kernel moves the arrays once
// per launch (36 times), mostly through the 50 MB L2.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_V = 8;     // payload arrays carried
constexpr int SEG = 1024;    // elements a block sorts in shared memory

struct Arrays {
  int32_t* key;
  int32_t* idx;
  uint32_t* v[MAX_V];
};

struct ConstArrays {
  const int32_t* key;
  const int32_t* idx;
  const uint32_t* v[MAX_V];
};

// (ka, ia) before (kb, ib) in the lexicographic order
__device__ __forceinline__ bool first(int32_t ka, int32_t ia, int32_t kb,
                                     int32_t ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// Sort stages k_first..k_last (powers of two), and for each the substages
// j < min(k, seg), on the seg-element segment of this block; src may be dst.
__global__ void segment_kernel(ConstArrays src, Arrays dst, int nv, int seg,
                               int k_first, int k_last) {
  extern __shared__ uint32_t smem[];
  int32_t* key = reinterpret_cast<int32_t*>(smem);
  int32_t* idx = key + seg;
  uint32_t* val = smem + 2 * seg;
  const size_t base = static_cast<size_t>(blockIdx.x) * seg;
  for (int i = threadIdx.x; i < seg; i += blockDim.x) {
    key[i] = src.key[base + i];
    idx[i] = src.idx[base + i];
    for (int a = 0; a < nv; ++a) val[a * seg + i] = src.v[a][base + i];
  }
  __syncthreads();
  for (int k = k_first; k <= k_last; k *= 2) {
    for (int j = (k < seg ? k : seg) / 2; j >= 1; j /= 2) {
      for (int t = threadIdx.x; t < seg / 2; t += blockDim.x) {
        const int i = (t / j) * 2 * j + t % j;  // bit j of i is clear
        const int p = i + j;
        const bool up = ((base + i) & static_cast<size_t>(k)) == 0;
        const bool swap = up ? first(key[p], idx[p], key[i], idx[i])
                             : first(key[i], idx[i], key[p], idx[p]);
        if (swap) {
          const int32_t tk = key[i], ti = idx[i];
          key[i] = key[p];
          idx[i] = idx[p];
          key[p] = tk;
          idx[p] = ti;
          for (int a = 0; a < nv; ++a) {
            const uint32_t tv = val[a * seg + i];
            val[a * seg + i] = val[a * seg + p];
            val[a * seg + p] = tv;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < seg; i += blockDim.x) {
    dst.key[base + i] = key[i];
    dst.idx[base + i] = idx[i];
    for (int a = 0; a < nv; ++a) dst.v[a][base + i] = val[a * seg + i];
  }
}

// One substage (j, k) with j >= the segment size, in place, a thread a pair.
__global__ void substage_kernel(Arrays a, int nv, int n, int j, int k) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n / 2) return;
  const int i = (t / j) * 2 * j + t % j;
  const int p = i + j;
  const int32_t ki = a.key[i], kp = a.key[p];
  const int32_t ii = a.idx[i], ip = a.idx[p];
  const bool up = (i & k) == 0;
  const bool swap = up ? first(kp, ip, ki, ii) : first(ki, ii, kp, ip);
  if (!swap) return;
  a.key[i] = kp;
  a.key[p] = ki;
  a.idx[i] = ip;
  a.idx[p] = ii;
  for (int v = 0; v < nv; ++v) {
    const uint32_t tv = a.v[v][i];
    a.v[v][i] = a.v[v][p];
    a.v[v][p] = tv;
  }
}

}  // namespace

// Launch B6 on `stream`: sort n elements (key_in, idx_in, nv payloads
// vals_in[a]) by (key, idx) into key_out, idx_out, vals_out[a]. The
// pointer arrays vals_in and vals_out live on the host and hold nv device
// pointers each; inputs are left unchanged. n must be a power of two
// >= 256 and nv <= 8. `*launched` counts the grid launches made.
// Returns the CUDA error code (0 = ok).
extern "C" int sb_sort(const void* key_in, const void* idx_in,
                       const void* const* vals_in, void* key_out,
                       void* idx_out, void* const* vals_out, int nv, int n,
                       void* stream, int* launched) {
  *launched = 0;
  if (n < 256 || (n & (n - 1)) != 0 || nv < 0 || nv > MAX_V)
    return static_cast<int>(cudaErrorInvalidValue);
  ConstArrays src{static_cast<const int32_t*>(key_in),
                  static_cast<const int32_t*>(idx_in), {}};
  Arrays dst{static_cast<int32_t*>(key_out), static_cast<int32_t*>(idx_out),
             {}};
  ConstArrays again{dst.key, dst.idx, {}};  // dst, read back in place
  for (int a = 0; a < nv; ++a) {
    src.v[a] = static_cast<const uint32_t*>(vals_in[a]);
    dst.v[a] = static_cast<uint32_t*>(vals_out[a]);
    again.v[a] = dst.v[a];
  }

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int seg = n < SEG ? n : SEG;
  const int segments = n / seg;
  const size_t smem = static_cast<size_t>(2 + nv) * seg * sizeof(uint32_t);
  segment_kernel<<<segments, seg / 2, smem, st>>>(src, dst, nv, seg, 2, seg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  constexpr int PAIR_THREADS = 256;
  const int pair_blocks = (n / 2 + PAIR_THREADS - 1) / PAIR_THREADS;
  for (int k = 2 * seg; k <= n; k *= 2) {
    for (int j = k / 2; j >= seg; j /= 2) {
      substage_kernel<<<pair_blocks, PAIR_THREADS, 0, st>>>(dst, nv, n, j, k);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      ++*launched;
    }
    segment_kernel<<<segments, seg / 2, smem, st>>>(again, dst, nv, seg, k,
                                                    k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  return 0;
}

extern "C" const char* rustexp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
