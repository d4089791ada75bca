// Kernel B6 of the port: a stable LSD radix sort that carries one
// permutation, for Hopper (sm_90a).
//
// Replaces rustexp_tpu/ops/sort_bitonic.py::_make_kernel (:125) and
// ::_make_kernel_loop (:157), the two Pallas kernels that _run_network
// launches through pl.pallas_call (:228 and :220); they run the same
// bitonic network, unrolled or in a loop. Python wrapper:
// rustexp_tpu_torch/ops/sort_bitonic.py::sort_kv_cuda; its plain PyTorch
// version, sort_kv_plain, sits beside it.
//
// What it computes. n = 2^p >= 256 elements, each an int32 key, an int32
// idx (the positions unless given) and nv 32-bit payload words, permuted
// into the lexicographic (key, idx) order with signed comparisons: with
// distinct idx the unique sorted order, equal to a stable argsort of the
// key followed by one gather per array, bit for bit.
//
// Design. The TPU network moves every array through O(n log^2 n)
// compare-exchanges. Here a pass sorts stably on 8 bits of a 32-bit word,
// and moves only (word, perm), two 32-bit words an element; perm holds
// each element's input position. Words are the keys XOR 0x80000000, whose
// unsigned order is the keys' signed order. Four passes (bits 0-7 up to
// 24-31) sort by the key; with an explicit idx, four passes on the idx
// come first, and stability then gives (key, idx) order. A pass is three
// launches:
//   count   a block per tile of TILE elements of the current order writes
//           the tile's 256-bin digit histogram to counts[digit * tiles +
//           tile];
//   scan    a block per digit turns its row of counts into the exclusive
//           prefix over the tiles, and writes the row's total after the
//           rows;
//   scatter a block per tile adds the exclusive scan of the 256 digit
//           totals to its row prefixes (its first slot for each digit),
//           ranks each element among the tile's elements of its digit, in
//           order, stages the tile in shared memory in that order and
//           writes it out, so that consecutive threads write consecutive
//           slots of a digit's run. Warps take consecutive stretches of 32
//           elements in turn; eight ballots of the digit's bits find a
//           lane's peers, and the peers in lower lanes give its rank.
// The last pass writes the outputs instead: the key, then idx and each
// payload read once from position perm, as 32-bit words (no payload bit
// passes through float arithmetic). Positions form: 12 launches at any n;
// with an explicit idx: 24. The wrapper allocates the ping-pong word and
// perm buffers and the counts (rs_counts_words); the kernels allocate
// nothing and leave the inputs unchanged. Shared memory stays under 48 KB
// (21 KB a scatter block), so no opt-in attribute is needed.
//
// Bound. The least traffic is every array read once and written once. The
// positions form reads the key and nv payloads and writes the key, idx and
// nv payloads: (3 + 2 nv) * n * 4 bytes, 6.8 MB at n = 131,072 with five
// payloads, 2.03 us at 3.35 TB/s; an explicit idx adds its read. A pass
// moves 2 words an element (count reads one, scatter reads and writes
// two), where a bitonic network moves all 2 + nv words on each of its
// O(log^2 n) substages, and the working set (~4 MB) stays in the 50 MB L2.
// What is left is latency: 12 launches in a chain, each a few microseconds
// however little it moves, and the last pass's gathers from random
// positions.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_V = 8;          // payload arrays carried
constexpr int TILE = 1024;        // elements a count or scatter block takes
constexpr int THREADS = 256;      // threads of a count or scatter block
constexpr int BINS = 256;         // 8-bit digits
constexpr int MAX_WARPS = THREADS / 32;
constexpr int MAX_ROUNDS = TILE / BINS;  // elements a thread holds (n >= 256)
constexpr int SCAN_THREADS = 256;
constexpr uint32_t SIGN = 0x80000000u;

static_assert(THREADS >= BINS && THREADS % 32 == 0 && TILE % THREADS == 0,
              "a block has a thread per bin and whole warps");

// The last pass's destinations: the key, the idx (nullptr idx_in: the
// positions) and the payloads, each read from position perm.
struct Outputs {
  int32_t* key;
  int32_t* idx;
  const int32_t* idx_in;
  const uint32_t* v_in[MAX_V];
  uint32_t* v[MAX_V];
  int nv;
};

__device__ __forceinline__ int digit_of(uint32_t w, int shift) {
  return static_cast<int>((w >> shift) & (BINS - 1));
}

// The lanes of this warp whose digit equals d (all lanes call it): one
// ballot a bit of the digit.
__device__ __forceinline__ unsigned peers_of(int d) {
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned set = __ballot_sync(0xffffffffu, (d >> b) & 1);
    peers &= ((d >> b) & 1) ? set : ~set;
  }
  return peers;
}

// A tile's element of round r for this thread: warps take consecutive
// stretches of 32 * rounds elements, lanes consecutive elements.
__device__ __forceinline__ int tile_slot(int warp, int lane, int r,
                                         int rounds) {
  return (warp * rounds + r) * 32 + lane;
}

// Exclusive prefix sum of the block's per-thread values (blockDim.x whole
// warps, at most 1,024 threads); every thread calls it.
__device__ uint32_t block_exclusive_scan(uint32_t v) {
  __shared__ uint32_t warp_sums[32];
  __syncthreads();  // an earlier call's readers are done with warp_sums
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const uint32_t up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = lane < static_cast<int>(blockDim.x / 32) ? warp_sums[lane]
                                                          : 0;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const uint32_t up = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += up;
    }
    warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  return (warp ? warp_sums[warp - 1] : 0) + incl - v;
}

// A pass reads the sort word `words[i] ^ flip` (flip = SIGN on the first
// pass of a phase, which reads the caller's int32 array; 0 after, the
// buffers holding flipped words) and perm[i] (nullptr: the identity).
__global__ void count_kernel(const uint32_t* words, uint32_t flip, int shift,
                             int tile, int tiles, uint32_t* counts) {
  __shared__ uint32_t hist[BINS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rounds = tile / blockDim.x;
  const size_t first = static_cast<size_t>(blockIdx.x) * tile;
  int dig[MAX_ROUNDS];
#pragma unroll
  for (int r = 0; r < MAX_ROUNDS; ++r)
    if (r < rounds)
      dig[r] = digit_of(words[first + tile_slot(warp, lane, r, rounds)]
                            ^ flip, shift);
  if (threadIdx.x < BINS) hist[threadIdx.x] = 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < MAX_ROUNDS; ++r) {
    if (r < rounds) {
      const unsigned peers = peers_of(dig[r]);
      if ((peers & ((1u << lane) - 1)) == 0)  // the digit's lowest lane
        atomicAdd(&hist[dig[r]], static_cast<uint32_t>(__popc(peers)));
    }
  }
  __syncthreads();
  if (threadIdx.x < BINS)
    counts[static_cast<size_t>(threadIdx.x) * tiles + blockIdx.x] =
        hist[threadIdx.x];
}

// Block d: row d of counts (tiles words) -> its exclusive prefix, in
// place, and the row's total -> counts[BINS * tiles + d].
__global__ void scan_kernel(uint32_t* counts, int tiles) {
  uint32_t* row = counts + static_cast<size_t>(blockIdx.x) * tiles;
  const int per = (tiles + SCAN_THREADS - 1) / SCAN_THREADS;
  const int begin = min(static_cast<int>(threadIdx.x) * per, tiles);
  const int end = min(begin + per, tiles);
  uint32_t sum = 0;
  for (int i = begin; i < end; ++i) sum += row[i];
  uint32_t run = block_exclusive_scan(sum);
  if (threadIdx.x == SCAN_THREADS - 1)
    counts[static_cast<size_t>(BINS) * tiles + blockIdx.x] = run + sum;
  for (int i = begin; i < end; ++i) {
    const uint32_t c = row[i];
    row[i] = run;
    run += c;
  }
}

// One pass's scatter. Writes (word, perm) of every element to its slot in
// words_out / perm_out, or, when next is not nullptr, the word
// next[perm] ^ SIGN (the first word of the key phase after the idx
// phase); on the last pass (out.key not nullptr) writes the outputs.
// Each element's slot is its tile's first slot for its digit plus its
// stable rank there. The tile is staged in shared memory in slot order,
// so that consecutive threads write consecutive slots of a digit's run.
__global__ void scatter_kernel(const uint32_t* words, const uint32_t* perm,
                               uint32_t flip, int shift, int tile, int tiles,
                               const uint32_t* counts, uint32_t* words_out,
                               uint32_t* perm_out, const uint32_t* next,
                               Outputs out) {
  // base[w][d]: warp w's count of digit d, then its first place for d in
  // the tile's slot order (digits, then warps, then rounds and lanes)
  __shared__ uint32_t base[MAX_WARPS][BINS];
  __shared__ uint32_t to_global[BINS];  // slot - place, per digit
  __shared__ uint32_t stage_dst[TILE], stage_a[TILE], stage_b[TILE];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int rounds = tile / blockDim.x;
  const size_t first = static_cast<size_t>(blockIdx.x) * tile;
  const bool last = out.key != nullptr;
  uint32_t word[MAX_ROUNDS], from[MAX_ROUNDS], rank[MAX_ROUNDS];
  int dig[MAX_ROUNDS];
#pragma unroll
  for (int r = 0; r < MAX_ROUNDS; ++r) {
    if (r < rounds) {
      const size_t i = first + tile_slot(warp, lane, r, rounds);
      word[r] = words[i] ^ flip;
      from[r] = perm ? perm[i] : static_cast<uint32_t>(i);
      dig[r] = digit_of(word[r], shift);
    }
  }
  // Reads from position perm, issued before the ranking so that their
  // latency passes under it: on the last pass the payloads and the idx
  // (got[r][MAX_V]), else the word to write (the key's, after the idx
  // phase).
  uint32_t got[MAX_ROUNDS][MAX_V + 1];
#pragma unroll
  for (int r = 0; r < MAX_ROUNDS; ++r) {
    if (r < rounds) {
      const uint32_t p = from[r];
      if (last) {
#pragma unroll
        for (int a = 0; a < MAX_V; ++a)
          if (a < out.nv) got[r][a] = out.v_in[a][p];
        got[r][MAX_V] =
            out.idx_in ? static_cast<uint32_t>(out.idx_in[p]) : p;
      } else {
        got[r][MAX_V] = next ? next[p] ^ SIGN : word[r];
      }
    }
  }
  for (int i = threadIdx.x; i < warps * BINS; i += blockDim.x)
    base[i / BINS][i % BINS] = 0;
  // the tile's first slot for each digit: the digits' totals scanned, and
  // this tile's row prefix
  const int d0 = threadIdx.x;
  uint32_t slot0 = block_exclusive_scan(
      d0 < BINS ? counts[static_cast<size_t>(BINS) * tiles + d0] : 0);
  if (d0 < BINS) slot0 += counts[static_cast<size_t>(d0) * tiles
                                 + blockIdx.x];
  // Stable rank within the warp's stretch, round after round: the warp's
  // running count of the digit, then the peers in lower lanes.
  const unsigned lower = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < MAX_ROUNDS; ++r) {
    if (r < rounds) {
      const unsigned peers = peers_of(dig[r]);
      const uint32_t seen = base[warp][dig[r]];
      rank[r] = seen + __popc(peers & lower);
      __syncwarp();
      if ((peers & lower) == 0) base[warp][dig[r]] = seen + __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  uint32_t in_tile = 0;  // a thread per digit: the tile's count of it
  if (d0 < BINS)
    for (int w = 0; w < warps; ++w) in_tile += base[w][d0];
  const uint32_t place0 = block_exclusive_scan(in_tile);
  if (d0 < BINS) {
    uint32_t run = place0;
    for (int w = 0; w < warps; ++w) {
      const uint32_t c = base[w][d0];
      base[w][d0] = run;
      run += c;
    }
    to_global[d0] = slot0 - place0;
  }
  __syncthreads();

  // Stage the tile in slot order: destination, then the two words the
  // pass writes (key and idx on the last pass, else word and perm).
  uint32_t place[MAX_ROUNDS];
#pragma unroll
  for (int r = 0; r < MAX_ROUNDS; ++r) {
    if (r < rounds) {
      place[r] = base[warp][dig[r]] + rank[r];
      stage_dst[place[r]] = to_global[dig[r]] + place[r];
      stage_a[place[r]] = last ? word[r] ^ SIGN : got[r][MAX_V];
      stage_b[place[r]] = last ? got[r][MAX_V] : from[r];
    }
  }
  __syncthreads();
  uint32_t* dst_a = last ? reinterpret_cast<uint32_t*>(out.key) : words_out;
  uint32_t* dst_b = last ? reinterpret_cast<uint32_t*>(out.idx) : perm_out;
  for (int j = threadIdx.x; j < tile; j += blockDim.x) {
    dst_a[stage_dst[j]] = stage_a[j];
    dst_b[stage_dst[j]] = stage_b[j];
  }
  if (!last) return;
  // The payloads, read once from position perm above and staged the same
  // way, as 32-bit words.
#pragma unroll
  for (int a = 0; a < MAX_V; ++a) {
    if (a < out.nv) {
      __syncthreads();  // the previous array's writes have read stage_a
#pragma unroll
      for (int r = 0; r < MAX_ROUNDS; ++r)
        if (r < rounds) stage_a[place[r]] = got[r][a];
      __syncthreads();
      for (int j = threadIdx.x; j < tile; j += blockDim.x)
        out.v[a][stage_dst[j]] = stage_a[j];
    }
  }
}

int tile_of(int n) { return n < TILE ? n : TILE; }

}  // namespace

// Words of scratch the wrapper allocates for `counts` at n elements: the
// [BINS, tiles] histograms and the BINS digit totals.
extern "C" int rs_counts_words(int n) {
  return BINS * (n / tile_of(n)) + BINS;
}

// Launch B6 on `stream`: sort n elements (key_in, idx_in, nv payloads
// vals_in[a]) by (key, idx) into key_out, idx_out, vals_out[a]. idx_in
// may be nullptr: the positions, 4 passes; else 8 passes. The pointer
// arrays vals_in and vals_out live on the host and hold nv device
// pointers each; inputs are left unchanged. words and perm are scratch of
// 2 * n words each, counts of rs_counts_words(n). n must be a power of two
// >= 256 and nv <= 8. `*launched` counts the grid launches made. Returns
// the CUDA error code (0 = ok).
extern "C" int rs_sort(const void* key_in, const void* idx_in,
                       const void* const* vals_in, void* key_out,
                       void* idx_out, void* const* vals_out, int nv, int n,
                       void* words, void* perm, void* counts, void* stream,
                       int* launched) {
  *launched = 0;
  if (n < 256 || (n & (n - 1)) != 0 || nv < 0 || nv > MAX_V)
    return static_cast<int>(cudaErrorInvalidValue);
  Outputs out{static_cast<int32_t*>(key_out), static_cast<int32_t*>(idx_out),
              static_cast<const int32_t*>(idx_in), {}, {}, nv};
  for (int a = 0; a < nv; ++a) {
    out.v_in[a] = static_cast<const uint32_t*>(vals_in[a]);
    out.v[a] = static_cast<uint32_t*>(vals_out[a]);
  }
  const Outputs none{};
  uint32_t* w_buf[2] = {static_cast<uint32_t*>(words),
                        static_cast<uint32_t*>(words) + n};
  uint32_t* p_buf[2] = {static_cast<uint32_t*>(perm),
                        static_cast<uint32_t*>(perm) + n};
  uint32_t* cnt = static_cast<uint32_t*>(counts);
  const uint32_t* key = static_cast<const uint32_t*>(key_in);
  const uint32_t* idx = static_cast<const uint32_t*>(idx_in);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tile = tile_of(n);
  const int tiles = n / tile;
  const int threads = tile < THREADS ? tile : THREADS;
  const int passes = idx ? 8 : 4;
  const uint32_t* src = idx ? idx : key;  // the first phase's words
  const uint32_t* src_perm = nullptr;     // the identity
  uint32_t flip = SIGN;
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = 8 * (pass % 4);
    const bool last = pass == passes - 1;
    const bool to_key = idx && pass == 3;  // the idx phase's last pass
    count_kernel<<<tiles, threads, 0, st>>>(src, flip, shift, tile, tiles,
                                            cnt);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    scan_kernel<<<BINS, SCAN_THREADS, 0, st>>>(cnt, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    uint32_t* w_out = w_buf[pass % 2];
    uint32_t* p_out = p_buf[pass % 2];
    scatter_kernel<<<tiles, threads, 0, st>>>(
        src, src_perm, flip, shift, tile, tiles, cnt, w_out, p_out,
        to_key ? key : nullptr, last ? out : none);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    src = w_out;
    src_perm = p_out;
    flip = 0;
  }
  return 0;
}

extern "C" const char* rustexp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
