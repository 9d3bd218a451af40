// OSD-0's elimination, bit-packed, one block a sample, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves OSD-0
// (feedback_gnn_tpu/decoders/osd.py, osd0_decode) to XLA ops, a rank-step
// Gauss-Jordan loop over an int32 table.  The port's plain version
// (decoders/osd.py, osd0_decode_plain, this kernel's oracle) runs the same
// loop from Python over a [B, rank, n+1] uint8 table: each of the rank
// steps writes a broadcast temporary of the whole table (388 MB at
// B = 1024 on [[882,24]]) and XORs it back.
//
// What bounds it on the card: 32-bit integer throughput.  Forward elimination on
// bit-packed rows costs a sample, at each pivot, a bit test of each row
// below and a masked XOR of each word from the pivot's word to the
// syndrome's of each row below that holds a one in the pivot column: about
// 140,000 operations a side on [[882,24]] at p = 0.10 (benchmark/
// osd_counts.py), against a few KB of device memory a sample.  The rank
// steps are a chain, so what sets the pace is each step's latency and its
// block-wide barrier, not the bandwidth of any memory.
//
// What this design does about it:
// - One block of 256 threads a sample; every phase stays in shared memory.
//   The table is rank rows of W = ceil((n+1)/32) words, sorted column p at
//   bit p % 32 of word p / 32 and the syndrome at column n.  The row stride
//   is W | 1 words: odd, so the 32 rows a warp tests in one column fall in
//   32 banks.  [[882,24]]: 429 x 29 words, 53 KB a block with the rest,
//   4 blocks an SM; [[1270,28]]: 621 x 41, 106 KB, 2 blocks.
// - The order: a bitonic sort of the 64-bit keys (reliability, column) in
//   shared memory.  The reliability's key is its float ordered as an
//   unsigned integer with -0.0 made +0.0 (they tie, as torch.sort and
//   jnp.argsort tie them) and every NaN last; the column in the low word
//   makes the keys distinct, so the order is the stable sort's.
// - The table is built in shared memory from the order and the basis packed
//   as column bit-vectors (the wrapper's pack_columns, [n, ceil(rank/32)]
//   words, 49 KB on [[882,24]], read from L2): a warp takes 32 sorted
//   columns and 32 rows, a lane loads its column's word, and 32 ballots
//   transpose the 32 x 32 bits into 32 row words.
// - Forward elimination, one barrier a rank step.  Every warp reads the
//   pivot row, finds its first nonzero word with a ballot and its first one
//   with ffs (no broadcast, no barrier), then tests 32 rows below at a time,
//   one a lane, and a ballot names the rows to clear (about 5 a step); for
//   each, the lanes XOR the pivot row into it a word a lane, from the
//   pivot's word on.  A warp owns the rows it tests for the whole step, so
//   only the next pivot row needs the barrier.
// - Back-substitution in one warp: x at pivot r = parity(row r AND X), where
//   X holds the solution found so far at the later pivots and a one at
//   column n (the row's syndrome bit); a ballot sums the lanes' parities.
//   Forward elimination and back-substitution give Gauss-Jordan's pivots
//   and its unique solution.
// - The solution goes out in column order (column c reads sorted position
//   inv[c]), so the stores are coalesced and every column is written.
// - A row that is all zero (no basis of full rank has one) takes column 0
//   as its pivot, as torch.argmax of zeros does, and clears nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int OSD_THREADS = 256;
constexpr int OSD_WARPS = OSD_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int OSD_MAX_WORDS = 64;             // two words of a row a lane
constexpr int OSD_MAX_SHARED = 232448;        // 227 KB, a block's most on sm_90
constexpr int OSD_BAD_SHAPE = -3;

// Byte offsets of a block's shared memory for n columns and rank rows.
// decoders/osd.py, shared_bytes, computes the same total.
struct Shape {
  int words, stride, groups, keys;  // W, W | 1, ceil(rank / 32), sort size (a power of two >= n)
  int order, inv, piv, synw, xs, bytes;
};

__host__ __device__ inline Shape osd_shape(int n, int rank) {
  Shape s;
  s.words = (n + 32) / 32;
  s.stride = s.words | 1;
  s.groups = (rank + 31) / 32;
  s.keys = 1;
  while (s.keys < n) s.keys <<= 1;
  const int table = 4 * rank * s.stride, keys = 8 * s.keys;  // the keys live where the table goes later
  s.order = table > keys ? table : keys;
  s.inv = s.order + 2 * n;
  s.piv = s.inv + 2 * n;
  s.synw = (s.piv + 2 * rank + 3) / 4 * 4;
  s.xs = s.synw + 4 * s.groups;
  s.bytes = s.xs + 4 * s.words;
  return s;
}

// The float's order as an unsigned integer: -0.0 ties with +0.0, NaNs last.
__device__ inline uint32_t sort_key(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// WPL: words of a row each lane holds, 1 (W <= 32) or 2 (W <= 64).
template <int WPL>
__global__ void __launch_bounds__(OSD_THREADS, 4)
osd0_kernel(const float* __restrict__ llr, const uint32_t* __restrict__ cols,
            const int32_t* __restrict__ syn, int32_t* __restrict__ out, int batch, int n, int rank) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shape sh = osd_shape(n, rank);
  const int W = sh.words, S = sh.stride, G = sh.groups;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  uint16_t* order = reinterpret_cast<uint16_t*>(smem + sh.order);
  uint16_t* inv = reinterpret_cast<uint16_t*>(smem + sh.inv);
  uint16_t* piv = reinterpret_cast<uint16_t*>(smem + sh.piv);
  uint32_t* synw = reinterpret_cast<uint32_t*>(smem + sh.synw);
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + sh.xs);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. the sort's keys, padded with the largest; the syndrome packed a word per 32 rows
  const float* row = llr + static_cast<size_t>(b) * n;
  for (int c = tid; c < sh.keys; c += OSD_THREADS)
    keys[c] = c < n ? (static_cast<unsigned long long>(sort_key(row[c])) << 32) | c : ~0ull;
  for (int g = warp; g < G; g += OSD_WARPS) {
    const int r = 32 * g + lane;
    const uint32_t w = __ballot_sync(FULL, r < rank && syn[static_cast<size_t>(r) * batch + b] != 0);
    if (lane == 0) synw[g] = w;
  }
  __syncthreads();

  // 2. bitonic sort, ascending
  for (int k = 2; k <= sh.keys; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < sh.keys / 2; t += OSD_THREADS) {
        const int i = 2 * t - (t & (j - 1)), l = i + j;
        const unsigned long long a = keys[i], c = keys[l];
        if ((a > c) == ((i & k) == 0)) {
          keys[i] = c;
          keys[l] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int p = tid; p < n; p += OSD_THREADS) {
    const int c = static_cast<int>(keys[p] & 0xffffffffu);
    order[p] = static_cast<uint16_t>(c);
    inv[c] = static_cast<uint16_t>(p);
  }
  __syncthreads();

  // 3. the table over the keys: a warp transposes 32 sorted columns x 32 rows
  {
    auto load = [&](int task) -> uint32_t {
      if (task >= W * G) return 0u;
      const int w = task / G, g = task - w * G, p = 32 * w + lane;
      return p < n ? cols[static_cast<size_t>(order[p]) * G + g] : (p == n ? synw[g] : 0u);
    };
    uint32_t x = load(warp);
    for (int task = warp; task < W * G; task += OSD_WARPS) {
      const uint32_t next = load(task + OSD_WARPS);
      uint32_t mine = 0u;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const uint32_t v = __ballot_sync(FULL, (x >> j) & 1u);
        if (lane == j) mine = v;
      }
      const int w = task / G, r = 32 * (task - w * G) + lane;
      if (r < rank) tab[r * S + w] = mine;
      x = next;
    }
  }
  __syncthreads();

  // 4. forward elimination
  for (int r = 0; r < rank; ++r) {
    const uint32_t* pr = tab + r * S;
    const uint32_t w0 = lane < W ? pr[lane] : 0u;
    const uint32_t w1 = (WPL > 1 && lane + 32 < W) ? pr[lane + 32] : 0u;
    int wi = 0;
    uint32_t word = 0u;
    uint32_t m = __ballot_sync(FULL, w0 != 0u);
    if (m != 0u) {
      wi = __ffs(m) - 1;
      word = __shfl_sync(FULL, w0, wi);
    } else if (WPL > 1) {
      m = __ballot_sync(FULL, w1 != 0u);
      if (m != 0u) {
        wi = 31 + __ffs(m);
        word = __shfl_sync(FULL, w1, wi - 32);
      }
    }
    const int bit = word != 0u ? __ffs(word) - 1 : 0;
    if (tid == 0) piv[r] = static_cast<uint16_t>(32 * wi + bit);
    for (int base = r + 1 + 32 * warp; base < rank; base += 32 * OSD_WARPS) {
      const int q = base + lane;
      uint32_t hits = __ballot_sync(FULL, q < rank && ((tab[q * S + wi] >> bit) & 1u));
      while (hits != 0u) {
        uint32_t* t = tab + (base + __ffs(hits) - 1) * S;
        hits &= hits - 1u;
        if (lane >= wi && lane < W) t[lane] ^= w0;
        if (WPL > 1 && lane + 32 >= wi && lane + 32 < W) t[lane + 32] ^= w1;
      }
    }
    __syncthreads();
  }

  // 5. back-substitution in warp 0; X starts with column n, the syndrome's
  if (warp == 0) {
    uint32_t x0 = lane == n / 32 ? 1u << (n % 32) : 0u;
    uint32_t x1 = (WPL > 1 && lane + 32 == n / 32) ? 1u << (n % 32) : 0u;
    for (int r = rank - 1; r >= 0; --r) {
      const uint32_t* pr = tab + r * S;
      const uint32_t t0 = lane < W ? pr[lane] : 0u;
      const uint32_t t1 = (WPL > 1 && lane + 32 < W) ? pr[lane + 32] : 0u;
      const uint32_t par = static_cast<uint32_t>(__popc(t0 & x0) + __popc(t1 & x1)) & 1u;
      if (__popc(__ballot_sync(FULL, par)) & 1) {
        const int pc = piv[r], pw = pc >> 5;
        const uint32_t mask = 1u << (pc & 31);
        if (lane == pw) x0 |= mask;
        if (WPL > 1 && lane + 32 == pw) x1 |= mask;
      }
    }
    if (lane < W) xs[lane] = x0;
    if (WPL > 1 && lane + 32 < W) xs[lane + 32] = x1;
  }
  __syncthreads();

  // 6. the solution in column order
  int32_t* o = out + static_cast<size_t>(b) * n;
  for (int c = tid; c < n; c += OSD_THREADS) {
    const int p = inv[c];
    o[c] = static_cast<int32_t>((xs[p >> 5] >> (p & 31)) & 1u);
  }
}

using OsdFn = void (*)(const float*, const uint32_t*, const int32_t*, int32_t*, int, int, int);

OsdFn osd_instance(int n, int rank, int groups, Shape* sh) {
  if (n < 1 || rank < 1) return nullptr;
  *sh = osd_shape(n, rank);
  if (sh->words > OSD_MAX_WORDS || sh->bytes > OSD_MAX_SHARED || groups != sh->groups) return nullptr;
  return sh->words <= 32 ? &osd0_kernel<1> : &osd0_kernel<2>;
}

}  // namespace

// Shared-memory bytes of a block for n columns and rank rows, or -3 for a
// shape the kernel does not take (more than 64 words a row, more than
// 227 KB, no column or no row).
extern "C" int fgt_osd0_shared_bytes(int n, int rank) {
  Shape sh;
  return osd_instance(n, rank, (rank + 31) / 32, &sh) ? sh.bytes : OSD_BAD_SHAPE;
}

// OSD-0 of batch samples on `stream`, one block each: llr [batch, n]
// float32, cols [n, groups] the basis's column bit-vectors (bit j of word g
// of column c is basis[32 g + j, c]), syn [rank, batch] int32 0/1, out
// [batch, n] int32.  Returns the CUDA error code of the attribute call or
// the launch (0 = ok), -3 for a shape the kernel does not take or an empty
// batch.
extern "C" int fgt_osd0_launch(const float* llr, const uint32_t* cols, int groups, const int32_t* syn,
                               int32_t* out, int batch, int n, int rank, void* stream) {
  Shape sh;
  const OsdFn fn = osd_instance(n, rank, groups, &sh);
  if (fn == nullptr || batch < 1) return OSD_BAD_SHAPE;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, sh.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<batch, OSD_THREADS, sh.bytes, static_cast<cudaStream_t>(stream)>>>(llr, cols, syn, out, batch, n, rank);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM, registers per thread and spill bytes per thread
// of the instance for n columns and rank rows, into out[0..2].  Returns a
// CUDA error code (0 = ok), -3 for a shape the kernel does not take.
extern "C" int fgt_osd0_occupancy(int n, int rank, int* out) {
  Shape sh;
  const OsdFn fn = osd_instance(n, rank, (rank + 31) / 32, &sh);
  if (fn == nullptr) return OSD_BAD_SHAPE;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, sh.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, OSD_THREADS, sh.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
