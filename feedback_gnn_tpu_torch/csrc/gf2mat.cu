// The GF(2) product (h @ v) mod 2, bit-packed, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the product
// (feedback_gnn_tpu/ops/gf2mat.py, mod2_matmul) to an XLA dot.  The port's
// plain version (ops/gf2mat.py, mod2_matmul_plain, this kernel's oracle)
// is a dense float32 matmul of a 0/1 matrix, with a float32 copy of v
// before it and an int32 cast and a bitwise and after it: 2 m n B FFMAs
// for a matrix whose rows hold 6 ones ([[1270,28]]'s hx: 3,810 of
// 640 x 1272), and some 400 MB of converted copies at B = 20480.
//
// What bounds it on the card: device memory.  The useful work is one read
// of v ([n, B], int32 or uint8, batch-last) and one write of the int32
// result ([m, B]): 104 + 52 MB for hx at B = 20480, 47 us at 3.35 TB/s.
// Everything else fits in shared memory and L2.
//
// What this design does about it:
// - A block of 32 warps a tile of 32 samples (640 blocks at B = 20480, 2
//   an SM): it reads every row of v for them once, one warp a row, 32
//   consecutive samples a warp load (coalesced along the batch, v's
//   contiguous axis), GF2_UNROLL rows in flight a warp.  The sub-batches
//   (1024-8192 samples: 32-256 blocks) are latency-bound, each warp packing
//   its rows in series: on an H100, 32 warps a block ran [[1270,28]]'s hx
//   at B = 1024 in 15 us where 8 warps took 45, and within 6 % at B = 20480.  Wider
//   tiles (64-256 samples) ran no faster at any cell's shape.
// - Packing: each warp packs its 32 samples of a row into one 32-bit word
//   with __ballot_sync on the values' low bits; the tile stays in shared
//   memory, n + 1 words (5 KB at n = 1272; word n is zero).
// - Product: a warp takes a slice of 32 rows of h, a lane a row; the
//   output word is the XOR of the packed words of the row's nonzero
//   columns.  The columns come from h's sliced row lists (the wrapper builds
//   them on the card once a matrix): slice t is a [width_t, 32] table of
//   uint16 columns, so step k of the loop reads column k of all 32 rows in
//   one coalesced 64-byte load, and a row shorter than its slice's heaviest
//   names the zero word.  The work of a word is its slice's width, so rows
//   of weight 6 and of weight 346 take the same path; the lanes of a warp
//   never diverge.  (A per-row list, a lane reading its own row, ran the
//   346-weight rows 1.7 times slower on an H100: 32 scattered loads a step.)
// - Output: the slice's 32 words are handed round by __shfl_sync; for each,
//   lane j writes bit j as sample j's int32, so every store is one
//   coalesced row segment of 32 samples.
// - Exact by construction: XOR of bits is the sum mod 2, whatever the row
//   sums are.  Samples past the batch read as zero and are never written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GF2_THREADS = 1024;
constexpr int GF2_UNROLL = 8;  // rows a warp loads before it packs them
constexpr int GF2_BAD_SHAPE = -4;
constexpr int GF2_SHARED_LIMIT = 232448;  // bytes of shared memory a block can have on sm_90

template <typename In>
__global__ void __launch_bounds__(GF2_THREADS) gf2_matmul_kernel(
    const In* __restrict__ v, long long ld, const int32_t* __restrict__ slices,
    const uint16_t* __restrict__ cols, int32_t* __restrict__ out, int m, int n, int batch) {
  extern __shared__ uint32_t packed[];  // [n + 1]: bit j of word c is v[c, 32 blockIdx.x + j] & 1; word n is 0
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const long long s = (static_cast<long long>(blockIdx.x) << 5) + lane;  // this lane's sample
  const bool inside = s < batch;

  // 1. pack the tile, a warp a row of v, GF2_UNROLL rows in flight
  for (int base = warp * GF2_UNROLL; base < n; base += warps * GF2_UNROLL) {
    uint32_t bit[GF2_UNROLL];
#pragma unroll
    for (int u = 0; u < GF2_UNROLL; ++u)
      bit[u] = (base + u < n && inside) ? static_cast<uint32_t>(__ldcs(v + (base + u) * ld + s)) & 1u : 0u;
#pragma unroll
    for (int u = 0; u < GF2_UNROLL; ++u) {
      const uint32_t word = __ballot_sync(0xffffffffu, bit[u]);
      if (lane == 0 && base + u < n) packed[base + u] = word;
    }
  }
  if (threadIdx.x == 0) packed[n] = 0u;
  __syncthreads();

  // 2. the product, a warp a slice of 32 rows, a lane a row: column k of
  // every row of the slice is one coalesced 64-byte load (pads name word n);
  // 3. the slice's 32 words out, one coalesced store of 32 samples a word
  for (int slice = warp; slice << 5 < m; slice += warps) {
    const int begin = __ldg(slices + slice), end = __ldg(slices + slice + 1);
    uint32_t acc = 0u;
#pragma unroll 4
    for (int k = begin + lane; k < end; k += 32) acc ^= packed[__ldg(cols + k)];
    const int rows = min(32, m - (slice << 5));
    for (int i = 0; i < rows; ++i) {
      const uint32_t word = __shfl_sync(0xffffffffu, acc, i);
      if (inside) out[static_cast<long long>((slice << 5) + i) * batch + s] = static_cast<int32_t>((word >> lane) & 1u);
    }
  }
}

// The instance for v's element size (4: int32, 1: uint8 or bool), and the
// shared bytes of a block for n columns; null for a shape the kernel does
// not take.
const void* gf2_instance(int elem_bytes, int n, int* bytes) {
  if (n < 1 || n >= 65536) return nullptr;
  *bytes = 4 * (n + 1);
  if (*bytes > GF2_SHARED_LIMIT) return nullptr;
  if (elem_bytes == 4) return reinterpret_cast<const void*>(gf2_matmul_kernel<int32_t>);
  if (elem_bytes == 1) return reinterpret_cast<const void*>(gf2_matmul_kernel<uint8_t>);
  return nullptr;
}

cudaError_t allow_shared(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// (h @ v) mod 2 on `stream`: v [n, batch] with row stride ld elements (its
// samples contiguous), int32 (elem_bytes 4) or uint8/bool (1), read by its
// low bit; h as its sliced row lists (slices [ceil(m / 32) + 1] int32
// offsets into cols, uint16, column k of slice t's lane-th row at
// slices[t] + 32 k + lane, n where the row has fewer); out [m, batch] int32
// {0, 1}.  Returns the CUDA error code of the attribute call or the launch
// (0 = ok), -4 for a shape the kernel does not take or an empty batch.
extern "C" int fgt_gf2_matmul_launch(const void* v, long long ld, int elem_bytes, const int32_t* slices,
                                     const uint16_t* cols, int32_t* out, int m, int n, int batch, void* stream) {
  int bytes = 0;
  const void* fn = gf2_instance(elem_bytes, n, &bytes);
  if (fn == nullptr || batch < 1 || m < 1) return GF2_BAD_SHAPE;
  cudaError_t err = allow_shared(fn, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = static_cast<unsigned>((static_cast<long long>(batch) + 31) >> 5);
  void* args[] = {(void*)&v, (void*)&ld, (void*)&slices, (void*)&cols, (void*)&out, (void*)&m, (void*)&n,
                  (void*)&batch};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(tiles), dim3(GF2_THREADS), args, bytes,
                                           static_cast<cudaStream_t>(stream)));
}

// Resident blocks per SM, registers per thread and spill bytes per thread
// of the instance for v's element size and n columns, into out[0..2].
// Returns a CUDA error code (0 = ok), -4 for a shape the kernel does not
// take.
extern "C" int fgt_gf2_occupancy(int elem_bytes, int n, int* out) {
  int bytes = 0;
  const void* fn = gf2_instance(elem_bytes, n, &bytes);
  if (fn == nullptr) return GF2_BAD_SHAPE;
  cudaError_t err = allow_shared(fn, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, GF2_THREADS, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
