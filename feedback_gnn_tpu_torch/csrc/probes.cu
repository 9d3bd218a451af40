// Hopper probes of the data movement and the transcendentals that the fused
// quasi-cyclic BP kernels are built from, for sm_90a.
//
// Replaces the thirteen Pallas TPU probes of scripts/probe_pallas.py (k1-k6)
// and scripts/probe_pallas2.py (ka-kf); feedback_gnn_tpu_torch/probes.py
// has one wrapper per probe, and plans every launch (_loop_plan,
// _pass_plan).  Two C entry points and phi:
//
// * fgt_probe_gather_launch: out[r, c] = src[idx(r, c), c] along the
//   gathered axis of a row-major [rows, cols] array: rows for k1, kb, k6,
//   ka, ke; lanes (the contiguous axis) for k2, k2b.  The index table is one
//   entry per gathered row, shared by every column (k1, k2, kb, k6), or a
//   full table laid out like the array (k2b, ka, ke).  An index outside
//   [0, length of the gathered axis) gives NaN.
// * fgt_probe_shift_launch: out[r, c] = src[(r + s) mod L, c] for r < L and
//   src[r, c] for r >= L, the index computed and not read from a table: k3
//   (the np.roll by 13 of [3840, 128]), k4 (s = 13, L = 127 on [128, 128]),
//   kf.
// * probe_phi: phi of a = |x| + 1e-3, elementwise, in the three forms the
//   probes compare: softplus(a) - log(expm1(a)) (k5), -log(tanh(a/2)) (kc)
//   and log1p(exp(-a)) - log(exp(a) - 1) + a (kd), with the accurate CUDA
//   math functions; a timing-only fast mode swaps in __expf, __logf and
//   tanh.approx.f32.
//
// gather and shift take an iteration count and a scale: each iteration
// applies the gather or the shift to the previous result and multiplies by
// the scale (1 and 1.0 for the single probes; 64 and 1.0001 for k6, ke and
// kf, the loops the TPU probes timed).  The loops perform every iteration's
// gather (or shift) and multiply, in that order.  Chasing each row's index
// through all iterations and gathering once would give the same numbers,
// and would measure nothing of what the loops exist to measure: an
// on-chip gather's cost per iteration.  So they do not compose the
// permutation, and they do not fold the scales into one multiply.
//
// What bounds them on the card: bytes.  A [3840, 128] f32 array is 1.97 MB,
// read once and written once from device memory (a full index table adds
// 1.97 MB), against one f32 multiply per element and iteration.  The
// 64-iteration loops also move each element through shared memory once per
// iteration, read and written (8 B), which at 64 iterations outweighs the
// device-memory traffic.  Their index does not change across iterations
// and stays in registers.
//
// Design of the loops (probe_gather_loop_kernel, probe_shift_loop_kernel).
// The gathered axis runs along rows, so every column is independent of
// every other: a block holds all rows of one column in shared memory, in
// two buffers, and runs every iteration there.
//  1. Load and store through a cluster: one block per column, a cluster of
//     adjacent columns (probes._loop_plan: pairs).  Block k of a cluster of
//     cl reads the rows [k rows / cl, (k + 1) rows / cl) of all cl columns,
//     a row's cl floats side by side, and writes each value into the
//     owning block's buffer through distributed shared memory; a full
//     index table (ke) goes the same way into the owner's second buffer,
//     which the iterations overwrite only after its entries are in
//     registers.  The store mirrors the load.  The last cluster of a ragged
//     column count masks its missing columns.  Pairs, not the 8 columns of
//     a 32-byte sector: on an H100 all pairs of [3840, 128] run one block
//     to an SM, while clusters of 4 or 8 land two blocks on an SM (an
//     iteration takes twice as long) or, one to an SM, do not all fit at
//     once.  The first
//     and the last cluster barrier order no memory (cluster.sync() puts a
//     GPU-wide fence before its arrival, which at the end waits for the
//     global stores).
//  2. Indices in registers: thread t owns the rows t + q * threads,
//     q < RPT, for every iteration, and holds their source rows' shared
//     addresses: read from the table (before the load, so that the read
//     overlaps it, unless the table is staged) or computed for the shift.
//  3. Independent work in flight: in each iteration a thread issues all its
//     reads of the source buffer, then its multiplies and its writes, and
//     the block meets one barrier.  The two buffers alternate: a
//     permutation cannot be applied in place.
//
// Design of the single passes (probe_rows_pass_kernel,
// probe_lanes_pass_kernel).  A gather along rows moves whole rows: a warp
// takes one (row, 32 x 4-float chunk) item at a time, reads the row's index
// once and moves a float4 a lane (scalars where the column count or the
// pointers do not allow 16-byte accesses); a grid of a few blocks per SM
// strides over the items, with one division per item and none per element.
// A full table along rows (ka) reads an int4 of indices a lane and gathers
// four scalars.  A gather along lanes ([8, 3840]: k2, k2b) stays a thread
// per element, in memory order along each row, so that the index reads and
// the stores are coalesced.  The phi kernel is one thread per element.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>

namespace cg = cooperative_groups;

namespace {

enum { PHI_SOFTPLUS_EXPM1 = 0, PHI_LOG_TANH = 1, PHI_EXP_LOG1P = 2 };

constexpr int LOOP_THREADS = 1024;
constexpr int LOOP_CHUNK = 8;    // source reads in flight per thread and batch
constexpr int SLAB_BATCH = 4;    // reads in flight per thread in the cluster's load and store
constexpr int PASS_THREADS = 256;

__device__ __forceinline__ bool in_rows(int j, int rows) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(rows);
}

// Where a gathered row comes from: a table of one index per row, or the
// shift computed.
struct TableRow {
  const int* ix;
  __device__ __forceinline__ int operator()(int r) const { return ix[r]; }
};

struct ShiftRow {
  int shift, length;  // 0 <= shift < length
  __device__ __forceinline__ int operator()(int r) const {
    if (r >= length) return r;
    const int j = r + shift;
    return j >= length ? j - length : j;
  }
};

// ---------------------------------------------------------------- loops

// The block's own shared memory by 32-bit window addresses.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ld_shared(unsigned at) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(at) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared(unsigned at, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(at), "f"(v) : "memory");
}

// A cluster barrier without memory ordering: cluster.sync() also orders
// every earlier memory access of the thread (a GPU-wide fence before the
// arrival), which at the kernel's end waits for its global stores.
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\tbarrier.cluster.wait.aligned;" ::: "memory");
}

// The first row of block `rank`'s slab in the cluster's load and store.
__device__ __forceinline__ int slab_begin(int rank, int rows, int cl) { return rank * rows / cl; }

// Rows [lo, hi) of the cluster's columns c0 .. c0 + ncl - 1 (a cluster of
// cl = 2**cl_log2 blocks), element e of the slab at row lo + e / cl, column
// c0 + e % cl: device memory <-> the owner's buffer `buf` (a block-local
// address, mapped into each owner).  A thread issues SLAB_BATCH reads before
// its writes, so that their latencies overlap.  (Moving a pair's row as one
// 8-byte access, a thread a row, measured slower: half the threads, and the
// same lines touched.)
template <bool LOAD, class T>
__device__ __forceinline__ void cluster_slab(cg::cluster_group& cluster, T* buf,
                                             const T* __restrict__ src, T* __restrict__ dst,
                                             int cols, int c0, int ncl, int lo, int hi,
                                             int cl_log2) {
  const int n = (hi - lo) << cl_log2, mask = (1 << cl_log2) - 1;
  for (int e0 = threadIdx.x; e0 < n; e0 += SLAB_BATCH * blockDim.x) {
    T v[SLAB_BATCH];
#pragma unroll
    for (int k = 0; k < SLAB_BATCH; ++k) {
      const int e = e0 + k * blockDim.x, j = e & mask, r = lo + (e >> cl_log2);
      if (e >= n || j >= ncl) continue;
      if constexpr (LOAD) {
        v[k] = src[static_cast<size_t>(r) * cols + c0 + j];
      } else {
        v[k] = cluster.map_shared_rank(buf, j)[r];
      }
    }
#pragma unroll
    for (int k = 0; k < SLAB_BATCH; ++k) {
      const int e = e0 + k * blockDim.x, j = e & mask, r = lo + (e >> cl_log2);
      if (e >= n || j >= ncl) continue;
      if constexpr (LOAD) {
        cluster.map_shared_rank(buf, j)[r] = v[k];
      } else {
        dst[static_cast<size_t>(r) * cols + c0 + j] = v[k];
      }
    }
  }
}

// One block per column of a row-major [rows, cols] array, in clusters of
// cl adjacent columns (the launch's cluster size, a power of 2); shared memory: two buffers of rows floats.  STAGED: the
// index is a full table [rows, cols] (`table`), staged through the second
// buffer; otherwise index(r) gives it.
template <int RPT, bool STAGED, class Index>
__device__ __forceinline__ void resident_loop(const float* __restrict__ src,
                                              const int* __restrict__ table,
                                              float* __restrict__ out, int rows, int cols,
                                              Index index, int iters, float scale) {
  static_assert(RPT <= 32, "one bit a row in has_src and is_row");
  extern __shared__ float smem[];  // two buffers: smem[0, rows), smem[rows, 2 rows)
  cg::cluster_group cluster = cg::this_cluster();
  int* staged = reinterpret_cast<int*>(smem + rows);
  const int cl = static_cast<int>(cluster.num_blocks()), cl_log2 = __ffs(cl) - 1;
  const int rank = static_cast<int>(cluster.block_rank());
  const int c0 = static_cast<int>(blockIdx.x) - rank;
  const int ncl = min(cl, cols - c0);
  const int lo = slab_begin(rank, rows, cl), hi = slab_begin(rank + 1, rows, cl);

  // Thread t's rows t + q * threads and their source rows, held in
  // registers for every iteration.  A source row that is not staged is read
  // (or computed) first, so that its latency overlaps the load's.
  int from[RPT];
  if constexpr (!STAGED) {
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int r = threadIdx.x + q * blockDim.x;
      from[q] = r < rows ? index(r) : 0;
    }
  }
  cluster_sync_relaxed();  // every block of the cluster has started: its shared memory exists
  cluster_slab<true>(cluster, smem, src, static_cast<float*>(nullptr), cols, c0, ncl, lo, hi,
                     cl_log2);
  if constexpr (STAGED)
    cluster_slab<true>(cluster, staged, table, static_cast<int*>(nullptr), cols, c0, ncl, lo, hi,
                       cl_log2);
  cluster.sync();

  if (rank < ncl) {  // the block owns column c0 + rank
    // The byte address of each row's source row in the first buffer, and
    // whether it has one (in range) and is a row at all.  The accesses go
    // through 32-bit shared-window addresses computed here once: left to
    // itself, nvcc rebuilds a cluster block's window base (S2R
    // SR_CgaCtaId) before every access in the loop.
    const unsigned base = smem_addr(smem);
    unsigned from_row[RPT];
    unsigned has_src = 0, is_row = 0;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int r = threadIdx.x + q * blockDim.x;
      if constexpr (STAGED) from[q] = r < rows ? staged[r] : 0;
      from_row[q] = base + 4u * static_cast<unsigned>(from[q]);
      has_src |= static_cast<unsigned>(in_rows(from[q], rows)) << q;
      is_row |= static_cast<unsigned>(r < rows) << q;
    }
    const unsigned to_row = base + 4u * threadIdx.x, step = 4u * blockDim.x, half = 4u * rows;
    __syncthreads();  // the staged table is in registers: the second buffer is free
    // iteration it reads buffer it % 2 and writes the other
    for (int it = 0; it < iters; ++it) {
      const unsigned read = (it & 1) * half, write = half - read;
#pragma unroll
      for (int q0 = 0; q0 < RPT; q0 += LOOP_CHUNK) {
        constexpr int N = RPT < LOOP_CHUNK ? RPT : LOOP_CHUNK;
        float v[N];
#pragma unroll
        for (int q = 0; q < N; ++q)
          v[q] = (has_src >> (q0 + q)) & 1u ? ld_shared(from_row[q0 + q] + read) : NAN;
#pragma unroll
        for (int q = 0; q < N; ++q)
          if ((is_row >> (q0 + q)) & 1u) st_shared(to_row + (q0 + q) * step + write, v[q] * scale);
      }
      __syncthreads();
    }
  }
  float* res = smem + (iters & 1) * rows;  // the same buffer in every owner
  cluster.sync();  // every owner's result is in place
  cluster_slab<false>(cluster, res, static_cast<const float*>(nullptr), out, cols, c0, ncl, lo, hi,
                      cl_log2);
  cluster_sync_relaxed();  // no block leaves while its buffers are read (the reads are done:
                           // their values are stored)
}

template <int RPT, bool FULL>
__global__ void __launch_bounds__(LOOP_THREADS)
    probe_gather_loop_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                             float* __restrict__ out, int rows, int cols, int iters, float scale) {
  resident_loop<RPT, FULL>(src, idx, out, rows, cols, TableRow{idx}, iters, scale);
}

template <int RPT>
__global__ void __launch_bounds__(LOOP_THREADS)
    probe_shift_loop_kernel(const float* __restrict__ src, float* __restrict__ out, int rows,
                            int cols, int shift, int length, int iters, float scale) {
  resident_loop<RPT, false>(src, nullptr, out, rows, cols, ShiftRow{shift, length}, iters, scale);
}

// --------------------------------------------------------- single passes

__device__ __forceinline__ float4 scaled(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// Along rows of a row-major [rows, cols] array: a warp per (row, chunk)
// item, W = 4 floats a lane where VEC (cols % 4 == 0, 16-byte aligned
// pointers), else 1.  FULL: a table of the array's shape; otherwise row(r)
// is the source row of the whole row.
template <bool VEC, bool FULL, class Row>
__global__ void __launch_bounds__(PASS_THREADS)
    probe_rows_pass_kernel(const float* __restrict__ src, const int* __restrict__ table,
                           float* __restrict__ out, int rows, int cols, Row row, float scale) {
  constexpr int W = VEC ? 4 : 1;
  constexpr int SPAN = 32 * W;
  const int chunks = (cols + SPAN - 1) / SPAN;
  const int items = rows * chunks;  // <= rows * cols < 2**31
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (int item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); item < items;
       item += warps) {
    const int r = chunks == 1 ? item : item / chunks;
    const int c = (item - r * chunks) * SPAN + lane * W;
    if (c >= cols) continue;
    const size_t o = static_cast<size_t>(r) * cols + c;
    if (FULL) {
      if (VEC) {
        const int4 j = *reinterpret_cast<const int4*>(table + o);
        const float4 v = make_float4(
            in_rows(j.x, rows) ? src[static_cast<size_t>(j.x) * cols + c] : NAN,
            in_rows(j.y, rows) ? src[static_cast<size_t>(j.y) * cols + c + 1] : NAN,
            in_rows(j.z, rows) ? src[static_cast<size_t>(j.z) * cols + c + 2] : NAN,
            in_rows(j.w, rows) ? src[static_cast<size_t>(j.w) * cols + c + 3] : NAN);
        *reinterpret_cast<float4*>(out + o) = scaled(v, scale);
      } else {
        const int j = table[o];
        out[o] = (in_rows(j, rows) ? src[static_cast<size_t>(j) * cols + c] : NAN) * scale;
      }
    } else {
      const int j = row(r);  // once per item: one row, one index
      const bool ok = in_rows(j, rows);
      if (VEC) {
        const float4 v = ok ? *reinterpret_cast<const float4*>(src + static_cast<size_t>(j) * cols + c)
                            : make_float4(NAN, NAN, NAN, NAN);
        *reinterpret_cast<float4*>(out + o) = scaled(v, scale);
      } else {
        out[o] = (ok ? src[static_cast<size_t>(j) * cols + c] : NAN) * scale;
      }
    }
  }
}

// Along lanes (the contiguous axis) of a row-major [rows, cols] array: a
// thread per element, rows by the grid's y, columns strided along x.  FULL:
// a table of the array's shape, else one index per column.
template <bool FULL>
__global__ void __launch_bounds__(PASS_THREADS)
    probe_lanes_pass_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                            float* __restrict__ out, int rows, int cols, float scale) {
  for (int m = blockIdx.y; m < rows; m += gridDim.y) {
    const size_t base = static_cast<size_t>(m) * cols;
    for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < cols; k += gridDim.x * blockDim.x) {
      const int j = FULL ? idx[base + k] : idx[k];
      out[base + k] = (in_rows(j, cols) ? src[base + j] : NAN) * scale;
    }
  }
}

// ------------------------------------------------------------------- phi

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The order of operations is that of the JAX probes: softplus(a) is
// jax.nn.softplus's max(a, 0) + log1p(exp(-|a|)).
template <bool FAST>
__device__ __forceinline__ float phi_form(float x, int form) {
  const float a = fabsf(x) + 1e-3f;
  if (form == PHI_LOG_TANH)
    return -(FAST ? __logf(tanh_approx(a * 0.5f)) : logf(tanhf(a * 0.5f)));
  const float em = FAST ? __expf(-a) : expf(-a);
  const float lp = FAST ? __logf(1.0f + em) : log1pf(em);
  if (form == PHI_SOFTPLUS_EXPM1) {
    const float e1 = FAST ? __expf(a) - 1.0f : expm1f(a);
    return (fmaxf(a, 0.0f) + lp) - (FAST ? __logf(e1) : logf(e1));
  }
  const float e1 = (FAST ? __expf(a) : expf(a)) - 1.0f;
  return (lp - (FAST ? __logf(e1) : logf(e1))) + a;
}

template <bool FAST>
__global__ void probe_phi_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                                 int form) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) out[k] = phi_form<FAST>(x[k], form);
}

// --------------------------------------------------------------- launches

template <class K>
int opt_in(K kernel, int smem_bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
}

int done() { return static_cast<int>(cudaGetLastError()); }

// A loop kernel's launch in clusters of `cluster` blocks; with `clusters`
// set, only asks how many such clusters the card holds at once.
template <class... Params, class... Args>
int launch_loop(void (*kernel)(Params...), int cluster, int blocks, int threads, int smem,
                cudaStream_t stream, int* clusters, Args... args) {
  if (int err = opt_in(kernel, smem)) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
  if (int err = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...))) return err;
  return done();
}

template <int RPT>
int gather_loop(const float* src, const int* idx, float* out, int rows, int cols, int full,
                int iters, float scale, int cluster, int threads, int blocks, int smem,
                cudaStream_t stream, int* clusters) {
  auto kernel = full ? probe_gather_loop_kernel<RPT, true> : probe_gather_loop_kernel<RPT, false>;
  return launch_loop(kernel, cluster, blocks, threads, smem, stream, clusters, src, idx, out, rows,
                     cols, iters, scale);
}

template <int RPT>
int shift_loop(const float* src, float* out, int rows, int cols, int shift, int length, int iters,
               float scale, int cluster, int threads, int blocks, int smem, cudaStream_t stream,
               int* clusters) {
  return launch_loop(probe_shift_loop_kernel<RPT>, cluster, blocks, threads, smem, stream, clusters,
                     src, out, rows, cols, shift, length, iters, scale);
}

// The loop instances, by rows per thread (probes.LOOP_RPT).
using GatherLoop = decltype(&gather_loop<1>);
using ShiftLoop = decltype(&shift_loop<1>);

GatherLoop gather_loop_for(int rpt) {
  switch (rpt) {
    case 1: return gather_loop<1>;
    case 2: return gather_loop<2>;
    case 4: return gather_loop<4>;
    case 8: return gather_loop<8>;
    case 16: return gather_loop<16>;
    case 32: return gather_loop<32>;
    default: return nullptr;
  }
}

ShiftLoop shift_loop_for(int rpt) {
  switch (rpt) {
    case 1: return shift_loop<1>;
    case 2: return shift_loop<2>;
    case 4: return shift_loop<4>;
    case 8: return shift_loop<8>;
    case 16: return shift_loop<16>;
    case 32: return shift_loop<32>;
    default: return nullptr;
  }
}

template <bool FULL, class Row>
int rows_pass(bool vec, int grid, cudaStream_t stream, const float* src, const int* table,
              float* out, int rows, int cols, Row row, float scale) {
  if (vec) {
    probe_rows_pass_kernel<true, FULL, Row><<<grid, PASS_THREADS, 0, stream>>>(src, table, out, rows,
                                                                             cols, row, scale);
  } else {
    probe_rows_pass_kernel<false, FULL, Row><<<grid, PASS_THREADS, 0, stream>>>(src, table, out,
                                                                              rows, cols, row, scale);
  }
  return done();
}

}  // namespace

// rows, cols: the array's row-major shape.  axis 0 gathers rows, axis 1
// lanes; full: idx has the array's shape, else one entry per gathered row
// (or lane).  rpt > 0 (axis 0 only): the loop, `rpt` rows per thread, in
// clusters of `cluster` blocks, `threads` threads, `blocks_x` blocks (a
// multiple of the cluster), `smem` bytes; otherwise a single pass on a grid
// of blocks_x x blocks_y blocks of 256 threads, `vec` for 16-byte accesses
// along rows.
extern "C" int fgt_probe_gather_launch(const float* src, const int* idx, float* out, int rows,
                                       int cols, int axis, int full, int iters, float scale,
                                       int vec, int rpt, int cluster, int threads, int blocks_x,
                                       int blocks_y, int smem_bytes, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (rpt > 0) {
    const GatherLoop loop = gather_loop_for(rpt);
    if (!loop || axis != 0) return static_cast<int>(cudaErrorInvalidValue);
    return loop(src, idx, out, rows, cols, full, iters, scale, cluster, threads, blocks_x,
                smem_bytes, s, nullptr);
  }
  if (axis == 1) {
    const dim3 grid(blocks_x, blocks_y);
    if (full) {
      probe_lanes_pass_kernel<true><<<grid, PASS_THREADS, 0, s>>>(src, idx, out, rows, cols, scale);
    } else {
      probe_lanes_pass_kernel<false><<<grid, PASS_THREADS, 0, s>>>(src, idx, out, rows, cols, scale);
    }
    return done();
  }
  if (full) return rows_pass<true>(vec, blocks_x, s, src, idx, out, rows, cols, TableRow{idx}, scale);
  return rows_pass<false>(vec, blocks_x, s, src, idx, out, rows, cols, TableRow{idx}, scale);
}

// The shift along rows of a row-major [rows, cols] array, 0 <= shift <
// length <= rows; the plan's arguments as for the gather.
extern "C" int fgt_probe_shift_launch(const float* src, float* out, int rows, int cols, int shift,
                                      int length, int iters, float scale, int vec, int rpt,
                                      int cluster, int threads, int blocks, int smem_bytes,
                                      void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (rpt > 0) {
    const ShiftLoop loop = shift_loop_for(rpt);
    if (!loop) return static_cast<int>(cudaErrorInvalidValue);
    return loop(src, out, rows, cols, shift, length, iters, scale, cluster, threads, blocks,
                smem_bytes, s, nullptr);
  }
  return rows_pass<false>(vec, blocks, s, src, nullptr, out, rows, cols, ShiftRow{shift, length},
                          scale);
}

// How many clusters of a loop's launch the card holds at once
// (cudaOccupancyMaxActiveClusters) in *clusters; kind 0: the gather with
// one index a row, 1: with a full table, 2: the shift.  Returns the error.
extern "C" int fgt_probe_loop_clusters(int kind, int rpt, int cluster, int threads, int blocks,
                                       int smem_bytes, int* clusters) {
  if (kind == 2) {
    const ShiftLoop loop = shift_loop_for(rpt);
    if (!loop) return static_cast<int>(cudaErrorInvalidValue);
    return loop(nullptr, nullptr, 0, 0, 0, 1, 0, 1.0f, cluster, threads, blocks, smem_bytes,
                nullptr, clusters);
  }
  const GatherLoop loop = gather_loop_for(rpt);
  if (!loop) return static_cast<int>(cudaErrorInvalidValue);
  return loop(nullptr, nullptr, nullptr, 0, 0, kind, 0, 1.0f, cluster, threads, blocks, smem_bytes,
              nullptr, clusters);
}

extern "C" int fgt_probe_phi_launch(const float* x, float* out, int n, int form, int fast,
                                    int threads, void* stream) {
  const int grid = (n + threads - 1) / threads;
  auto s = static_cast<cudaStream_t>(stream);
  if (fast) {
    probe_phi_kernel<true><<<grid, threads, 0, s>>>(x, out, n, form);
  } else {
    probe_phi_kernel<false><<<grid, threads, 0, s>>>(x, out, n, form);
  }
  return static_cast<int>(cudaGetLastError());
}
