// Hopper probes of the data movement and the transcendentals that the fused
// quasi-cyclic BP kernels are built from, for sm_90a.
//
// Replaces the thirteen Pallas TPU probes of scripts/probe_pallas.py (k1-k6)
// and scripts/probe_pallas2.py (ka-kf); feedback_gnn_tpu_torch/probes.py
// has one wrapper per probe.  They come down to three kernels:
//
// * probe_gather: out[r, c] = src[idx(r, c), c] along the gathered axis of a
//   2-D array given by its strides (rows of [E, B] for k1, kb, k6, ka, ke;
//   lanes of [8, E] for k2, k2b).  The index table is one entry per row,
//   shared by every column (k1, k2, kb, k6), or a full table laid out like
//   the array (k2b, ka, ke).  An index outside [0, rows) gives NaN.
// * probe_shift: out[r, c] = src[(r + s) mod L, c] for r < L and src[r, c]
//   for r >= L, the index computed and not read from a table: k3 (the
//   np.roll by 13 of [3840, 128]), k4 (s = 13, L = 127 on [128, 128]).
// * probe_phi: phi of a = |x| + 1e-3, elementwise, in the three forms the
//   probes compare: softplus(a) - log(expm1(a)) (k5), -log(tanh(a/2)) (kc)
//   and log1p(exp(-a)) - log(exp(a) - 1) + a (kd), with the accurate CUDA
//   math functions; a timing-only fast mode swaps in __expf, __logf and
//   tanh.approx.f32.
//
// gather and shift take an iteration count and a scale: each iteration
// applies the gather or the shift to the previous result and multiplies by
// the scale (1 and 1.0 for the single probes; 64 and 1.0001 for k6, ke and
// kf, the loops the TPU probes timed).
//
// What bounds them on the card: bytes.  A [3840, 128] f32 array is 1.97 MB,
// read once and written once from device memory (a full index table adds
// 1.97 MB), against a handful of f32 operations per element.  The
// 64-iteration loops also move each element through shared memory once per
// iteration: read, written, and for a gather its index read, which at
// 64 iterations outweighs the device-memory traffic.
//
// Design.  A single pass (the single probes) goes straight from device
// memory to device memory, a thread per element in memory order, so that
// neighbouring threads touch neighbouring addresses.  The loops keep their
// data on chip: the gathered axis runs along rows, so every column is
// independent of every other, and a block holds all rows of one column in
// shared memory, in two buffers (and the column's index table), and runs
// every iteration there; device memory is read once and written once
// whatever the iteration count.  A column of 3840 rows costs 2 x 15 KB
// (plus 15 KB of table).  One column per block gives [3840, 128] 128
// blocks, about one for each of the 132 SMs, where several columns per
// block would leave SMs idle through the loop.  The price is the load and
// the store of the loops: a warp touches 32 rows, 4 bytes of each 32-byte
// sector.  A thread strides over rows, so the hot loop has no division.
// The phi kernel is one thread per element.

#include <cuda_runtime.h>

#include <cmath>

namespace {

enum { PHI_SOFTPLUS_EXPM1 = 0, PHI_LOG_TANH = 1, PHI_EXP_LOG1P = 2 };

struct Tile {
  int rows, cols, row_stride, col_stride;
};

__device__ __forceinline__ size_t offset(const Tile& t, int r, int c) {
  return static_cast<size_t>(r) * t.row_stride + static_cast<size_t>(c) * t.col_stride;
}

// Column c of device memory -> buf[r], and back.
__device__ __forceinline__ void load_column(float* buf, const float* __restrict__ src,
                                            const Tile& t, int c) {
  for (int r = threadIdx.x; r < t.rows; r += blockDim.x) buf[r] = src[offset(t, r, c)];
}

__device__ __forceinline__ void store_column(float* __restrict__ dst, const float* buf,
                                             const Tile& t, int c) {
  for (int r = threadIdx.x; r < t.rows; r += blockDim.x) dst[offset(t, r, c)] = buf[r];
}

// Where a gathered element comes from: row(r, c) is the source row of
// element (r, c).  A table (in device memory for a single pass, in shared
// memory for the loops), or the shift computed.
struct TableRow {
  const int* ix;
  int rs, cs;
  __device__ __forceinline__ int operator()(int r, int c) const {
    return ix[static_cast<size_t>(r) * rs + static_cast<size_t>(c) * cs];
  }
};

struct ShiftRow {
  int shift, length;  // 0 <= shift < length
  __device__ __forceinline__ int operator()(int r, int) const {
    if (r >= length) return r;
    const int j = r + shift;
    return j >= length ? j - length : j;
  }
};

__device__ __forceinline__ bool in_rows(int j, int rows) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(rows);
}

// One pass straight from device memory: thread k takes the k-th element in
// memory order, so neighbouring threads touch neighbouring addresses along
// the contiguous axis.
template <class Row>
__device__ __forceinline__ void direct_pass(const float* __restrict__ src,
                                            float* __restrict__ out, const Tile& t, Row row,
                                            float scale) {
  const int n = t.rows * t.cols;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n; k += gridDim.x * blockDim.x) {
    int r, c;
    if (t.col_stride == 1) {
      r = k / t.cols;
      c = k - r * t.cols;
    } else {
      c = k / t.rows;
      r = k - c * t.rows;
    }
    const int j = row(r, c);
    out[offset(t, r, c)] = (in_rows(j, t.rows) ? src[offset(t, j, c)] : NAN) * scale;
  }
}

// The iterations on the block's column in shared memory, a -> b -> a ...;
// returns the buffer that holds the result.
template <class Row>
__device__ __forceinline__ float* resident_iterations(float* a, float* b, int rows, Row row,
                                                      int iters, float scale) {
  for (int it = 0; it < iters; ++it) {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const int j = row(r, 0);
      b[r] = (in_rows(j, rows) ? a[j] : NAN) * scale;
    }
    __syncthreads();
    float* tmp = a;
    a = b;
    b = tmp;
  }
  return a;
}

// resident == 0: one pass straight from device memory (the single probes).
// Otherwise block c holds column c in shared memory: two buffers of rows
// floats, then the column's index table, rows ints.
__global__ void __launch_bounds__(1024)
    probe_gather_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                        float* __restrict__ out, Tile t, int idx_row_stride, int idx_col_stride,
                        int iters, float scale, int resident) {
  if (!resident) {
    direct_pass(src, out, t, TableRow{idx, idx_row_stride, idx_col_stride}, scale);
    return;
  }
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  float* a = smem;
  float* b = a + t.rows;
  int* ix = reinterpret_cast<int*>(b + t.rows);
  load_column(a, src, t, c);
  for (int r = threadIdx.x; r < t.rows; r += blockDim.x)
    ix[r] = idx[static_cast<size_t>(r) * idx_row_stride + static_cast<size_t>(c) * idx_col_stride];
  __syncthreads();
  a = resident_iterations(a, b, t.rows, TableRow{ix, 1, 0}, iters, scale);
  store_column(out, a, t, c);
}

// The same with the row index computed: (r + s) mod L for r < L, with
// 0 <= s < L, and r itself past L.
__global__ void __launch_bounds__(1024)
    probe_shift_kernel(const float* __restrict__ src, float* __restrict__ out, Tile t, int shift,
                       int length, int iters, float scale, int resident) {
  const ShiftRow row{shift, length};
  if (!resident) {
    direct_pass(src, out, t, row, scale);
    return;
  }
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  float* a = smem;
  float* b = a + t.rows;
  load_column(a, src, t, c);
  __syncthreads();
  a = resident_iterations(a, b, t.rows, row, iters, scale);
  store_column(out, a, t, c);
}

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

template <class K>
int opt_in(K kernel, int smem_bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
}

// A block per column when resident, else a thread per element.
int grid_size(int rows, int cols, int resident, int threads) {
  return resident ? cols : (rows * cols + threads - 1) / threads;
}

}  // namespace

extern "C" int fgt_probe_gather_launch(const float* src, const int* idx, float* out, int rows,
                                       int cols, int row_stride, int col_stride,
                                       int idx_row_stride, int idx_col_stride, int iters,
                                       float scale, int resident, int threads,
                                       int smem_bytes, void* stream) {
  if (int err = opt_in(probe_gather_kernel, smem_bytes)) return err;
  const Tile t{rows, cols, row_stride, col_stride};
  const int grid = grid_size(rows, cols, resident, threads);
  probe_gather_kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      src, idx, out, t, idx_row_stride, idx_col_stride, iters, scale, resident);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fgt_probe_shift_launch(const float* src, float* out, int rows, int cols,
                                      int row_stride, int col_stride, int shift, int length,
                                      int iters, float scale, int resident, int threads,
                                      int smem_bytes, void* stream) {
  if (int err = opt_in(probe_shift_kernel, smem_bytes)) return err;
  const Tile t{rows, cols, row_stride, col_stride};
  const int grid = grid_size(rows, cols, resident, threads);
  probe_shift_kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      src, out, t, shift, length, iters, scale, resident);
  return static_cast<int>(cudaGetLastError());
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
