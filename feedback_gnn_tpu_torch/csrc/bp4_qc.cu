// Fused quaternary syndrome BP for quasi-cyclic CSS codes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel feedback_gnn_tpu/decoders/bp4_qc.py
// (bp4_qc_marginals, body _make_kernel): num_iter flooding iterations of
// quaternary syndrome BP with every message of a sample kept on chip; the
// channel LLRs and syndromes are read from device memory once and only the
// marginals llrx/llry/llrz are written back.
//
// What bounds it on the card: operations, not bytes.  Per edge and
// iteration the decode does two log-space extrinsics (exp, log1p) and, for
// boxplus-phi, two phi evaluations (tanh, log) — transcendental-heavy f32
// work on 5,292 ([[882,24]]) or 7,620 ([[1270,28]]) edges, against one
// read of 4*(4n) bytes and one write of 4*(3n) bytes per sample.
//
// Design: one thread block decodes one sample and keeps that sample's whole
// state in shared memory — 2 x G x l message floats, the 3n channel LLRs,
// the syndromes as +-1 and the code's small index tables.  ([[1270,28]]
// needs ~51 KB, above the 48 KB default, so the launcher opts in to the
// larger dynamic size.)  The TPU kernel's two-roll-plus-select trick is not
// needed: a cyclic shift is (q + s) mod l indexing into shared memory.
// Message plane g, row r holds the edge between CN (i_g, r) and VN
// (j_g, (r - s_g) mod l).  Each iteration is one pass over all VNs, which
// reads each incident slot, forms the marginals and writes the extrinsic
// back into the same slot (each slot belongs to one edge, so the in-place
// update is race-free), then one pass over all CNs of both sides, again in
// place.  Threads stride over nodes, so any code size fits a block.
// Speed is a later concern: no tensor cores, no TMA, one sample per block.
//
// Numerics match the JAX kernel: sums in vn_groups / cn_groups order,
// sign(0) = +1, softplus without threshold, phi clipped to
// [8.5e-8, 16.635532] on input and output.
//
// The constants, phi and the CN update are shared with the binary kernel
// (bp2_qc.cu) through qc_common.cuh.  Built with plain nvcc into a shared
// library with a C interface and loaded with ctypes
// (feedback_gnn_tpu_torch/_build.py); no PyTorch headers.

#include "qc_common.cuh"

namespace {

struct Dims {
  int l, nb, mbx, mbz, gx, gz, dcx, dcz, dvx, dvz;
};

// log(exp(-a) + exp(-b))
__device__ __forceinline__ float lse_neg(float a, float b) {
  return -fminf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// Sum of the VN-frame messages at VN (j, q) over the groups of block column
// j, in vn_groups order.  Fills the slot indices and the values read.
__device__ __forceinline__ float vn_gather(const float* msg, const Side& s, int l, int j, int q,
                                           int* slot, float* val, int& deg) {
  deg = s.vn_deg[j];
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < MAX_DEG; ++k) {
    if (k < deg) {
      const int g = s.vn_tab[j * s.dv + k];
      int r = q + s.shift[g];
      if (r >= l) r -= l;
      slot[k] = g * l + r;
      val[k] = msg[slot[k]];
      sum = (k == 0) ? val[k] : sum + val[k];
    }
  }
  return sum;
}

__global__ void bp4_qc_kernel(const float* __restrict__ llr, const float* __restrict__ synx,
                              const float* __restrict__ synz, float* __restrict__ out,
                              const int* __restrict__ tab, int tab_len, Dims d, int num_iter,
                              int cn_type, int phi_impl, float factor) {
  extern __shared__ float smem[];
  const int l = d.l;
  const int n = d.nb * l;
  const int mx = d.mbx * l;
  const int mz = d.mbz * l;
  float* msg_x = smem;               // [gx, l] CN-frame planes of Hx edges
  float* msg_z = msg_x + d.gx * l;   // [gz, l] planes of Hz edges
  float* L = msg_z + d.gz * l;       // [3, n] channel LLRs (x, y, z)
  float* sx = L + 3 * n;             // [mx] Hx syndrome as +-1
  float* sz = sx + mx;               // [mz] Hz syndrome as +-1
  int* t = reinterpret_cast<int*>(sz + mz);

  const size_t b = blockIdx.x;
  for (int k = threadIdx.x; k < 3 * n; k += blockDim.x) L[k] = llr[b * 3 * n + k];
  for (int k = threadIdx.x; k < mx; k += blockDim.x) sx[k] = 1.0f - 2.0f * synx[b * mx + k];
  for (int k = threadIdx.x; k < mz; k += blockDim.x) sz[k] = 1.0f - 2.0f * synz[b * mz + k];
  for (int k = threadIdx.x; k < tab_len; k += blockDim.x) t[k] = tab[k];
  for (int k = threadIdx.x; k < (d.gx + d.gz) * l; k += blockDim.x) msg_x[k] = 0.0f;
  __syncthreads();

  const Side X = side_at(t, d.nb, d.mbx, d.gx, d.dcx, d.dvx);
  const Side Z = side_at(t + side_len(d.nb, d.mbx, d.gx, d.dcx, d.dvx), d.nb, d.mbz, d.gz, d.dcz,
                         d.dvz);

  for (int it = 0; it < num_iter; ++it) {
    // VN pass: marginals, then extrinsics written back into the read slots
    for (int v = threadIdx.x; v < n; v += blockDim.x) {
      const int j = v / l;
      const int q = v - j * l;
      int slot_x[MAX_DEG], slot_z[MAX_DEG], dgx, dgz;
      float val_x[MAX_DEG], val_z[MAX_DEG];
      const float s_x = vn_gather(msg_x, X, l, j, q, slot_x, val_x, dgx);  // about Z
      const float s_z = vn_gather(msg_z, Z, l, j, q, slot_z, val_z, dgz);  // about X
      const float llrx = s_z + L[v];
      const float llry = s_x + s_z + L[n + v];
      const float llrz = s_x + L[2 * n + v];
      const float num_x = softplusf(-llrx);
#pragma unroll
      for (int k = 0; k < MAX_DEG; ++k) {
        if (k < dgx) msg_x[slot_x[k]] = num_x - lse_neg(llrz - val_x[k], llry - val_x[k]);
      }
      const float num_z = softplusf(-llrz);
#pragma unroll
      for (int k = 0; k < MAX_DEG; ++k) {
        if (k < dgz) msg_z[slot_z[k]] = num_z - lse_neg(llrx - val_z[k], llry - val_z[k]);
      }
    }
    __syncthreads();
    // CN pass over both sides
    for (int c = threadIdx.x; c < mx + mz; c += blockDim.x) {
      if (c < mx) {
        const int i = c / l;
        cn_node(msg_x, X, l, i, c - i * l, sx[c], cn_type, phi_impl, factor);
      } else {
        const int cz = c - mx;
        const int i = cz / l;
        cn_node(msg_z, Z, l, i, cz - i * l, sz[cz], cn_type, phi_impl, factor);
      }
    }
    __syncthreads();
  }

  // final marginals
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    const int j = v / l;
    const int q = v - j * l;
    int slot[MAX_DEG], dg;
    float val[MAX_DEG];
    const float s_x = vn_gather(msg_x, X, l, j, q, slot, val, dg);
    const float s_z = vn_gather(msg_z, Z, l, j, q, slot, val, dg);
    out[b * 3 * n + v] = s_z + L[v];
    out[b * 3 * n + n + v] = s_x + s_z + L[n + v];
    out[b * 3 * n + 2 * n + v] = s_x + L[2 * n + v];
  }
}

}  // namespace

// Launches one block of `threads` threads per sample on `stream`.
// llr [batch, 3, n], synx [batch, mbx*l], synz [batch, mbz*l] (0/1 floats),
// out [batch, 3, n]; tab is the int table of both sides (Hx then Hz).
// Returns the CUDA error code of the attribute call or the launch (0 = ok).
extern "C" int fgt_bp4_qc_launch(const float* llr, const float* synx, const float* synz,
                                 float* out, const int* tab, int tab_len, int batch, int l, int nb,
                                 int mbx, int mbz, int gx, int gz, int dcx, int dcz, int dvx,
                                 int dvz, int num_iter, int cn_type, int phi_impl, float factor,
                                 int threads, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(bp4_qc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Dims d{l, nb, mbx, mbz, gx, gz, dcx, dcz, dvx, dvz};
  bp4_qc_kernel<<<batch, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      llr, synx, synz, out, tab, tab_len, d, num_iter, cn_type, phi_impl, factor);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fgt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
