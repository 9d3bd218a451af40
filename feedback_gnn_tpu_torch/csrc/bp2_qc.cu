// Fused binary syndrome BP for one quasi-cyclic parity-check matrix, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel feedback_gnn_tpu/decoders/bp2_qc.py
// (bp2_qc_logits, body _make_kernel): num_iter flooding iterations of
// binary syndrome BP with every message of a sample kept on chip.  The
// channel logits are clipped to +-20 and negated into "true" LLRs on entry,
// the syndrome enters the CN sign product as 1 - 2s, and the marginals are
// negated back into logits on the way out.  The channel logits and the
// syndrome are read from device memory once; only the marginal logits are
// written back.
//
// What bounds it on the card: operations, not bytes.  For the hx of
// [[882,24]] (2,646 edges, 441 x 882) at B=20480 and 100 minsum
// iterations, the decode does about 17 f32 operations per edge and
// iteration (VN side 2, CN side 15), ~0.09 TFLOP, ~1.4 ms at 67 TFLOP/s;
// it reads and writes (882 + 441 + 882) floats, ~8.8 KB, per sample, ~180
// MB in all, ~0.05 ms at 3.35 TB/s.
//
// Design: the one-block-per-sample design of the quaternary kernel
// (bp4_qc.cu).  A block keeps one sample's whole state in shared memory:
// G x l message floats in the CN frame, the n true LLRs, the m syndrome
// signs and the code's small index table ([[882,24]]: 15,876 B plus 588 B
// of table; [[1270,28]]: 22,860 B plus its table).  A cyclic shift is
// (q + s) mod l indexing, not the TPU's two rolls and a select.  Each
// iteration is a VN pass, which forms each VN's total and writes the
// extrinsics back into the slots it read, then a CN pass, in place, with
// __syncthreads() between them.  Threads stride over nodes.  Speed is a
// later concern: many samples are in flight only because the batch is
// large; no tensor cores, no TMA.
//
// Numerics match the JAX kernel: the VN total starts from the channel LLR
// and adds the groups in vn_groups order (not the quaternary kernel's
// order, which starts from the first message), the CN rules are those of
// qc_common.cuh with phi in the tanh form.

#include "qc_common.cuh"

namespace {

__global__ void bp2_qc_kernel(const float* __restrict__ logits, const float* __restrict__ syn,
                              float* __restrict__ out, const int* __restrict__ tab, int tab_len,
                              int l, int nb, int mb, int g, int dc, int dv, int num_iter,
                              int cn_type, float factor) {
  extern __shared__ float smem[];
  const int n = nb * l;
  const int m = mb * l;
  float* msg = smem;        // [g, l] CN-frame planes
  float* L = msg + g * l;   // [n] true LLRs
  float* sp = L + n;        // [m] syndrome as +-1
  int* t = reinterpret_cast<int*>(sp + m);

  const size_t b = blockIdx.x;
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    L[k] = -clipf(logits[b * n + k], -LLR_MAX, LLR_MAX);
  for (int k = threadIdx.x; k < m; k += blockDim.x) sp[k] = 1.0f - 2.0f * syn[b * m + k];
  for (int k = threadIdx.x; k < tab_len; k += blockDim.x) t[k] = tab[k];
  for (int k = threadIdx.x; k < g * l; k += blockDim.x) msg[k] = 0.0f;
  __syncthreads();

  const Side S = side_at(t, nb, mb, g, dc, dv);

  for (int it = 0; it < num_iter; ++it) {
    // VN pass: total = LLR + messages in vn_groups order, then the
    // extrinsics written back into the read slots
    for (int v = threadIdx.x; v < n; v += blockDim.x) {
      const int j = v / l;
      const int q = v - j * l;
      const int deg = S.vn_deg[j];
      int slot[MAX_DEG];
      float val[MAX_DEG];
      float tot = L[v];
#pragma unroll
      for (int k = 0; k < MAX_DEG; ++k) {
        if (k < deg) {
          const int gg = S.vn_tab[j * S.dv + k];
          int r = q + S.shift[gg];
          if (r >= l) r -= l;
          slot[k] = gg * l + r;
          val[k] = msg[slot[k]];
          tot = tot + val[k];
        }
      }
#pragma unroll
      for (int k = 0; k < MAX_DEG; ++k) {
        if (k < deg) msg[slot[k]] = tot - val[k];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < m; c += blockDim.x) {
      const int i = c / l;
      cn_node(msg, S, l, i, c - i * l, sp[c], cn_type, PHI_TANH, factor);
    }
    __syncthreads();
  }

  // final marginals, back to logits
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    const int j = v / l;
    const int q = v - j * l;
    const int deg = S.vn_deg[j];
    float tot = L[v];
#pragma unroll
    for (int k = 0; k < MAX_DEG; ++k) {
      if (k < deg) {
        const int gg = S.vn_tab[j * S.dv + k];
        int r = q + S.shift[gg];
        if (r >= l) r -= l;
        tot = tot + msg[gg * l + r];
      }
    }
    out[b * n + v] = -tot;
  }
}

}  // namespace

// Launches one block of `threads` threads per sample on `stream`.
// logits [batch, nb*l] channel logits, syn [batch, mb*l] (0/1 floats),
// out [batch, nb*l] marginal logits; tab is the int table of the matrix
// (layout of Side in qc_common.cuh).
// Returns the CUDA error code of the attribute call or the launch (0 = ok).
extern "C" int fgt_bp2_qc_launch(const float* logits, const float* syn, float* out,
                                 const int* tab, int tab_len, int batch, int l, int nb, int mb,
                                 int g, int dc, int dv, int num_iter, int cn_type, float factor,
                                 int threads, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(bp2_qc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  bp2_qc_kernel<<<batch, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      logits, syn, out, tab, tab_len, l, nb, mb, g, dc, dv, num_iter, cn_type, factor);
  return static_cast<int>(cudaGetLastError());
}
