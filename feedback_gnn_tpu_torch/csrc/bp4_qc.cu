// Fused quaternary syndrome BP for quasi-cyclic CSS codes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel feedback_gnn_tpu/decoders/bp4_qc.py
// (bp4_qc_marginals, body _make_kernel): num_iter flooding iterations of
// quaternary syndrome BP with every message of a sample kept on chip; the
// channel LLRs and syndromes are read from device memory once and only the
// marginals llrx/llry/llrz are written back.
//
// What bounds it on the card: operations and their issue, not bytes.  Per
// edge and iteration the decode does two log-space extrinsics (exp, log1p)
// and, for boxplus-phi, two phi evaluations (tanh, log): chains of accurate
// libm calls on 5,292 ([[882,24]]) or 7,620 ([[1270,28]]) edges, against
// one read of 4*(4n) bytes and one write of 4*(3n) bytes per sample.  Such
// chains need many warps in flight to keep the schedulers issuing.
//
// What this design does about it:
// - Everything a decode does not change is a template argument: the CN
//   rule, the phi form, the degree pair (DC, DV).  No dead branch and no
//   MAX_DEG-sized array is left in a specialised instance.
// - __launch_bounds__(1024, 1) holds every instance to 64 registers, so an
//   SM keeps 32 warps resident.
// - The graph's indices are looked up once per node, not computed per
//   edge: the wrapper builds a per-node slot table (uint16 message slots of
//   each VN's Hx and Hz edges, in vn_groups order, and of each CN's edges,
//   in cn_groups order), which the block copies into shared memory once.
//   One 16-byte read per node and iteration replaces the divisions by l
//   and the shift and group-table reads of every edge.
// - Each thread owns fixed nodes of one sample for the whole decode (VN v
//   and CN c for v, c = t, t + threads, ...).  A block holds
//   samples_per_block samples, each in its own shared-memory slice with its
//   own threads, which wait on the sample's own named barrier: a sample's
//   half-iterations never wait for another's.  The wrapper's launch plan
//   (decoders/bp4_qc.py, _launch_plan) picks the shape by batch: about one
//   node per thread and one sample per block when the batch is small, to
//   shorten each sample's critical path; fewer threads per sample and as
//   many samples as the SM's shared memory holds when it is large.
//   Samples past the batch in the last block return after the load.
//
// Per sample in shared memory: 2 x G x l message floats in the CN frame
// (plane g, row r holds the edge between CN (i_g, r) and VN
// (j_g, (r - s_g) mod l)), the 3n channel LLRs and one byte per syndrome
// bit (the contract's {0,1}).  Each iteration is a VN pass, which reads each
// incident slot, forms the marginals and writes the extrinsic back into the
// same slot (each slot belongs to one edge, so the update in place is
// race-free), then a CN pass over both sides, in place.
//
// Numerics match the JAX kernel and the plain version bit for bit: sums in
// vn_groups / cn_groups order, sign(0) = +1, softplus without threshold,
// phi clipped to [8.5e-8, 16.635532] on input and output, accurate libm
// only (no fast-math), no expression that nvcc could contract into an FMA.
//
// Instances (K1_INSTANCES below): the five CN-rule/phi cases for the degree
// pairs (6, 3) (the GHP codes) and (8, 4) (GB-48), and for (0, 0), the
// generic instance with runtime degrees up to MAX_DEG; each with the
// float32 message carry and with the bfloat16 one.
//
// The bfloat16 carry (MSG_BF16) is the JAX kernel's msg_dtype=bfloat16:
// the CN pass rounds each output to bfloat16 (nearest even) before it
// writes it into its float32 slot, and nothing else is rounded: the VN
// pass's extrinsics, the marginals and all arithmetic stay float32.  The
// slots, the shared-memory layout and the launch plan are the float32
// carry's.  The constants, phi,
// the CN update and the slot-table rows are shared with the binary kernel
// (bp2_qc.cu) through qc_common.cuh.  Built with plain nvcc into a shared
// library with a C interface and loaded with ctypes
// (feedback_gnn_tpu_torch/_build.py); no PyTorch headers.

#include "qc_common.cuh"

namespace {

struct Dims {
  int n, mx, mz, msgs;  // VNs, Hx CNs, Hz CNs, message slots of both sides
};

// log(exp(-a) + exp(-b))
__device__ __forceinline__ float lse_neg(float a, float b) {
  return -fminf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// Slot-table layout of an instance: a VN row holds VW Hx slots then VW Hz
// slots, a CN row CW slots, each row padded to 16 bytes.
template <int DC, int DV>
struct K1Layout {
  static constexpr int VW = DV ? DV : MAX_DEG;
  static constexpr int CW = DC ? DC : MAX_DEG;
  static constexpr int RV = round_up(2 * VW, 8);
  static constexpr int RC = round_up(CW, 8);
};

// Sum of the VN-frame messages of one side, in vn_groups order; the values
// read are kept for the extrinsics.
template <int DV, int VW, int W>
__device__ __forceinline__ float vn_side(const float* msg, const Row<W>& row, int k0, float* val,
                                         int& deg) {
  deg = DV ? DV : row.degree(k0, VW);
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    if (k < deg) {
      val[k] = msg[row[k0 + k]];
      sum = (k == 0) ? val[k] : sum + val[k];
    }
  }
  return sum;
}

template <int CN, int PHI, int DC, int DV, int MSG>
__global__ void __launch_bounds__(1024, 1)
    bp4_qc_kernel(const float* __restrict__ llr, const float* __restrict__ synx,
                  const float* __restrict__ synz, float* __restrict__ out,
                  const uint16_t* __restrict__ tab, Dims d, int num_iter, float factor, int batch,
                  int threads) {
  using Lay = K1Layout<DC, DV>;
  constexpr int VW = Lay::VW, RV = Lay::RV, RC = Lay::RC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = d.n, m = d.mx + d.mz;
  const int vtab_bytes = round_up(2 * n * RV, 16);
  const int tab_bytes = vtab_bytes + 2 * m * RC;
  const int sample_bytes = round_up(4 * d.msgs + 12 * n + m, 16);

  const uint16_t* vtab = reinterpret_cast<const uint16_t*>(smem);               // [n, RV]
  const uint16_t* ctab = reinterpret_cast<const uint16_t*>(smem + vtab_bytes);  // [m, RC]
  for (int k = threadIdx.x; k < tab_bytes / 16; k += blockDim.x)
    reinterpret_cast<uint4*>(smem)[k] = reinterpret_cast<const uint4*>(tab)[k];

  const int s = threadIdx.x / threads;  // this thread's sample in the block
  const int t = threadIdx.x - s * threads;
  const size_t b = static_cast<size_t>(blockIdx.x) * (blockDim.x / threads) + s;
  float* msg = reinterpret_cast<float*>(smem + tab_bytes + s * sample_bytes);  // [msgs]
  float* L = msg + d.msgs;                                                    // [3, n]
  unsigned char* syn = reinterpret_cast<unsigned char*>(L + 3 * n);           // [m] 0/1
  const bool active = b < static_cast<size_t>(batch);
  if (active) {
    for (int k = t; k < 3 * n; k += threads) L[k] = llr[b * 3 * n + k];
    for (int k = t; k < d.mx; k += threads) syn[k] = synx[b * d.mx + k] != 0.0f;
    for (int k = t; k < d.mz; k += threads) syn[d.mx + k] = synz[b * d.mz + k] != 0.0f;
    for (int k = t; k < d.msgs; k += threads) msg[k] = 0.0f;
  }
  __syncthreads();
  if (!active) return;  // a ragged tail's empty slices; no barrier waits for them

  for (int it = 0; it < num_iter; ++it) {
    // VN pass: marginals, then extrinsics written back into the read slots
    for (int v = t; v < n; v += threads) {
      const Row<RV> row(vtab + v * RV);
      float val_x[VW], val_z[VW];
      int dgx, dgz;
      const float s_x = vn_side<DV, VW>(msg, row, 0, val_x, dgx);   // about Z
      const float s_z = vn_side<DV, VW>(msg, row, VW, val_z, dgz);  // about X
      const float llrx = s_z + L[v];
      const float llry = s_x + s_z + L[n + v];
      const float llrz = s_x + L[2 * n + v];
      const float num_x = softplusf(-llrx);
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        if (k < dgx) msg[row[k]] = num_x - lse_neg(llrz - val_x[k], llry - val_x[k]);
      }
      const float num_z = softplusf(-llrz);
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        if (k < dgz) msg[row[VW + k]] = num_z - lse_neg(llrx - val_z[k], llry - val_z[k]);
      }
    }
    sample_sync(s, threads);
    // CN pass over both sides (Hx CNs, then Hz CNs)
    for (int c = t; c < m; c += threads) {
      const Row<RC> row(ctab + c * RC);
      cn_node<CN, PHI, DC, MSG>(msg, row, syn[c] ? -1.0f : 1.0f, factor);
    }
    sample_sync(s, threads);
  }

  // final marginals
  for (int v = t; v < n; v += threads) {
    const Row<RV> row(vtab + v * RV);
    float val[VW];
    int dg;
    const float s_x = vn_side<DV, VW>(msg, row, 0, val, dg);
    const float s_z = vn_side<DV, VW>(msg, row, VW, val, dg);
    out[b * 3 * n + v] = s_z + L[v];
    out[b * 3 * n + n + v] = s_x + s_z + L[n + v];
    out[b * 3 * n + 2 * n + v] = s_x + L[2 * n + v];
  }
}

using K1Fn = void (*)(const float*, const float*, const float*, float*, const uint16_t*, Dims, int,
                      float, int, int);

struct K1Instance {
  int cn, phi, dc, dv, msg;
  K1Fn fn;
};

// Every instance the launcher dispatches to: (CN rule, phi form, DC, DV,
// message carry); the bfloat16 carry has an instance for every float32 one.
const K1Instance K1_INSTANCES[] = {
    {CN_PHI, PHI_TANH, 6, 3, MSG_F32, bp4_qc_kernel<CN_PHI, PHI_TANH, 6, 3, MSG_F32>},
    {CN_PHI, PHI_TF, 6, 3, MSG_F32, bp4_qc_kernel<CN_PHI, PHI_TF, 6, 3, MSG_F32>},
    {CN_PHI, PHI_ACCURATE, 6, 3, MSG_F32, bp4_qc_kernel<CN_PHI, PHI_ACCURATE, 6, 3, MSG_F32>},
    {CN_TANH, PHI_TANH, 6, 3, MSG_F32, bp4_qc_kernel<CN_TANH, PHI_TANH, 6, 3, MSG_F32>},
    {CN_MINSUM, PHI_TANH, 6, 3, MSG_F32, bp4_qc_kernel<CN_MINSUM, PHI_TANH, 6, 3, MSG_F32>},
    {CN_PHI, PHI_TANH, 8, 4, MSG_F32, bp4_qc_kernel<CN_PHI, PHI_TANH, 8, 4, MSG_F32>},
    {CN_PHI, PHI_TF, 8, 4, MSG_F32, bp4_qc_kernel<CN_PHI, PHI_TF, 8, 4, MSG_F32>},
    {CN_PHI, PHI_ACCURATE, 8, 4, MSG_F32, bp4_qc_kernel<CN_PHI, PHI_ACCURATE, 8, 4, MSG_F32>},
    {CN_TANH, PHI_TANH, 8, 4, MSG_F32, bp4_qc_kernel<CN_TANH, PHI_TANH, 8, 4, MSG_F32>},
    {CN_MINSUM, PHI_TANH, 8, 4, MSG_F32, bp4_qc_kernel<CN_MINSUM, PHI_TANH, 8, 4, MSG_F32>},
    {CN_PHI, PHI_TANH, 0, 0, MSG_F32, bp4_qc_kernel<CN_PHI, PHI_TANH, 0, 0, MSG_F32>},
    {CN_PHI, PHI_TF, 0, 0, MSG_F32, bp4_qc_kernel<CN_PHI, PHI_TF, 0, 0, MSG_F32>},
    {CN_PHI, PHI_ACCURATE, 0, 0, MSG_F32, bp4_qc_kernel<CN_PHI, PHI_ACCURATE, 0, 0, MSG_F32>},
    {CN_TANH, PHI_TANH, 0, 0, MSG_F32, bp4_qc_kernel<CN_TANH, PHI_TANH, 0, 0, MSG_F32>},
    {CN_MINSUM, PHI_TANH, 0, 0, MSG_F32, bp4_qc_kernel<CN_MINSUM, PHI_TANH, 0, 0, MSG_F32>},
    {CN_PHI, PHI_TANH, 6, 3, MSG_BF16, bp4_qc_kernel<CN_PHI, PHI_TANH, 6, 3, MSG_BF16>},
    {CN_PHI, PHI_TF, 6, 3, MSG_BF16, bp4_qc_kernel<CN_PHI, PHI_TF, 6, 3, MSG_BF16>},
    {CN_PHI, PHI_ACCURATE, 6, 3, MSG_BF16, bp4_qc_kernel<CN_PHI, PHI_ACCURATE, 6, 3, MSG_BF16>},
    {CN_TANH, PHI_TANH, 6, 3, MSG_BF16, bp4_qc_kernel<CN_TANH, PHI_TANH, 6, 3, MSG_BF16>},
    {CN_MINSUM, PHI_TANH, 6, 3, MSG_BF16, bp4_qc_kernel<CN_MINSUM, PHI_TANH, 6, 3, MSG_BF16>},
    {CN_PHI, PHI_TANH, 8, 4, MSG_BF16, bp4_qc_kernel<CN_PHI, PHI_TANH, 8, 4, MSG_BF16>},
    {CN_PHI, PHI_TF, 8, 4, MSG_BF16, bp4_qc_kernel<CN_PHI, PHI_TF, 8, 4, MSG_BF16>},
    {CN_PHI, PHI_ACCURATE, 8, 4, MSG_BF16, bp4_qc_kernel<CN_PHI, PHI_ACCURATE, 8, 4, MSG_BF16>},
    {CN_TANH, PHI_TANH, 8, 4, MSG_BF16, bp4_qc_kernel<CN_TANH, PHI_TANH, 8, 4, MSG_BF16>},
    {CN_MINSUM, PHI_TANH, 8, 4, MSG_BF16, bp4_qc_kernel<CN_MINSUM, PHI_TANH, 8, 4, MSG_BF16>},
    {CN_PHI, PHI_TANH, 0, 0, MSG_BF16, bp4_qc_kernel<CN_PHI, PHI_TANH, 0, 0, MSG_BF16>},
    {CN_PHI, PHI_TF, 0, 0, MSG_BF16, bp4_qc_kernel<CN_PHI, PHI_TF, 0, 0, MSG_BF16>},
    {CN_PHI, PHI_ACCURATE, 0, 0, MSG_BF16, bp4_qc_kernel<CN_PHI, PHI_ACCURATE, 0, 0, MSG_BF16>},
    {CN_TANH, PHI_TANH, 0, 0, MSG_BF16, bp4_qc_kernel<CN_TANH, PHI_TANH, 0, 0, MSG_BF16>},
    {CN_MINSUM, PHI_TANH, 0, 0, MSG_BF16, bp4_qc_kernel<CN_MINSUM, PHI_TANH, 0, 0, MSG_BF16>},
};

K1Fn k1_instance(int cn, int phi, int dc, int dv, int msg) {
  for (const K1Instance& k : K1_INSTANCES)
    if (k.cn == cn && k.phi == phi && k.dc == dc && k.dv == dv && k.msg == msg) return k.fn;
  return nullptr;
}

}  // namespace

// Launches ceil(batch / samples_per_block) blocks of threads *
// samples_per_block threads on `stream`, with smem_bytes of dynamic shared
// memory.  llr [batch, 3, n], synx [batch, mx], synz [batch, mz] (0/1
// floats), out [batch, 3, n]; tab the uint16 slot table of the instance's
// layout (VN rows, then CN rows; 16-byte multiple).  Returns the CUDA error
// code of the attribute call or the launch (0 = ok), -1 for an instance
// that does not exist.
extern "C" int fgt_bp4_qc_launch(const float* llr, const float* synx, const float* synz,
                                 float* out, const uint16_t* tab, int batch, int n, int mx, int mz,
                                 int msgs, int num_iter, int cn_type, int phi_impl, int dc, int dv,
                                 int msg_dtype, float factor, int threads, int samples_per_block,
                                 int smem_bytes, void* stream) {
  const K1Fn fn = k1_instance(cn_type, phi_impl, dc, dv, msg_dtype);
  if (fn == nullptr) return -1;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Dims d{n, mx, mz, msgs};
  const int blocks = (batch + samples_per_block - 1) / samples_per_block;
  fn<<<blocks, threads * samples_per_block, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      llr, synx, synz, out, tab, d, num_iter, factor, batch, threads);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM, registers per thread and spill bytes per thread
// of one instance at block_threads threads and smem_bytes of dynamic shared
// memory, into out[0..2].  Returns a CUDA error code (0 = ok), -1 for an
// instance that does not exist.
extern "C" int fgt_bp4_qc_occupancy(int cn_type, int phi_impl, int dc, int dv, int msg_dtype,
                                    int block_threads, int smem_bytes, int* out) {
  const K1Fn fn = k1_instance(cn_type, phi_impl, dc, dv, msg_dtype);
  if (fn == nullptr) return -1;
  return occupancy_of(fn, block_threads, smem_bytes, out);
}

extern "C" const char* fgt_cuda_error_string(int code) {
  if (code == -1) return "no kernel instance for this CN rule, phi form, degree pair and message carry";
  if (code == -2) return "no feedback-GNN kernel instance for these widths and VN degree";
  if (code == -3) return "no OSD-0 kernel for this shape or batch";
  if (code == -4) return "no GF(2) product kernel for this shape or batch";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
