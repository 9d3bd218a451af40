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
// What bounds it on the card: operations and their issue, not bytes.  For
// the hx of [[882,24]] (2,646 edges, 441 x 882) at B=20480 and 100 minsum
// iterations, the decode does about 17 f32 operations per edge and
// iteration (VN side 2, CN side 15), ~0.09 TFLOP, ~1.4 ms at 67 TFLOP/s;
// it reads and writes (882 + 441 + 882) floats, ~8.8 KB, per sample, ~180
// MB in all, ~0.05 ms at 3.35 TB/s.  Each edge's few operations sit between
// index work and shared-memory reads, so issue slots and warps in flight,
// not arithmetic, set the pace.
//
// What this design does about it: the design of the quaternary kernel
// (bp4_qc.cu).  Instances are specialised on the CN rule and the degree
// pair (DC, DV); the minsum instances are held to 40 registers by
// __launch_bounds__(512, 3), so three 512-thread blocks fit an SM, the
// others to 64; the graph's message slots come from a per-node slot table
// in shared memory (one 8-byte read per VN, one 16-byte read per CN, each
// iteration), with no division by l and no shift-table read per edge; each
// thread owns fixed nodes of one sample, several samples share a block,
// each waiting on its own named barrier; the launch plan
// (decoders/bp2_qc.py) picks threads per sample and samples per block by
// batch.
//
// Per sample in shared memory: G x l message floats in the CN frame, the n
// true LLRs and one byte per syndrome bit ([[882,24]]'s hx: 14,560 B; the
// slot table, 14,112 B, once per block).  Each iteration is a VN pass,
// which forms each VN's total and writes the extrinsics back into the slots
// it read, then a CN pass, in place, with the sample's barrier between.
//
// Numerics match the JAX kernel and the plain version bit for bit: the VN
// total starts from the channel LLR and adds the groups in vn_groups order
// (not the quaternary kernel's order, which starts from the first message),
// the CN rules are those of qc_common.cuh with phi in the tanh form.
//
// Instances (K2_INSTANCES below): the three CN rules for the degree pairs
// (6, 3) and (8, 4), and for (0, 0), the generic instance with runtime
// degrees up to MAX_DEG.

#include "qc_common.cuh"

namespace {

// Slot-table layout of an instance: a VN row holds VW slots, a CN row CW,
// each padded to an 8- (VN) or 16-byte (CN) multiple.
template <int DC, int DV>
struct K2Layout {
  static constexpr int VW = DV ? DV : MAX_DEG;
  static constexpr int CW = DC ? DC : MAX_DEG;
  static constexpr int RV = round_up(VW, 4);
  static constexpr int RC = round_up(CW, 8);
};

// VN total: the true LLR plus the VN-frame messages in vn_groups order.
template <int DV, int VW, int W>
__device__ __forceinline__ float vn_total(const float* msg, const Row<W>& row, float llr,
                                          float* val, int& deg) {
  deg = DV ? DV : row.degree(0, VW);
  float tot = llr;
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    if (k < deg) {
      val[k] = msg[row[k]];
      tot = tot + val[k];
    }
  }
  return tot;
}

template <int CN, int DC, int DV>
__global__ void __launch_bounds__(512, CN == CN_MINSUM ? 3 : 2)
    bp2_qc_kernel(const float* __restrict__ logits, const float* __restrict__ syn_in,
                  float* __restrict__ out, const uint16_t* __restrict__ tab, int n, int m, int msgs,
                  int num_iter, float factor, int batch, int threads) {
  using Lay = K2Layout<DC, DV>;
  constexpr int VW = Lay::VW, RV = Lay::RV, RC = Lay::RC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int vtab_bytes = round_up(2 * n * RV, 16);
  const int tab_bytes = vtab_bytes + 2 * m * RC;
  const int sample_bytes = round_up(4 * msgs + 4 * n + m, 16);

  const uint16_t* vtab = reinterpret_cast<const uint16_t*>(smem);               // [n, RV]
  const uint16_t* ctab = reinterpret_cast<const uint16_t*>(smem + vtab_bytes);  // [m, RC]
  for (int k = threadIdx.x; k < tab_bytes / 16; k += blockDim.x)
    reinterpret_cast<uint4*>(smem)[k] = reinterpret_cast<const uint4*>(tab)[k];

  const int s = threadIdx.x / threads;  // this thread's sample in the block
  const int t = threadIdx.x - s * threads;
  const size_t b = static_cast<size_t>(blockIdx.x) * (blockDim.x / threads) + s;
  float* msg = reinterpret_cast<float*>(smem + tab_bytes + s * sample_bytes);  // [msgs]
  float* L = msg + msgs;                                                      // [n] true LLRs
  unsigned char* syn = reinterpret_cast<unsigned char*>(L + n);               // [m] 0/1
  const bool active = b < static_cast<size_t>(batch);
  if (active) {
    for (int k = t; k < n; k += threads) L[k] = -clipf(logits[b * n + k], -LLR_MAX, LLR_MAX);
    for (int k = t; k < m; k += threads) syn[k] = syn_in[b * m + k] != 0.0f;
    for (int k = t; k < msgs; k += threads) msg[k] = 0.0f;
  }
  __syncthreads();
  if (!active) return;  // a ragged tail's empty slices; no barrier waits for them

  for (int it = 0; it < num_iter; ++it) {
    // VN pass: total = LLR + messages in vn_groups order, then the
    // extrinsics written back into the read slots
    for (int v = t; v < n; v += threads) {
      const Row<RV> row(vtab + v * RV);
      float val[VW];
      int deg;
      const float tot = vn_total<DV, VW>(msg, row, L[v], val, deg);
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        if (k < deg) msg[row[k]] = tot - val[k];
      }
    }
    sample_sync(s, threads);
    for (int c = t; c < m; c += threads) {
      const Row<RC> row(ctab + c * RC);
      cn_node<CN, PHI_TANH, DC>(msg, row, syn[c] ? -1.0f : 1.0f, factor);
    }
    sample_sync(s, threads);
  }

  // final marginals, back to logits
  for (int v = t; v < n; v += threads) {
    const Row<RV> row(vtab + v * RV);
    float val[VW];
    int deg;
    out[b * n + v] = -vn_total<DV, VW>(msg, row, L[v], val, deg);
  }
}

using K2Fn = void (*)(const float*, const float*, float*, const uint16_t*, int, int, int, int, float,
                      int, int);

struct K2Instance {
  int cn, dc, dv;
  K2Fn fn;
};

// Every instance the launcher dispatches to: (CN rule, DC, DV).
const K2Instance K2_INSTANCES[] = {
    {CN_PHI, 6, 3, bp2_qc_kernel<CN_PHI, 6, 3>},
    {CN_TANH, 6, 3, bp2_qc_kernel<CN_TANH, 6, 3>},
    {CN_MINSUM, 6, 3, bp2_qc_kernel<CN_MINSUM, 6, 3>},
    {CN_PHI, 8, 4, bp2_qc_kernel<CN_PHI, 8, 4>},
    {CN_TANH, 8, 4, bp2_qc_kernel<CN_TANH, 8, 4>},
    {CN_MINSUM, 8, 4, bp2_qc_kernel<CN_MINSUM, 8, 4>},
    {CN_PHI, 0, 0, bp2_qc_kernel<CN_PHI, 0, 0>},
    {CN_TANH, 0, 0, bp2_qc_kernel<CN_TANH, 0, 0>},
    {CN_MINSUM, 0, 0, bp2_qc_kernel<CN_MINSUM, 0, 0>},
};

K2Fn k2_instance(int cn, int dc, int dv) {
  for (const K2Instance& k : K2_INSTANCES)
    if (k.cn == cn && k.dc == dc && k.dv == dv) return k.fn;
  return nullptr;
}

}  // namespace

// Launches ceil(batch / samples_per_block) blocks of threads *
// samples_per_block threads on `stream`, with smem_bytes of dynamic shared
// memory.  logits [batch, n] channel logits, syn [batch, m] (0/1 floats),
// out [batch, n] marginal logits; tab the uint16 slot table of the
// instance's layout (VN rows, then CN rows; 16-byte multiple).  Returns the
// CUDA error code of the attribute call or the launch (0 = ok), -1 for an
// instance that does not exist.
extern "C" int fgt_bp2_qc_launch(const float* logits, const float* syn, float* out,
                                 const uint16_t* tab, int batch, int n, int m, int msgs,
                                 int num_iter, int cn_type, int dc, int dv, float factor,
                                 int threads, int samples_per_block, int smem_bytes, void* stream) {
  const K2Fn fn = k2_instance(cn_type, dc, dv);
  if (fn == nullptr) return -1;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (batch + samples_per_block - 1) / samples_per_block;
  fn<<<blocks, threads * samples_per_block, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      logits, syn, out, tab, n, m, msgs, num_iter, factor, batch, threads);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM, registers per thread and spill bytes per thread
// of one instance, into out[0..2] (as fgt_bp4_qc_occupancy).
extern "C" int fgt_bp2_qc_occupancy(int cn_type, int dc, int dv, int block_threads,
                                    int smem_bytes, int* out) {
  const K2Fn fn = k2_instance(cn_type, dc, dv);
  if (fn == nullptr) return -1;
  return occupancy_of(fn, block_threads, smem_bytes, out);
}
