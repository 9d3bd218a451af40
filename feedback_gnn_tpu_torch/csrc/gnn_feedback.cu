// One feedback-GNN step, fused, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the step
// (feedback_gnn_tpu/decoders/gnn_feedback.py, feedback_gnn_apply) to XLA.
// Its plain PyTorch version (decoders/gnn_feedback.py, the oracle of this
// kernel) is some 60 kernels that pass [hidden, n_pad, B] float32
// intermediates through device memory: ~17.7 GB a step on [[1270,28]] at
// B = 1024.  Here one thread takes one (VN, sample) pair from its inputs to
// its three outputs with every hidden activation in registers: it reads
// the VN's three marginals and its edges' check logits and syndromes, and
// writes the three new LLRs, ~42 MB a step.
//
// What bounds it on the card: instruction issue.  A pair costs ~3,900
// float32 FMAs and 280 accurate tanhf (40 hidden units x 3 edges x 2 sides,
// and 40 in the embed MLP), each tanhf some 20 instructions, two of them
// MUFU: ~10k instructions a pair, against 36 bytes of device memory.
//
// What this design does about it:
// - Threads: blockIdx.y is the VN, 128 blockIdx.x + threadIdx.x the sample,
//   so every load and store of a warp is one coalesced row of the
//   batch-last layout, and the VN's degree, masks and CN ids are the same
//   for the whole block: uniform branches, broadcast reads.
// - Weights: gnn_pack_kernel lays the parameters out once a call in the
//   order the step reads them (Layout below); each block copies them
//   (15.9 KB at (40, 20)) into shared memory with float4 loads.  Every lane
//   of a warp reads the same word: a broadcast, and one LDS.128 feeds four
//   FMAs.
// - Edge MLP, per side: u_k = b0_k + w0[1:, k] . h, then
//   a_k = sum_d mask_d tanh(u_k + w0[0, k] c_d) with c_d = logit (1 - 2 s)
//   of slot d's check, then m += a_k w1[k, :].  Layer 1 is linear, so it
//   commutes with the mean over the edges (as the plain fast path uses):
//   m = m / deg + b1 at the end.  M accumulators a side, never H x dv.
// - Embed MLP: e_k = tanh(be_k + We[:, k] . [m_x, m_z, h]) in four partial
//   sums (the lanes of a float4 row), then out += e_k Wo[k, :]; out += bo.
// - Float32 throughout with accurate tanhf: no tanh.approx, no fast math.
//   Sums are taken in another order than the plain version's products, so
//   the two agree to float32 rounding, not bit for bit.
// - Pad VN rows (no edge) give m = b1, as the plain fast path does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GNN_THREADS = 128;

// The packed parameters of widths (H, M), in floats:
//   side x, then side z, each SIDE floats: per hidden unit k a float4
//     (w0[0,k], w0[1,k], w0[2,k], w0[3,k]); b0[H]; w1[H][M] row-major; b1[M];
//   embed: per k a row of EROW floats, We[0..IN-1, k], be_k, zeros;
//   output: per k a float4 (Wo[k, 0..2], 0); then (bo[0..2], 0).
template <int H, int M>
struct Layout {
  static_assert(H % 4 == 0 && M % 4 == 0, "float4 rows need H and M in fours");
  static constexpr int IN = 2 * M + 3;  // embed inputs: m_x, m_z, h
  static constexpr int SIDE = (5 * H + H * M + M + 3) / 4 * 4;
  static constexpr int EROW = (IN + 1 + 3) / 4 * 4;  // the inputs' weights, then the bias
  static constexpr int EMBED = 2 * SIDE;
  static constexpr int OUT = EMBED + H * EROW;
  static constexpr int TOTAL = OUT + 4 * H + 4;
};

// The parameter tensors, Keras [in, out] kernels read through their
// element strides (the shipped weights are column-major), contiguous
// biases; a null bias reads as 0.
struct Weights {
  const float* w0[2];  // [4, H] per side (x, z)
  const float* b0[2];  // [H]
  const float* w1[2];  // [H, M]
  const float* b1[2];  // [M]
  const float* we;     // [2M+3, H]
  const float* be;     // [H]
  const float* wo;     // [H, 3]
  const float* bo;     // [3]
  int st[6][2];        // (row, column) strides of w0[0], w0[1], w1[0], w1[1], we, wo
};

// One side's inputs: check logits [logit_rows, B] and int32 syndromes
// [syn_rows, B] (rows past their count read as 0, as the plain version pads
// them), and the graph's [dv, n_pad] CN ids and masks and [n_pad] degrees.
struct Side {
  const float* logit;
  const int32_t* syn;
  const int64_t* cn;
  const float* mask;
  const float* deg;
  int logit_rows, syn_rows, dv;
};

template <int H, int M>
__global__ void gnn_pack_kernel(Weights p, float* __restrict__ packed) {
  using L = Layout<H, M>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L::TOTAL) return;
  float x = 0.f;
  if (i < L::EMBED) {
    const int s = i / L::SIDE, r = i % L::SIDE;
    if (r < 4 * H) {
      x = p.w0[s][(r % 4) * p.st[s][0] + (r / 4) * p.st[s][1]];
    } else if (r < 5 * H) {
      x = p.b0[s] ? p.b0[s][r - 4 * H] : 0.f;
    } else if (r < 5 * H + H * M) {
      const int k = (r - 5 * H) / M, j = (r - 5 * H) % M;
      x = p.w1[s][k * p.st[2 + s][0] + j * p.st[2 + s][1]];
    } else if (r < 5 * H + H * M + M) {
      x = p.b1[s] ? p.b1[s][r - 5 * H - H * M] : 0.f;
    }
  } else if (i < L::OUT) {
    const int r = i - L::EMBED, k = r / L::EROW, c = r % L::EROW;
    if (c < L::IN) {
      x = p.we[c * p.st[4][0] + k * p.st[4][1]];
    } else if (c == L::IN) {
      x = p.be ? p.be[k] : 0.f;
    }
  } else if (i < L::OUT + 4 * H) {
    const int r = i - L::OUT, k = r / 4, c = r % 4;
    if (c < 3) x = p.wo[k * p.st[5][0] + c * p.st[5][1]];
  } else {
    const int c = i - L::OUT - 4 * H;
    if (c < 3 && p.bo) x = p.bo[c];
  }
  packed[i] = x;
}

// One side's per-VN message mean m[M] at (v, b); w is the side's packed block.
template <int H, int M, int DV>
__device__ __forceinline__ void edge_side(const float* __restrict__ w, const Side& s, int v, int b,
                                          int n_pad, int batch, float h0, float h1, float h2,
                                          float (&m)[M]) {
  float c[DV], mk[DV];
#pragma unroll
  for (int d = 0; d < DV; ++d) {
    mk[d] = d < s.dv ? s.mask[d * n_pad + v] : 0.f;
    c[d] = 0.f;
    if (mk[d] != 0.f) {
      const int64_t row = s.cn[d * n_pad + v];
      const float lg = row < s.logit_rows ? s.logit[row * batch + b] : 0.f;
      const float sy = row < s.syn_rows ? static_cast<float>(s.syn[row * batch + b]) : 0.f;
      c[d] = lg * (1.f - 2.f * sy);
    }
  }
  const float inv_deg = 1.f / fmaxf(s.deg[v], 1.f);
  const float4* a4 = reinterpret_cast<const float4*>(w);
  const float* b0 = w + 4 * H;
  const float4* w1 = reinterpret_cast<const float4*>(w + 5 * H);
  const float* b1 = w + 5 * H + H * M;
  float acc[M];
#pragma unroll
  for (int j = 0; j < M; ++j) acc[j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < H; ++k) {
    const float4 a = a4[k];
    const float u = fmaf(a.w, h2, fmaf(a.z, h1, fmaf(a.y, h0, b0[k])));
    float t = 0.f;
#pragma unroll
    for (int d = 0; d < DV; ++d) {
      if (mk[d] != 0.f) t = fmaf(mk[d], tanhf(fmaf(a.x, c[d], u)), t);
    }
#pragma unroll
    for (int q = 0; q < M / 4; ++q) {
      const float4 r = w1[k * (M / 4) + q];
      acc[4 * q] = fmaf(t, r.x, acc[4 * q]);
      acc[4 * q + 1] = fmaf(t, r.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(t, r.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(t, r.w, acc[4 * q + 3]);
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j) m[j] = fmaf(acc[j], inv_deg, b1[j]);
}

// h_vn [3, hvn_rows, B] (rows past hvn_rows read as 0), out [3, n_pad, B].
template <int H, int M, int DV>
__global__ void __launch_bounds__(GNN_THREADS)
    gnn_feedback_kernel(const float* __restrict__ hvn, int hvn_rows, Side sx, Side sz,
                        const float* __restrict__ packed, float* __restrict__ out, int n_pad,
                        int batch) {
  using L = Layout<H, M>;
  __shared__ __align__(16) float w[L::TOTAL];
  {
    const float4* src = reinterpret_cast<const float4*>(packed);
    float4* dst = reinterpret_cast<float4*>(w);
    for (int i = threadIdx.x; i < L::TOTAL / 4; i += GNN_THREADS) dst[i] = src[i];
  }
  __syncthreads();
  const int v = blockIdx.y;
  const int b = blockIdx.x * GNN_THREADS + threadIdx.x;
  if (b >= batch) return;

  float h[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    h[i] = v < hvn_rows ? hvn[(static_cast<int64_t>(i) * hvn_rows + v) * batch + b] : 0.f;
  }
  float mx[M], mz[M];
  edge_side<H, M, DV>(w, sx, v, b, n_pad, batch, h[0], h[1], h[2], mx);
  edge_side<H, M, DV>(w + L::SIDE, sz, v, b, n_pad, batch, h[0], h[1], h[2], mz);

  float in[L::EROW];  // [m_x, m_z, h, 1 (the bias), zeros]
#pragma unroll
  for (int j = 0; j < M; ++j) {
    in[j] = mx[j];
    in[M + j] = mz[j];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) in[2 * M + i] = h[i];
#pragma unroll
  for (int i = L::IN; i < L::EROW; ++i) in[i] = i == L::IN ? 1.f : 0.f;
  const float4* we = reinterpret_cast<const float4*>(w + L::EMBED);
  const float4* wo = reinterpret_cast<const float4*>(w + L::OUT);
  float o0 = 0.f, o1 = 0.f, o2 = 0.f;
#pragma unroll 2
  for (int k = 0; k < H; ++k) {
    float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < L::EROW / 4; ++q) {
      const float4 r = we[k * (L::EROW / 4) + q];
      z.x = fmaf(r.x, in[4 * q], z.x);
      z.y = fmaf(r.y, in[4 * q + 1], z.y);
      z.z = fmaf(r.z, in[4 * q + 2], z.z);
      z.w = fmaf(r.w, in[4 * q + 3], z.w);
    }
    const float e = tanhf((z.x + z.y) + (z.z + z.w));
    const float4 r = wo[k];
    o0 = fmaf(e, r.x, o0);
    o1 = fmaf(e, r.y, o1);
    o2 = fmaf(e, r.z, o2);
  }
  const float4 bo = wo[H];
  const int64_t plane = static_cast<int64_t>(n_pad) * batch;
  const int64_t at = static_cast<int64_t>(v) * batch + b;
  out[at] = o0 + bo.x;
  out[plane + at] = o1 + bo.y;
  out[2 * plane + at] = o2 + bo.z;
}

template <int H, int M, int DV>
struct Instance {
  static int launch(const float* hvn, int hvn_rows, const Side& sx, const Side& sz, const Weights& w,
                    float* packed, float* out, int n_pad, int batch, cudaStream_t stream) {
    using L = Layout<H, M>;
    gnn_pack_kernel<H, M><<<(L::TOTAL + 255) / 256, 256, 0, stream>>>(w, packed);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((batch + GNN_THREADS - 1) / GNN_THREADS, n_pad);
    gnn_feedback_kernel<H, M, DV><<<grid, GNN_THREADS, 0, stream>>>(hvn, hvn_rows, sx, sz, packed,
                                                                   out, n_pad, batch);
    return static_cast<int>(cudaGetLastError());
  }
  static const void* kernel() {
    return reinterpret_cast<const void*>(gnn_feedback_kernel<H, M, DV>);
  }
  static int packed_floats() { return Layout<H, M>::TOTAL; }
};

// The instances: (hidden, msg_dims, slots), slots the largest VN degree
// the instance takes: 3 for the GHP codes, 8 for any other graph.
// tests/test_torch_gnn_dispatch.py reads this list.
#define GNN_INSTANCES(X) X(40, 20, 3) X(40, 20, 8)

struct InstanceFns {
  int (*launch)(const float*, int, const Side&, const Side&, const Weights&, float*, float*, int, int,
                cudaStream_t);
  const void* (*kernel)();
  int (*packed_floats)();
};

bool gnn_instance(int hidden, int msg, int slots, InstanceFns* fns) {
#define GNN_CASE(H, M, DV)                                                                   \
  if (hidden == H && msg == M && slots == DV) {                                              \
    *fns = {Instance<H, M, DV>::launch, Instance<H, M, DV>::kernel,                          \
            Instance<H, M, DV>::packed_floats};                                              \
    return true;                                                                             \
  }
  GNN_INSTANCES(GNN_CASE)
#undef GNN_CASE
  return false;
}

}  // namespace

// Floats of the packed-parameter workspace of an instance; 0 if it does not exist.
extern "C" int fgt_gnn_feedback_packed_floats(int hidden, int msg, int slots) {
  InstanceFns fns;
  return gnn_instance(hidden, msg, slots, &fns) ? fns.packed_floats() : 0;
}

// One step: the pack kernel into `packed`, then the step into `out`, both
// on `stream`.  weights: the 12 parameter pointers in the order of
// Weights (w0x, w0z, b0x, b0z, w1x, w1z, b1x, b1z, we, be, wo, bo);
// strides: the 12 kernel strides in the order of Weights::st.
// Returns a CUDA error code (0 = ok), -2 for an instance that does not exist.
extern "C" int fgt_gnn_feedback_launch(
    const float* hvn, int hvn_rows,
    const float* logit_x, int logit_x_rows, const int32_t* syn_x, int syn_x_rows,
    const int64_t* cn_x, const float* mask_x, const float* deg_x, int dv_x,
    const float* logit_z, int logit_z_rows, const int32_t* syn_z, int syn_z_rows,
    const int64_t* cn_z, const float* mask_z, const float* deg_z, int dv_z,
    const float* const* weights, const int* strides, float* packed, float* out, int n_pad,
    int batch, int hidden, int msg, int slots, void* stream) {
  InstanceFns fns;
  if (!gnn_instance(hidden, msg, slots, &fns) || dv_x > slots || dv_z > slots) return -2;
  Weights w;
  for (int s = 0; s < 2; ++s) {
    w.w0[s] = weights[s];
    w.b0[s] = weights[2 + s];
    w.w1[s] = weights[4 + s];
    w.b1[s] = weights[6 + s];
  }
  w.we = weights[8];
  w.be = weights[9];
  w.wo = weights[10];
  w.bo = weights[11];
  for (int i = 0; i < 12; ++i) w.st[i / 2][i % 2] = strides[i];
  const Side sx{logit_x, syn_x, cn_x, mask_x, deg_x, logit_x_rows, syn_x_rows, dv_x};
  const Side sz{logit_z, syn_z, cn_z, mask_z, deg_z, logit_z_rows, syn_z_rows, dv_z};
  return fns.launch(hvn, hvn_rows, sx, sz, w, packed, out, n_pad, batch,
                    static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM, registers per thread and local (spill) bytes per
// thread of an instance's step kernel, into out[0..2].  Returns a CUDA
// error code (0 = ok), -2 for an instance that does not exist.
extern "C" int fgt_gnn_feedback_occupancy(int hidden, int msg, int slots, int* out) {
  InstanceFns fns;
  if (!gnn_instance(hidden, msg, slots, &fns)) return -2;
  int blocks = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns.kernel(), GNN_THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fns.kernel());
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
