// GNN_BP4's CN update and VN update, each one fused kernel, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves GNN_BP4
// (feedback_gnn_tpu/decoders/gnn_full.py) to XLA.  Its plain PyTorch version
// (decoders/gnn_full.py, _update_cn_plain and _update_vn_plain, the oracle of
// these kernels) gathers each edge's endpoint embeddings into
// [2e, slots, nodes, B] tensors and runs the message MLPs through them as
// sgemms, ReLU, sign and mask passes and slot sums: at [[882,24]] and
// B = 20480 each such tensor is 8.7 GB, and an update passes over several.
// Here one thread takes one (node, sample) pair from the embeddings it reads
// to the embedding it writes; every edge feature, hidden activation and
// message stays in registers.
//
// What bounds it on the card: float32 FMA issue.  A CN update's pair costs
// dc (2e h + h m) + (m + e + 1) h + h e FMAs (16,840 at [[882,24]]'s widths
// and degrees) against 4 (dc + 1) e + 4 bytes read and 4 e written, a VN
// update's 2 dv (2e h + h m) + (2m + e) h + h e (17,600) against
// 4 (2 dv + 1) e + 8 dv read and 4 e written.
//
// What the design does about it:
// - Threads: a thread a (node, sample) pair; a work item is 128 consecutive
//   samples of one node, so every load and store of a warp is one coalesced
//   row of the batch-last layout, and the node's slots, masks and degree are
//   the same for the whole block: uniform branches, broadcast reads.
// - Persistent blocks: as many as are resident at once, each walking the
//   items node-fastest within a batch tile, so the items in flight share a
//   tile and a gathered endpoint embedding (a VN's for its CNs, a CN's for
//   its VNs) comes from L2 after its first read.
// - Weights: packed by the wrapper in the order they are read (each dense
//   kernel in its Keras [in][out] layout, row-major: Widths below) and
//   copied once a block into shared memory.  Every lane reads the same word
//   (a broadcast); one LDS.128 feeds 4 SP FMAs of a message MLP.
// - Register blocking over the slots: a message MLP takes SP of the node's
//   slots at a time (the instance's; 2 of a CN's 6, 3 of a VN's 3 a side),
//   their endpoint embeddings and the node's own (the "to" half of every
//   slot's feature, loaded once) in registers; layer 0 in chunks of 4
//   hidden units, 4 SP accumulators, each over the slot's whole
//   concatenated feature.
// - Layer 1 right behind each chunk: SP x M accumulators,
//   part[d][j] += relu(u_dk) W1[k][j], so every edge's layer 1 is computed,
//   in the plain version's order (each sum over its inputs from the first),
//   and no H x slots activations are held.  Then each slot's message times
//   its mask (and syndrome sign in a VN update: +1, -1 or 0, exact) is added
//   to the node's sum in slot order, as the plain version's masked sum adds
//   them.  So the VN update equals the plain version bit for bit and the CN
//   update comes within a few float32 ulps (its embed product's order).
//   The alternative of M accumulators over every (slot, unit) product holds
//   fewer registers but sums 240 products in a row: 1.4e-5 from the plain
//   version under reduce_op "sum", past the 1e-5 that its tests hold.
// - Sums that outlive a pass (a CN's slot sum over its passes, a VN's side x
//   while side z runs) wait in this thread's column of a shared-memory tile,
//   not in registers, so the passes fit 168 registers: 3 blocks an SM (the
//   VN update's 3-slot pass spills 32 bytes; at 2 blocks an SM, with no
//   spill, it ran 18.7 ms against 17.1 at [[882,24]], B = 20480).
// - Each pass loads its gathers straight into registers: a cp.async prefetch
//   of the next pass into shared memory while this one computes ran slower
//   (CN 17.1 ms against 16.5, VN 22.4 against 17.1), its copies and reads
//   competing with the weights' shared-memory loads.
// - One copy of the message code a kernel (a VN update's two sides loop over
//   it), which keeps the hot code in the instruction cache: the VN update
//   with a copy a side ran 20.1 ms against 16.8 at [[882,24]], B = 20480.
// - Then the mean (division by max(deg, 1)) or the sum, and the embed MLP,
//   its hidden layer in chunks of 4 units fed straight into its output layer.
// - Float32 FFMA throughout: no tensor cores, no fast math.
// - A slot with mask 0 is skipped, which the plain version's masked sum
//   makes 0; a node with none (a pad row) reduces to 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BP4_THREADS = 128;

// The packed weights of widths (E, M, H), in floats; a message MLP is
// W0 [2E][H] (rows 0..E-1 the "from" endpoint's, E..2E-1 the "to" node's),
// W1 [H][M]; an embed MLP V0 [IN][H], V1 [H][E].
//   CN update: side x, then side z, each: message W0, W1; embed V0, V1
//   (IN = M + E + 1: the reduced messages, the CN's embedding, its logit).
//   VN update: message x W0, W1; message z W0, W1; embed V0, V1 (IN = 2M + E:
//   the reduced x messages, the reduced z messages, the VN's embedding).
template <int E, int M, int H>
struct Widths {
  static_assert(E % 4 == 0 && M % 4 == 0 && H % 4 == 0, "float4 rows need the widths in fours");
  static constexpr int MSG = 2 * E * H + H * M;
  static constexpr int CN_IN = M + E + 1;
  static constexpr int VN_IN = 2 * M + E;
  static constexpr int CN_SIDE = MSG + CN_IN * H + H * E;
  static constexpr int CN_TOTAL = 2 * CN_SIDE;
  static constexpr int VN_TOTAL = 2 * MSG + VN_IN * H + H * E;
};

// Resident blocks an SM that __launch_bounds__ asks for: 3 (at most 168
// registers a thread) while a pass holds up to 3 slots' embeddings and
// per-slot sums without spilling, else 2.
constexpr int min_blocks(int sp) { return sp <= 3 ? 3 : 2; }

// One side of a CN update: its CN embeddings [E, c_pad, B], its logits
// [c_pad, B] (the check logits times the syndrome signs, or zeros), its
// output [E, c_pad, B], and the graph's [dc, c_pad] VN ids and masks and
// [c_pad] degrees.
struct CnSide {
  const float* h_cn;
  const float* logit;
  float* out;
  const int64_t* vn;
  const float* mask;
  const float* deg;
  int c_pad, dc;
};

// One side of a VN update: its CN embeddings [E, c_pad, B], the syndrome
// signs [c_pad, B] (+1 / -1), and the graph's [dv, n_pad] CN ids and masks
// and [n_pad] degrees.
struct VnSide {
  const float* h_cn;
  const float* sign;
  const int64_t* cn;
  const float* mask;
  const float* deg;
  int c_pad, dv;
};

template <int TOTAL>
__device__ __forceinline__ void copy_weights(const float* __restrict__ packed, float* w) {
  static_assert(TOTAL % 4 == 0, "float4 copy");
  const float4* src = reinterpret_cast<const float4*>(packed);
  float4* dst = reinterpret_cast<float4*>(w);
  for (int i = threadIdx.x; i < TOTAL / 4; i += BP4_THREADS) dst[i] = src[i];
  __syncthreads();
}

// The message MLP on SP slots: part[d][j] = sum over the hidden units k of
// relu(W0[:, k] . [from[d]; to]) W1[k][j], each sum over k in order from 0,
// as the plain version's products take them.
template <int E, int M, int H, int SP>
__device__ __forceinline__ void message_pass(const float* __restrict__ w0, const float* __restrict__ w1,
                                             const float (&from)[SP][E], const float (&to)[E],
                                             float (&part)[SP][M]) {
#pragma unroll
  for (int d = 0; d < SP; ++d) {
#pragma unroll
    for (int j = 0; j < M; ++j) part[d][j] = 0.f;
  }
#pragma unroll 1
  for (int k = 0; k < H; k += 4) {
    float u[SP][4];
#pragma unroll
    for (int d = 0; d < SP; ++d) {
#pragma unroll
      for (int q = 0; q < 4; ++q) u[d][q] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float4 w = *reinterpret_cast<const float4*>(w0 + i * H + k);
#pragma unroll
      for (int d = 0; d < SP; ++d) {
        u[d][0] = fmaf(w.x, from[d][i], u[d][0]);
        u[d][1] = fmaf(w.y, from[d][i], u[d][1]);
        u[d][2] = fmaf(w.z, from[d][i], u[d][2]);
        u[d][3] = fmaf(w.w, from[d][i], u[d][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float4 w = *reinterpret_cast<const float4*>(w0 + (E + i) * H + k);
#pragma unroll
      for (int d = 0; d < SP; ++d) {
        u[d][0] = fmaf(w.x, to[i], u[d][0]);
        u[d][1] = fmaf(w.y, to[i], u[d][1]);
        u[d][2] = fmaf(w.z, to[i], u[d][2]);
        u[d][3] = fmaf(w.w, to[i], u[d][3]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float r[SP];
#pragma unroll
      for (int d = 0; d < SP; ++d) r[d] = fmaxf(u[d][q], 0.f);
      const float4* w = reinterpret_cast<const float4*>(w1 + (k + q) * M);
#pragma unroll
      for (int j = 0; j < M / 4; ++j) {
        const float4 c = w[j];
#pragma unroll
        for (int d = 0; d < SP; ++d) {
          part[d][4 * j] = fmaf(r[d], c.x, part[d][4 * j]);
          part[d][4 * j + 1] = fmaf(r[d], c.y, part[d][4 * j + 1]);
          part[d][4 * j + 2] = fmaf(r[d], c.z, part[d][4 * j + 2]);
          part[d][4 * j + 3] = fmaf(r[d], c.w, part[d][4 * j + 3]);
        }
      }
    }
  }
}

// y = V1^T relu(V0^T x), the hidden layer in chunks of 4 units fed straight
// into the output layer.
template <int IN, int H, int OUT>
__device__ __forceinline__ void embed_mlp(const float* __restrict__ v0, const float* __restrict__ v1,
                                          const float (&x)[IN], float (&y)[OUT]) {
#pragma unroll
  for (int j = 0; j < OUT; ++j) y[j] = 0.f;
#pragma unroll 1
  for (int k = 0; k < H; k += 4) {
    float z0 = 0.f, z1 = 0.f, z2 = 0.f, z3 = 0.f;
#pragma unroll
    for (int i = 0; i < IN; ++i) {
      const float4 w = *reinterpret_cast<const float4*>(v0 + i * H + k);
      z0 = fmaf(w.x, x[i], z0);
      z1 = fmaf(w.y, x[i], z1);
      z2 = fmaf(w.z, x[i], z2);
      z3 = fmaf(w.w, x[i], z3);
    }
    const float r[4] = {fmaxf(z0, 0.f), fmaxf(z1, 0.f), fmaxf(z2, 0.f), fmaxf(z3, 0.f)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4* w = reinterpret_cast<const float4*>(v1 + (k + q) * OUT);
#pragma unroll
      for (int j = 0; j < OUT / 4; ++j) {
        const float4 c = w[j];
        y[4 * j] = fmaf(r[q], c.x, y[4 * j]);
        y[4 * j + 1] = fmaf(r[q], c.y, y[4 * j + 1]);
        y[4 * j + 2] = fmaf(r[q], c.z, y[4 * j + 2]);
        y[4 * j + 3] = fmaf(r[q], c.w, y[4 * j + 3]);
      }
    }
  }
}

// Both sides' CN updates: item (node, tile) with the nodes of side x, then
// those of side z.  h_vn [E, n_pad, B].  The slot sum runs in this thread's
// column of `keep` in shared memory, in slot order, so that no sum is held
// in registers while a pass's embeddings are.
template <int E, int M, int H, int DC, int SP>
__global__ void __launch_bounds__(BP4_THREADS, min_blocks(SP))
    gnn_bp4_cn_kernel(const float* __restrict__ h_vn, int n_pad, CnSide sx, CnSide sz,
                      const float* __restrict__ packed, int batch, int mean) {
  using W = Widths<E, M, H>;
  __shared__ __align__(16) float w[W::CN_TOTAL];
  __shared__ float keep_tile[M * BP4_THREADS];
  float* keep = keep_tile + threadIdx.x;
  copy_weights<W::CN_TOTAL>(packed, w);
  const int nodes = sx.c_pad + sz.c_pad;
  const int64_t items = static_cast<int64_t>(nodes) * ((batch + BP4_THREADS - 1) / BP4_THREADS);
  const int64_t vplane = static_cast<int64_t>(n_pad) * batch;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int node = static_cast<int>(item % nodes);
    const int b = static_cast<int>(item / nodes) * BP4_THREADS + threadIdx.x;
    const int bl = min(b, batch - 1);  // the ragged tile's idle lanes read a valid sample
    const bool z = node >= sx.c_pad;
    const int c = z ? node - sx.c_pad : node;
    const int c_pad = z ? sz.c_pad : sx.c_pad;
    const int dc = z ? sz.dc : sx.dc;
    const float* __restrict__ h_cn = z ? sz.h_cn : sx.h_cn;
    const int64_t* __restrict__ vn = z ? sz.vn : sx.vn;
    const float* __restrict__ mask = z ? sz.mask : sx.mask;
    const float* ws = w + (z ? W::CN_SIDE : 0);
    const int64_t cplane = static_cast<int64_t>(c_pad) * batch;
    const int64_t at = static_cast<int64_t>(c) * batch + bl;

    float to[E];
#pragma unroll
    for (int i = 0; i < E; ++i) to[i] = h_cn[i * cplane + at];
#pragma unroll
    for (int j = 0; j < M; ++j) keep[j * BP4_THREADS] = 0.f;
#pragma unroll 1
    for (int p = 0; p < DC; p += SP) {
      float from[SP][E], part[SP][M], scale[SP];
      bool any = false;
#pragma unroll
      for (int d = 0; d < SP; ++d) {
        const int slot = p + d;
        scale[d] = slot < DC && slot < dc ? mask[slot * c_pad + c] : 0.f;
        any |= scale[d] != 0.f;
        const int64_t v = scale[d] != 0.f ? vn[slot * c_pad + c] : 0;
#pragma unroll
        for (int i = 0; i < E; ++i) from[d][i] = scale[d] != 0.f ? h_vn[i * vplane + v * batch + bl] : 0.f;
      }
      if (!any) continue;
      message_pass<E, M, H, SP>(ws, ws + 2 * E * H, from, to, part);
#pragma unroll
      for (int d = 0; d < SP; ++d) {
        if (scale[d] != 0.f) {
#pragma unroll
          for (int j = 0; j < M; ++j) keep[j * BP4_THREADS] = fmaf(part[d][j], scale[d], keep[j * BP4_THREADS]);
        }
      }
    }

    float x[W::CN_IN], y[E];
    const float deg = fmaxf((z ? sz.deg : sx.deg)[c], 1.f);
#pragma unroll
    for (int j = 0; j < M; ++j) x[j] = mean ? keep[j * BP4_THREADS] / deg : keep[j * BP4_THREADS];
#pragma unroll
    for (int i = 0; i < E; ++i) x[M + i] = to[i];
    x[M + E] = (z ? sz.logit : sx.logit)[at];
    embed_mlp<W::CN_IN, H, E>(ws + W::MSG, ws + W::MSG + W::CN_IN * H, x, y);
    if (b < batch) {
      float* __restrict__ out = z ? sz.out : sx.out;
#pragma unroll
      for (int j = 0; j < E; ++j) out[j * cplane + at] = y[j];
    }
  }
}

// The VN update: item (VN, tile).  h_vn and out [E, n_pad, B].  Each side's
// slots in one pass (DV <= SP), both sides through one copy of the code;
// side x's reduced messages wait in this thread's column of `keep` in
// shared memory while side z's pass runs.
template <int E, int M, int H, int DV, int SP>
__global__ void __launch_bounds__(BP4_THREADS, min_blocks(SP))
    gnn_bp4_vn_kernel(const float* __restrict__ h_vn, int n_pad, float* __restrict__ out, VnSide sx, VnSide sz,
                      const float* __restrict__ packed, int batch, int mean) {
  static_assert(DV <= SP, "a VN update takes each side's slots in one pass");
  using W = Widths<E, M, H>;
  __shared__ __align__(16) float w[W::VN_TOTAL];
  __shared__ float keep_tile[M * BP4_THREADS];
  float* keep = keep_tile + threadIdx.x;
  copy_weights<W::VN_TOTAL>(packed, w);
  const int64_t items = static_cast<int64_t>(n_pad) * ((batch + BP4_THREADS - 1) / BP4_THREADS);
  const int64_t vplane = static_cast<int64_t>(n_pad) * batch;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int v = static_cast<int>(item % n_pad);
    const int b = static_cast<int>(item / n_pad) * BP4_THREADS + threadIdx.x;
    const int bl = min(b, batch - 1);
    const int64_t at = static_cast<int64_t>(v) * batch + bl;

    float to[E];
#pragma unroll
    for (int i = 0; i < E; ++i) to[i] = h_vn[i * vplane + at];
    float red[M];
#pragma unroll 1
    for (int z = 0; z < 2; ++z) {
      const int dv = z ? sz.dv : sx.dv;
      const float* __restrict__ h_cn = z ? sz.h_cn : sx.h_cn;
      const float* __restrict__ sign = z ? sz.sign : sx.sign;
      const int64_t* __restrict__ cn = z ? sz.cn : sx.cn;
      const float* __restrict__ mask = z ? sz.mask : sx.mask;
      const int64_t cplane = static_cast<int64_t>(z ? sz.c_pad : sx.c_pad) * batch;
      float from[SP][E], part[SP][M];
      bool any = false;
#pragma unroll
      for (int d = 0; d < SP; ++d) {
        const bool on = d < DV && d < dv && mask[d * n_pad + v] != 0.f;
        any |= on;
        const int64_t cat = (on ? cn[d * n_pad + v] : 0) * batch + bl;
#pragma unroll
        for (int i = 0; i < E; ++i) from[d][i] = on ? h_cn[i * cplane + cat] : 0.f;
      }
      if (any) message_pass<E, M, H, SP>(w + (z ? W::MSG : 0), w + (z ? W::MSG : 0) + 2 * E * H, from, to, part);
#pragma unroll
      for (int j = 0; j < M; ++j) red[j] = 0.f;
      if (any) {
#pragma unroll
        for (int d = 0; d < SP; ++d) {
          // the mask and sign read again here: nothing but the pass's own arrays lives through it
          const float mk = d < DV && d < dv ? mask[d * n_pad + v] : 0.f;
          if (mk != 0.f) {
            const float scale = mk * sign[cn[d * n_pad + v] * batch + bl];
#pragma unroll
            for (int j = 0; j < M; ++j) red[j] = fmaf(part[d][j], scale, red[j]);
          }
        }
      }
      const float deg = fmaxf((z ? sz.deg : sx.deg)[v], 1.f);
#pragma unroll
      for (int j = 0; j < M; ++j) red[j] = mean ? red[j] / deg : red[j];
      if (!z) {
#pragma unroll
        for (int j = 0; j < M; ++j) keep[j * BP4_THREADS] = red[j];
      }
    }
    float x[W::VN_IN], y[E];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      x[j] = keep[j * BP4_THREADS];
      x[M + j] = red[j];
    }
#pragma unroll
    for (int i = 0; i < E; ++i) x[2 * M + i] = to[i];
    embed_mlp<W::VN_IN, H, E>(w + 2 * W::MSG, w + 2 * W::MSG + W::VN_IN * H, x, y);
    if (b < batch) {
#pragma unroll
      for (int j = 0; j < E; ++j) out[j * vplane + at] = y[j];
    }
  }
}

// The grid of resident blocks (every SM full), no larger than the items.
int resident_grid(const void* kernel, int64_t items, int* grid) {
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, BP4_THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t full = static_cast<int64_t>(sms) * (blocks > 0 ? blocks : 1);
  *grid = static_cast<int>(items < full ? items : full);
  return 0;
}

template <int E, int M, int H, int DC, int SP>
struct CnInstance {
  static const void* kernel() { return reinterpret_cast<const void*>(gnn_bp4_cn_kernel<E, M, H, DC, SP>); }
  static int launch(const float* h_vn, int n_pad, const CnSide& sx, const CnSide& sz, const float* packed,
                    int batch, int mean, cudaStream_t stream) {
    int grid = 0;
    const int64_t items =
        static_cast<int64_t>(sx.c_pad + sz.c_pad) * ((batch + BP4_THREADS - 1) / BP4_THREADS);
    const int err = resident_grid(kernel(), items, &grid);
    if (err != 0) return err;
    gnn_bp4_cn_kernel<E, M, H, DC, SP><<<grid, BP4_THREADS, 0, stream>>>(h_vn, n_pad, sx, sz, packed, batch,
                                                                             mean);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int E, int M, int H, int DV, int SP>
struct VnInstance {
  static const void* kernel() {
    return reinterpret_cast<const void*>(gnn_bp4_vn_kernel<E, M, H, DV, SP>);
  }
  static int launch(const float* h_vn, int n_pad, float* out, const VnSide& sx, const VnSide& sz,
                    const float* packed, int batch, int mean, cudaStream_t stream) {
    int grid = 0;
    const int64_t items = static_cast<int64_t>(n_pad) * ((batch + BP4_THREADS - 1) / BP4_THREADS);
    const int err = resident_grid(kernel(), items, &grid);
    if (err != 0) return err;
    gnn_bp4_vn_kernel<E, M, H, DV, SP><<<grid, BP4_THREADS, 0, stream>>>(h_vn, n_pad, out, sx, sz,
                                                                                  packed, batch, mean);
    return static_cast<int>(cudaGetLastError());
  }
};

// The instances: (E, M, H, slots, SP), the slots the largest node degree the
// instance takes (CN slots for a CN update, VN slots a side for a VN update)
// and SP the slots a pass of the message MLP holds in registers.
// decoders/gnn_full.py's KERNEL_WIDTHS and KERNEL_SLOTS pick them, and
// tests/test_torch_gnn_bp4_kernel.py reads these lists.
#define BP4_CN_INSTANCES(X) X(20, 20, 40, 6, 2) X(20, 20, 40, 8, 4)
#define BP4_VN_INSTANCES(X) X(20, 20, 40, 3, 3) X(20, 20, 40, 4, 4)

#define BP4_MATCH(E, M, H, S, P) e == E && m == M && h == H && slots == S && sp == P

bool cn_instance(int e, int m, int h, int slots, int sp, const void** kernel,
                 int (**launch)(const float*, int, const CnSide&, const CnSide&, const float*, int, int,
                                cudaStream_t)) {
#define BP4_CN_CASE(E, M, H, S, P)                        \
  if (BP4_MATCH(E, M, H, S, P)) {                         \
    *kernel = CnInstance<E, M, H, S, P>::kernel();        \
    *launch = CnInstance<E, M, H, S, P>::launch;          \
    return true;                                          \
  }
  BP4_CN_INSTANCES(BP4_CN_CASE)
#undef BP4_CN_CASE
  return false;
}

bool vn_instance(int e, int m, int h, int slots, int sp, const void** kernel,
                 int (**launch)(const float*, int, float*, const VnSide&, const VnSide&, const float*, int, int,
                                cudaStream_t)) {
#define BP4_VN_CASE(E, M, H, S, P)                        \
  if (BP4_MATCH(E, M, H, S, P)) {                         \
    *kernel = VnInstance<E, M, H, S, P>::kernel();        \
    *launch = VnInstance<E, M, H, S, P>::launch;          \
    return true;                                          \
  }
  BP4_VN_INSTANCES(BP4_VN_CASE)
#undef BP4_VN_CASE
  return false;
}

}  // namespace

// Both sides' CN updates in one launch on `stream`: out_s [e, c_pad_s, B]
// from h_vn [e, n_pad, B], h_cn_s [e, c_pad_s, B] and logit_s [c_pad_s, B];
// vn_s, mask_s [dc_s, c_pad_s] and deg_s [c_pad_s] the graph's CN-slot
// tables; packed the weights in Widths' CN order; mean 1 divides the slot
// sums by max(deg, 1), 0 keeps them.  Returns a CUDA error code (0 = ok), -2
// for an instance that does not exist or a degree above its slots.
extern "C" int fgt_gnn_bp4_cn_launch(
    const float* h_vn, int n_pad,
    const float* h_cn_x, const float* logit_x, float* out_x, const int64_t* vn_x, const float* mask_x,
    const float* deg_x, int c_pad_x, int dc_x,
    const float* h_cn_z, const float* logit_z, float* out_z, const int64_t* vn_z, const float* mask_z,
    const float* deg_z, int c_pad_z, int dc_z,
    const float* packed, int batch, int mean, int e, int m, int h, int slots, int sp, void* stream) {
  const void* kernel = nullptr;
  int (*launch)(const float*, int, const CnSide&, const CnSide&, const float*, int, int, cudaStream_t) = nullptr;
  if (!cn_instance(e, m, h, slots, sp, &kernel, &launch) || dc_x > slots || dc_z > slots) return -2;
  const CnSide sx{h_cn_x, logit_x, out_x, vn_x, mask_x, deg_x, c_pad_x, dc_x};
  const CnSide sz{h_cn_z, logit_z, out_z, vn_z, mask_z, deg_z, c_pad_z, dc_z};
  return launch(h_vn, n_pad, sx, sz, packed, batch, mean, static_cast<cudaStream_t>(stream));
}

// The VN update on `stream`: out [e, n_pad, B] from h_vn [e, n_pad, B] and
// each side's h_cn_s [e, c_pad_s, B] and syndrome signs sign_s [c_pad_s, B];
// cn_s, mask_s [dv_s, n_pad] and deg_s [n_pad] the graph's VN-slot tables;
// packed the weights in Widths' VN order; mean as above.  Returns a CUDA
// error code (0 = ok), -2 for an instance that does not exist or a degree
// above its slots.
extern "C" int fgt_gnn_bp4_vn_launch(
    const float* h_vn, int n_pad, float* out,
    const float* h_cn_x, const float* sign_x, const int64_t* cn_x, const float* mask_x, const float* deg_x,
    int c_pad_x, int dv_x,
    const float* h_cn_z, const float* sign_z, const int64_t* cn_z, const float* mask_z, const float* deg_z,
    int c_pad_z, int dv_z,
    const float* packed, int batch, int mean, int e, int m, int h, int slots, int sp, void* stream) {
  const void* kernel = nullptr;
  int (*launch)(const float*, int, float*, const VnSide&, const VnSide&, const float*, int, int,
                cudaStream_t) = nullptr;
  if (!vn_instance(e, m, h, slots, sp, &kernel, &launch) || dv_x > slots || dv_z > slots) return -2;
  const VnSide sx{h_cn_x, sign_x, cn_x, mask_x, deg_x, c_pad_x, dv_x};
  const VnSide sz{h_cn_z, sign_z, cn_z, mask_z, deg_z, c_pad_z, dv_z};
  return launch(h_vn, n_pad, out, sx, sz, packed, batch, mean, static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM, registers per thread and local (spill) bytes per
// thread of an instance (update 0: CN, 1: VN), into out[0..2].  Returns a
// CUDA error code (0 = ok), -2 for an instance that does not exist.
extern "C" int fgt_gnn_bp4_occupancy(int update, int e, int m, int h, int slots, int sp, int* out) {
  const void* kernel = nullptr;
  int (*cn)(const float*, int, const CnSide&, const CnSide&, const float*, int, int, cudaStream_t) = nullptr;
  int (*vn)(const float*, int, float*, const VnSide&, const VnSide&, const float*, int, int, cudaStream_t) =
      nullptr;
  if (update == 0 ? !cn_instance(e, m, h, slots, sp, &kernel, &cn) : !vn_instance(e, m, h, slots, sp, &kernel, &vn)) {
    return -2;
  }
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, BP4_THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
