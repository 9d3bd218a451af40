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
// Built with plain nvcc into a shared library with a C interface and loaded
// with ctypes (feedback_gnn_tpu_torch/_build.py); no PyTorch headers.

#include <cuda_runtime.h>

namespace {

constexpr float PHI_CLIP_MIN = 8.5e-8f;
constexpr float PHI_CLIP_MAX = 16.635532f;
constexpr float ATANH_CLIP = 0.9999999f;  // 1 - 1e-7 rounded to float
constexpr float LLR_MAX = 20.0f;
constexpr float LARGE_VAL = 10000.0f;
constexpr int MAX_DEG = 8;  // the wrapper rejects codes with larger degrees

enum { CN_PHI = 0, CN_TANH = 1, CN_MINSUM = 2 };
enum { PHI_TANH = 0, PHI_TF = 1, PHI_ACCURATE = 2 };

// Index tables of one side (Hx or Hz), laid out back to back in one int
// array: shift[G], cn_tab[mb*dc], cn_deg[mb], vn_tab[nb*dv], vn_deg[nb].
struct Side {
  const int* shift;
  const int* cn_tab;
  const int* cn_deg;
  const int* vn_tab;
  const int* vn_deg;
  int mb, g, dc, dv;
};

struct Dims {
  int l, nb, mbx, mbz, gx, gz, dcx, dcz, dvx, dvz;
};

__device__ __forceinline__ Side side_at(const int* t, int nb, int mb, int g, int dc, int dv) {
  Side s;
  s.shift = t;
  s.cn_tab = s.shift + g;
  s.cn_deg = s.cn_tab + mb * dc;
  s.vn_tab = s.cn_deg + mb;
  s.vn_deg = s.vn_tab + nb * dv;
  s.mb = mb;
  s.g = g;
  s.dc = dc;
  s.dv = dv;
  return s;
}

__device__ __forceinline__ int side_len(int nb, int mb, int g, int dc, int dv) {
  return g + mb * dc + mb + nb * dv + nb;
}

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float softplusf(float x) {
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.0f);
}

// log(exp(-a) + exp(-b))
__device__ __forceinline__ float lse_neg(float a, float b) {
  return -fminf(a, b) + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ float phif(float x, int impl) {
  x = clipf(x, PHI_CLIP_MIN, PHI_CLIP_MAX);
  float out;
  if (impl == PHI_TF) {
    out = softplusf(x) - logf(expf(x) - 1.0f);
  } else if (impl == PHI_ACCURATE) {
    const float e = expf(-x);
    out = log1pf(e) - log1pf(-e);
  } else {
    out = -logf(tanhf(x * 0.5f));
  }
  return clipf(out, PHI_CLIP_MIN, PHI_CLIP_MAX);
}

__device__ __forceinline__ float sign_no_zero(float x) { return x < 0.0f ? -1.0f : 1.0f; }

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

// One CN (block row i, row r) of one side: read its slots, apply the CN
// rule, write the scaled extrinsics back in place.
__device__ void cn_node(float* msg, const Side& s, int l, int i, int r, float syn, int cn_type,
                        int phi_impl, float factor) {
  const int deg = s.cn_deg[i];
  int slot[MAX_DEG];
  float v[MAX_DEG];
#pragma unroll
  for (int k = 0; k < MAX_DEG; ++k) {
    if (k < deg) {
      slot[k] = s.cn_tab[i * s.dc + k] * l + r;
      v[k] = msg[slot[k]];
    }
  }
  if (cn_type == CN_PHI) {
    float sgn[MAX_DEG], p[MAX_DEG];
    float sprod = 1.0f, psum = 0.0f;
#pragma unroll
    for (int k = 0; k < MAX_DEG; ++k) {
      if (k < deg) {
        sgn[k] = sign_no_zero(v[k]);
        p[k] = phif(fabsf(v[k]), phi_impl);
        sprod = (k == 0) ? sgn[k] : sprod * sgn[k];
        psum = (k == 0) ? p[k] : psum + p[k];
      }
    }
    sprod = sprod * syn;
#pragma unroll
    for (int k = 0; k < MAX_DEG; ++k) {
      if (k < deg) msg[slot[k]] = sgn[k] * sprod * phif(psum - p[k], phi_impl) * factor;
    }
  } else if (cn_type == CN_TANH) {
    float t[MAX_DEG];
    float tprod = 1.0f;
#pragma unroll
    for (int k = 0; k < MAX_DEG; ++k) {
      if (k < deg) {
        t[k] = tanhf(v[k] * 0.5f);
        if (t[k] == 0.0f) t[k] = 1e-12f;
        tprod = (k == 0) ? t[k] : tprod * t[k];
      }
    }
    tprod = tprod * syn;
#pragma unroll
    for (int k = 0; k < MAX_DEG; ++k) {
      if (k < deg) {
        float o = tprod / t[k];
        if (fabsf(o) < 1e-7f) o = 0.0f;
        o = clipf(o, -ATANH_CLIP, ATANH_CLIP);
        msg[slot[k]] = 2.0f * atanhf(o) * factor;
      }
    }
  } else {  // CN_MINSUM
    float sgn[MAX_DEG], a[MAX_DEG];
    float sprod = 1.0f, min1 = 0.0f;
#pragma unroll
    for (int k = 0; k < MAX_DEG; ++k) {
      if (k < deg) {
        const float m = clipf(v[k], -LLR_MAX, LLR_MAX);
        sgn[k] = sign_no_zero(m);
        a[k] = fabsf(m);
        sprod = (k == 0) ? sgn[k] : sprod * sgn[k];
        min1 = (k == 0) ? a[k] : fminf(min1, a[k]);
      }
    }
    sprod = sprod * syn;
    float min2 = 0.0f;
    int nmin = 0;
#pragma unroll
    for (int k = 0; k < MAX_DEG; ++k) {
      if (k < deg) {
        const bool is_min = a[k] == min1;
        const float masked = is_min ? LARGE_VAL : a[k];
        min2 = (k == 0) ? masked : fminf(min2, masked);
        nmin += is_min ? 1 : 0;
      }
    }
    const float min_e = nmin >= 2 ? min1 : min2;
#pragma unroll
    for (int k = 0; k < MAX_DEG; ++k) {
      if (k < deg) msg[slot[k]] = sgn[k] * sprod * (a[k] == min1 ? min_e : min1) * factor;
    }
  }
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
