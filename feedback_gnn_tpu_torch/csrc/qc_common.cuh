// Device code shared by the fused quasi-cyclic BP kernels (bp4_qc.cu, K1;
// bp2_qc.cu, K2): the clip constants, phi in its three formulations, the
// per-node slot tables, the per-sample barrier, and the extrinsic CN update
// of one check node, done in place on the CN-frame message planes in
// shared memory.
//
// Everything a decode does not change is a template argument: the CN rule,
// the phi form, the degree pair (DC, DV) and, for K1, the message carry
// (MSG_F32, or MSG_BF16: each CN output rounded to bfloat16, nearest even,
// where it is stored).  A degree of 0 is the generic
// instance: node degrees up to MAX_DEG, read from the slot table, where an
// unused entry holds NO_SLOT.
//
// Numerics are those of the JAX kernels (feedback_gnn_tpu/decoders/
// bp4_qc.py, _cn_update and _phi): products and sums in cn_groups order,
// sign(0) = +1, softplus without threshold, phi clipped to
// [8.5e-8, 16.635532] on input and output, accurate libm functions only.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float PHI_CLIP_MIN = 8.5e-8f;
constexpr float PHI_CLIP_MAX = 16.635532f;
constexpr float ATANH_CLIP = 0.9999999f;  // 1 - 1e-7 rounded to float
constexpr float LLR_MAX = 20.0f;
constexpr float LARGE_VAL = 10000.0f;
// float32 tanh is exactly +-1 from |x| = TANH_SAT on, as XLA's and TF's
// are; the same constant as cn_update.TANH_SAT on the Python side
constexpr float TANH_SAT = 7.90531110763549805f;
constexpr int MAX_DEG = 8;  // the generic instance's largest node degree
constexpr unsigned NO_SLOT = 0xFFFFu;  // an unused entry of a slot-table row

enum { CN_PHI = 0, CN_TANH = 1, CN_MINSUM = 2 };
enum { PHI_TANH = 0, PHI_TF = 1, PHI_ACCURATE = 2 };
enum { MSG_F32 = 0, MSG_BF16 = 1 };

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// One row of a slot table: W uint16 message slots (W a multiple of 4),
// read from shared memory in 8- or 16-byte words.
template <int W>
struct Row {
  static_assert(W % 4 == 0, "slot-table rows are 8-byte multiples");
  uint32_t w[W / 2];
  __device__ __forceinline__ explicit Row(const uint16_t* p) {
    if constexpr (W % 8 == 0) {
#pragma unroll
      for (int i = 0; i < W / 8; ++i) {
        const uint4 u = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = u.x;
        w[4 * i + 1] = u.y;
        w[4 * i + 2] = u.z;
        w[4 * i + 3] = u.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < W / 4; ++i) {
        const uint2 u = reinterpret_cast<const uint2*>(p)[i];
        w[2 * i] = u.x;
        w[2 * i + 1] = u.y;
      }
    }
  }
  __device__ __forceinline__ unsigned operator[](int k) const {
    return (k & 1) ? (w[k >> 1] >> 16) : (w[k >> 1] & 0xFFFFu);
  }
  // entries before the first NO_SLOT in [k0, k0 + n): a node's degree
  __device__ __forceinline__ int degree(int k0, int n) const {
    int d = 0;
#pragma unroll
    for (int k = 0; k < n; ++k) d += ((*this)[k0 + k] != NO_SLOT) ? 1 : 0;
    return d;
  }
};

// The threads of one sample (whole warps) wait for each other, and for
// nobody else: named barrier 1 + sample (the launch plan keeps samples per
// block at 15 or fewer; barrier 0 is __syncthreads).
__device__ __forceinline__ void sample_sync(int sample, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(sample + 1), "r"(threads) : "memory");
}

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float softplusf(float x) {
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.0f);
}

template <int PHI>
__device__ __forceinline__ float phif(float x) {
  x = clipf(x, PHI_CLIP_MIN, PHI_CLIP_MAX);
  float out;
  if constexpr (PHI == PHI_TF) {
    out = softplusf(x) - logf(expf(x) - 1.0f);
  } else if constexpr (PHI == PHI_ACCURATE) {
    const float e = expf(-x);
    out = log1pf(e) - log1pf(-e);
  } else {
    out = -logf(tanhf(x * 0.5f));
  }
  return clipf(out, PHI_CLIP_MIN, PHI_CLIP_MAX);
}

__device__ __forceinline__ float sign_no_zero(float x) { return x < 0.0f ? -1.0f : 1.0f; }

// A CN output as the message carry stores it in its float32 slot: as is,
// or rounded to bfloat16 (nearest even, as torch's and XLA's casts) and
// widened back exactly.
template <int MSG>
__device__ __forceinline__ float carry(float x) {
  if constexpr (MSG == MSG_BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// One CN: read the slots of its table row, apply the CN rule with the
// syndrome sign syn (+-1), write the scaled extrinsics back in place, each
// through the message carry MSG.
// DC > 0: every CN has degree DC; DC == 0: the row's degree, up to MAX_DEG.
template <int CN, int PHI, int DC, int MSG = MSG_F32, int W>
__device__ __forceinline__ void cn_node(float* msg, const Row<W>& row, float syn, float factor) {
  constexpr int K = DC ? DC : MAX_DEG;
  const int deg = DC ? DC : row.degree(0, MAX_DEG);
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < deg) v[k] = msg[row[k]];
  }
  if constexpr (CN == CN_PHI) {
    float sgn[K], p[K];
    float sprod = 1.0f, psum = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < deg) {
        sgn[k] = sign_no_zero(v[k]);
        p[k] = phif<PHI>(fabsf(v[k]));
        sprod = (k == 0) ? sgn[k] : sprod * sgn[k];
        psum = (k == 0) ? p[k] : psum + p[k];
      }
    }
    sprod = sprod * syn;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < deg) msg[row[k]] = carry<MSG>(sgn[k] * sprod * phif<PHI>(psum - p[k]) * factor);
    }
  } else if constexpr (CN == CN_TANH) {
    float t[K];
    float tprod = 1.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < deg) {
        const float h = v[k] * 0.5f;
        t[k] = fabsf(h) >= TANH_SAT ? copysignf(1.0f, h) : tanhf(h);
        if (t[k] == 0.0f) t[k] = 1e-12f;
        tprod = (k == 0) ? t[k] : tprod * t[k];
      }
    }
    tprod = tprod * syn;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < deg) {
        float o = tprod / t[k];
        if (fabsf(o) < 1e-7f) o = 0.0f;
        o = clipf(o, -ATANH_CLIP, ATANH_CLIP);
        msg[row[k]] = carry<MSG>(2.0f * atanhf(o) * factor);
      }
    }
  } else {  // CN_MINSUM
    float sgn[K], a[K];
    float sprod = 1.0f, min1 = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
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
    for (int k = 0; k < K; ++k) {
      if (k < deg) {
        const bool is_min = a[k] == min1;
        const float masked = is_min ? LARGE_VAL : a[k];
        min2 = (k == 0) ? masked : fminf(min2, masked);
        nmin += is_min ? 1 : 0;
      }
    }
    const float min_e = nmin >= 2 ? min1 : min2;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < deg) msg[row[k]] = carry<MSG>(sgn[k] * sprod * (a[k] == min1 ? min_e : min1) * factor);
    }
  }
}

// Occupancy of one kernel instance on this card: resident blocks per SM at
// `threads` threads and `smem` bytes of dynamic shared memory, its
// registers per thread and its local (spill) bytes per thread.
template <typename Kernel>
int occupancy_of(Kernel kernel, int threads, int smem, int* out) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace
