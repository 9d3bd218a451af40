// Device code shared by the fused quasi-cyclic BP kernels (bp4_qc.cu, K1;
// bp2_qc.cu, K2): the clip constants, phi in its three formulations, the
// index-table layout of one parity-check matrix's circulant edge groups,
// and the extrinsic CN update of one check node, done in place on the
// CN-frame message planes in shared memory.
//
// Numerics are those of the JAX kernels (feedback_gnn_tpu/decoders/
// bp4_qc.py, _cn_update and _phi): products and sums in cn_groups order,
// sign(0) = +1, softplus without threshold, phi clipped to
// [8.5e-8, 16.635532] on input and output.

#pragma once

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
        const float h = v[k] * 0.5f;
        t[k] = fabsf(h) >= TANH_SAT ? copysignf(1.0f, h) : tanhf(h);
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

}  // namespace
