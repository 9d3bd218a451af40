// Bit-packed GF(2) linear algebra on the host: the port's native core.
//
// Word-parallel (uint64) Gaussian elimination for the GF(2) helpers of
// feedback_gnn_tpu_torch/codes/gf2.py (row_echelon and, through it, rank,
// kernel, row_basis and inverse): about 64x fewer inner operations than
// the vectorised NumPy path and no Python overhead.  Used at
// code-construction time only; the same contract as the NumPy path (the
// same pivot and swap choices, the same outputs).
//
// Built at first use by feedback_gnn_tpu_torch/native/__init__.py:
// g++ -O3 -shared -fPIC gf2_native.cpp, into feedback_gnn_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Packed {
  int rows, cols, words;
  std::vector<uint64_t> w;  // rows * words

  Packed(int r, int c) : rows(r), cols(c), words((c + 63) / 64), w((size_t)r * words, 0) {}

  inline uint64_t* row(int r) { return w.data() + (size_t)r * words; }
  inline bool get(int r, int c) const {
    return (w[(size_t)r * words + (c >> 6)] >> (c & 63)) & 1u;
  }
  inline void set(int r, int c) { w[(size_t)r * words + (c >> 6)] |= 1ull << (c & 63); }

  void from_u8(const uint8_t* m) {
    for (int r = 0; r < rows; ++r)
      for (int c = 0; c < cols; ++c)
        if (m[(size_t)r * cols + c] & 1) set(r, c);
  }
  void to_u8(uint8_t* m) const {
    for (int r = 0; r < rows; ++r)
      for (int c = 0; c < cols; ++c)
        m[(size_t)r * cols + c] = get(r, c);
  }
  inline void xor_rows(int dst, int src) {
    uint64_t* d = row(dst);
    const uint64_t* s = w.data() + (size_t)src * words;
    for (int k = 0; k < words; ++k) d[k] ^= s[k];
  }
  inline void swap_rows(int a, int b) {
    if (a == b) return;
    uint64_t* pa = row(a);
    uint64_t* pb = row(b);
    for (int k = 0; k < words; ++k) {
      uint64_t t = pa[k];
      pa[k] = pb[k];
      pb[k] = t;
    }
  }
};

}  // namespace

extern "C" {

// Gaussian elimination over GF(2) with transform tracking.
//
//   mat       : [m*n] uint8 in/out -> row echelon form
//   transform : [m*m] uint8 out    -> transform @ mat_in % 2 == mat_out
//   pivots    : [<=n] int32 out    -> pivot column indices
//   reduced   : also eliminate above the pivots (RREF)
//
// Returns the rank.  Identical pivot/swap choices to codes/gf2.py's
// NumPy row_echelon: the FIRST row at or below pivot_row holding a 1 is swapped
// up, all other rows holding a 1 in the pivot column are XORed at once.
int gf2_row_echelon(uint8_t* mat, int m, int n, uint8_t* transform, int reduced,
                    int32_t* pivots) {
  Packed a(m, n);
  a.from_u8(mat);
  Packed t(m, m);
  for (int r = 0; r < m; ++r) t.set(r, r);

  int pivot_row = 0;
  int npiv = 0;
  for (int col = 0; col < n && pivot_row < m; ++col) {
    if (!a.get(pivot_row, col)) {
      int swap = -1;
      for (int r = pivot_row + 1; r < m; ++r)
        if (a.get(r, col)) {
          swap = r;
          break;
        }
      if (swap >= 0) {
        a.swap_rows(swap, pivot_row);
        t.swap_rows(swap, pivot_row);
      }
    }
    if (a.get(pivot_row, col)) {
      int lo = reduced ? 0 : pivot_row + 1;
      for (int r = lo; r < m; ++r) {
        if (r == pivot_row) continue;
        if (a.get(r, col)) {
          a.xor_rows(r, pivot_row);
          t.xor_rows(r, pivot_row);
        }
      }
      pivots[npiv++] = col;
      ++pivot_row;
    }
  }
  a.to_u8(mat);
  t.to_u8(transform);
  return pivot_row;
}

// (h @ v) % 2 for a [m,n] 0/1 matrix and [n,b] 0/1 vectors, bit-packed over
// n.  A host-side helper for tests and tools (syndromes on the card go
// through ops/gf2mat.py).
void gf2_matmul(const uint8_t* h, const uint8_t* v, uint8_t* out, int m, int n, int b) {
  Packed hp(m, n);
  hp.from_u8(h);
  // pack v column-wise: vp[j] holds column j of v as a bit row over n
  Packed vp(b, n);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < b; ++j)
      if (v[(size_t)i * b + j] & 1) vp.set(j, i);
  for (int r = 0; r < m; ++r) {
    const uint64_t* hr = hp.w.data() + (size_t)r * hp.words;
    for (int j = 0; j < b; ++j) {
      const uint64_t* vj = vp.w.data() + (size_t)j * vp.words;
      uint64_t acc = 0;
      for (int k = 0; k < hp.words; ++k) acc ^= hr[k] & vj[k];
      out[(size_t)r * b + j] = (uint8_t)(__builtin_popcountll(acc) & 1);
    }
  }
}

}  // extern "C"
