// SwinV2's window attention for Hopper (sm_90a): per window and head
//
//   o = softmax(q k^T + bias[h] + mask[w]) v
//
// with q, k, v [B, W, H, N, d] (any strides, rows of stride 1), the bias
// [H, N, N] shared by the batch and the windows, and the shift mask given as
// each window's region labels [W, N] (int32): -100 between tokens of two
// regions, 0 within one; a null label pointer for a block without a mask.
//
// Replaces no TPU kernel: the JAX package has no SwinV2.  It stands in for
// the library call the port made before, scaled_dot_product_attention's
// memory-efficient sm80 kernels, which read a [B, W x H, N, N] bias and
// wrote its gradient at that size in bf16 for a sum over the batch.
//
// Four kernels, FlashAttention-2's plan on mma.sync tiles of 16 rows a warp:
//   window_attn_fwd       one block per (b, w, h, query tile): the online
//                         softmax over key tiles of 64; o, and each row's
//                         log2-sum-exp in fp32
//   window_attn_bwd_dq    one block per query tile: delta = rowsum(dO o),
//                         stored for the two kernels after it, then dQ
//   window_attn_bwd_dkdv  one block per key tile: dK and dV over the query
//                         tiles, from the bias transposed [H, keys, queries]
//   window_attn_dbias     one block per (h, query tile, key tile): dS of
//                         every batch element and window, summed in fp32
//                         registers in a fixed order and written once
// The bias and the labels are read in their shared forms and added to the
// scores in fp32 registers; no [B, ..., N, N] tensor is read or written and
// no float atomic is used, so two runs give the same bits.
//
// What bounds it.  At head width 32 each score costs 2 x 32 multiply-adds
// in a pass against one exponential and some eight fp32 operations around
// it (bias, mask, row max, sum, casts), so on paper the exponent unit and
// the fp32 issue slots bound it before the tensor cores do.  The design
// keeps each score to one ex2.approx (log2(e) folded into one fused
// multiply-add with the row's max or log-sum-exp) and stages every tile a
// block meets (K, V or Q, dO, the bias block, the labels) in shared memory,
// double-buffered with cp.async and shared by the block's four warps.  On
// an H100 the arithmetic is not what the time follows: taking the
// exponentials, either product or the bias add out of the forward moves it
// by 1-10%; the tile copies, about 4 bytes a score at some 2.5 TB/s out of
// L2, and each block's latency do.  wgmma in place of mma.sync for the
// products with K^T and V^T (the same fragments, core-matrix tiles) gave
// the same results within rounding and 7% more time over a step's blocks,
// so the products stay on mma.sync.
//
// Types: fp16 and bf16 (mma.sync m16n8k16, fp32 sums) and fp32, whose
// products a warp computes in fp32 with shuffles in the same fragment
// layout (for correctness; no speed target).  The bias is in q's type.
// Head width 16 or 32; N a multiple of 8 (rows of the bias in 16-byte
// copies).
//
// Contract: every pointer 16-byte aligned, every row stride of q, k, v, o,
// dO a multiple of 16 bytes, outputs not aliasing inputs.  Launches on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK_VALUE = -100.0f;
constexpr int BN = 64;      // keys (or queries) of one inner-loop tile
constexpr int PAD = 8;      // row padding of a shared tile, in elements
constexpr int WARPS = 4;    // warps of a block, 16 rows each
constexpr int NT = WARPS * 32;
constexpr int ROWS = WARPS * 16;
constexpr int MIN_BLOCKS = 3;  // blocks an SM should hold: <= 168 registers

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;  // [H, N, N] (dkdv: transposed, [H, keys, queries])
  const int* lab;    // [W, N] or null
  const void* o;
  const void* dout;
  void* out0;  // o (fwd), dq, dk
  void* out1;  // dv
  float* lse;    // [B, W, H, N], log2 units
  float* delta;  // [B, W, H, N]
  float* dbias;  // [H, N, N]
  // element strides (batch, window, head, row)
  long long sq[4], sk[4], sv[4], so[4], sdo[4], s0[4], s1[4];
  int B, W, H, N;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---- cp.async ---------------------------------------------------------------

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// R rows [row0, row0 + R) of a [n, D] matrix of row stride `stride` into a
// shared [R, D + PAD] tile; rows past n are zeros.
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(T* s, const T* g, long long stride,
                                          int row0, int n) {
  constexpr int PER = 16 / sizeof(T);
  constexpr int C = D / PER;
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int r = i / C, c = i % C, row = row0 + r;
    const bool ok = row < n;
    cp16(s + r * (D + PAD) + c * PER, ok ? g + row * stride + c * PER : g, ok);
  }
}

// R 4-byte values [row0, row0 + R) of a vector of n (a multiple of 4) into
// shared memory; zeros past n.
template <int R, typename V>
__device__ __forceinline__ void load_vec(V* s, const V* g, int row0, int n) {
  static_assert(sizeof(V) == 4, "4-byte values");
  for (int i = threadIdx.x; i < R / 4; i += NT) {
    const bool ok = row0 + 4 * i < n;
    cp16(s + 4 * i, ok ? g + row0 + 4 * i : g, ok);
  }
}

// ---- fragments of mma m16n8k16 ----------------------------------------------
// lane = 4 g + t.  A (16 x 16, rows x k): (g, 2t..2t+1), (g+8, 2t..), (g, 8+2t..),
// (g+8, 8+2t..).  B (16 x 8, k x n): (k 2t..2t+1, n g), (k 8+2t.., n g).
// C (16 x 8): (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).

template <typename T>
struct FragA { uint32_t x[4]; };
template <>
struct FragA<float> { float x[8]; };
template <typename T>
struct FragB { uint32_t x[2]; };
template <>
struct FragB<float> { float x[4]; };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A at (r0, c0) of a row-major shared tile of leading dimension ld.
template <typename T>
__device__ __forceinline__ void load_a(FragA<T>& a, const T* s, int ld, int r0,
                                       int c0) {
  const int lane = threadIdx.x & 31;
  const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = c0 + (lane >> 4) * 8;
  ldsm4(a.x, s + row * ld + col);
}

template <>
__device__ __forceinline__ void load_a<float>(FragA<float>& a, const float* s,
                                              int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = s + (r0 + g) * ld + c0 + 2 * t;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* q = p + (i & 1) * 8 * ld + (i >> 1) * 8;
    a.x[2 * i] = q[0];
    a.x[2 * i + 1] = q[1];
  }
}

// The B fragments of n-blocks n0 and n0 + 8 at k0, from a shared tile held
// [n][k] (rows are n: K or V rows for products with K^T or V^T).
template <typename T>
__device__ __forceinline__ void load_b_nk(FragB<T>& b0, FragB<T>& b1,
                                          const T* s, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const int row = n0 + (lane & 7) + (lane >> 4) * 8;
  const int col = k0 + ((lane >> 3) & 1) * 8;
  uint32_t r[4];
  ldsm4(r, s + row * ld + col);
  b0.x[0] = r[0]; b0.x[1] = r[1]; b1.x[0] = r[2]; b1.x[1] = r[3];
}

template <>
__device__ __forceinline__ void load_b_nk<float>(FragB<float>& b0,
                                                 FragB<float>& b1,
                                                 const float* s, int ld,
                                                 int n0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = s + (n0 + g) * ld + k0 + 2 * t;
  b0.x[0] = p[0]; b0.x[1] = p[1]; b0.x[2] = p[8]; b0.x[3] = p[9];
  p += 8 * ld;
  b1.x[0] = p[0]; b1.x[1] = p[1]; b1.x[2] = p[8]; b1.x[3] = p[9];
}

// The same from a tile held [k][n] (rows are k: V or Q rows for products
// with P, dS).
template <typename T>
__device__ __forceinline__ void load_b_kn(FragB<T>& b0, FragB<T>& b1,
                                          const T* s, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = n0 + (lane >> 4) * 8;
  uint32_t r[4];
  ldsm4t(r, s + row * ld + col);
  b0.x[0] = r[0]; b0.x[1] = r[1]; b1.x[0] = r[2]; b1.x[1] = r[3];
}

template <>
__device__ __forceinline__ void load_b_kn<float>(FragB<float>& b0,
                                                 FragB<float>& b1,
                                                 const float* s, int ld,
                                                 int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = s + (k0 + 2 * t) * ld + n0 + g;
  b0.x[0] = p[0]; b0.x[1] = p[ld]; b0.x[2] = p[8 * ld]; b0.x[3] = p[9 * ld];
  p += 8;
  b1.x[0] = p[0]; b1.x[1] = p[ld]; b1.x[2] = p[8 * ld]; b1.x[3] = p[9 * ld];
}

__device__ __forceinline__ void mma(float* c, const FragA<__nv_bfloat16>& a,
                                    const FragB<__nv_bfloat16>& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]),
        "r"(b.x[1]));
}

__device__ __forceinline__ void mma(float* c, const FragA<__half>& a,
                                    const FragB<__half>& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]),
        "r"(b.x[1]));
}

// fp32: the same product in fp32 fused multiply-adds, k in order, each
// operand fetched from the lane that holds it.
__device__ __forceinline__ void mma(float* c, const FragA<float>& a,
                                    const FragB<float>& b) {
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int ea = (kk & 1) + (kk >= 8 ? 4 : 0);
    const int eb = (kk & 1) + (kk >= 8 ? 2 : 0);
    const int src_a = (lane & ~3) | ((kk & 7) >> 1);
    const int src_b = (2 * t) * 4 + ((kk & 7) >> 1);
    const float a0 = __shfl_sync(0xffffffffu, a.x[ea], src_a);
    const float a1 = __shfl_sync(0xffffffffu, a.x[ea + 2], src_a);
    const float b0 = __shfl_sync(0xffffffffu, b.x[eb], src_b);
    const float b1 = __shfl_sync(0xffffffffu, b.x[eb], src_b + 4);
    c[0] = fmaf(a0, b0, c[0]);
    c[1] = fmaf(a0, b1, c[1]);
    c[2] = fmaf(a1, b0, c[2]);
    c[3] = fmaf(a1, b1, c[3]);
  }
}

__device__ __forceinline__ uint32_t pack(float lo, float hi, __nv_bfloat16*) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi, __half*) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of the 16 columns held by two C fragments (P, dS).
template <typename T>
__device__ __forceinline__ void to_a(FragA<T>& a, const float* c0,
                                     const float* c1) {
  a.x[0] = pack(c0[0], c0[1], (T*)nullptr);
  a.x[1] = pack(c0[2], c0[3], (T*)nullptr);
  a.x[2] = pack(c1[0], c1[1], (T*)nullptr);
  a.x[3] = pack(c1[2], c1[3], (T*)nullptr);
}

template <>
__device__ __forceinline__ void to_a<float>(FragA<float>& a, const float* c0,
                                            const float* c1) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a.x[i] = c0[i];
    a.x[4 + i] = c1[i];
  }
}

// ---- two elements at a time in global memory --------------------------------

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack(a, b, (T*)nullptr);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- the scores of one tile -------------------------------------------------

// Two bias values as loaded: bf16 and fp16 pairs stay packed in one register
// until they are added.
template <typename T>
struct Pair { using type = uint32_t; };
template <>
struct Pair<float> { using type = float2; };

template <typename T>
__device__ __forceinline__ typename Pair<T>::type load_pair(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
template <>
__device__ __forceinline__ float2 load_pair<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 unpack(float2 v, float*) { return v; }
__device__ __forceinline__ float2 unpack(uint32_t u, __nv_bfloat16*) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float2 unpack(uint32_t u, __half*) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

// BN columns from c0 of R rows from row0 of a row-major [n, n] matrix g into
// a shared [R, BN + PAD] tile; zeros outside the matrix (n a multiple of 8).
template <typename T, int R>
__device__ __forceinline__ void load_block(T* s, const T* g, int row0, int c0,
                                           int n) {
  constexpr int PER = 16 / sizeof(T);
  constexpr int C = BN / PER;
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int r = i / C, c = i % C, row = row0 + r, col = c0 + c * PER;
    const bool ok = row < n && col < n;
    cp16(s + r * (BN + PAD) + c * PER, ok ? g + (long long)row * n + col : g,
         ok);
  }
}

// s (a warp's 16 rows by BN columns from c0) plus the bias from the shared
// tile sb (its row 0 the warp's first row) and, with the columns' labels
// slab (else null), the mask for rows labelled la, lb; -inf at columns past
// n.
template <typename T>
__device__ __forceinline__ void add_bias(float (*s)[4], const T* sb,
                                         const int* slab, int la, int lb,
                                         int c0, int n) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const int cl = nb * 8 + 2 * t;
    if (c0 + cl < n) {
      const float2 ba = unpack(load_pair(sb + g * (BN + PAD) + cl), (T*)nullptr);
      const float2 bb =
          unpack(load_pair(sb + (g + 8) * (BN + PAD) + cl), (T*)nullptr);
      s[nb][0] += ba.x;
      s[nb][1] += ba.y;
      s[nb][2] += bb.x;
      s[nb][3] += bb.y;
      if (slab) {
        const int2 lk = *reinterpret_cast<const int2*>(slab + cl);
        s[nb][0] += la != lk.x ? MASK_VALUE : 0.f;
        s[nb][1] += la != lk.y ? MASK_VALUE : 0.f;
        s[nb][2] += lb != lk.x ? MASK_VALUE : 0.f;
        s[nb][3] += lb != lk.y ? MASK_VALUE : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nb][i] = -INFINITY;
    }
  }
}

// s[8][4] = A B^T for a warp's A fragments (D/16 of them) and 64 rows of B
// in a shared tile [64][D + PAD].
template <typename T, int D>
__device__ __forceinline__ void product_t(float (*s)[4], const FragA<T>* a,
                                          const T* sb) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nb][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int nb2 = 0; nb2 < 4; ++nb2) {
      FragB<T> b0, b1;
      load_b_nk(b0, b1, sb, D + PAD, nb2 * 16, kk * 16);
      mma(s[2 * nb2], a[kk], b0);
      mma(s[2 * nb2 + 1], a[kk], b1);
    }
}

// acc[D/8][4] += P B for a warp's P (16 rows by 64 columns, C fragments) and
// a shared tile B [64][D + PAD].
template <typename T, int D>
__device__ __forceinline__ void product_n(float (*acc)[4], float (*p)[4],
                                          const T* sb) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    FragA<T> a;
    to_a(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int db = 0; db < D / 16; ++db) {
      FragB<T> b0, b1;
      load_b_kn(b0, b1, sb, D + PAD, kk * 16, db * 16);
      mma(acc[2 * db], a, b0);
      mma(acc[2 * db + 1], a, b1);
    }
  }
}

// A warp's 16 rows of an [ROWS, D] tile (C fragments) to rows row0.. of a
// [n, D] matrix of row stride `stride`; rows past n are not written.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* g, long long stride,
                                           const float (*acc)[4], int ra,
                                           int n, float sa, float sb) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int db = 0; db < D / 8; ++db) {
    const int col = db * 8 + 2 * t;
    if (ra < n) store2(g + ra * stride + col, acc[db][0] * sa, acc[db][1] * sa);
    if (ra + 8 < n)
      store2(g + (ra + 8) * stride + col, acc[db][2] * sb, acc[db][3] * sb);
  }
}

// The (b, w, h) of a flat index over [B, W, H].
struct Bwh {
  long long bwh, b;
  int w, h;
  __device__ Bwh(long long i, const Params& p)
      : bwh(i), b(i / ((long long)p.W * p.H)), w((i / p.H) % p.W),
        h(i % p.H) {}
  __device__ Bwh(int b_, int w_, int h_, const Params& p)
      : bwh(((long long)b_ * p.W + w_) * p.H + h_), b(b_), w(w_), h(h_) {}
  template <typename T>
  __device__ const T* at(const void* base, const long long* s) const {
    return static_cast<const T*>(base) + b * s[0] + w * s[1] + h * s[2];
  }
  template <typename T>
  __device__ T* at_mut(void* base, const long long* s) const {
    return static_cast<T*>(base) + b * s[0] + w * s[1] + h * s[2];
  }
};

// ---- the kernels ------------------------------------------------------------
// Each block double-buffers its inner loop's tiles (K, V or Q, dO, with the
// bias block and the labels they meet) in shared memory: the copies of tile
// j + 1 are in flight while the warps compute on tile j.

template <typename T, int D>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) window_attn_fwd(const Params p) {
  constexpr int LD = D + PAD, BLD = BN + PAD;
  constexpr int STAGE = 2 * BN * LD + ROWS * BLD;  // k, v, bias
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* st = sq + ROWS * LD;                              // [2][STAGE]
  int* slab = reinterpret_cast<int*>(st + 2 * STAGE);  // [2][BN]
  const int n = p.N, tiles = cdiv(n, ROWS);
  const Bwh id(blockIdx.x / tiles, p);
  const int q0 = (blockIdx.x % tiles) * ROWS;
  const T* K = id.at<T>(p.k, p.sk);
  const T* V = id.at<T>(p.v, p.sv);
  const T* bias = static_cast<const T*>(p.bias) + (long long)id.h * n * n;
  const int* lab = p.lab ? p.lab + (long long)id.w * n : nullptr;
  auto load = [&](int j, int buf) {
    T* s = st + buf * STAGE;
    load_rows<T, D, BN>(s, K, p.sk[3], j * BN, n);
    load_rows<T, D, BN>(s + BN * LD, V, p.sv[3], j * BN, n);
    load_block<T, ROWS>(s + 2 * BN * LD, bias, q0, j * BN, n);
    if (lab) load_vec<BN>(slab + buf * BN, lab, j * BN, n);
  };
  load_rows<T, D, ROWS>(sq, id.at<T>(p.q, p.sq), p.sq[3], q0, n);
  load(0, 0);
  commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ra = q0 + warp * 16 + (lane >> 2);
  const int la = lab && ra < n ? lab[ra] : 0;
  const int lb = lab && ra + 8 < n ? lab[ra + 8] : 0;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float acc[D / 8][4] = {};
  FragA<T> qf[D / 16];
  const int nk = cdiv(n, BN);
  for (int j = 0; j < nk; ++j) {
    const int buf = j & 1;
    if (j + 1 < nk) {
      load(j + 1, buf ^ 1);
      commit();
      wait_groups<1>();
    } else {
      wait_groups<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], sq, LD, warp * 16, kk * 16);
    }
    const T* s = st + buf * STAGE;
    float sc[8][4];
    product_t<T, D>(sc, qf, s);
    add_bias(sc, s + 2 * BN * LD + warp * 16 * BLD, lab ? slab + buf * BN : nullptr,
             la, lb, j * BN, n);
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      mx_a = fmaxf(mx_a, fmaxf(sc[nb][0], sc[nb][1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[nb][2], sc[nb][3]));
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    const float al_a = ex2((m_a - mx_a) * LOG2E), al_b = ex2((m_b - mx_b) * LOG2E);
    const float ma = mx_a * LOG2E, mb = mx_b * LOG2E;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      sc[nb][0] = ex2(fmaf(sc[nb][0], LOG2E, -ma));
      sc[nb][1] = ex2(fmaf(sc[nb][1], LOG2E, -ma));
      sc[nb][2] = ex2(fmaf(sc[nb][2], LOG2E, -mb));
      sc[nb][3] = ex2(fmaf(sc[nb][3], LOG2E, -mb));
      sa += sc[nb][0] + sc[nb][1];
      sb += sc[nb][2] + sc[nb][3];
    }
    l_a = l_a * al_a + sa;
    l_b = l_b * al_b + sb;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      acc[db][0] *= al_a;
      acc[db][1] *= al_a;
      acc[db][2] *= al_b;
      acc[db][3] *= al_b;
    }
    m_a = mx_a;
    m_b = mx_b;
    product_n<T, D>(acc, sc, s + BN * LD);
    __syncthreads();
  }
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  store_rows<T, D>(id.at_mut<T>(p.out0, p.s0), p.s0[3], acc, ra, n, 1.f / l_a,
                   1.f / l_b);
  if ((lane & 3) == 0) {
    float* lse = p.lse + id.bwh * n;
    if (ra < n) lse[ra] = fmaf(m_a, LOG2E, log2f(l_a));
    if (ra + 8 < n) lse[ra + 8] = fmaf(m_b, LOG2E, log2f(l_b));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) window_attn_bwd_dq(const Params p) {
  constexpr int LD = D + PAD, BLD = BN + PAD;
  constexpr int STAGE = 2 * BN * LD + ROWS * BLD;  // k, v, bias
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = sq + ROWS * LD;
  T* so = sdo + ROWS * LD;
  T* st = so + ROWS * LD;                              // [2][STAGE]
  int* slab = reinterpret_cast<int*>(st + 2 * STAGE);  // [2][BN]
  const int n = p.N, tiles = cdiv(n, ROWS);
  const Bwh id(blockIdx.x / tiles, p);
  const int q0 = (blockIdx.x % tiles) * ROWS;
  const T* K = id.at<T>(p.k, p.sk);
  const T* V = id.at<T>(p.v, p.sv);
  const T* bias = static_cast<const T*>(p.bias) + (long long)id.h * n * n;
  const int* lab = p.lab ? p.lab + (long long)id.w * n : nullptr;
  auto load = [&](int j, int buf) {
    T* s = st + buf * STAGE;
    load_rows<T, D, BN>(s, K, p.sk[3], j * BN, n);
    load_rows<T, D, BN>(s + BN * LD, V, p.sv[3], j * BN, n);
    load_block<T, ROWS>(s + 2 * BN * LD, bias, q0, j * BN, n);
    if (lab) load_vec<BN>(slab + buf * BN, lab, j * BN, n);
  };
  load_rows<T, D, ROWS>(sq, id.at<T>(p.q, p.sq), p.sq[3], q0, n);
  load_rows<T, D, ROWS>(sdo, id.at<T>(p.dout, p.sdo), p.sdo[3], q0, n);
  load_rows<T, D, ROWS>(so, id.at<T>(p.o, p.so), p.so[3], q0, n);
  load(0, 0);
  commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int ra = q0 + warp * 16 + g;
  const int la = lab && ra < n ? lab[ra] : 0;
  const int lb = lab && ra + 8 < n ? lab[ra + 8] : 0;
  const float lse_a = ra < n ? p.lse[id.bwh * n + ra] : 0.f;
  const float lse_b = ra + 8 < n ? p.lse[id.bwh * n + ra + 8] : 0.f;
  float d_a = 0.f, d_b = 0.f;
  float dq[D / 8][4] = {};
  FragA<T> qf[D / 16], dof[D / 16];
  const int nk = cdiv(n, BN);
  for (int j = 0; j < nk; ++j) {
    const int buf = j & 1;
    if (j + 1 < nk) {
      load(j + 1, buf ^ 1);
      commit();
      wait_groups<1>();
    } else {
      wait_groups<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        load_a(qf[kk], sq, LD, warp * 16, kk * 16);
        load_a(dof[kk], sdo, LD, warp * 16, kk * 16);
      }
      // delta = rowsum(dO o) of the warp's rows, two lanes a row, stored for
      // the kernels after this one
      const int r = warp * 16 + (lane >> 1), e0 = (lane & 1) * (D / 2);
      float x = 0.f;
#pragma unroll
      for (int e = 0; e < D / 2; ++e)
        x += to_f(sdo[r * LD + e0 + e]) * to_f(so[r * LD + e0 + e]);
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      if ((lane & 1) == 0 && q0 + r < n) p.delta[id.bwh * n + q0 + r] = x;
      d_a = __shfl_sync(0xffffffffu, x, 2 * g);
      d_b = __shfl_sync(0xffffffffu, x, 2 * g + 16);
    }
    const T* s = st + buf * STAGE;
    float sc[8][4], dp[8][4];
    product_t<T, D>(sc, qf, s);
    add_bias(sc, s + 2 * BN * LD + warp * 16 * BLD, lab ? slab + buf * BN : nullptr,
             la, lb, j * BN, n);
    product_t<T, D>(dp, dof, s + BN * LD);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      sc[nb][0] = ex2(fmaf(sc[nb][0], LOG2E, -lse_a)) * (dp[nb][0] - d_a);
      sc[nb][1] = ex2(fmaf(sc[nb][1], LOG2E, -lse_a)) * (dp[nb][1] - d_a);
      sc[nb][2] = ex2(fmaf(sc[nb][2], LOG2E, -lse_b)) * (dp[nb][2] - d_b);
      sc[nb][3] = ex2(fmaf(sc[nb][3], LOG2E, -lse_b)) * (dp[nb][3] - d_b);
    }
    product_n<T, D>(dq, sc, s);
    __syncthreads();
  }
  store_rows<T, D>(id.at_mut<T>(p.out0, p.s0), p.s0[3], dq, ra, n, 1.f, 1.f);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) window_attn_bwd_dkdv(const Params p) {
  constexpr int LD = D + PAD, BLD = BN + PAD;
  constexpr int STAGE = 2 * BN * LD + ROWS * BLD;  // q, dO, bias transposed
  extern __shared__ __align__(16) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + ROWS * LD;
  T* st = sv + ROWS * LD;                                   // [2][STAGE]
  float* sf = reinterpret_cast<float*>(st + 2 * STAGE);     // [2][lse, delta][BN]
  int* slab = reinterpret_cast<int*>(sf + 4 * BN);          // [2][BN]
  const int n = p.N, tiles = cdiv(n, ROWS);
  const Bwh id(blockIdx.x / tiles, p);
  const int k0 = (blockIdx.x % tiles) * ROWS;
  const T* Q = id.at<T>(p.q, p.sq);
  const T* DO = id.at<T>(p.dout, p.sdo);
  const T* bias = static_cast<const T*>(p.bias) + (long long)id.h * n * n;
  const int* lab = p.lab ? p.lab + (long long)id.w * n : nullptr;
  auto load = [&](int j, int buf) {
    T* s = st + buf * STAGE;
    load_rows<T, D, BN>(s, Q, p.sq[3], j * BN, n);
    load_rows<T, D, BN>(s + BN * LD, DO, p.sdo[3], j * BN, n);
    load_block<T, ROWS>(s + 2 * BN * LD, bias, k0, j * BN, n);
    load_vec<BN>(sf + buf * 2 * BN, p.lse + id.bwh * n, j * BN, n);
    load_vec<BN>(sf + buf * 2 * BN + BN, p.delta + id.bwh * n, j * BN, n);
    if (lab) load_vec<BN>(slab + buf * BN, lab, j * BN, n);
  };
  load_rows<T, D, ROWS>(sk, id.at<T>(p.k, p.sk), p.sk[3], k0, n);
  load_rows<T, D, ROWS>(sv, id.at<T>(p.v, p.sv), p.sv[3], k0, n);
  load(0, 0);
  commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int ra = k0 + warp * 16 + (lane >> 2);
  const int la = lab && ra < n ? lab[ra] : 0;
  const int lb = lab && ra + 8 < n ? lab[ra + 8] : 0;
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  FragA<T> kf[D / 16], vf[D / 16];
  const int nq = cdiv(n, BN);
  for (int j = 0; j < nq; ++j) {
    const int buf = j & 1;
    if (j + 1 < nq) {
      load(j + 1, buf ^ 1);
      commit();
      wait_groups<1>();
    } else {
      wait_groups<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        load_a(kf[kk], sk, LD, warp * 16, kk * 16);
        load_a(vf[kk], sv, LD, warp * 16, kk * 16);
      }
    }
    const T* s = st + buf * STAGE;
    const float* cl = sf + buf * 2 * BN;
    const float* cd = cl + BN;
    // the scores transposed: rows are keys, columns queries
    float sc[8][4], dp[8][4];
    product_t<T, D>(sc, kf, s);
    add_bias(sc, s + 2 * BN * LD + warp * 16 * BLD, lab ? slab + buf * BN : nullptr,
             la, lb, j * BN, n);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float2 l2 = *reinterpret_cast<const float2*>(cl + nb * 8 + 2 * t);
      sc[nb][0] = ex2(fmaf(sc[nb][0], LOG2E, -l2.x));
      sc[nb][1] = ex2(fmaf(sc[nb][1], LOG2E, -l2.y));
      sc[nb][2] = ex2(fmaf(sc[nb][2], LOG2E, -l2.x));
      sc[nb][3] = ex2(fmaf(sc[nb][3], LOG2E, -l2.y));
    }
    product_n<T, D>(dv, sc, s + BN * LD);
    product_t<T, D>(dp, vf, s + BN * LD);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float2 d2 = *reinterpret_cast<const float2*>(cd + nb * 8 + 2 * t);
      sc[nb][0] *= dp[nb][0] - d2.x;
      sc[nb][1] *= dp[nb][1] - d2.y;
      sc[nb][2] *= dp[nb][2] - d2.x;
      sc[nb][3] *= dp[nb][3] - d2.y;
    }
    product_n<T, D>(dk, sc, s);
    __syncthreads();
  }
  store_rows<T, D>(id.at_mut<T>(p.out0, p.s0), p.s0[3], dk, ra, n, 1.f, 1.f);
  store_rows<T, D>(id.at_mut<T>(p.out1, p.s1), p.s1[3], dv, ra, n, 1.f, 1.f);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) window_attn_dbias(const Params p) {
  constexpr int LD = D + PAD, BLD = BN + PAD;
  constexpr int STAGE = (2 * ROWS + 2 * BN) * LD;  // q, dO, k, v
  extern __shared__ __align__(16) unsigned char smem[];
  T* sbias = reinterpret_cast<T*>(smem);                   // [ROWS][BLD]
  T* st = sbias + ROWS * BLD;                              // [2][STAGE]
  float* sf = reinterpret_cast<float*>(st + 2 * STAGE);    // [2][lse, delta][ROWS]
  int* slab = reinterpret_cast<int*>(sf + 4 * ROWS);       // [2][ROWS + BN]
  const int n = p.N, kt = cdiv(n, BN);
  const int q0 = (blockIdx.x / kt) * ROWS, k0 = (blockIdx.x % kt) * BN;
  const int h = blockIdx.y;
  const int total = p.B * p.W;
  auto load = [&](int i, int buf) {
    const Bwh id(i / p.W, i % p.W, h, p);
    T* s = st + buf * STAGE;
    load_rows<T, D, ROWS>(s, id.at<T>(p.q, p.sq), p.sq[3], q0, n);
    load_rows<T, D, ROWS>(s + ROWS * LD, id.at<T>(p.dout, p.sdo), p.sdo[3], q0, n);
    load_rows<T, D, BN>(s + 2 * ROWS * LD, id.at<T>(p.k, p.sk), p.sk[3], k0, n);
    load_rows<T, D, BN>(s + (2 * ROWS + BN) * LD, id.at<T>(p.v, p.sv), p.sv[3], k0, n);
    load_vec<ROWS>(sf + buf * 2 * ROWS, p.lse + id.bwh * n, q0, n);
    load_vec<ROWS>(sf + buf * 2 * ROWS + ROWS, p.delta + id.bwh * n, q0, n);
    if (p.lab) {
      const int* lab = p.lab + (long long)id.w * n;
      load_vec<ROWS>(slab + buf * (ROWS + BN), lab, q0, n);
      load_vec<BN>(slab + buf * (ROWS + BN) + ROWS, lab, k0, n);
    }
  };
  load_block<T, ROWS>(sbias, static_cast<const T*>(p.bias) + (long long)h * n * n,
                      q0, k0, n);
  load(0, 0);
  commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int r = warp * 16 + g, ra = q0 + r;
  float acc[8][4] = {};
  for (int i = 0; i < total; ++i) {
    const int buf = i & 1;
    if (i + 1 < total) {
      load(i + 1, buf ^ 1);
      commit();
      wait_groups<1>();
    } else {
      wait_groups<0>();
    }
    __syncthreads();
    const T* s = st + buf * STAGE;
    const float* cl = sf + buf * 2 * ROWS;
    const int* cb = slab + buf * (ROWS + BN);
    FragA<T> qf[D / 16], dof[D / 16];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      load_a(qf[kk], s, LD, warp * 16, kk * 16);
      load_a(dof[kk], s + ROWS * LD, LD, warp * 16, kk * 16);
    }
    const float lse_a = cl[r], lse_b = cl[r + 8];
    const float d_a = cl[ROWS + r], d_b = cl[ROWS + r + 8];
    float sc[8][4], dp[8][4];
    product_t<T, D>(sc, qf, s + 2 * ROWS * LD);
    add_bias(sc, sbias + warp * 16 * BLD, p.lab ? cb + ROWS : nullptr,
             p.lab ? cb[r] : 0, p.lab ? cb[r + 8] : 0, k0, n);
    product_t<T, D>(dp, dof, s + (2 * ROWS + BN) * LD);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      acc[nb][0] += ex2(fmaf(sc[nb][0], LOG2E, -lse_a)) * (dp[nb][0] - d_a);
      acc[nb][1] += ex2(fmaf(sc[nb][1], LOG2E, -lse_a)) * (dp[nb][1] - d_a);
      acc[nb][2] += ex2(fmaf(sc[nb][2], LOG2E, -lse_b)) * (dp[nb][2] - d_b);
      acc[nb][3] += ex2(fmaf(sc[nb][3], LOG2E, -lse_b)) * (dp[nb][3] - d_b);
    }
    __syncthreads();
  }
  float* out = p.dbias + (long long)h * n * n;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const int col = k0 + nb * 8 + 2 * (lane & 3);
    if (col < n) {
      if (ra < n) store2(out + (long long)ra * n + col, acc[nb][0], acc[nb][1]);
      if (ra + 8 < n)
        store2(out + (long long)(ra + 8) * n + col, acc[nb][2], acc[nb][3]);
    }
  }
}

// Shared memory past 48 KB is granted per kernel, once, before its first
// launch.
template <typename K>
cudaError_t prepare(K kernel, size_t smem, bool& done) {
  if (!done && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  done = true;
  return cudaSuccess;
}

template <typename T, int D>
int launch(int which, const Params& p, cudaStream_t stream) {
  constexpr size_t LD = D + PAD, E = sizeof(T);
  const long long bwh = (long long)p.B * p.W * p.H;
  const int rows = cdiv(p.N, ROWS), keys = cdiv(p.N, BN);
  cudaError_t err = cudaSuccess;
  constexpr size_t BLD = BN + PAD, L = sizeof(int);
  constexpr size_t STAGE_ROWS = (2 * BN * LD + ROWS * BLD) * E;  // fwd, dq, dkdv
  switch (which) {
    case 0: {
      const size_t smem = ROWS * LD * E + 2 * STAGE_ROWS + 2 * BN * L;
      static bool done = false;
      err = prepare(window_attn_fwd<T, D>, smem, done);
      if (err == cudaSuccess)
        window_attn_fwd<T, D><<<(unsigned)(bwh * rows), NT, smem, stream>>>(p);
      break;
    }
    case 1: {
      const size_t smem = 3 * ROWS * LD * E + 2 * STAGE_ROWS + 2 * BN * L;
      static bool done = false;
      err = prepare(window_attn_bwd_dq<T, D>, smem, done);
      if (err == cudaSuccess)
        window_attn_bwd_dq<T, D><<<(unsigned)(bwh * rows), NT, smem, stream>>>(p);
      break;
    }
    case 2: {
      const size_t smem = 2 * ROWS * LD * E + 2 * STAGE_ROWS + 6 * BN * L;
      static bool done = false;
      err = prepare(window_attn_bwd_dkdv<T, D>, smem, done);
      if (err == cudaSuccess)
        window_attn_bwd_dkdv<T, D><<<(unsigned)(bwh * rows), NT, smem, stream>>>(p);
      break;
    }
    case 3: {
      const size_t smem = ROWS * BLD * E + 2 * (2 * ROWS + 2 * BN) * LD * E +
                          2 * (3 * ROWS + BN) * L;
      static bool done = false;
      err = prepare(window_attn_dbias<T, D>, smem, done);
      if (err == cudaSuccess)
        window_attn_dbias<T, D><<<dim3(rows * keys, p.H), NT, smem, stream>>>(p);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(int which, int d, const Params& p, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(which, p, stream);
    case 32: return launch<T, 32>(which, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// which: 0 fwd, 1 bwd_dq, 2 bwd_dkdv, 3 dbias; dtype: 0 fp16, 1 bf16,
// 2 fp32; d: 16 or 32 (else cudaErrorInvalidValue and no launch).
extern "C" int window_attn(int which, int dtype, int d, const void* params,
                           void* stream) {
  const Params* p = static_cast<const Params*>(params);
  if (p->N < 8 || p->N % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_width<__half>(which, d, *p, s);
    case 1: return launch_width<__nv_bfloat16>(which, d, *p, s);
    case 2: return launch_width<float>(which, d, *p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
