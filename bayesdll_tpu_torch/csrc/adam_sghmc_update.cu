// Adam-SGHMC momentum and the torch-SGD step that follows it, for Hopper
// (sm_90a), in one pass over the flat vector, in place.
//
// Replaces no Pallas kernel: the JAX package leaves this update to XLA's
// fusion (bayesdll_tpu/ops/fused.py::adam_sghmc_update and, with a
// temperature, bayesdll_tpu/methods/adam_csghmc.py).  On the card the port
// ran it as eager PyTorch: about 27 elementwise kernels, a whole-vector
// noise draw (philox_draw.cu) and the SGD step's two more, some 290 bytes
// an element.  Per element, with bc1 = 1 - b1^t and bc2 = 1 - b2^t from the
// card:
//   grad_U = g / T + mask * (θ - θ0) / σ² / N
//   m'     = b1 m + (1 - b1) grad_U
//   v2'    = b2 v2 + (1 - b2) grad_U grad_U
//   P      = 1 / (sqrt(v2' / bc2) + ε)
//   v_mom' = (1 - α) v_mom + lr (m' / bc1) P + nd sqrt(2α P / N) z
// and then SGD's gradient s = v_mom' (Adam-cSGHMC) or g + v_mom'
// (Adam-SGHMC).  At torch-SGD momentum 0 the pass also takes the step,
// θ' = θ - lr s; at another momentum it leaves s for the eager step
// (core/sgd.py), writing g + v_mom' over g where s is that.  The two
// choices are template parameters, so the loop holds no branch on them.
//
// Rounding: the eager composition's, so that on the card the pass equals
// ops/fused.py::adam_sghmc_momentum followed by core/sgd.py::sgd_step bit
// for bit.  Each product, sum, square root and division is rounded on its
// own (__fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn: nvcc would otherwise
// contract a product and a sum into one fused multiply-add), in the
// eager order: (1 - b2) grad_U first, then times grad_U; lr times m' / bc1,
// then times P.  PyTorch on the card divides by a host scalar as a
// multiplication by its fp32 reciprocal, so 1/T, 1/σ² and 1/N come by
// value as those reciprocals, and m' / bc1, v2' / bc2 multiply by 1/bc1,
// 1/bc2 rounded here as torch.reciprocal rounds them
// (core/moments.py::div_as_host_scalar).  The scalar coefficients (b1,
// 1 - b1, 2α, ...) come rounded to fp32 as the host hands them to PyTorch.
// z is normal_from_bits.cuh's normal4 on the Adam stream at the counters
// philox_draw.cu uses for the same (seed, step, element): the draw's bits,
// drawn only where nd != 0 and never stored.
//
// What bounds it: memory traffic.  Per element it reads g, θ, θ0, mask,
// lr, v_mom, m and v2 and writes v_mom, m, v2 and θ: 48 bytes (14.67 GB,
// 4.38 ms at 3.35 TB/s at ViT-L/32's D = 305,549,312), against about 25
// rounded operations, two of them divisions and two square roots, plus a
// quarter of a Philox call and half a Box-Muller pair.  So the design is
// the sibling kernels': one element quad per thread, 16-byte (float4)
// loads and stores, every load of a quad issued before its arithmetic, a
// scalar tail for n % 4, no temporaries in device memory.
//
// The Philox seed and the step come from dev, the int64 [3] (seed, step,
// gate) row the other kernels read (the gate unused), and the bias
// corrections from bc, an fp32 [2] (bc1, bc2) on the card: the per-step
// path copies both from pinned host memory without waiting, the fused
// path's captured graph fills them before each replay.
//
// Contract: elem0 a multiple of 4 with every global quad below 2^32 (else
// cudaErrorInvalidValue and no launch), form 0-3 (else the same), the
// vectors 16-byte aligned fp32 of n elements each; the vectors written (v_mom,
// m, v2, and θ or g by the form) alias no other operand.  Launches on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "normal_from_bits.cuh"

namespace {

struct Scalars {
  float inv_temp;         // 1 / T, 1 where T = 1
  float inv_sig2;         // 1 / σ²
  float inv_n;            // 1 / N
  float nd;
  float beta1;
  float one_minus_beta1;  // 1 - b1
  float beta2;
  float one_minus_beta2;  // 1 - b2
  float eps;
  float one_minus_alpha;  // 1 - α
  float two_alpha;        // 2α
  uint64_t quad0;  // global quad of element 0 (elem0 / 4)
};

// SGD's gradient is g + v_mom' (kAddG) or v_mom'; kStep: θ <- θ - lr s here
template <bool kAddG, bool kStep>
__device__ __forceinline__ void update_one(float& g, float& th, float th0,
                                           float mask, float lr, float& vm,
                                           float& m, float& v2, float z,
                                           float inv_bc1, float inv_bc2,
                                           const Scalars& s) {
  const float prior = __fmul_rn(
      __fmul_rn(__fmul_rn(mask, __fsub_rn(th, th0)), s.inv_sig2), s.inv_n);
  const float gu = __fadd_rn(__fmul_rn(g, s.inv_temp), prior);
  m = __fadd_rn(__fmul_rn(s.beta1, m), __fmul_rn(s.one_minus_beta1, gu));
  v2 = __fadd_rn(__fmul_rn(s.beta2, v2),
                 __fmul_rn(__fmul_rn(s.one_minus_beta2, gu), gu));
  const float p = __fdiv_rn(
      1.0f, __fadd_rn(__fsqrt_rn(__fmul_rn(v2, inv_bc2)), s.eps));
  float vn = __fadd_rn(__fmul_rn(s.one_minus_alpha, vm),
                       __fmul_rn(__fmul_rn(lr, __fmul_rn(m, inv_bc1)), p));
  if (s.nd != 0.f) {
    const float scale = __fmul_rn(
        s.nd, __fsqrt_rn(__fmul_rn(__fmul_rn(s.two_alpha, p), s.inv_n)));
    vn = __fadd_rn(vn, __fmul_rn(scale, z));
  }
  vm = vn;
  const float sgd_grad = kAddG ? __fadd_rn(g, vn) : vn;
  if constexpr (kStep) {
    th = __fsub_rn(th, __fmul_rn(lr, sgd_grad));
  } else if constexpr (kAddG) {
    g = sgd_grad;
  }
}

template <bool kAddG, bool kStep>
__global__ void adam_sghmc_update_kernel(
    float* __restrict__ g, float* __restrict__ theta,
    const float* __restrict__ theta0, const float* __restrict__ mask,
    const float* __restrict__ lr, float* __restrict__ v_mom,
    float* __restrict__ m, float* __restrict__ v2, int64_t n, Scalars s,
    const float* __restrict__ bc, const int64_t* __restrict__ dev) {
  const uint64_t seed = static_cast<uint64_t>(dev[0]);  // (seed, step, unused)
  const uint64_t step = static_cast<uint64_t>(dev[1]);
  const float inv_bc1 = __fdiv_rn(1.0f, bc[0]);
  const float inv_bc2 = __fdiv_rn(1.0f, bc[1]);
  const int64_t full_quads = n / 4;
  const int64_t quads = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       q < quads; q += stride) {
    float z[4] = {0.f, 0.f, 0.f, 0.f};
    if (s.nd != 0.f) {
      bdl::normal4(seed, s.quad0 + static_cast<uint64_t>(q), step,
                   bdl::kStreamAdam, z);
    }
    if (q < full_quads) {
      float4 g4 = reinterpret_cast<const float4*>(g)[q];
      float4 th4 = reinterpret_cast<const float4*>(theta)[q];
      const float4 th04 = reinterpret_cast<const float4*>(theta0)[q];
      const float4 mk4 = reinterpret_cast<const float4*>(mask)[q];
      const float4 lr4 = reinterpret_cast<const float4*>(lr)[q];
      float4 vm4 = reinterpret_cast<const float4*>(v_mom)[q];
      float4 m4 = reinterpret_cast<const float4*>(m)[q];
      float4 v24 = reinterpret_cast<const float4*>(v2)[q];
      update_one<kAddG, kStep>(g4.x, th4.x, th04.x, mk4.x, lr4.x, vm4.x, m4.x,
                               v24.x, z[0], inv_bc1, inv_bc2, s);
      update_one<kAddG, kStep>(g4.y, th4.y, th04.y, mk4.y, lr4.y, vm4.y, m4.y,
                               v24.y, z[1], inv_bc1, inv_bc2, s);
      update_one<kAddG, kStep>(g4.z, th4.z, th04.z, mk4.z, lr4.z, vm4.z, m4.z,
                               v24.z, z[2], inv_bc1, inv_bc2, s);
      update_one<kAddG, kStep>(g4.w, th4.w, th04.w, mk4.w, lr4.w, vm4.w, m4.w,
                               v24.w, z[3], inv_bc1, inv_bc2, s);
      reinterpret_cast<float4*>(v_mom)[q] = vm4;
      reinterpret_cast<float4*>(m)[q] = m4;
      reinterpret_cast<float4*>(v2)[q] = v24;
      if constexpr (kStep) {
        reinterpret_cast<float4*>(theta)[q] = th4;
      } else if constexpr (kAddG) {
        reinterpret_cast<float4*>(g)[q] = g4;
      }
    } else {
      // constant indices into z keep it in registers
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t i = 4 * q + j;
        if (i < n) {
          float gg = g[i], tt = theta[i], vv = v_mom[i], mm = m[i], ss = v2[i];
          update_one<kAddG, kStep>(gg, tt, theta0[i], mask[i], lr[i], vv, mm,
                                   ss, z[j], inv_bc1, inv_bc2, s);
          v_mom[i] = vv;
          m[i] = mm;
          v2[i] = ss;
          if constexpr (kStep) {
            theta[i] = tt;
          } else if constexpr (kAddG) {
            g[i] = gg;
          }
        }
      }
    }
  }
}

template <bool kAddG, bool kStep>
int launch(void* g, void* theta, const void* theta0, const void* mask,
           const void* lr, void* v_mom, void* m, void* v2, int64_t n,
           const Scalars& s, const void* bc, const void* dev, void* stream) {
  constexpr int kThreads = 256;
  const int64_t quads = (n + 3) / 4;
  int64_t blocks = (quads + kThreads - 1) / kThreads;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;  // grid-stride beyond
  adam_sghmc_update_kernel<kAddG, kStep>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<float*>(g), static_cast<float*>(theta),
          static_cast<const float*>(theta0), static_cast<const float*>(mask),
          static_cast<const float*>(lr), static_cast<float*>(v_mom),
          static_cast<float*>(m), static_cast<float*>(v2), n, s,
          static_cast<const float*>(bc), static_cast<const int64_t*>(dev));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// form: bit 0 set where SGD's gradient is g + v_mom' (Adam-SGHMC), bit 1
// where the pass takes the SGD step (torch-SGD momentum 0); elem0: the
// global index of element 0, a multiple of 4, 0 for a whole vector; bc:
// fp32 [2] = (1 - b1^t, 1 - b2^t) and dev: int64 [3] = (seed, step, unused),
// both on the vectors' device
extern "C" int adam_sghmc_update(void* g, void* theta, const void* theta0,
                                 const void* mask, const void* lr,
                                 void* v_mom, void* m, void* v2, int64_t n,
                                 int64_t elem0, int form, float inv_temp,
                                 float inv_sig2, float inv_n, float nd,
                                 float beta1, float one_minus_beta1,
                                 float beta2, float one_minus_beta2,
                                 float eps, float one_minus_alpha,
                                 float two_alpha, const void* bc,
                                 const void* dev, void* stream) {
  if (!bdl::valid_offset(elem0, n) || form < 0 || form > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const Scalars s{inv_temp, inv_sig2, inv_n, nd, beta1, one_minus_beta1,
                  beta2, one_minus_beta2, eps, one_minus_alpha, two_alpha,
                  static_cast<uint64_t>(elem0 / 4)};
  switch (form) {
    case 0:
      return launch<false, false>(g, theta, theta0, mask, lr, v_mom, m, v2,
                                  n, s, bc, dev, stream);
    case 1:
      return launch<true, false>(g, theta, theta0, mask, lr, v_mom, m, v2, n,
                                 s, bc, dev, stream);
    case 2:
      return launch<false, true>(g, theta, theta0, mask, lr, v_mom, m, v2, n,
                                 s, bc, dev, stream);
    default:
      return launch<true, true>(g, theta, theta0, mask, lr, v_mom, m, v2, n,
                                s, bc, dev, stream);
  }
}
