// A whole vector of counter-based draws for Hopper (sm_90a): N(0, 1) or
// U[0, 1), keyed by (seed, step, stream).
//
// Replaces the jax.random draws that the JAX package takes inside a
// method's step, with the step's key folded from the (traced) global step:
// VI's reparameterisation eps (bayesdll_tpu/methods/vi.py:78), MC-dropout's
// keep-mask uniforms (bayesdll_tpu/methods/mc_dropout.py:61,85) and the
// Adam-SGHMC and Adam-cSGHMC momentum noise
// (bayesdll_tpu/ops/fused.py:118, bayesdll_tpu/methods/adam_csghmc.py:119).
// None of these is a Pallas kernel; the kernel exists so that the port's
// fused path (a captured CUDA graph of the step) draws anew at each step:
// the kernel reads the seed and the step from device memory, which the
// graph's runner fills before each replay.  The Adam methods' step draws
// the same Adam-stream bits inside adam_sghmc_update.cu's pass; this
// draw is what its eager oracle reads.
//
// Element i takes word i % 4 of the Philox4x32-10 call of quad i / 4 at
// counter (quad, step low word, stream, step high word), the layout of
// normal_from_bits.cuh that the three sampler-update kernels use: normals
// through the same Box-Muller (normal4), uniforms as the same 24-bit
// fractions (uniform4).  Each method's draw has its own stream id, so no
// two draws of one step share bits with each other or with the update
// kernels.
//
// What bounds it: each element is written once (4 bytes) and read from
// nowhere, so the bound is the bytes': 1.22 GB at ViT-L/32's D, 364.8 us
// at 3.35 TB/s.  The work per element is a quarter of a Philox call (10
// rounds of 2 wide multiplies and 2 three-input xors for 4 elements) and,
// for normals, half a Box-Muller pair.  Uniforms stay bytes-bound;
// normals are bound by issue slots, about 50 SASS instructions an element,
// 28 of them Box-Muller's (normal_from_bits.cuh, fitted to the 24-bit
// uniforms, one MUFU a pair; libdevice's logf, sqrtf and sincospif took
// 105 instructions a pair).  So the design keeps that work small and in
// flight: the kind a template parameter, so the loop holds no branch on
// it; each thread taking 2 or 4 element quads an iteration, independent
// Philox chains and Box-Mullers the scheduler interleaves; one 16-byte
// store per quad; a grid that covers the vector.  A scalar tail handles
// n % 4.
//
// The seed and the step come from dev, the int64 [3] (seed, step, gate)
// row that the update kernels read (the gate unused here): the per-step
// path copies it from pinned host memory without waiting, the fused
// path's graph fills it before each replay.
//
// A launch may draw a shard of a longer vector: elem0, the global index of
// its first element (a multiple of 4), shifts the counter's quad, so the
// shards' draws at their offsets concatenate to the whole vector's draw
// (normal_from_bits.cuh).
//
// Contract: out 16-byte aligned fp32 of n elements; kind 0 normal, 1
// uniform; elem0 a multiple of 4 with every global quad below 2^32 (else
// cudaErrorInvalidValue and no launch).  Launches on `stream`, allocates nothing, does not synchronise;
// returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "normal_from_bits.cuh"

namespace {

constexpr int kNormal = 0;
constexpr int kUniform = 1;
constexpr int kThreads = 256;
// Element quads per thread and iteration (philox_draw below).  From
// kManyQuads quads on, a grid of 4-quad threads has at least 1024 blocks,
// about as many as an H100 holds at once (132 SMs, 8 blocks of 256
// threads each); below it normals take 2-quad threads, which keep more of
// the card busy.
constexpr int64_t kManyQuads = int64_t{1} << 20;

// dev = (seed, step, gate), the gate unused
template <int kKind, int kQuads>
__global__ void __launch_bounds__(kThreads)
philox_draw_kernel(float* __restrict__ out, int64_t n, uint64_t quad0,
                   uint32_t stream_id, const int64_t* __restrict__ dev) {
  const uint64_t seed = static_cast<uint64_t>(dev[0]);
  const uint64_t step = static_cast<uint64_t>(dev[1]);
  const int64_t full_quads = n / 4;
  const int64_t quads = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       q0 < quads; q0 += kQuads * stride) {
    float z[kQuads][4];
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      // a quad past the end is drawn and not stored: no branch before the
      // stores, so the chains interleave
      const uint64_t q = quad0 + static_cast<uint64_t>(q0 + i * stride);
      if constexpr (kKind == kNormal) {
        bdl::normal4(seed, q, step, stream_id, z[i]);
      } else {
        bdl::uniform4(seed, q, step, stream_id, z[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const int64_t q = q0 + i * stride;
      if (q < full_quads) {
        reinterpret_cast<float4*>(out)[q] =
            make_float4(z[i][0], z[i][1], z[i][2], z[i][3]);
      } else if (q < quads) {
        // constant indices into z keep it in registers
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * q + j < n) out[4 * q + j] = z[i][j];
        }
      }
    }
  }
}

// kQuads element quads per thread and iteration, over a grid that covers
// the vector (grid-stride beyond 2^20 blocks)
template <int kKind, int kQuads>
int launch(void* out, int64_t n, uint64_t quad0, uint32_t stream_id,
           const void* dev, void* stream) {
  const int64_t per_block = int64_t{kThreads} * kQuads;
  int64_t blocks = ((n + 3) / 4 + per_block - 1) / per_block;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;
  philox_draw_kernel<kKind, kQuads>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<float*>(out), n, quad0, stream_id,
          static_cast<const int64_t*>(dev));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// elem0: the global index of element 0, a multiple of 4, 0 for a whole
// vector; dev: int64 [3] = (seed, step, gate) on out's device, the gate
// unused.  The launch shapes each draw ran fastest with: uniforms 2 quads
// per thread; normals 4 from kManyQuads quads on, else 2.
extern "C" int philox_draw(void* out, int64_t n, int64_t elem0, int kind,
                           uint32_t stream_id, const void* dev, void* stream) {
  if (!bdl::valid_offset(elem0, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const uint64_t quad0 = static_cast<uint64_t>(elem0 / 4);
  if (kind != kNormal) {
    return launch<kUniform, 2>(out, n, quad0, stream_id, dev, stream);
  }
  if ((n + 3) / 4 < kManyQuads) {
    return launch<kNormal, 2>(out, n, quad0, stream_id, dev, stream);
  }
  return launch<kNormal, 4>(out, n, quad0, stream_id, dev, stream);
}
