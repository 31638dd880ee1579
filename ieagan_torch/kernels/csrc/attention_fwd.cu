// Fused attention forward for Hopper (sm_90a): o = softmax(scale * q k^T) v
// and the f32 row statistic lse = m + log(l), per batch entry b:
//   q (B, Lq, dk), k (B, Lkv, dk), v (B, Lkv, dv) -> o (B, Lq, dv), lse (B, Lq)
// Inputs are f32 or bf16 (o takes their type); softmax statistics and all
// accumulation are f32. dk, dv <= 128. Row-major, contiguous tensors.
//
// Replaces ieagan_tpu/ops/pallas/flash_attention.py::_fwd_kernel (launched by
// _fwd), which keeps the whole kv (padded to 8) in VMEM and does one pass.
// This kernel is not a block-by-block copy of it:
//   * one block per (batch entry, tile of kBQ = 16 q rows); four warps, each
//     owning four q rows;
//   * kv is walked in tiles of kBKV = 32 rows through shared memory with an
//     online softmax (running max m and running sum l in f32, the output
//     accumulator rescaled by exp(m_old - m_new)). Shared memory per block is
//     fixed (43,136 B) whatever Lkv is, so D's image-attention site
//     (Lkv = 768, dv = 128), whose whole kv would need 245,760 B in bf16 --
//     above the 232,448 B a block may use -- runs the same kernel;
//   * a lane computes the score of kv column `lane` for its warp's rows, then
//     output columns lane, lane+32, ... of those rows;
//   * ragged edges are masked here: kv columns past Lkv score -inf, q rows past
//     Lq are computed on zeros and never stored;
//   * lse is written for the backward kernel (B2), which recomputes
//     p = exp(s - lse).
//
// Bound. At the site on the deployment path (G's relational-reasoning module,
// B = events * 2 heads, Lq = Lkv = 40, dk = dv = 64, scale 1/8, f32) q, k, v
// and o are 4 * 2*40*64*4 B ~ 82 KB per event and the products 2*2*40*40*128
// ~ 0.8 MFLOP per event: ~25 ns per event at 3.35 TB/s, far below the cost
// of one launch. The kernel is launch-bound there. The design answers that
// with a single launch per attention call over all events and heads (the
// batch axis is the grid's x axis), so the launch is paid once per generator
// call, not once per event or head. Scalar FMA is enough at that site;
// tensor-core tiles (mma / wgmma) are for the discriminator's sites, where
// the work is large enough to be bound by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // q rows per block
constexpr int kBKV = 32;                    // kv rows per tile: one per lane
constexpr int kMaxD = 128;
constexpr int kColsPerLane = kMaxD / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, int lq, int lkv, int dk,
                         int dv, float scale) {
  __shared__ float q_s[kBQ][kMaxD];
  __shared__ float k_s[kBKV][kMaxD + 1];  // +1: lanes read distinct banks
  __shared__ float v_s[kBKV][kMaxD];
  __shared__ float p_s[kBQ][kBKV];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.y * kBQ;
  const long long q_row0 = static_cast<long long>(blockIdx.x) * lq;
  const long long kv_row0 = static_cast<long long>(blockIdx.x) * lkv;

  for (int i = tid; i < kBQ * dk; i += blockDim.x) {
    const int r = i / dk, c = i % dk;
    q_s[r][c] = q0 + r < lq ? to_f32(q[(q_row0 + q0 + r) * dk + c]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[r][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < lkv; kv0 += kBKV) {
    __syncthreads();  // q_s written; the previous kv tile fully consumed
    for (int i = tid; i < kBKV * dk; i += blockDim.x) {
      const int r = i / dk, c = i % dk;
      k_s[r][c] = kv0 + r < lkv ? to_f32(k[(kv_row0 + kv0 + r) * dk + c]) : 0.f;
    }
    for (int i = tid; i < kBKV * dv; i += blockDim.x) {
      const int r = i / dv, c = i % dv;
      v_s[r][c] = kv0 + r < lkv ? to_f32(v[(kv_row0 + kv0 + r) * dv + c]) : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    for (int c = 0; c < dk; ++c) {
      const float kc = k_s[lane][c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] = fmaf(q_s[warp * kRowsPerWarp + r][c], kc, s[r]);
    }

    // Online softmax. The first tile always holds column 0, so m_new is
    // finite from the first tile on, and alpha = exp(-inf) = 0 there.
    const bool valid = kv0 + lane < lkv;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sr = valid ? s[r] * scale : -CUDART_INF_F;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = valid ? expf(sr - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      p_s[warp * kRowsPerWarp + r][lane] = p;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    const int n_kv = min(kBKV, lkv - kv0);
    for (int j = 0; j < n_kv; ++j) {
      float vj[kColsPerLane];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int col = lane + 32 * c;
        vj[c] = col < dv ? v_s[j][col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = p_s[warp * kRowsPerWarp + r][j];
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c)
          acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
    __syncwarp();  // p_s rows are rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= lq) continue;
    const float inv_l = 1.f / l[r];
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int col = lane + 32 * c;
      if (col < dv) o[(q_row0 + row) * dv + col] = from_f32<T>(acc[r][c] * inv_l);
    }
    if (lane == 0) lse[q_row0 + row] = m[r] + logf(l[r]);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream` of `device` without synchronising; returns the
// cudaError_t of the launch (0 on success), or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int ieagan_attention_fwd(const void* q, const void* k, const void* v,
                                    void* o, void* lse, int batch, int lq,
                                    int lkv, int dk, int dv, float scale,
                                    int dtype, int device, void* stream) {
  if (batch <= 0 || lq <= 0 || lkv <= 0 || dk <= 0 || dv <= 0 || dk > kMaxD ||
      dv > kMaxD || (lq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch, (lq + kBQ - 1) / kBQ);
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    attention_fwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), lq, lkv, dk, dv, scale);
  } else if (dtype == 1) {
    attention_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        static_cast<float*>(lse), lq, lkv, dk, dv, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ieagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
