// Fused attention backward for Hopper (sm_90a). For each batch entry b, with
// p = exp(scale * q k^T - lse) recomputed from the forward's f32 row
// statistic lse (B1, attention_fwd.cu):
//   dV = p^T dO
//   delta = rowsum(dO * O)                         (f32, from O in its type)
//   dS = p * (dO v^T - delta) * scale
//   dQ = dS k,  dK = dS^T q
// q (B, Lq, dk), k (B, Lkv, dk), v (B, Lkv, dv), o and dO (B, Lq, dv), lse and
// delta (B, Lq) f32. Inputs are f32 or bf16; dq, dk, dv take their type. All
// accumulation is f32. dk, dv <= 128. Row-major, contiguous tensors.
//
// Replaces ieagan_tpu/ops/pallas/flash_attention.py::_bwd_kernel (launched by
// _bwd, bound to the forward by defvjp). That kernel keeps the whole padded q,
// o, dO and dq of a batch entry in VMEM and walks q tiles in order, carrying
// dK and dV from tile to tile. At the discriminator's image-attention site
// (Lq = 3072, Lkv = 768, dk = 32, dv = 128) that residency is
// 3072 * (2*32 + 2*128) * 4 B ~ 3.9 MB, far above the 232,448 B of shared
// memory a block may use, and blocks run in parallel, not in order. So the
// work is split three ways, FA2-style, with no atomics and a deterministic
// result:
//   1. delta_kernel: one warp per q row computes delta = rowsum(dO * O);
//   2. dkdv_kernel: one block per (batch entry, tile of kBKV = 32 kv rows)
//      loops over q tiles of kBQ = 8 rows, recomputes p and dS for the
//      (8 x 32) tile in shared memory and accumulates dK and dV for its kv
//      rows in f32 registers (a warp owns 8 kv rows; a lane owns columns
//      lane, lane+32, ...);
//   3. dq_kernel: one block per (batch entry, tile of 8 q rows) loops over kv
//      tiles of 32 rows, recomputes p and dS and accumulates dQ in f32
//      registers.
// Shared memory is fixed by the largest head width (under 48 KB per block),
// whatever Lq and Lkv are. Ragged edges are masked here: q rows past Lq and
// kv rows past Lkv get p = dS = 0 and are never stored.
//
// Bound. At the image-attention site in the train step (B = 40 images) the
// least work is the five products, 2*B*Lq*Lkv*(3*dk + 2*dv) ~ 6.6e10 FLOP:
// about 1.0 ms at the card's 67 TFLOP/s f32 rate outside the tensor cores,
// 0.07 ms at 989 TFLOP/s bf16 on them; the bytes (q, k, v, o, dO, lse in;
// dq, dk, dv out) are ~0.14 GB in f32, 0.04 ms at 3.35 TB/s. So the kernel
// is bound by operations there. This design recomputes s = q k^T in both
// the dK/dV and the dQ kernel (7 products instead of 5) and runs scalar FMA
// from shared memory, so it stays well above that bound; tensor-core tiles
// (mma.sync, then wgmma with TMA) are the next step. At the relational-
// reasoning sites (Lq = Lkv = 40) the work is under 10 MFLOP and the call is
// launch-bound: one C call launches the three kernels back to back on the
// caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 8;                      // q rows per tile
constexpr int kRowsPerWarp = kBQ / kWarps;  // q rows per warp in the score step
constexpr int kBKV = 32;                    // kv rows per tile: one per lane
constexpr int kKvPerWarp = kBKV / kWarps;   // kv rows a warp accumulates
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// delta[row] = sum_c dO[row, c] * O[row, c] in f32; one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ d_o,
                 float* __restrict__ delta, long long rows, int dv) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < dv; c += 32)
    acc = fmaf(to_f32(d_o[row * dv + c]), to_f32(o[row * dv + c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// Shared by both kernels: for the (kBQ x kBKV) tile of q rows q0.. and kv rows
// kv0.., with q_s/do_s holding the q rows and k_s/v_s the kv rows (f32), write
// p and dS into p_s and ds_s. A lane takes kv column `lane`, a warp its
// kRowsPerWarp q rows.
__device__ __forceinline__ void scores_tile(
    const float (*q_s)[kMaxD], const float (*do_s)[kMaxD],
    const float (*k_s)[kMaxD + 1], const float (*v_s)[kMaxD + 1],
    const float* lse_s, const float* delta_s, float (*p_s)[kBKV],
    float (*ds_s)[kBKV], int q0, int lq, int kv0, int lkv, int dk, int dv,
    float scale) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
  for (int c = 0; c < dk; ++c) {
    const float kc = k_s[lane][c];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      s[r] = fmaf(q_s[warp * kRowsPerWarp + r][c], kc, s[r]);
  }
  for (int c = 0; c < dv; ++c) {
    const float vc = v_s[lane][c];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      dp[r] = fmaf(do_s[warp * kRowsPerWarp + r][c], vc, dp[r]);
  }
  const bool kv_valid = kv0 + lane < lkv;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp * kRowsPerWarp + r;
    const bool valid = kv_valid && q0 + row < lq;
    const float p = valid ? expf(s[r] * scale - lse_s[row]) : 0.f;
    p_s[row][lane] = p;
    ds_s[row][lane] = p * (dp[r] - delta_s[row]) * scale;
  }
}

// Rows r0 .. r0+n_rows-1 of a (rows, width) tensor starting at row `row0`,
// as f32, into dst; rows at or past `limit` read as zeros.
template <int W, typename T>
__device__ __forceinline__ void load_rows(float (*dst)[W], const T* src,
                                          long long row0, int r0, int n_rows,
                                          int limit, int width) {
  for (int i = threadIdx.x; i < n_rows * width; i += kThreads) {
    const int r = i / width, c = i % width;
    dst[r][c] = r0 + r < limit ? to_f32(src[(row0 + r0 + r) * width + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ d_o,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk_out, T* __restrict__ dv_out, int lq, int lkv,
                int dk, int dv, float scale) {
  __shared__ float k_s[kBKV][kMaxD + 1];  // +1: lanes read distinct banks
  __shared__ float v_s[kBKV][kMaxD + 1];
  __shared__ float q_s[kBQ][kMaxD];
  __shared__ float do_s[kBQ][kMaxD];
  __shared__ float p_s[kBQ][kBKV];
  __shared__ float ds_s[kBQ][kBKV];
  __shared__ float lse_s[kBQ];
  __shared__ float delta_s[kBQ];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kv0 = blockIdx.y * kBKV;
  const long long q_row0 = static_cast<long long>(blockIdx.x) * lq;
  const long long kv_row0 = static_cast<long long>(blockIdx.x) * lkv;

  load_rows(k_s, k, kv_row0, kv0, kBKV, lkv, dk);
  load_rows(v_s, v, kv_row0, kv0, kBKV, lkv, dv);

  float dk_acc[kKvPerWarp][kColsPerLane], dv_acc[kKvPerWarp][kColsPerLane];
#pragma unroll
  for (int j = 0; j < kKvPerWarp; ++j)
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) dk_acc[j][c] = dv_acc[j][c] = 0.f;

  for (int q0 = 0; q0 < lq; q0 += kBQ) {
    __syncthreads();  // k_s/v_s written; the previous q tile fully consumed
    load_rows(q_s, q, q_row0, q0, kBQ, lq, dk);
    load_rows(do_s, d_o, q_row0, q0, kBQ, lq, dv);
    if (threadIdx.x < kBQ) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < lq ? lse[q_row0 + row] : 0.f;
      delta_s[threadIdx.x] = row < lq ? delta[q_row0 + row] : 0.f;
    }
    __syncthreads();
    scores_tile(q_s, do_s, k_s, v_s, lse_s, delta_s, p_s, ds_s, q0, lq, kv0,
                lkv, dk, dv, scale);
    __syncthreads();
    const int n_q = min(kBQ, lq - q0);
    for (int r = 0; r < n_q; ++r) {
      float q_r[kColsPerLane], do_r[kColsPerLane];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int col = lane + 32 * c;
        q_r[c] = col < dk ? q_s[r][col] : 0.f;
        do_r[c] = col < dv ? do_s[r][col] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kKvPerWarp; ++j) {
        const float pj = p_s[r][warp * kKvPerWarp + j];
        const float dsj = ds_s[r][warp * kKvPerWarp + j];
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          dv_acc[j][c] = fmaf(pj, do_r[c], dv_acc[j][c]);
          dk_acc[j][c] = fmaf(dsj, q_r[c], dk_acc[j][c]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kKvPerWarp; ++j) {
    const int row = kv0 + warp * kKvPerWarp + j;
    if (row >= lkv) continue;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int col = lane + 32 * c;
      if (col < dk) dk_out[(kv_row0 + row) * dk + col] = from_f32<T>(dk_acc[j][c]);
      if (col < dv) dv_out[(kv_row0 + row) * dv + col] = from_f32<T>(dv_acc[j][c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ d_o,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq_out, int lq, int lkv, int dk, int dv,
              float scale) {
  __shared__ float k_s[kBKV][kMaxD + 1];
  __shared__ float v_s[kBKV][kMaxD + 1];
  __shared__ float q_s[kBQ][kMaxD];
  __shared__ float do_s[kBQ][kMaxD];
  __shared__ float p_s[kBQ][kBKV];
  __shared__ float ds_s[kBQ][kBKV];
  __shared__ float lse_s[kBQ];
  __shared__ float delta_s[kBQ];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.y * kBQ;
  const long long q_row0 = static_cast<long long>(blockIdx.x) * lq;
  const long long kv_row0 = static_cast<long long>(blockIdx.x) * lkv;

  load_rows(q_s, q, q_row0, q0, kBQ, lq, dk);
  load_rows(do_s, d_o, q_row0, q0, kBQ, lq, dv);
  if (threadIdx.x < kBQ) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < lq ? lse[q_row0 + row] : 0.f;
    delta_s[threadIdx.x] = row < lq ? delta[q_row0 + row] : 0.f;
  }

  float dq_acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) dq_acc[r][c] = 0.f;

  for (int kv0 = 0; kv0 < lkv; kv0 += kBKV) {
    __syncthreads();  // q_s/do_s written; the previous kv tile fully consumed
    load_rows(k_s, k, kv_row0, kv0, kBKV, lkv, dk);
    load_rows(v_s, v, kv_row0, kv0, kBKV, lkv, dv);
    __syncthreads();
    scores_tile(q_s, do_s, k_s, v_s, lse_s, delta_s, p_s, ds_s, q0, lq, kv0,
                lkv, dk, dv, scale);
    __syncwarp();  // a warp reads back only the ds_s rows it wrote
    const int n_kv = min(kBKV, lkv - kv0);
    for (int j = 0; j < n_kv; ++j) {
      float kj[kColsPerLane];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int col = lane + 32 * c;
        kj[c] = col < dk ? k_s[j][col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float dsj = ds_s[warp * kRowsPerWarp + r][j];
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c)
          dq_acc[r][c] = fmaf(dsj, kj[c], dq_acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= lq) continue;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int col = lane + 32 * c;
      if (col < dk) dq_out[(q_row0 + row) * dk + col] = from_f32<T>(dq_acc[r][c]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* d_o, const void* lse, void* delta, void* dq,
                   void* dk_out, void* dv_out, int batch, int lq, int lkv,
                   int dk, int dv, float scale, cudaStream_t s) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(o);
  const T* do_ = static_cast<const T*>(d_o);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);
  const long long rows = static_cast<long long>(batch) * lq;
  delta_kernel<T><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kThreads, 0, s>>>(
      o_, do_, delta_, rows, dv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<T><<<dim3(batch, (lkv + kBKV - 1) / kBKV), kThreads, 0, s>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<T*>(dk_out),
      static_cast<T*>(dv_out), lq, lkv, dk, dv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T><<<dim3(batch, (lq + kBQ - 1) / kBQ), kThreads, 0, s>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<T*>(dq), lq, lkv, dk, dv,
      scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// `delta` is f32 scratch of batch * lq elements that the caller allocates.
// Launches the three kernels on `stream` of `device` without synchronising;
// returns the cudaError_t of the first launch that fails (0 on success), or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int ieagan_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* o, const void* d_o,
                                    const void* lse, void* delta, void* dq,
                                    void* dk_out, void* dv_out, int batch,
                                    int lq, int lkv, int dk, int dv,
                                    float scale, int dtype, int device,
                                    void* stream) {
  if (batch <= 0 || lq <= 0 || lkv <= 0 || dk <= 0 || dv <= 0 || dk > kMaxD ||
      dv > kMaxD || (lq + kBQ - 1) / kBQ > 65535 || (lkv + kBKV - 1) / kBKV > 65535 ||
      (static_cast<long long>(batch) * lq + kWarps - 1) / kWarps > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(q, k, v, o, d_o, lse, delta, dq, dk_out, dv_out, batch,
                        lq, lkv, dk, dv, scale, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, o, d_o, lse, delta, dq, dk_out,
                                dv_out, batch, lq, lkv, dk, dv, scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

extern "C" const char* ieagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
