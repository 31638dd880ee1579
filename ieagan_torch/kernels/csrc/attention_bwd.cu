// Fused attention backward (B2) for Hopper (sm_90a). For each batch entry b,
// with p = exp(scale * q k^T - lse) recomputed from the forward's f32 row
// statistic lse (B1, attention_fwd.cu):
//   dV = p^T dO
//   delta = rowsum(dO * O)                         (f32, from O in its type)
//   dS = p * (dO v^T - delta) * scale
//   dQ = dS k,  dK = dS^T q
// q (B, Lq, dk), k (B, Lkv, dk), v (B, Lkv, dv), o and dO (B, Lq, dv), lse and
// delta (B, Lq) f32. Inputs are f32 or bf16; dq, dk, dv take their type. All
// accumulation is f32. dk, dv <= 128, any Lq, Lkv. Row-major, contiguous.
//
// Replaces ieagan_tpu/ops/pallas/flash_attention.py::_bwd_kernel (launched by
// _bwd, bound to the forward by defvjp). That kernel keeps the whole padded q,
// o, dO and dq of a batch entry in VMEM and walks q tiles in order, carrying
// dK and dV from tile to tile -- ~3.9 MB at D's image-attention site, while a
// block has 227 KB of shared memory and blocks run in parallel, in no order.
//
// Bound, on an H100 SXM: at the image-attention site in the train step
// (B = 40, Lq = 3072, Lkv = 768, dk = 32, dv = 128) the least work is the five
// products, 2*B*Lq*Lkv*(3*dk + 2*dv) = 6.6e10 FLOP: 0.40 ms at the 165 TFLOP/s
// of f32-accurate split-TF32 (495 / 3), 0.067 ms in bf16 at 989 TFLOP/s,
// against ~0.14 GB (f32) of inputs and outputs, 0.04 ms at 3.35 TB/s. So it
// is bound by operations. At the relational-reasoning sites (Lq = Lkv = 40)
// the work is under 10 MFLOP and the call is launch-bound: one C call
// launches two kernels back to back on the caller's stream.
//
// Design: FA2's split in three passes, no atomics, a deterministic result
// (each output element is summed by one thread in a fixed order). The second
// and third pass share one launch (bwd_kernel), so one call launches two
// kernels:
//   1. delta_kernel: one warp per q row, delta = rowsum(dO * O) (bytes-bound);
//   2. dkdv_block: one block of 4 warps owns 64 kv rows (16 per warp) and
//      walks q tiles of 64 rows, with q, dO, lse and delta in a cp.async ring
//      of two stages, or of one where two stages would keep a second block
//      off the SM (BwdLayout). It works transposed, so its kv rows are the M dimension
//      of every product: s^T = k q^T, p^T = exp(scale s^T - lse),
//      dP^T = v dO^T, dS^T = p^T (dP^T - delta) scale, then dV += p^T dO and
//      dK += dS^T q in f32 registers. Each q tile is taken in two halves of
//      32 columns, which keeps dk = dv = 128 in f32 inside the register file;
//   3. dq_block: one block owns 64 q rows and walks kv tiles of 64 through
//      the ring: s, p, dP, dS, then dQ += dS k.
// Every product runs on the tensor cores on the skeleton of B1 (mma_tile.cuh):
// f32 as split-TF32 (three m16n8k8.tf32 per step, p and dS split too), bf16
// as m16n8k16 with ldmatrix. p^T and dS^T (dS) become A operands straight
// from their accumulators. Widths are padded to 32, 64 or 128 as in B1. The
// price of no atomics is that s = q k^T is recomputed in both kernels (seven
// products instead of five).
//
// Each kernel adds every 32-column half's products to its f32 accumulators
// through a fresh partial (mma_acc_b): the tensor cores' truncating
// accumulation, straight over Lq = 3072 rows, drifts past the f32 tolerance.
//
// Rounding against the Pallas kernel: the Pallas backward keeps p and dS in
// f32 (flash_attention.py:113-160). The f32 instances split both, as every
// f32 operand. The bf16 instances take p and dS as bf16 hi + lo pairs (two
// bf16 products each, ~2^-17 of the value) for dV, dK and dQ, not rounded
// to bf16 as FA2 rounds them: dK sums up to Lq = 3072 terms of dS q, and one
// bf16 rounding of each (2^-9) is too coarse for the bf16 tolerance
// (mma_acc_b says why).

#include "mma_tile.cuh"

namespace {

using namespace ieagan;

template <typename T, int DK, int DV>
struct BwdLayout {
  static constexpr int kSK = row_stride<T>(DK);
  static constexpr int kSV = row_stride<T>(DV);
  // The block's own rows (k and v, or q and dO), then the ring, whose stages
  // hold the streamed rows (q and dO, or k and v) and, for dK/dV, their lse
  // and delta.
  static constexpr int kOwnBytes = kTile * (kSK + kSV) * static_cast<int>(sizeof(T));
  static constexpr int kStatBytes = 2 * kTile * static_cast<int>(sizeof(float));
  static constexpr int kStageBytes = kOwnBytes + kStatBytes;
  // Two stages, unless that keeps a second block off the SM and one stage
  // does not (f32 at dk + dv = 160: 130 KB against 87 KB). Two resident
  // blocks overlap one's loads with the other's products as a second stage
  // would, and give the SM 8 warps instead of 4.
  static constexpr int kStages =
      kOwnBytes + 2 * kStageBytes > kTwoBlockBytes && kOwnBytes + kStageBytes <= kTwoBlockBytes
          ? 1
          : 2;
  static constexpr int kBytes = kOwnBytes + kStages * kStageBytes;
};

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
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// dK and dV of kv rows 64 * tile .. 64 * tile + 63 of batch entry blockIdx.x.
template <typename T, int DK, int DV>
__device__ __noinline__ void dkdv_block(unsigned char* smem, int tile, const T* q, const T* k,
                                           const T* v, const T* d_o, const float* lse,
                                           const float* delta, T* dk_out, T* dv_out, int lq,
                                           int lkv, int dk, int dv, float scale, bool vec) {
  using L = BwdLayout<T, DK, DV>;
  constexpr int SK = L::kSK, SV = L::kSV;
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kTile * SK;
  unsigned char* ring = smem + L::kOwnBytes;
  auto stage_q = [&](int i) { return reinterpret_cast<T*>(ring + i * L::kStageBytes); };
  auto stage_stats = [&](int i) {
    return reinterpret_cast<float*>(ring + i * L::kStageBytes + L::kOwnBytes);
  };

  const int warp = threadIdx.x / 32, t = lane_t();
  const int kv0 = tile * kTile;
  const long long bq = static_cast<long long>(blockIdx.x) * lq;
  const long long bkv = static_cast<long long>(blockIdx.x) * lkv;
  const T* q_b = q + bq * dk;
  const T* do_b = d_o + bq * dv;
  const float* lse_b = lse + bq;
  const float* delta_b = delta + bq;
  const int n_tiles = (lq + kTile - 1) / kTile;

  auto load_stage = [&](int i, int q0) {
    T* q_t = stage_q(i);
    float* st = stage_stats(i);
    load_tile<T, DK>(q_t, q_b, q0, lq, dk, vec);
    load_tile<T, DV>(q_t + kTile * SK, do_b, q0, lq, dv, vec);
    load_stats(st, lse_b, q0, lq);
    load_stats(st + kTile, delta_b, q0, lq);
  };

  load_tile<T, DK>(k_s, k + bkv * dk, kv0, lkv, dk, vec);
  load_tile<T, DV>(v_s, v + bkv * dv, kv0, lkv, dv, vec);
  load_stage(0, 0);
  cp_async_commit();

  const float c = scale * kLog2e;
  float dk_acc[DK / 8][4] = {}, dv_acc[DV / 8][4] = {};
  for (int it = 0; it < n_tiles; ++it) ring_step<L::kStages>(it, n_tiles, load_stage, [&](int slot) {
    const int q0 = it * kTile;
    const T* q_t = stage_q(slot);
    const T* do_t = q_t + kTile * SK;
    const float* lse_t = stage_stats(slot);
    const float* delta_t = lse_t + kTile;

#pragma unroll
    for (int h = 0; h < 2; ++h) {  // 32 q columns at a time
      const int qc0 = 32 * h;
      float pt[4][4] = {}, dst[4][4] = {};  // p^T, then dS^T; dP^T first
      mma_abt<DK, SK>(pt, k_s, 16 * warp, q_t, qc0);   // s^T = k q^T
      mma_abt<DV, SV>(dst, v_s, 16 * warp, do_t, qc0);  // dP^T = v dO^T
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = qc0 + 8 * n + 2 * t + (e & 1);  // q row in the tile
          const float p = q0 + col < lq ? exp2f(pt[n][e] * c - lse_t[col] * kLog2e) : 0.f;
          pt[n][e] = p;
          dst[n][e] = p * (dst[n][e] - delta_t[col]) * scale;
        }
      mma_acc_b<DV, SV, 4, true>(dv_acc, pt, do_t, qc0);  // dV += p^T dO
      mma_acc_b<DK, SK, 4, true>(dk_acc, dst, q_t, qc0);  // dK += dS^T q
    }
  });

  const float one[2] = {1.f, 1.f};
  const int row0 = kv0 + 16 * warp;
  store_rows<T, DK>(dk_out + bkv * dk, dk_acc, row0, lkv, dk, one);
  store_rows<T, DV>(dv_out + bkv * dv, dv_acc, row0, lkv, dv, one);
}

// dQ of q rows 64 * tile .. 64 * tile + 63 of batch entry blockIdx.x.
template <typename T, int DK, int DV>
__device__ __noinline__ void dq_block(unsigned char* smem, int tile, const T* q, const T* k,
                                         const T* v, const T* d_o, const float* lse,
                                         const float* delta, T* dq_out, int lq, int lkv, int dk,
                                         int dv, float scale, bool vec) {
  using L = BwdLayout<T, DK, DV>;
  constexpr int SK = L::kSK, SV = L::kSV;
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + kTile * SK;
  unsigned char* ring = smem + L::kOwnBytes;
  auto stage_k = [&](int i) { return reinterpret_cast<T*>(ring + i * L::kStageBytes); };

  const int warp = threadIdx.x / 32, g = lane_g(), t = lane_t();
  const int q0 = tile * kTile;
  const long long bq = static_cast<long long>(blockIdx.x) * lq;
  const long long bkv = static_cast<long long>(blockIdx.x) * lkv;
  const T* k_b = k + bkv * dk;
  const T* v_b = v + bkv * dv;
  const int n_tiles = (lkv + kTile - 1) / kTile;

  auto load_stage = [&](int i, int kv0) {
    T* k_t = stage_k(i);
    load_tile<T, DK>(k_t, k_b, kv0, lkv, dk, vec);
    load_tile<T, DV>(k_t + kTile * SK, v_b, kv0, lkv, dv, vec);
  };

  load_tile<T, DK>(q_s, q + bq * dk, q0, lq, dk, vec);
  load_tile<T, DV>(do_s, d_o + bq * dv, q0, lq, dv, vec);
  load_stage(0, 0);
  cp_async_commit();

  // The statistics of the thread's two q rows (g and g + 8 of the warp's 16).
  const int row0 = q0 + 16 * warp;
  bool row_ok[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    row_ok[r] = row < lq;
    lse_r[r] = row_ok[r] ? lse[bq + row] * kLog2e : 0.f;
    delta_r[r] = row_ok[r] ? delta[bq + row] : 0.f;
  }

  const float c = scale * kLog2e;
  float dq_acc[DK / 8][4] = {};
  for (int it = 0; it < n_tiles; ++it) ring_step<L::kStages>(it, n_tiles, load_stage, [&](int slot) {
    const int kv0 = it * kTile;
    const T* k_t = stage_k(slot);
    const T* v_t = k_t + kTile * SK;

#pragma unroll
    for (int h = 0; h < 2; ++h) {  // 32 kv columns at a time
      const int kc0 = 32 * h;
      float p[4][4] = {}, ds[4][4] = {};  // p, then dS; dP first
      mma_abt<DK, SK>(p, q_s, 16 * warp, k_t, kc0);    // s = q k^T
      mma_abt<DV, SV>(ds, do_s, 16 * warp, v_t, kc0);  // dP = dO v^T
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          const bool ok = row_ok[r] && kv0 + kc0 + 8 * n + 2 * t + (e & 1) < lkv;
          const float pe = ok ? exp2f(p[n][e] * c - lse_r[r]) : 0.f;
          ds[n][e] = pe * (ds[n][e] - delta_r[r]) * scale;
        }
      mma_acc_b<DK, SK, 4, true>(dq_acc, ds, k_t, kc0);  // dQ += dS k
    }
  });

  const float one[2] = {1.f, 1.f};
  store_rows<T, DK>(dq_out + bq * dk, dq_acc, row0, lq, dk, one);
}

// The dK/dV blocks (blockIdx.y < n_kv_tiles, each walking all of Lq) and the
// dQ blocks (the rest, each walking all of Lkv) in one launch: both need only
// delta, so they share the card -- the long dK/dV blocks are dispatched
// first and the dQ blocks fill in behind them, and at the 40-row sites the
// two single-tile blocks of an entry run side by side, not one after the
// other. The layouts are the same size, so one dynamic size serves both. The
// two bodies are not inlined, so that each gets its own register allocation:
// inlined into one function they spilled where two kernels had not.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ d_o, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dq, T* __restrict__ dk_out,
               T* __restrict__ dv_out, int lq, int lkv, int dk, int dv, float scale, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_kv_tiles = (lkv + kTile - 1) / kTile;
  if (static_cast<int>(blockIdx.y) < n_kv_tiles)
    dkdv_block<T, DK, DV>(smem, blockIdx.y, q, k, v, d_o, lse, delta, dk_out, dv_out, lq, lkv,
                          dk, dv, scale, vec);
  else
    dq_block<T, DK, DV>(smem, blockIdx.y - n_kv_tiles, q, k, v, d_o, lse, delta, dq, lq, lkv,
                        dk, dv, scale, vec);
}

template <typename T, int DK, int DV>
cudaError_t launch(const T* q, const T* k, const T* v, const T* d_o, const float* lse,
                   const float* delta, T* dq, T* dk_out, T* dv_out, int batch, int lq,
                   int lkv, int dk, int dv, float scale, bool vec, int device,
                   cudaStream_t s) {
  constexpr int kBytes = BwdLayout<T, DK, DV>::kBytes;
  static bool smem_set[kMaxDevices] = {};
  const cudaError_t err = allow_smem(bwd_kernel<T, DK, DV>, kBytes, device, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch, (lkv + kTile - 1) / kTile + (lq + kTile - 1) / kTile);
  bwd_kernel<T, DK, DV><<<grid, kThreads, kBytes, s>>>(q, k, v, d_o, lse, delta, dq, dk_out,
                                                       dv_out, lq, lkv, dk, dv, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* d_o, const void* lse, void* delta, void* dq, void* dk_out,
                     void* dv_out, int batch, int lq, int lkv, int dk, int dv, float scale,
                     int device, cudaStream_t s) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(d_o);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);
  const long long rows = static_cast<long long>(batch) * lq;
  delta_kernel<T><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kThreads, 0, s>>>(
      static_cast<const T*>(o), do_, delta_, rows, dv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(d_o) &&
                   dk * sizeof(T) % 16 == 0 && dv * sizeof(T) % 16 == 0;
  const int pk = padded_width(dk), pv = padded_width(dv);
#define IEAGAN_CASE(DK, DV)                                                                  \
  if (pk == DK && pv == DV)                                                                  \
    return launch<T, DK, DV>(q_, k_, v_, do_, lse_, delta_, static_cast<T*>(dq),            \
                             static_cast<T*>(dk_out), static_cast<T*>(dv_out), batch, lq, lkv, \
                             dk, dv, scale, vec, device, s);
  IEAGAN_ATTENTION_WIDTHS(IEAGAN_CASE)
#undef IEAGAN_CASE
  return cudaErrorInvalidValue;  // not reached: the entry admits dk, dv <= 128 only
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// `delta` is f32 scratch of batch * lq elements that the caller allocates.
// Launches the two kernels (delta, then dK/dV and dQ) on `stream` of `device`
// without synchronising; returns the cudaError_t of the first launch that
// fails (0 on success), or cudaErrorInvalidValue for arguments the kernels
// do not take.
extern "C" int ieagan_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* o, const void* d_o,
                                    const void* lse, void* delta, void* dq,
                                    void* dk_out, void* dv_out, int batch,
                                    int lq, int lkv, int dk, int dv,
                                    float scale, int dtype, int device,
                                    void* stream) {
  if (batch <= 0 || lq <= 0 || lkv <= 0 || dk <= 0 || dv <= 0 || dk > kMaxD ||
      dv > kMaxD || (lq + kTile - 1) / kTile + (lkv + kTile - 1) / kTile > 65535 ||
      (static_cast<long long>(batch) * lq + kWarps - 1) / kWarps > 0x7fffffffLL ||
      device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch<float>(q, k, v, o, d_o, lse, delta, dq, dk_out, dv_out, batch, lq, lkv, dk,
                          dv, scale, device, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, o, d_o, lse, delta, dq, dk_out, dv_out, batch, lq,
                                  lkv, dk, dv, scale, device, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* ieagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
