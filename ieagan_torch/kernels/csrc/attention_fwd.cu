// Fused attention forward (B1) for Hopper (sm_90a): o = softmax(scale * q k^T) v
// and the f32 row statistic lse = m + log(l), per batch entry b:
//   q (B, Lq, dk), k (B, Lkv, dk), v (B, Lkv, dv) -> o (B, Lq, dv), lse (B, Lq)
// Inputs are f32 or bf16 (o takes their type); softmax statistics and all
// accumulation are f32. dk, dv <= 256, any Lq, Lkv. Row-major, contiguous.
//
// Replaces ieagan_tpu/ops/pallas/flash_attention.py::_fwd_kernel (launched by
// _fwd), which keeps the whole kv (padded to 8) in VMEM and does one pass per
// q tile with f32 products on the MXU.
//
// Bound, on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 and 495 TF32 on the
// tensor cores, so 165 TFLOP/s for f32-accurate split-TF32):
//   * D's image attention in the train step (B = 40, Lq = 3072, Lkv = 768,
//     dk = 32, dv = 128, scale 1): 2*B*Lq*Lkv*(dk + dv) = 3.0e10 FLOP, against
//     ~0.1 GB (f32) of q, k, v, o: operations bound, 0.18 ms in split-TF32 and
//     0.031 ms in bf16;
//   * the relational-reasoning sites (Lq = Lkv = 40, d = 64 or 128) are ~1
//     MFLOP per head: one launch costs more than the work, so one launch covers
//     all events and heads (the batch is the grid's x axis).
//
// Design (FA2 on mma.sync):
//   * one block of 4 warps owns 64 q rows, 16 per warp; the grid is
//     (B, ceil(Lq / 64));
//   * q is loaded once; its A fragments are split (f32) or loaded (bf16) into
//     registers once where they fit (f32 dk <= 32, all bf16), else re-read
//     from shared memory and split per kv tile;
//   * k and v stream in tiles of 64 rows through a 2-stage cp.async ring in
//     dynamic shared memory (16-byte copies; rows past Lkv and columns past the
//     head width are zero-filled by the src-size-0 form);
//   * s = q k^T on the tensor cores: bf16 mma.sync.m16n8k16 fed by ldmatrix;
//     f32 as split-TF32, three mma.sync.m16n8k8.tf32 per k step (big·big +
//     big·small + small·big), never single-pass TF32 (mma_tile.cuh says why);
//   * online softmax in registers: row max and sum over the quad by shuffles,
//     exp2f with log2(e) folded into the scale, columns past Lkv at -inf;
//   * p·v: the s accumulators become the A operand in registers -- packed to
//     bf16 (bf16), or split with the k order permuted to the accumulator's
//     column order (f32), so no shuffle and no trip through shared memory;
//     each tile's p·v is summed in a fresh partial and added to o in f32
//     (mma_acc_b says why);
//   * epilogue: o / l in the input type, lse = m + log l in f32 for B2; q rows
//     past Lq are computed on zeros and never stored.
// Head widths are padded to 32, 64 or 128 (zero columns change no product) and
// each padded pair has its own instance (IEAGAN_ATTENTION_WIDTHS).
//
// (64, 256), B1's own instance (the last case of dispatch): BigGAN-deep's G
// self-attention at 64x64 over 512 channels (B = images, Lq 4096, Lkv 1024,
// dk 64, dv 256). Under the (256, 256) instance q·kᵀ ran four times its width
// in each of o's two column tiles; here it runs at 64, and o is still
// computed in two column tiles of 128, as below. Its layout is the (64, 128)
// instance's: two ring stages in f32 and bf16.
//
// Width 256 (D's proxy RRM, 4 heads of 256 at L = 40 or 80: ~10 MFLOP, bound
// by the launch): one (256, 256) instance. A 64 x 256 f32 accumulator would
// take 128 registers a thread on 4 warps before any score, so o is computed
// in two column tiles of 128, one per blockIdx.z, each recomputing the
// scores over all of dk; only the tile's v columns are loaded. In f32 the q
// tile, a k tile and a v column tile (166 KB) leave no room for a second ring
// stage under the 227 KB a block may take, so that instance streams k and v
// through one stage (FwdLayout); bf16 keeps two. q's fragments stay in
// shared memory at dk 256 in bf16 (64 registers otherwise).
//
// Rounding against the Pallas kernel: in f32 both sum f32-accurate products in
// different orders. In bf16 the Pallas kernel widens q, k, v to f32 and keeps
// p in f32 (flash_attention.py:63-75); here q k^T is a bf16 product with f32
// accumulation (exact products), and p is rounded to bf16 before p·v, as FA2
// does: o moves by about 2^-9 of its size, inside the bf16 tolerance.

#include "mma_tile.cuh"

namespace {

using namespace ieagan;

template <typename T, int DK, int DV>
struct FwdLayout {
  static constexpr int kCols = col_tile(DV);  // o's columns per block
  static constexpr int kSK = row_stride<T>(DK);
  static constexpr int kSV = row_stride<T>(kCols);
  static constexpr int kQ = kTile * kSK;              // q tile, elements
  static constexpr int kStage = kTile * (kSK + kSV);  // k tile then v's column tile
  static constexpr int kStages =
      (kQ + 2 * kStage) * static_cast<int>(sizeof(T)) <= kMaxSmemBytes ? 2 : 1;
  static constexpr int kBytes = (kQ + kStages * kStage) * static_cast<int>(sizeof(T));
};

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, int lq, int lkv, int dk, int dv,
                         float scale, bool vec) {
  using L = FwdLayout<T, DK, DV>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int SK = L::kSK, SV = L::kSV, DC = L::kCols;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* ring = q_s + L::kQ;

  const int warp = threadIdx.x / 32, g = lane_g(), t = lane_t();
  const int q0 = blockIdx.y * kTile;
  const int c0 = blockIdx.z * DC;  // the block's first column of v and o
  const long long bq = static_cast<long long>(blockIdx.x) * lq;
  const long long bkv = static_cast<long long>(blockIdx.x) * lkv;
  const T* k_b = k + bkv * dk;
  const T* v_b = v + bkv * dv + c0;
  const int n_tiles = (lkv + kTile - 1) / kTile;

  load_tile<T, DK>(q_s, q + bq * dk, q0, lq, dk, vec);
  cp_async_commit();
  load_tile<T, DK>(ring, k_b, 0, lkv, dk, vec);
  load_tile<T, DC>(ring + kTile * SK, v_b, 0, lkv, dv - c0, vec, dv);
  cp_async_commit();
  cp_async_wait<1>();  // q has landed; kv tile 0 may be in flight
  __syncthreads();

  // q's A operand for the warp's 16 rows, once.
  constexpr bool kQRegs = kF32 ? DK <= 32 : DK <= 128;
  constexpr int kQSteps = kF32 ? DK / 8 : DK / 16;
  SplitA qa_f32[kF32 && kQRegs ? kQSteps : 1];
  uint32_t qa_bf16[!kF32 && kQRegs ? kQSteps : 1][4];
  if constexpr (kF32 && kQRegs) {
#pragma unroll
    for (int kk = 0; kk < kQSteps; ++kk) qa_f32[kk] = a_rows_f32<SK>(q_s, 16 * warp, 8 * kk);
  } else if constexpr (!kF32 && kQRegs) {
#pragma unroll
    for (int kk = 0; kk < kQSteps; ++kk) a_rows_bf16<SK>(qa_bf16[kk], q_s, 16 * warp, 16 * kk);
  }

  const float c = scale * kLog2e;  // scores in the log2 domain
  float acc[DC / 8][4] = {};
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  auto load_kv = [&](int slot, int kv0) {
    T* stage = ring + slot * L::kStage;
    load_tile<T, DK>(stage, k_b, kv0, lkv, dk, vec);
    load_tile<T, DC>(stage + kTile * SK, v_b, kv0, lkv, dv - c0, vec, dv);
  };
  for (int it = 0; it < n_tiles; ++it) ring_step<L::kStages>(it, n_tiles, load_kv, [&](int slot) {
    const int kv0 = it * kTile;
    const T* k_t = ring + slot * L::kStage;
    const T* v_t = k_t + kTile * SK;

    // s = q k^T for the warp's 16 rows and the tile's 64 kv columns.
    float s[8][4] = {};
    if constexpr (kF32 && kQRegs)
      mma_abt<DK, SK>(s, qa_f32, k_t, 0);
    else if constexpr (kQRegs)
      mma_abt<DK, SK>(s, qa_bf16, k_t, 0);
    else
      mma_abt<DK, SK>(s, q_s, 16 * warp, k_t, 0);

    // Online softmax. Column kv0 is always valid, so the new max is finite
    // and alpha = exp2(-inf) = 0 on the first tile.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + 8 * n + 2 * t + (e & 1);
        s[n][e] = col < lkv ? s[n][e] * c : -CUDART_INF_F;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];  // a partial sum per thread; the quad adds up at the end
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - mx[e / 2]);
        l[e / 2] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    mma_acc_b<DC, SV>(acc, s, v_t, 0);  // o += p v
  });

  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv_l[r] = 1.f / l[r];
  }
  const int row0 = q0 + 16 * warp;
  store_rows<T, DC>(o + bq * dv + c0, acc, row0, lq, dv - c0, inv_l, dv);
  if (t == 0 && blockIdx.z == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + g + 8 * r < lq) lse[bq + row0 + g + 8 * r] = m[r] * kLn2 + logf(l[r]);
  }
}

template <typename T, int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                   int lq, int lkv, int dk, int dv, float scale, bool vec, int device,
                   cudaStream_t s) {
  using L = FwdLayout<T, DK, DV>;
  static bool smem_set[kMaxDevices] = {};
  const cudaError_t err =
      allow_smem(attention_fwd_kernel<T, DK, DV>, L::kBytes, device, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch, (lq + kTile - 1) / kTile, DV / L::kCols);
  attention_fwd_kernel<T, DK, DV><<<grid, kThreads, L::kBytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), lq, lkv, dk, dv, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                     int lq, int lkv, int dk, int dv, int pk, int pv, float scale, int device,
                     cudaStream_t s) {
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) && dk * sizeof(T) % 16 == 0 &&
                   dv * sizeof(T) % 16 == 0;
#define IEAGAN_CASE(DK, DV)                                                              \
  if (pk == DK && pv == DV)                                                              \
    return launch<T, DK, DV>(q, k, v, o, lse, batch, lq, lkv, dk, dv, scale, vec, device, s);
  IEAGAN_ATTENTION_WIDTHS(IEAGAN_CASE)
  IEAGAN_CASE(64, 256)
#undef IEAGAN_CASE
  return cudaErrorInvalidValue;  // a pair with no instance
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// (pk, pv) is the instance, flash_attention.py::fwd_pair(dk, dv). Launches on
// `stream` of `device` without synchronising; returns the cudaError_t of the
// launch (0 on success), or cudaErrorInvalidValue for arguments the kernel
// does not take.
extern "C" int ieagan_attention_fwd(const void* q, const void* k, const void* v,
                                    void* o, void* lse, int batch, int lq,
                                    int lkv, int dk, int dv, int pk, int pv,
                                    float scale, int dtype, int device, void* stream) {
  if (batch <= 0 || lq <= 0 || lkv <= 0 || dk <= 0 || dv <= 0 || dk > pk || dv > pv ||
      (lq + kTile - 1) / kTile > 65535 || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch<float>(q, k, v, o, lse, batch, lq, lkv, dk, dv, pk, pv, scale, device, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, o, lse, batch, lq, lkv, dk, dv, pk, pv, scale,
                                  device, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* ieagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
