// int8-weight matmul for Hopper (sm_90a): y = x @ (W_int8 * scale[col])^T,
// K9 of the port.
//
// Replaces the Pallas kernel bdm_db1_tpu/ops/quant_matmul.py quant_matmul
// (:125, call :150, body _qmm_kernel :101, tiles select_blocks :53).
// Contract: x [R, K] bf16 (the compute dtype), W [N, K] int8 (the torch
// [out, in] layout), scale [N] f32; y [R, N] f32 = sum_k x[r, k] * W[n, k],
// accumulated in f32, times scale[n] once at the end. int8 -> bf16 is exact,
// so every product is exact in f32 and only the order of the sums differs
// from the plain version.
//
// What bounds it on an H100: at the decode rows (R = 56, one q == 1
// forward of the 56-env batch) bytes, the weight stream (1 byte/element,
// 4.2 to 16.8 MB per trunk matrix); at a 256-token prompt slice (R = 14336)
// operations, 2 * R * K * N (up to 481 GFLOP per call). The design: a tiled
// GEMM on the tensor cores (nvcuda::wmma bf16 m16n16k16, f32 accumulators).
// Each block owns a BM x BN output tile and walks K in BK steps through a
// ring of STAGES shared-memory stages filled by cp.async (16-byte copies,
// zero-filled past the edges), so STAGES - 1 steps of x and of the raw int8
// weight are in flight while the tensor cores work: device memory sees the
// weight at 1 byte/element. Each step converts its int8 weight tile to bf16
// in shared memory (exact) before the products. select_blocks' principle
// carries over, not its tile sizes: every m-tile re-streams the whole
// weight, so at R <= 64 all rows share one m-tile, with narrow (BN = 32)
// column tiles so that N / 32 blocks stream the weight once per call; larger
// R takes BM = BN = 128. The per-column scale is applied once in the
// epilogue, which stages each 16 x 16 accumulator through shared memory to
// mask the ragged rows and columns.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int THREADS = 256;     // 8 warps
constexpr int K_ALIGN = 32;      // K must be a multiple of this
constexpr int SMALL_R = 64;      // rows up to which one m-tile holds them all

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: nothing is read, the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 int8 -> 16 bf16 (exact) into dst (16-byte aligned)
__device__ __forceinline__ void int8x16_to_bf16(const uint4& raw, __nv_bfloat16* dst) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
  uint4 out[2];
  uint32_t* w = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    __nv_bfloat162 pair = __floats2bfloat162_rn(static_cast<float>(e[2 * i]),
                                                static_cast<float>(e[2 * i + 1]));
    w[i] = *reinterpret_cast<uint32_t*>(&pair);
  }
  reinterpret_cast<uint4*>(dst)[0] = out[0];
  reinterpret_cast<uint4*>(dst)[1] = out[1];
}

template <int BM_, int BN_, int BK_, int STAGES_, int WARPS_M_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = 8 / WARPS_M_;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;   // warp tile
  static constexpr int FM = WM / 16, FN = WN / 16;             // 16 x 16 fragments
  static constexpr int LDS = BK + 8;         // bf16 row stride: no bank conflicts
  static constexpr int XV = BM * BK / 8;     // 16-byte x copies per step
  static constexpr int WV = BN * BK / 16;    // 16-byte W copies per step
  static constexpr int X_BYTES = BM * LDS * 2;
  static constexpr int WQ_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = X_BYTES + WQ_BYTES;
  static constexpr int WB_BYTES = BN * LDS * 2;
  static constexpr int LOOP_BYTES = STAGES * STAGE_BYTES + WB_BYTES;
  static constexpr int SMEM = LOOP_BYTES > 8 * 256 * 4 ? LOOP_BYTES : 8 * 256 * 4;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile");
  static_assert(X_BYTES % 128 == 0 && WQ_BYTES % 128 == 0, "stage alignment");
};

using SmallCfg = Cfg<64, 32, 64, 8, 4>;     // R <= 64
using LargeCfg = Cfg<128, 128, 64, 3, 2>;   // R > 64

template <typename C>
__global__ void __launch_bounds__(THREADS, 2) qmm_kernel(
    const __nv_bfloat16* __restrict__ x,   // [R, K]
    const int8_t* __restrict__ w,          // [N, K]
    const float* __restrict__ scale,       // [N]
    float* __restrict__ y,                 // [R, N]
    int R, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(smem + C::STAGES * C::STAGE_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int nk = (K + C::BK - 1) / C::BK;

  // copy step kt of x [BM, BK] and of the raw W [BN, BK] into stage s
  auto load_stage = [&](int kt, int s) {
    unsigned char* st = smem + s * C::STAGE_BYTES;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st);
    int8_t* wq = reinterpret_cast<int8_t*>(st + C::X_BYTES);
    const int k0 = kt * C::BK;
    for (int v = tid; v < C::XV; v += THREADS) {
      const int r = v / (C::BK / 8), c = (v % (C::BK / 8)) * 8;
      const bool ok = m0 + r < R && k0 + c < K;
      cp_async16(xs + r * C::LDS + c, ok ? x + (size_t)(m0 + r) * K + k0 + c : x, ok);
    }
    for (int v = tid; v < C::WV; v += THREADS) {
      const int r = v / (C::BK / 16), c = (v % (C::BK / 16)) * 16;
      const bool ok = n0 + r < N && k0 + c < K;
      cp_async16(wq + r * C::BK + c, ok ? w + (size_t)(n0 + r) * K + k0 + c : w, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::FM][C::FN];
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<C::STAGES - 2>();     // this thread's copies of step kt landed
    __syncthreads();                    // everyone's; and step kt - 1 is done
    const int nxt = kt + C::STAGES - 1;
    if (nxt < nk) load_stage(nxt, nxt % C::STAGES);   // into the stage of step kt - 1
    cp_async_commit();
    const unsigned char* st = smem + (kt % C::STAGES) * C::STAGE_BYTES;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st);
    const int8_t* wq = reinterpret_cast<const int8_t*>(st + C::X_BYTES);
    for (int v = tid; v < C::WV; v += THREADS) {
      const int r = v / (C::BK / 16), c = (v % (C::BK / 16)) * 16;
      int8x16_to_bf16(*reinterpret_cast<const uint4*>(wq + r * C::BK + c), wb + r * C::LDS + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[C::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[C::FN];
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm * C::WM + i * 16) * C::LDS + kk, C::LDS);
#pragma unroll
      for (int j = 0; j < C::FN; ++j)
        wmma::load_matrix_sync(b[j], wb + (wn * C::WN + j * 16) * C::LDS + kk, C::LDS);
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
#pragma unroll
        for (int j = 0; j < C::FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: each warp stages one 16 x 16 accumulator at a time in its own
  // 1 KB of shared memory (the stages are free now), then writes the rows
  // and columns inside [R, N] times their column scale
  float* cs = reinterpret_cast<float*>(smem) + warp * 256;
#pragma unroll
  for (int i = 0; i < C::FM; ++i) {
#pragma unroll
    for (int j = 0; j < C::FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * C::WM + i * 16, c0 = n0 + wn * C::WN + j * 16;
#pragma unroll
      for (int e = lane; e < 256; e += 32) {
        const int r = r0 + (e >> 4), c = c0 + (e & 15);
        if (r < R && c < N) y[(size_t)r * N + c] = cs[e] * scale[c];
      }
      __syncwarp();
    }
  }
}

template <typename C>
cudaError_t launch(const void* x, const void* w, const void* scale, void* y,
                   int R, int K, int N, cudaStream_t st) {
  static bool smem_set = false;   // above 48 KB only after this attribute
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        qmm_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((N + C::BN - 1) / C::BN, (R + C::BM - 1) / C::BM);
  qmm_kernel<C><<<grid, THREADS, C::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(y), R, K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bdm_qmm_k_align() { return K_ALIGN; }

const char* bdm_qmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// y [R, N] f32 = (x [R, K] bf16 @ W [N, K] int8 ^T) * scale [N] f32.
// K must be a multiple of K_ALIGN; R and N are any positive sizes.
int bdm_quant_matmul(const void* x, const void* w, const void* scale,
                     void* y, int R, int K, int N, int device, void* stream) {
  if (R < 1 || N < 1 || K < K_ALIGN || K % K_ALIGN ||
      (R + LargeCfg::BM - 1) / LargeCfg::BM > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return R <= SMALL_R ? launch<SmallCfg>(x, w, scale, y, R, K, N, st)
                      : launch<LargeCfg>(x, w, scale, y, R, K, N, st);
}

}  // extern "C"
