// int8-weight matmul for Hopper (sm_90a): y = x @ (W_int8 * scale[col])^T,
// K9 of the port.
//
// Replaces the Pallas kernel bdm_db1_tpu/ops/quant_matmul.py quant_matmul
// (:125, call :150, body _qmm_kernel :101, tiles select_blocks :53).
// Contract: x [R, K] bf16 (the compute dtype), W [N, K] int8 (the torch
// [out, in] layout), scale [N] f32; y [R, N] f32 = sum_k x[r, k] * W[n, k],
// accumulated in f32, times scale[n] once at the end. int8 -> bf16 is exact,
// so every product is exact in f32 and only the order of the sums differs
// from the plain version. K % 32 == 0; R and N of any size.
//
// What bounds it on an H100: at the decode rows (R = 56, one q == 1
// forward of the 56-env batch) bytes, the weight stream (1 byte/element,
// 4.2 to 16.8 MB per trunk matrix); at the primes (R = 1064, 1456) and a
// 256-token prompt slice (R = 14336) operations, 2 * R * K * N.
//
// The design, swap-AB on warpgroup MMA:
// * Each warpgroup computes a transposed tile D^T [64 weight rows, BN x
//   rows] = W_tile . x_tile^T. W is wgmma's A operand from registers: each
//   consumer thread reads its fragment bytes of the int8 tile from shared
//   memory (2-byte loads; the 64-byte TMA swizzle keeps them free of bank
//   conflicts) and converts them to bf16 in registers, so no bf16 copy of W
//   exists anywhere and device memory sees W at 1 byte an element. x is the
//   B operand, K-major bf16 in shared memory under the 128-byte swizzle.
//   The rows of x are wgmma's n, so the decode's 56 rows are n = 56.
// * A ring of STAGES shared-memory stages is filled by TMA
//   (cp.async.bulk.tensor: one thread of a producer warp starts a W box
//   and an x box per 64-deep K step) with full and empty mbarriers. Boxes past
//   R, N or K are zero-filled by the TMA unit.
// * R <= 64 (the weight stream bounds it; one x tile of n = 56 or 64): a
//   CTA holds 64 W rows and four consumer warpgroups, each taking every
//   fourth K step (a "way") and reading its next step's fragments while
//   this step's products run; the ways' sums meet in shared memory, in way
//   order. Where K is long enough (ops/quant_matmul.py plan_quant_matmul),
//   it is split further across a thread-block cluster of S <= 8 CTAs: each
//   leaves its f32 partial in its own shared memory and, after a cluster
//   barrier, CTA s sums a 1/S share of the tile's elements over the S
//   partials in the fixed order 0 .. S - 1 through distributed shared
//   memory. One launch, no workspace, no atomics: the same inputs always
//   give the same bits.
// * R > 64 (operations bound it): 128 W rows (two consumer warpgroups) x
//   BN x rows a CTA, BN one of a few compiled widths the planner picks so
//   that ragged R wastes little (1064 rows are 8 tiles of 136). The
//   producer is a whole warpgroup that gives its registers to the
//   consumers (setmaxnreg 40 / 232).
// * Epilogue: straight from the accumulators, times scale[n]: each store
//   instruction of a warp writes 4 x rows x 8 consecutive W columns, whole
//   32-byte sectors of y; ragged R and N are masked.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below). The
// tensor maps are encoded on the host by cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint(ByVersion), so nothing links libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <unordered_map>

namespace {

constexpr int K_ALIGN = 32;      // K must be a multiple of this
constexpr int BK = 64;           // K elements a stage (128 bytes of x)
constexpr int MAX_SPLIT = 8;     // K splits a tile: CTAs a cluster (portable)

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c_inner, int c_outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c_inner), "r"(c_outer)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int REGS>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// every thread of every CTA of the cluster; orders shared-memory writes
// before the other CTAs' reads
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the f32 at this CTA's shared address `saddr` in CTA `rank` of the cluster
__device__ __forceinline__ float ld_cluster_f32(uint32_t saddr, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(saddr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wgmma descriptor of a K-major bf16 tile under the 128-byte swizzle: rows
// of 128 bytes, 8-row groups 1024 bytes apart (SBO), layout type 1 (128B).
// The tile starts 1024-byte aligned; a k16 slice kk starts kk * 32 bytes in.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// two int8 (one 16-bit load) -> bf16x2, exact: each byte, offset to
// unsigned, is the low mantissa of 2^23 + u in f32, less 2^23 + 128
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t two) {
  const uint32_t u = two ^ 0x8080u;
  const float lo = __uint_as_float(0x4B000000u | (u & 0xFFu)) - 8388736.f;
  const float hi = __uint_as_float(0x4B000000u | ((u >> 8) & 0xFFu)) - 8388736.f;
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// ---- wgmma m64nNk16, A (bf16) from registers, B (bf16) from shared --------
// The accumulator list of each width, written out (wgmma's n is part of
// the instruction).

#define QMM_D8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define QMM_D32(i) QMM_D8(i), QMM_D8(i + 8), QMM_D8(i + 16), QMM_D8(i + 24)

template <int N>
struct Wgmma;
template <>
struct Wgmma<56> {
  __device__ __forceinline__ static void mma(float (&d)[28], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27}, "
        "{%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
        : QMM_D8(0), QMM_D8(8), QMM_D8(16), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : QMM_D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<136> {
  __device__ __forceinline__ static void mma(float (&d)[68], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67}, "
        "{%68, %69, %70, %71}, %72, p, 1, 1, 0;\n}\n"
        : QMM_D32(0), QMM_D32(32), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<208> {
  __device__ __forceinline__ static void mma(float (&d)[104], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %109, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103}, "
        "{%104, %105, %106, %107}, %108, p, 1, 1, 0;\n}\n"
        : QMM_D32(0), QMM_D32(32), QMM_D32(64), QMM_D8(96)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : QMM_D32(0), QMM_D32(32), QMM_D32(64), QMM_D32(96)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// ---- the kernel ------------------------------------------------------------

// The CTA shape of an x-row tile BN. NWG consumer warpgroups, split as MW =
// NWG / KW m64 tiles of W rows times KW ways of K: way k takes the CTA's K
// steps k, k + KW, ...; the ways' sums meet in shared memory at the end.
// Up to 64 x rows (the weight stream bounds it): 4 ways on 64 W rows, each
// warpgroup reading and converting its next step's fragments while this
// step's products run (LOOKAHEAD, a second set of fragment registers),
// and a producer warp. Wider: 2 warpgroups on 128 W rows, and a producer
// warpgroup that hands its registers to them (REGSPLIT, setmaxnreg; no
// split-K then).
template <int BN_>
struct Cfg {
  static constexpr int BN = BN_;
  static constexpr bool SMALL = BN <= 64;
  static constexpr int NWG = SMALL ? 4 : 2, KW = SMALL ? 4 : 1;
  static constexpr int STAGES = SMALL ? 12 : BN <= 136 ? 6 : 5;
  static constexpr bool LOOKAHEAD = SMALL, REGSPLIT = !SMALL;
  static constexpr int MW = NWG / KW;              // m64 tiles of W rows
  static constexpr int BM = 64 * MW;               // W rows a CTA
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int TILE_THREADS = 128 * MW;    // the threads of K way 0
  static constexpr int THREADS = CONSUMERS + (REGSPLIT ? 128 : 32);   // then the producer
  // registers a consumer thread gets from setmaxnreg: the block's share
  // (ptxas counts whole warpgroups) less the producer's 40 a thread
  static constexpr int CONSUMER_REGS =
      ((65536 / (128 * (NWG + 1)) / 8 * 8) * 128 * (NWG + 1) - 40 * 128) / CONSUMERS / 8 * 8;
  static constexpr int X_BYTES = BN * BK * 2;      // x box [BN, 64] bf16
  static constexpr int W_BYTES = BM * BK;          // W box [BM, 64] int8
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  // the ring and its 2 x STAGES barriers, and slack to align to 1 KB
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
  static_assert(NWG % KW == 0, "ways");
  static_assert(X_BYTES % 1024 == 0 && W_BYTES % 1024 == 0, "swizzle atoms");
  static_assert(BN % 8 == 0 && BN <= 256 && BM <= 256, "wgmma n, TMA box");
  static_assert(BN / 2 * CONSUMERS * 4 <= STAGES * STAGE_BYTES, "partials in the ring");
};

// A fragments of the four k16 slices of one stage's W tile: a[kk] = {(row,
// 2c..), (row + 8, 2c..), (row, 2c + 8..), (row + 8, 2c + 8..)}, bf16 pairs.
// The tile's 64-byte swizzle XORs the 16-byte chunk index with bits 7-8 of
// the offset: (row >> 1) & 3 for 64-byte rows.
__device__ __forceinline__ void load_frags(const unsigned char* wsm, int row, int c,
                                           uint32_t (&a)[4][4]) {
  const int rb = row + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const unsigned char* p0 = wsm + row * BK + 2 * c + ((kk ^ ((row >> 1) & 3)) << 4);
    const unsigned char* p1 = wsm + rb * BK + 2 * c + ((kk ^ ((rb >> 1) & 3)) << 4);
    a[kk][0] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(p0));
    a[kk][1] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(p1));
    a[kk][2] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(p0 + 8));
    a[kk][3] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(p1 + 8));
  }
}

// the four k16 products of one stage, committed as one group
template <int N>
__device__ __forceinline__ void mma_stage(float (&d)[N / 2], const uint32_t (&a)[4][4],
                                          const unsigned char* xs) {
  wgmma_fence();
  const uint64_t db = desc_sw128(smem_u32(xs));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) Wgmma<N>::mma(d, a[kk], db + 2 * kk);
  wgmma_commit();
}

// grid (ceil(N / BM), ceil(R / BN), S), clusters of (1, 1, S) when S > 1;
// split s runs the CTA's K steps [s * kps, min(nk, (s + 1) * kps)).
template <typename C>
__global__ void __launch_bounds__(C::THREADS, 1)
    qmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const float* __restrict__ scale, float* __restrict__ y, int R, int N,
                     int nk, int kps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;
  constexpr int ACC = C::BN / 2;

  const int S = gridDim.z, s = blockIdx.z;
  const int n0 = blockIdx.x * C::BM, r0 = blockIdx.y * C::BN;
  const int k_begin = s * kps;
  const int steps = min(nk, k_begin + kps) - k_begin;
  const int tid = threadIdx.x, lane = tid & 31;
  const bool consumer = tid < C::CONSUMERS;

  if (tid == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], C::MW);   // the MW warpgroups of the step's way
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // a consumer thread's K way and its W rows: row and row + 8 of the tile;
  // its x rows 8 (i >> 2) + 2c + (i & 1) for accumulator i
  const int way = (tid >> 7) / C::MW, c = lane & 3;
  const int row = ((tid >> 7) % C::MW) * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const bool lead = consumer && way == 0;   // the threads that write y
  float d[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) d[i] = 0.f;

  auto stage = [&](int i) { return base + (i % C::STAGES) * C::STAGE_BYTES; };
  auto wait_full = [&](int i) { mbar_wait(&full[i % C::STAGES], (i / C::STAGES) & 1); };
  auto release = [&](int i) {
    if ((tid & 127) == 0) mbar_arrive(&empty[i % C::STAGES]);
  };
  if (!consumer) {
    // ---- producer warp: one thread keeps the ring full ----
    if constexpr (C::REGSPLIT) reg_dealloc<40>();
    if (tid == C::CONSUMERS) {
      for (int i = 0; i < steps; ++i) {
        const int st = i % C::STAGES;
        mbar_wait(&empty[st], ((i / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], C::STAGE_BYTES);
        const int k = (k_begin + i) * BK;
        tma_load_2d(stage(i), &map_x, &full[st], k, r0);
        tma_load_2d(stage(i) + C::X_BYTES, &map_w, &full[st], k, n0);
      }
    }
    if constexpr (C::REGSPLIT) return;
    __syncwarp();
  } else if constexpr (C::LOOKAHEAD) {
    // ---- consumers, one step ahead in the fragments ----
    uint32_t fa[4][4], fb[4][4];
    if (way < steps) {
      wait_full(way);
      load_frags(stage(way) + C::X_BYTES, row, c, fa);
    }
    for (int i = way; i < steps; i += 2 * C::KW) {
      const int i1 = i + C::KW, i2 = i1 + C::KW;
      mma_stage<C::BN>(d, fa, stage(i));
      if (i1 < steps) {
        wait_full(i1);
        load_frags(stage(i1) + C::X_BYTES, row, c, fb);
      }
      wgmma_wait0();
      release(i);
      if (i1 < steps) {
        mma_stage<C::BN>(d, fb, stage(i1));
        if (i2 < steps) {
          wait_full(i2);
          load_frags(stage(i2) + C::X_BYTES, row, c, fa);
        }
        wgmma_wait0();
        release(i1);
      }
    }
  } else {
    // ---- consumers ----
    if constexpr (C::REGSPLIT) reg_alloc<C::CONSUMER_REGS>();
    for (int i = way; i < steps; i += C::KW) {
      uint32_t a[4][4];
      wait_full(i);
      load_frags(stage(i) + C::X_BYTES, row, c, a);
      mma_stage<C::BN>(d, a, stage(i));
      wgmma_wait0();
      release(i);
    }
  }

  // partials go to shared memory once the ring is drained (every step was
  // waited on), thread-major: slot j of thread t at j * threads + t
  float* part = reinterpret_cast<float*>(base);
  if constexpr (C::KW > 1) {
    // the K ways meet: way 0 adds ways 1 .. KW - 1 in order
    if (consumer) {
      named_sync(1, C::CONSUMERS);
      if (way > 0) {
#pragma unroll
        for (int i = 0; i < ACC; ++i)
          part[((way - 1) * ACC + i) * C::TILE_THREADS + tid - way * C::TILE_THREADS] = d[i];
      }
      named_sync(1, C::CONSUMERS);
      if (lead) {
        for (int k = 0; k < C::KW - 1; ++k)
#pragma unroll
          for (int i = 0; i < ACC; ++i) d[i] += part[(k * ACC + i) * C::TILE_THREADS + tid];
      }
    }
  }

  const int col0 = n0 + row, col1 = col0 + 8;
  if (!C::REGSPLIT && S > 1) {
    // split-K across the cluster: each CTA leaves its partial in its own
    // shared memory; after the cluster barrier CTA s sums the accumulators
    // i with i % S == s over the S partials in split order, through
    // distributed shared memory
    if (consumer) named_sync(1, C::CONSUMERS);   // the ways' slots are read
    if (lead) {
#pragma unroll
      for (int i = 0; i < ACC; ++i) part[i * C::TILE_THREADS + tid] = d[i];
    }
    cluster_sync();
    if (lead) {
      const float sc0 = col0 < N ? scale[col0] : 0.f, sc1 = col1 < N ? scale[col1] : 0.f;
      const uint32_t mine = smem_u32(part + tid);
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        if (i % S != s) continue;
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < MAX_SPLIT; ++t)
          if (t < S) sum += ld_cluster_f32(mine + i * C::TILE_THREADS * 4, t);
        const int r = r0 + (i >> 2) * 8 + 2 * c + (i & 1);
        const int col = (i & 2) ? col1 : col0;
        if (r < R && col < N) y[static_cast<size_t>(r) * N + col] = sum * ((i & 2) ? sc1 : sc0);
      }
    }
    cluster_sync();   // no CTA leaves while another still reads its partial
  } else if (lead) {
    // y = d * scale[col]: each store of a warp writes 4 x rows x 8
    // consecutive columns, whole 32-byte sectors
    const float sc0 = col0 < N ? scale[col0] : 0.f, sc1 = col1 < N ? scale[col1] : 0.f;
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int r = r0 + (i >> 2) * 8 + 2 * c + (i & 1);
      const int col = (i & 2) ? col1 : col0;
      if (r < R && col < N) y[static_cast<size_t>(r) * N + col] = d[i] * ((i & 2) ? sc1 : sc0);
    }
  }
}

// ---- host: tensor maps and the launch ---------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      p = nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A 2-D map [rows, inner] of 1- or 2-byte elements, densely packed, boxes
// [box_rows, 64]. A map depends only on these, so maps are
// kept by them (a cache per host thread): the weights' maps are encoded
// once, the activations' once per buffer the allocator hands out.
struct MapKey {
  const void* ptr;
  int rows, inner, box_rows, elem;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && inner == o.inner && box_rows == o.box_rows &&
           elem == o.elem;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = reinterpret_cast<size_t>(k.ptr);
    for (int v : {k.rows, k.inner, k.box_rows, k.elem}) h = h * 1000003u ^ static_cast<size_t>(v);
    return h;
  }
};

cudaError_t tensor_map(CUtensorMap* out, const void* ptr, int rows, int inner, int box_rows,
                       int elem) {
  thread_local std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{ptr, rows, inner, box_rows, elem};
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  EncodeTiledFn encode = encode_fn();
  if (!encode) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * elem};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  CUtensorMap map;
  const CUresult rc = encode(
      &map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
      const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      elem == 2 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, map);
  *out = map;
  return cudaSuccess;
}

template <typename C>
cudaError_t launch(const void* x, const void* w, const void* scale, void* y, int R, int K,
                   int N, int bm, int split, int kps, cudaStream_t st) {
  if (bm != C::BM || (C::REGSPLIT && split > 1)) return cudaErrorInvalidValue;
  static bool smem_set = false;   // above 48 KB only after this attribute
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        qmm_wgmma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  CUtensorMap mx, mw;
  cudaError_t err = tensor_map(&mx, x, R, K, C::BN, 2);
  if (err == cudaSuccess) err = tensor_map(&mw, w, N, K, C::BM, 1);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + C::BM - 1) / C::BM, (R + C::BN - 1) / C::BN, split);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = split;
  cfg.attrs = &cluster;
  cfg.numAttrs = split > 1;   // a cluster only where the splits meet
  err = cudaLaunchKernelEx(&cfg, qmm_wgmma_kernel<C>, mx, mw, static_cast<const float*>(scale),
                           static_cast<float*>(y), R, N, (K + BK - 1) / BK, kps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

int bdm_qmm_k_align() { return K_ALIGN; }

const char* bdm_qmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// y [R, N] f32 = (x [R, K] bf16 @ W [N, K] int8 ^T) * scale [N] f32, on the
// plan of ops/quant_matmul.py plan_quant_matmul, packed in one integer (one
// argument fewer to convert a call): bits 0-8 the x-row tile bn, 9-17 the
// W-row tile bm (a compiled pair, the cases below), 18-21 the K splits
// `split` (a cluster each tile, at most MAX_SPLIT; only the 64-row tiles
// split), 22 on the 64-deep steps a split `kps`, none empty. K must be a
// multiple of K_ALIGN; R and N are any positive sizes.
int bdm_quant_matmul(const void* x, const void* w, const void* scale, void* y, int R, int K,
                     int N, long long plan, int device, void* stream) {
  const int bn = static_cast<int>(plan & 511), bm = static_cast<int>((plan >> 9) & 511);
  const int split = static_cast<int>((plan >> 18) & 15);
  const long long kps_wide = plan >> 22;
  if (kps_wide > (1 << 30)) return cudaErrorInvalidValue;
  const int kps = static_cast<int>(kps_wide);
  const int nk = (K + BK - 1) / BK;
  if (R < 1 || N < 1 || K < K_ALIGN || K % K_ALIGN || split < 1 || split > MAX_SPLIT ||
      kps < 1 || (split - 1) * kps_wide >= nk || split * kps_wide < nk)
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 56: return launch<Cfg<56>>(x, w, scale, y, R, K, N, bm, split, kps, st);
    case 64: return launch<Cfg<64>>(x, w, scale, y, R, K, N, bm, split, kps, st);
    case 136: return launch<Cfg<136>>(x, w, scale, y, R, K, N, bm, split, kps, st);
    case 208: return launch<Cfg<208>>(x, w, scale, y, R, K, N, bm, split, kps, st);
    case 256: return launch<Cfg<256>>(x, w, scale, y, R, K, N, bm, split, kps, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
