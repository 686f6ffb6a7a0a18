// TransformerXL relative attention, forward, for Hopper (sm_90a): K3.
//
// Replaces the Pallas kernel _rel_attention_kernel of
// bdm_db1_tpu/ops/pallas_attention.py (:50), launched by
// _pallas_rel_attention_fwd_impl (:391; :427 with row stats, :434 without)
// through pallas_rel_attention (:540) and pallas_rel_attention_anylen
// (:560). Contract, not the TPU block layout: for q [B, qlen, H, Dh],
// k/v [B, klen, H, Dh], rk [klen, H, Dh] (positional projections, row 0 the
// most distant) and the f32 biases r_w, r_r [H, Dh]:
//
//   AC[i, j] = (q_i + r_w) . k_j
//   BD[i, j] = (q_i + r_r) . rk[t],  t = j - i + (qlen - 1)
//   s = (AC + BD) * scale, -1e30 where banned:
//       col > row + mlen (mlen = klen - qlen), and with same_length also
//       col < row - (shift - 1), shift = qlen - (klen - mem_len) if that
//       difference is > 0, else qlen
//   online softmax over key tiles: m, l = sum exp(s - m) in f32, p cast to
//   bf16 before the PV product, o = acc / max(l, 1e-30) in bf16,
//   and the row stats (m, l) in f32 (kept for the backward kernels).
//
// Design. The biases stay out of the tensor-core products:
// (q + r_w) . k = q . k + r_w . k and (q + r_r) . rk = q . rk + r_r . rk.
// A first small kernel makes the per-key f32 terms r_w . k_j [B, H, klen]
// and r_r . rk_t [H, klen] once per call (4 lanes a dot product). The main
// kernel runs q . k and q . rk as bf16 tensor-core products with f32
// accumulation (each bf16 x bf16 product is exact in f32) onto those
// terms, so the scores keep the f32 arithmetic of the JAX kernel.
//
// One block of two warpgroups (8 warps) takes 128 query rows of one (b, h),
// warpgroup g rows 64 g..64 g + 63 (wgmma's M of 64), one block an SM, and
// walks the 64-key tiles that hold any unbanned entry for its rows (fully
// banned tiles are skipped, as _tile_j_bounds does). Query blocks are
// issued heaviest first (most key tiles). All three products of a tile are
// wgmma.mma_async m64n64k16, bf16 in and f32 accumulators, A from
// registers, B from shared memory in the 128-byte swizzle (16-byte chunk c
// of a 128-byte row r at chunk c ^ (r % 8), each [64, 64] tile 1024-byte
// aligned):
// - S = r_w . k_j + Q . K^T: 8 k-steps over the head dims, B the K tile
//   K-major (K's own [key, Dh] rows).
// - G = r_r . rk_t + Q . band^T: for 64 rows and 64 keys a warpgroup needs
//   127 rk rows, band column c = 63 - i + j of its row i and key j; two
//   products a k-step, one a 64-row band chunk, B K-major.
// - O += P . V: A is P (the S accumulator as bf16 pairs is wgmma's A
//   register layout), B the V tile MN-major (the transpose bit), two n64
//   halves of the head dims, 4 k-steps over the keys.
// Q is A of S and G: each warp's A fragments of the 8 k-steps, loaded once
// a block from the swizzled Q tile (32 registers). The per-key f32 terms
// enter as the accumulators' starting values (loaded from shared memory
// before wgmma.fence), so no add follows the products.
//
// The rel-shift. Each warp stores its 16 rows of G (all 128 band columns,
// f32, row stride 136: the accumulator's float2 stores are free of bank
// conflicts, the skewed reads two-way) and reads BD[i, j] = G[i, j + 63 -
// i] back in the accumulator layout (the GPU form of the per-row
// pltpu.roll); a warp reads only the rows it wrote. G stays f32: bf16's
// 2^-8 rounding of G would move m far past the kernel's limits. Band rows
// outside [0, klen) are zero and pair only with banned positions.
//
// The elementwise pass runs in the accumulator layout (thread l of warp w
// holds rows 16 w + l / 4 and 8 below, keys 8 n + 2 (l % 4)..): s = S +
// BD, the running max m in units of s, and p = exp2(s scale log2e - m
// scale log2e) as one FFMA and one MUFU.EX2. A banned entry gets s = -1e30
// by a select; a row with no unbanned entry yet (a warpgroup's rows on a
// tile beyond their causal edge, rows past qlen) takes 0 as its exponent
// offset, so its p is exp2(-1e30 scale log2e) = 0 and not exp2(0). A warp
// whose 16 rows ban the whole tile sets p = 0 and reads no G; the products
// run for both warpgroups on every tile all the same: a wgmma inside a
// branch that differs between warpgroups makes ptxas serialize every wgmma
// of the kernel (its note C7520).
//
// The copies: cp.async into the swizzled tiles, each thread the same four
// 16-byte chunks of every [64, 128] tile (addresses set up once a block,
// moved on by a step a tile). Key tile tn + 1's K, V and r_w . k_j (two
// stages) and its one new 64-row band chunk with its r_r . rk_t (a ring of
// four chunks: band row r of tile tn lives in chunk tn + r / 64, ring slot
// (tn + r / 64) % 4) are issued under tile tn's score products and waited
// for at the top of tile tn + 1, where fence.proxy.async and the tile's
// one block barrier hand them to wgmma (G is per warp; the PV product is
// waited for before the next barrier).
//
// rk is read in place through its [klen, H, Dh] strides, q, k and v through
// their batch and token strides. The ragged query and key edges are masked
// here, so nothing is padded or copied: the JAX wrapper's rk pad and batch
// broadcast and the anylen wrapper's q/k/v pad have no counterpart (equal
// padding of q and k leaves shift unchanged on every real row).
//
// Shared memory (bytes): the eight warps' G 69,632 (Q's 32,768 lie under
// it: read into registers before the first G is stored), two K/V stages
// 65,536, the band ring 65,536, the key terms 1,536, 1,024 to align:
// 203,264, one block an SM. Registers: Q's fragments 32, O 64, the two G
// accumulators 64, S 32; 243 in all, no spills.
//
// What bounds it on an H100: operations. At the eval shape (B 4, H 16,
// qlen = klen = 1024, Dh 128, causal) each (b, h) has 524,800 unbanned
// pairs and three products (AC, BD, PV) of 2 * 128 FLOP each: 25.8 GFLOP,
// 0.026 ms at 989 TFLOP/s, against 71.8 MB of q, k, v, o, rk and stats,
// 0.021 ms at 3.35 TB/s. It executes more than that count: G computes 128
// band columns for 64 keys (4/3 of the three counted products a tile), and
// the masked halves of diagonal tiles run whole: 38.7 GFLOP, 0.039 ms.
//
// Where the time goes (probe copies of this source with one part taken
// out, timed in turns with it by `chip_smoke.py --phases build,kernels
// --old-rel-fwd COPY --probe` at the validation shape; H100 80GB HBM3,
// 700 W): of 0.129 ms, the elementwise pass 0.033, the S and G products
// 0.021, the G stores 0.012, the tile's block barrier 0.011 (the wait for
// the slowest warp), the PV products 0.005, the staging 0.003, the O
// rescale 0.002. Both warpgroups run each pass at the same time, so the
// tensor cores idle through the elementwise pass and the G round trip;
// the two warpgroups out of phase are the next step. In a copy that kept
// G apart (80 columns a warp), Q read by descriptor from its swizzled tile
// ran at 0.1273 ms and Q from registers at 0.1275 (each in turns with this
// tree's 0.128): Q stays in registers, and G takes its space. Adding the
// key terms after the products made the G stores a chain of loads, adds
// and stores; as the accumulators' starting values they cost one load
// each, before wgmma.fence (fence_acc: ptxas otherwise moves the register
// copies past the fence and waits on the first products).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int DH = 128;          // head dim the kernel takes
constexpr int BQ = 128;          // query rows per block
constexpr int BK = 64;           // keys per tile, and band rows per ring chunk
constexpr int WGROWS = 64;       // query rows per warpgroup (wgmma's M)
constexpr int WROWS = 16;        // query rows per warp
constexpr int THREADS = 256;     // two warpgroups
constexpr int NCH = (BQ + BK) / BK;    // band chunks a tile reads
constexpr int RING = NCH + 1;          // band chunks in the ring
constexpr int LDG = BQ + 8;            // f32 row stride of a warp's G
constexpr int VECS = DH / 8;           // 16-byte vectors per bf16 row
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The wgmma operands: bf16 tiles of 128-byte rows (64 values) under the
// 128-byte swizzle, each 1024-byte aligned. A staged [64, 128] tile (a
// warpgroup's Q, K, V, a band chunk) is two such [64, 64] halves, head
// dims 0-63 and 64-127.
constexpr int SW_ROW = 64;                   // bf16 values of a swizzled row
constexpr int SW_HALF = BK * SW_ROW;         // bf16 values of a [64, 64] tile
constexpr int SW_TILE = 2 * SW_HALF * 2;     // bytes of a staged [64, 128] tile
constexpr int G_OFF = 0;                              // each warp's G, f32
constexpr int Q_OFF = 0;        // 2 warpgroups' rows, under G: read once, before any G
constexpr int K_OFF = G_OFF + 8 * WROWS * LDG * 4;    // 2 stages
constexpr int V_OFF = K_OFF + 2 * SW_TILE;            // 2 stages
constexpr int R_OFF = V_OFF + 2 * SW_TILE;            // band ring: RING chunks
constexpr int RWK_OFF = R_OFF + RING * SW_TILE;       // r_w . k_j  [2][BK]
constexpr int RRK_OFF = RWK_OFF + 2 * BK * 4;         // r_r . rk_t [RING][BK]
// and up to 1023 bytes to align the dynamic shared memory to 1024
constexpr int SMEM = RRK_OFF + RING * BK * 4 + 1024;
static_assert(K_OFF % 1024 == 0, "the swizzled tiles must stay 1024-byte aligned");
static_assert(2 * SW_TILE <= K_OFF, "Q lies under G");
static_assert(SMEM <= 232448, "one block must fit one SM");

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* rk;
  const float* rw;
  const float* rr;
  bf16* o;
  float* m;
  float* l;
  float* rwk;     // scratch [B * H, klen]: r_w . k_j
  float* rrk;     // scratch [H, klen]: r_r . rk_t
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st;   // element strides
  int B, H, qlen, klen, mem_len, same_length;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: nothing is read, the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x; underflow flushes to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// element (r, c) of a tile of 128-byte bf16 rows under the 128-byte
// swizzle: 16-byte chunk c / 8 of row r lies at chunk (c / 8) ^ (r % 8)
__device__ __forceinline__ int sw128(int r, int c) {
  return r * SW_ROW + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

// element (r, d) of a staged swizzled [64, 128] tile (two [64, 64] halves)
__device__ __forceinline__ int sw_tile(int r, int d) { return (d >> 6) * SW_HALF + sw128(r, d & 63); }

// ---- wgmma (copies of the helpers of csrc/flash_rel_attention_bwd.cu) ------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic writes (cp.async, st.shared) before it are seen by wgmma after
// the next barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a swizzled tile (128-byte rows, 8-row groups 1024 bytes
// apart, layout type 1: the 128-byte swizzle) from its shared address. K-
// major (rows are M for A, N for B; 64 K values a row) a k16 slice starts
// 32 bytes further; MN-major (B: rows are K, 64 N values a row) 2048 bytes
// further. The stride between 64-wide MN blocks is never used (N <= 64): it
// is set to 1024 bytes too.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// the descriptor of the tile `bytes` further: its start address field, the
// low 14 bits, never carries into the rest
__device__ __forceinline__ uint64_t desc_at(uint64_t d, uint32_t bytes) {
  return (d & 0xFFFFFFFF00000000ull) | (static_cast<uint32_t>(d) + (bytes >> 4));
}

// d[64 x 64] (+)= A . B with f32 accumulators; thread l of warp w of the
// warpgroup holds d[n][0..1] at row 16 w + l / 4, columns 8 n + 2 (l % 4)..,
// d[n][2..3] eight rows below. scale_d 0 ignores d's old values.
#define WG_D4(n) "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
// A from registers (the mma.sync A fragment of the warp's 16 rows), B
// K-major from shared memory
__device__ __forceinline__ void wgmma_64x64_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3), WG_D4(4), WG_D4(5), WG_D4(6), WG_D4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// A from registers, B MN-major (transposed) from shared memory
__device__ __forceinline__ void wgmma_64x64_rs_t(float (&d)[8][4], const uint32_t (&a)[4],
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3), WG_D4(4), WG_D4(5), WG_D4(6), WG_D4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef WG_D4

// after wgmma.wait_group: the accumulators are read only from here on;
// before wgmma.fence: every write to them is done
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

// the same for A fragments held in registers
template <int N>
__device__ __forceinline__ void fence_a(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[n][e])::"memory");
}

// r_w . k_j for every (b, h, j), then r_r . rk_t for every (h, t), in f32
// over the bf16 rows: 4 lanes a dot product (32 dims each), 8 a warp
__global__ void k3_key_terms_kernel(const Params p) {
  const long long w = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 2;
  const int part = threadIdx.x & 3;
  const long long n_k = static_cast<long long>(p.B) * p.H * p.klen;
  const long long n_r = static_cast<long long>(p.H) * p.klen;
  const bool live = w < n_k + n_r;
  const bf16* row = p.rk;
  const float* bias = p.rr;
  float* dst = nullptr;
  if (live && w < n_k) {
    const int bh = static_cast<int>(w / p.klen), j = static_cast<int>(w % p.klen);
    const int b = bh / p.H, h = bh % p.H;
    row = p.k + b * p.k_sb + j * p.k_st + h * DH;
    bias = p.rw + h * DH;
    dst = p.rwk + w;
  } else if (live) {
    const long long w2 = w - n_k;
    const int h = static_cast<int>(w2 / p.klen), t = static_cast<int>(w2 % p.klen);
    row = p.rk + (static_cast<long long>(t) * p.H + h) * DH;
    bias = p.rr + h * DH;
    dst = p.rrk + w2;
  }
  float acc = 0.f;
  if (live) {
#pragma unroll
    for (int c = 0; c < DH / 4; c += 8) {
      const int d = part * (DH / 4) + c;
      const uint4 raw = *reinterpret_cast<const uint4*>(row + d);
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias + d));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias + d + 4));
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 x0 = __bfloat1622float2(x[0]), x1 = __bfloat1622float2(x[1]);
      const float2 x2 = __bfloat1622float2(x[2]), x3 = __bfloat1622float2(x[3]);
      acc += b0.x * x0.x + b0.y * x0.y + b0.z * x1.x + b0.w * x1.y +
             b1.x * x2.x + b1.y * x2.y + b1.z * x3.x + b1.w * x3.y;
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (live && part == 0) *dst = acc;
}

// Thread tid's four 16-byte chunks of a swizzled [64, 128] tile at dst
// (rows row + 16 i, i < 4, row = tid / 16; head dims 8 (tid % 16)..) by
// cp.async from src + i * step bytes, zeroed where !ok(i).
template <typename Ok>
__device__ __forceinline__ void copy_tile(unsigned char* dst, const bf16* src, uint32_t step, Ok ok,
                                          const bf16* any) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
#pragma unroll
  for (int i = 0; i < BK / WROWS; ++i) {
    const bool v = ok(i);
    cp_async16(dst + i * (WROWS * SW_ROW * 2), v ? reinterpret_cast<const bf16*>(s + i * step) : any, v);
  }
}

// A thread's chunk of every staged tile: its row and its byte offset in a
// swizzled tile; its first element of the next key tile's K and V and of
// the next band chunk's rk rows, and the bytes from one of its chunks to
// the next (16 rows)
struct Chunk {
  int row, off;
  const bf16 *k, *v, *rk;
  uint32_t k16, v16, rk16;
};

// band chunk of 64 rk rows from t1 (and their r_r . rk_t) into ring slot
// `slot`, zero outside [0, klen); the chunk's pointer moves on 64 rows
__device__ __forceinline__ void stage_chunk(const Params& p, Chunk& ch, int h, int t1,
                                            unsigned char* smem, int slot, int tid) {
  copy_tile(smem + R_OFF + slot * SW_TILE + ch.off, ch.rk, ch.rk16, [&](int i) {
    const int tr = t1 + ch.row + WROWS * i;
    return tr >= 0 && tr < p.klen;
  }, p.rk);
  ch.rk += static_cast<long long>(BK) * p.H * DH;
  if (tid >= BK && tid < 2 * BK) {
    const int tr = t1 + tid - BK;
    const bool ok = tr >= 0 && tr < p.klen;
    float* rrk_s = reinterpret_cast<float*>(smem + RRK_OFF) + slot * BK;
    cp_async4(rrk_s + tid - BK, ok ? p.rrk + static_cast<long long>(h) * p.klen + tr : p.rrk, ok);
  }
}

// key tile c0's K, V and r_w . k_j into stage s, zero past klen; the
// chunk's pointers move on 64 keys
__device__ __forceinline__ void stage_kv(const Params& p, Chunk& ch, int bh, int c0,
                                         unsigned char* smem, int s, int tid) {
  const auto key_ok = [&](int i) { return c0 + ch.row + WROWS * i < p.klen; };
  copy_tile(smem + K_OFF + s * SW_TILE + ch.off, ch.k, ch.k16, key_ok, p.k);
  copy_tile(smem + V_OFF + s * SW_TILE + ch.off, ch.v, ch.v16, key_ok, p.v);
  ch.k += static_cast<long long>(BK) * p.k_st;
  ch.v += static_cast<long long>(BK) * p.v_st;
  if (tid < BK) {
    const int j = c0 + tid;
    const bool ok = j < p.klen;
    float* rwk_s = reinterpret_cast<float*>(smem + RWK_OFF) + s * BK;
    cp_async4(rwk_s + tid, ok ? p.rwk + static_cast<long long>(bh) * p.klen + j : p.rwk, ok);
  }
}

__global__ void __launch_bounds__(THREADS, 1) k3_rel_attention_kernel(const Params p) {
  // the swizzled tiles need 1024-byte alignment; an offset from the shared
  // array itself keeps every access in the shared state space
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - static_cast<unsigned>(__cvta_generic_to_shared(smem_raw))) & 1023u);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // warpgroup wg: block rows 64 wg..; warp rg = warp % 4 of it: rows
  // 16 rg.. of the warpgroup. wg by a shuffle from lane 0, so that the
  // compiler keeps what depends on it (the descriptors) in uniform registers.
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int rg = __shfl_sync(0xffffffffu, warp & 3, 0);
  float* Gw = reinterpret_cast<float*>(smem + G_OFF) + warp * WROWS * LDG;
  const float* rrk_s = reinterpret_cast<const float*>(smem + RRK_OFF);
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int nq = (p.qlen + BQ - 1) / BQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.y);   // heaviest first
  const int r0 = iq * BQ;
  const int rows = min(BQ, p.qlen - r0);
  const int mlen = p.klen - p.qlen;
  const int mask_len = p.klen - p.mem_len;
  const int shift = mask_len > 0 ? p.qlen - mask_len : p.qlen;
  const int nk = (p.klen + BK - 1) / BK;
  const int j_hi = min(nk, (r0 + rows - 1 + mlen) / BK + 1);
  int j_lo = 0;
  if (p.same_length) {
    const int lo_col = r0 - (shift - 1);
    j_lo = lo_col > 0 ? lo_col / BK : 0;
  }
  const int ntiles = j_hi - j_lo;
  // band chunk c holds the 64 rk rows from t_lo + 64 c: tile tn's band row
  // r (rk row t_lo + 64 tn + r, r = 127 - i + j for block row i, key j) is
  // row r % 64 of chunk tn + r / 64
  const int t_lo = j_lo * BK - r0 + p.qlen - BQ;

  Chunk ch;
  {  // Q, and tile 0: its K, V and the first NCH band chunks
    ch.row = tid / VECS;
    const int c = (tid % VECS) * 8;
    ch.off = 2 * sw_tile(ch.row, c);
    const long long rk_st = static_cast<long long>(p.H) * DH;
    ch.k16 = static_cast<uint32_t>(2 * WROWS * p.k_st);
    ch.v16 = static_cast<uint32_t>(2 * WROWS * p.v_st);
    ch.rk16 = static_cast<uint32_t>(2 * WROWS * rk_st);
    const uint32_t q16 = static_cast<uint32_t>(2 * WROWS * p.q_st);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rq = WGROWS * half + ch.row;
      copy_tile(smem + Q_OFF + half * SW_TILE + ch.off,
                p.q + b * p.q_sb + (r0 + rq) * p.q_st + h * DH + c, q16,
                [&](int i) { return rq + WROWS * i < rows; }, p.q);
    }
    ch.k = p.k + b * p.k_sb + (j_lo * BK + ch.row) * p.k_st + h * DH + c;
    ch.v = p.v + b * p.v_sb + (j_lo * BK + ch.row) * p.v_st + h * DH + c;
    ch.rk = p.rk + (static_cast<long long>(t_lo) + ch.row) * rk_st + h * DH + c;
    if (ntiles > 0) {
      stage_kv(p, ch, bh, j_lo * BK, smem, 0, tid);
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc) stage_chunk(p, ch, h, t_lo + BK * cc, smem, cc, tid);
    }
    cp_async_commit();
  }

  // rows il = g and g + 8 of this warp: warpgroup rows i0, i0 + 8
  const int i0 = WROWS * rg + g;
  const int wrow = r0 + WGROWS * wg + WROWS * rg;   // the warp's first row
  const int row0 = wrow + g, row1 = row0 + 8;
  const float sl2 = p.scale * LOG2E;               // s to log2 units
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  uint32_t qa[DH / 16][4];   // the warp's Q as A fragments
  float o[2][DH / 16][4];    // head dims 64 hh + 8 n + 2 t..
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) o[hh][n][0] = o[hh][n][1] = o[hh][n][2] = o[hh][n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // m in units of s

  {  // register e: row i0 + 8 (e % 2), head dims 16 kk + 8 (e / 2) + 2 t..
    cp_async_wait0();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qa[kk][e] = *reinterpret_cast<const uint32_t*>(
            smem + Q_OFF + wg * SW_TILE +
            2 * sw_tile(i0 + 8 * (e & 1), 16 * kk + 8 * (e >> 1) + 2 * t));
  }

  for (int tn = 0; tn < ntiles; ++tn) {
    const int s = tn & 1;
    const int c0 = (j_lo + tn) * BK;
    cp_async_wait0();
    fence_proxy_async();
    __syncthreads();   // tile tn has landed; every warp is done with tile tn - 1
    // the warpgroup's band columns 0-63 lie in ring slot lo, 64-127 in hi
    const int slot_lo = (tn + 1 - wg) % RING, slot_hi = (tn + 2 - wg) % RING;

    // The score products, B K-major, 8 k-steps over the head dims, onto
    // accumulators that start at the per-key f32 terms: G = r_r . rk_t +
    // Q . band^T (band columns 0-63 and 64-127), S = r_w . k_j + Q . K^T
    float gl[DH / 16][4], gh[DH / 16][4], sc[BK / 8][4];
    {
      const float* rwk_s = reinterpret_cast<const float*>(smem + RWK_OFF) + s * BK;
      const auto init = [&](float (&d)[8][4], const float* terms) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 v = *reinterpret_cast<const float2*>(terms + 8 * n + 2 * t);
          d[n][0] = d[n][2] = v.x;
          d[n][1] = d[n][3] = v.y;
        }
      };
      init(gl, rrk_s + slot_lo * BK);
      init(gh, rrk_s + slot_hi * BK);
      init(sc, rwk_s);
      // every accumulator written before wgmma.fence (else ptxas injects
      // a wait after the first products)
      fence_acc(gl);
      fence_acc(gh);
      fence_acc(sc);
      const uint64_t d_lo = desc_sw128(sa + R_OFF + slot_lo * SW_TILE);
      const uint64_t d_hi = desc_sw128(sa + R_OFF + slot_hi * SW_TILE);
      const uint64_t d_k = desc_sw128(sa + K_OFF + s * SW_TILE);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        const uint32_t ko = (ks >> 2) * (SW_HALF * 2) + 32 * (ks & 3);
        wgmma_64x64_rs(gl, qa[ks], desc_at(d_lo, ko), 1);
        wgmma_64x64_rs(gh, qa[ks], desc_at(d_hi, ko), 1);
        wgmma_64x64_rs(sc, qa[ks], desc_at(d_k, ko), 1);
      }
      wgmma_commit();
    }
    // tile tn + 1 into the slots tile tn - 1 used, under the products
    if (tn + 1 < ntiles) {
      stage_kv(p, ch, bh, c0 + BK, smem, s ^ 1, tid);
      stage_chunk(p, ch, h, t_lo + BK * (tn + NCH), smem, (tn + NCH) % RING, tid);
    }
    cp_async_commit();
    wgmma_wait0();
    fence_acc(gl);
    fence_acc(gh);
    fence_acc(sc);

    // G into the warp's G, all 128 band columns of its 16 rows (stores at
    // fixed offsets from one address)
    {
      float* gw = Gw + g * LDG + 2 * t;
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) {
        *reinterpret_cast<float2*>(gw + 8 * n) = make_float2(gl[n][0], gl[n][1]);
        *reinterpret_cast<float2*>(gw + 8 * LDG + 8 * n) = make_float2(gl[n][2], gl[n][3]);
        *reinterpret_cast<float2*>(gw + BK + 8 * n) = make_float2(gh[n][0], gh[n][1]);
        *reinterpret_cast<float2*>(gw + 8 * LDG + BK + 8 * n) = make_float2(gh[n][2], gh[n][3]);
      }
    }
    __syncwarp();   // the warp's G is complete

    // The elementwise pass: rows row0, row1 x keys c0 + 8 n + 2 t + e
    // every entry of the warp's 16 rows x 64 keys banned (the upper half of
    // a diagonal tile, the window's edge, the ragged end)
    const bool empty = wrow >= p.qlen || c0 > wrow + WROWS - 1 + mlen ||
                       (p.same_length && c0 + BK - 1 < wrow - (shift - 1));
    float mx0 = NEG_INF, mx1 = NEG_INF;
    if (!empty) {
      // s = S + BD (S holds r_w . k_j), BD[i, j] = G[i, j + 63 - i]
      const float* g0 = Gw + g * LDG + WGROWS - 1 - i0 + 2 * t;   // row i0, key 0
      const auto scores = [&](int n, int e, float& s0, float& s1) {
        s0 = sc[n][e] + g0[8 * n + e];
        s1 = sc[n][2 + e] + g0[8 * LDG - 8 + 8 * n + e];
      };
      // most tiles ban nothing in the warp's 16 rows x 64 keys
      const bool full = wrow + WROWS <= p.qlen && c0 + BK <= p.klen &&
                        c0 + BK - 1 <= wrow + mlen &&
                        (!p.same_length || c0 >= wrow + WROWS - 1 - (shift - 1));
      if (full) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float s0, s1;
            scores(n, e, s0, s1);
            sc[n][e] = s0;
            sc[n][2 + e] = s1;
            mx0 = fmaxf(mx0, s0);
            mx1 = fmaxf(mx1, s1);
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float s0, s1;
            scores(n, e, s0, s1);
            const int col = c0 + 8 * n + 2 * t + e;
            bool ban0 = col > row0 + mlen || col >= p.klen;
            bool ban1 = col > row1 + mlen || col >= p.klen;
            if (p.same_length) {
              ban0 = ban0 || col < row0 - (shift - 1);
              ban1 = ban1 || col < row1 - (shift - 1);
            }
            s0 = ban0 ? NEG_INF : s0;
            s1 = ban1 ? NEG_INF : s1;
            sc[n][e] = s0;
            sc[n][2 + e] = s1;
            mx0 = fmaxf(mx0, s0);
            mx1 = fmaxf(mx1, s1);
          }
        }
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // p = exp2(s sl2 - mn sl2); a row with no unbanned entry yet takes 0 as
    // its offset, so that its banned -1e30 give p = 0 and not exp2(0) = 1
    const float ms0 = mn0 > NEG_INF ? mn0 * sl2 : 0.f;
    const float ms1 = mn1 > NEG_INF ? mn1 * sl2 : 0.f;
    float sum0 = 0.f, sum1 = 0.f;
    if (empty) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    } else {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[n][e] = exp2_approx(fmaf(sc[n][e], sl2, -ms0));
          sc[n][2 + e] = exp2_approx(fmaf(sc[n][2 + e], sl2, -ms1));
          sum0 += sc[n][e];
          sum1 += sc[n][2 + e];
        }
      }
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float a0 = exp2_approx((m0 - mn0) * sl2), a1 = exp2_approx((m1 - mn1) * sl2);
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) {
        o[hh][n][0] *= a0;
        o[hh][n][1] *= a0;
        o[hh][n][2] *= a1;
        o[hh][n][3] *= a1;
      }

    // O += bf16(p) . V: the score blocks 2 kq, 2 kq + 1 are the A fragment
    // of keys 16 kq..; B the V tile's half hh, MN-major
    {
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kq = 0; kq < BK / 16; ++kq) {
        pa[kq][0] = pack_bf16(sc[2 * kq][0], sc[2 * kq][1]);
        pa[kq][1] = pack_bf16(sc[2 * kq][2], sc[2 * kq][3]);
        pa[kq][2] = pack_bf16(sc[2 * kq + 1][0], sc[2 * kq + 1][1]);
        pa[kq][3] = pack_bf16(sc[2 * kq + 1][2], sc[2 * kq + 1][3]);
      }
      const uint64_t d_v = desc_sw128(sa + V_OFF + s * SW_TILE);
      fence_acc(o[0]);
      fence_acc(o[1]);
      fence_a(pa);
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < BK / 16; ++kq) {
        wgmma_64x64_rs_t(o[0], pa[kq], desc_at(d_v, 2048 * kq), 1);
        wgmma_64x64_rs_t(o[1], pa[kq], desc_at(d_v, SW_HALF * 2 + 2048 * kq), 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_acc(o[0]);
      fence_acc(o[1]);
    }
  }
  cp_async_wait0();   // Q, should no key tile have been visited

  // o = acc / max(l, 1e-30) in bf16; row stats in f32, m in natural units
  const float den0 = __frcp_rn(fmaxf(l0, 1e-30f)), den1 = __frcp_rn(fmaxf(l1, 1e-30f));
  bf16* out0 = p.o + ((static_cast<long long>(b) * p.qlen + row0) * p.H + h) * DH + 2 * t;
  bf16* out1 = out0 + 8LL * p.H * DH;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) {
      const int d = DH / 2 * hh + 8 * n;
      if (row0 < p.qlen)
        *reinterpret_cast<uint32_t*>(out0 + d) = pack_bf16(o[hh][n][0] * den0, o[hh][n][1] * den0);
      if (row1 < p.qlen)
        *reinterpret_cast<uint32_t*>(out1 + d) = pack_bf16(o[hh][n][2] * den1, o[hh][n][3] * den1);
    }
  if (t == 0) {
    const long long srow = static_cast<long long>(bh) * p.qlen;
    if (row0 < p.qlen) {
      p.m[srow + row0] = m0 * p.scale;
      p.l[srow + row0] = l0;
    }
    if (row1 < p.qlen) {
      p.m[srow + row1] = m1 * p.scale;
      p.l[srow + row1] = l1;
    }
  }
}

}  // namespace

extern "C" {

int bdm_rel_head_dim() { return DH; }
int bdm_rel_block_q() { return BQ; }
int bdm_rel_block_k() { return BK; }
// dynamic shared memory of k3_rel_attention_kernel, bytes
int bdm_rel_smem() { return SMEM; }

const char* bdm_rel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K3: o [B, qlen, H, DH] bf16 (contiguous), m and l [B, H, qlen] f32;
// rwk [B * H * klen] and rrk [H * klen] f32 are scratch. q, k, v are bf16
// with element strides (batch, token) given and the heads packed (head
// stride DH, unit stride inside a head); rk is a contiguous [klen, H, DH]
// bf16 tensor, rw and rr contiguous [H, DH] f32. Every pointer and stride
// must keep 16-byte alignment.
int bdm_flash_rel_attention(const void* q, const void* k, const void* v, const void* rk,
                            const void* rw, const void* rr, void* o, void* m, void* l,
                            void* rwk, void* rrk, long long q_sb, long long q_st,
                            long long k_sb, long long k_st, long long v_sb, long long v_st,
                            int B, int H, int qlen, int klen, int mem_len, int same_length,
                            float scale, int device, void* stream) {
  const long long nq = (qlen + BQ - 1) / BQ;
  const long long dots = (static_cast<long long>(B) + 1) * H * klen;
  if (B < 1 || H < 1 || qlen < 1 || klen < qlen ||
      static_cast<long long>(B) * H > 2147483647LL || nq > 65535 ||
      (dots * 4 + 255) / 256 > 2147483647LL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  static bool smem_set = false;   // above 48 KB only after this attribute
  if (!smem_set) {
    err = cudaFuncSetAttribute(k3_rel_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k3_rel_attention_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.rk = static_cast<const bf16*>(rk);
  p.rw = static_cast<const float*>(rw);
  p.rr = static_cast<const float*>(rr);
  p.o = static_cast<bf16*>(o);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.rwk = static_cast<float*>(rwk);
  p.rrk = static_cast<float*>(rrk);
  p.q_sb = q_sb;
  p.q_st = q_st;
  p.k_sb = k_sb;
  p.k_st = k_st;
  p.v_sb = v_sb;
  p.v_st = v_st;
  p.B = B;
  p.H = H;
  p.qlen = qlen;
  p.klen = klen;
  p.mem_len = mem_len;
  p.same_length = same_length;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  k3_key_terms_kernel<<<static_cast<unsigned>((dots * 4 + 255) / 256), 256, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>(nq));
  k3_rel_attention_kernel<<<grid, THREADS, SMEM, st>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
