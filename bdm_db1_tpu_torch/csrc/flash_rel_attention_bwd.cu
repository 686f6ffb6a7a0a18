// TransformerXL relative attention, backward, for Hopper (sm_90a): K4 and K5.
//
// Replaces the Pallas kernels _rel_attention_bwd_dq_kernel (K4, :244,
// launched at :470) and _rel_attention_bwd_dkv_kernel (K5, :299, launched
// at :487) of bdm_db1_tpu/ops/pallas_attention.py, with the assembly of
// _pallas_rel_attention_bwd_impl (:441). Contract: for the forward of K3
// (csrc/flash_rel_attention.cu; q [B, qlen, H, Dh], k/v [B, klen, H, Dh],
// rk [klen, H, Dh], f32 biases r_w, r_r [H, Dh]), its row stats (m, l)
// [B, H, qlen], the upstream gradient dO [B, qlen, H, Dh] and
// delta = rowsum(dO * O) [B, H, qlen] (f32, made by the wrapper):
//
//   p = exp(s - m) / max(l, 1e-30), s recomputed exactly as K3 computes it
//   dP = dO . V^T,  dS = p * (dP - delta) * scale
//   dG[i, j + (qlen - 1 - i)] = dS[i, j]      (the rel-shift, backward)
//   dq  = dS . K + dG . rk                     (K4)
//   dV  = p^T . dO,  dK = dS^T . (q + r_w)     (K5)
//   drk = sum_b dG^T . (q + r_r)               (K5, summed over the batch)
//   drw = sum_{b,i} (dS . K)_i,  drr = sum_{b,i} (dG . rk)_i   (K5)
//
// Scores. Each tile recomputes q . k and q . rk_band as bf16 mma.sync
// products with f32 accumulation plus the f32 per-key terms r_w . k_j and
// r_r . rk_t (a small first kernel, as in K3), with K3's mask from indices
// (a banned entry gets p = 0, as exp(-1e30 - m) gives it) and K3's
// skipping of fully banned tiles, so exp(s - m) / l gives back K3's
// probabilities. p and dS are rounded to bf16 for the tensor-core
// products (as FlashAttention-2 does); the row and column sums below stay
// f32.
//
// The biases stay outside the tensor-core products. dK_j = sum_i dS_ij q_i
// + (sum_i dS_ij) r_w and drk_t = sum_i dG_it q_i + (sum_i dG_it) r_r, with
// the column sums of dS and the diagonal sums of dG kept in f32. The bias
// gradients are reduced inside K5 from the same sums: sum_i (dS . K)_i =
// sum_j (sum_i dS_ij) k_j and sum_i (dG . rk)_i = sum_t (sum_i dG_it) rk_t,
// so K4 writes dq once, in bf16, and no [B, qlen, H, Dh] f32 parts exist.
//
// The rel-shift. K3 reads BD[i, j] = G[i, j + (15 - i)] from a warp's band
// product G. The backward writes dS into the warp's shared memory at
// dG[i, j + (15 - i)] (bf16, zero elsewhere) and runs dq += dG . band (K4)
// or, over the block's 64 rows, drk_band += dG^T . q (K5). No row reversal
// or roll of the TPU kernels is needed: it is an addressing change.
//
// K4. One block of 4 warps takes 64 query rows of one (b, h), 16 rows a
// warp, and walks the key tiles of K3's _tile_j_bounds; dq lives in
// registers. It uses 224 registers a thread and 124 KB of shared memory,
// one block an SM, with no copy/compute overlap (latency-bound).
//
// K5. One block of 8 warps takes 64 keys of one (b, h) and walks the query
// tiles of _tile_i_bounds in order. A tile runs in two passes between
// three barriers:
// - Query-major: warp w takes row group w / 2 (16 query rows) and key half
//   w % 2 (32 keys), so its band slice is 48 rows (G, p and dS are
//   [16, 48] and [16, 32] in registers). The sums of dS over rows (for
//   dK's r_w term and drw) and over diagonals (dgsum, for drk's r_r term
//   and drr) stay f32: dS goes skewed into the warp's own G buffer and each
//   lane adds one column, one shared add per sum. p and dS go to shared
//   memory as bf16, and dG skewed into the row group's pair of G buffers
//   (a 64-thread barrier), with only the two 16-column strips at its ends
//   zeroed: the drk product reads nothing else.
// - Key-major: warp w owns keys 16 (w % 4).. and head dims 64 (w / 4)..:
//   dK and dV are 64 f32 a thread. On the same q fragments it runs the drk
//   product of band blocks w % 4 (16 rows, fresh) and w % 4 + 4 (carried):
//   the next query tile's band is this one's moved down 64 rows, so a
//   warp's low block is the next tile's high block and stays in registers
//   until it is complete; it then goes to drk by red.global.add.v4.f32
//   (lanes t, t ^ 1 swap halves), once per rk row per block and tile pair,
//   while the remaining products run. Every (b, key tile) adds into the
//   same rk rows, so drk's summation order changes from run to run. drr
//   sums dgsum . rk over the rk rows no later tile touches.
// - Stages: Q, dO, (m, l, delta) and r_r . rk_t in two stages; the band in
//   a ring of three 64-row chunks, so a tile loads only its 64 new rk rows.
//   The next tile's cp.async copies are issued inside the query-major pass
//   and waited for (wait_group 0) at the next tile's first barrier.
// - Budget: 207,360 bytes of shared memory (K, V 34.8 KB; two stages of Q
//   and dO 69.6 KB; the band ring 52.2 KB; eight warps' G 26.6 KB, with dG
//   on it; p and dS 18.4 KB; stats, biases and sums 5.5 KB), one block an
//   SM; registers near the 255 cap (chip_smoke's build phase reports what
//   ptxas gives, and that nothing spills).
//
// What bounds them on an H100: operations by the count, latency in fact.
// At the training shape (B 4, H 16, qlen = klen = 1024, Dh 128, causal:
// 33.6 M unbanned pairs) K4 runs 5 products of 2 * 128 FLOP a pair (AC,
// BD, dP, dq_ac, dq_bd): 43.0 GFLOP, 0.0435 ms at 989 TFLOP/s; K5 6 (AC,
// BD, dP, dV, dK, drk): 51.6 GFLOP, 0.0522 ms. K5 executes more than that
// count (48 band rows for 32 keys, the masked halves of diagonal tiles) at
// 2 warps a scheduler, and its time is spread over the drk flush (the L2
// atomics), the cp.async issue, the shared-memory sums and the mma.sync
// chains, none of them dominant. (Pairing the blocks of two batch
// elements in a cluster, to add their drk rows through distributed shared
// memory before the atomics, was slower: two cluster barriers a tile hold
// both blocks in step.) Left for a wgmma version: products from shared
// memory by warpgroup (fewer registers, so more warps or a deeper ring)
// and TMA for the staging.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int DH = 128;          // head dim the kernels take
constexpr int BQ = 64;           // query rows per tile
constexpr int BK = 64;           // keys per tile
constexpr int BAND = BQ + BK;    // rk band rows staged (BQ + BK - 1 used)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int WROWS = BQ / WARPS;      // 16 query rows (or keys) per warp
constexpr int WBAND = WROWS + BK;      // 80 band rows per warp (79 used)
constexpr int VECS = DH / 8;           // 16-byte vectors per bf16 row
constexpr int LDH = DH + 8;            // bf16 row stride of Q, K, V, dO, band
constexpr int LDG = WBAND + 4;         // f32 row stride of a warp's G
constexpr int LDGB = WBAND + 8;        // bf16 row stride of a warp's dG (K4)
constexpr int LDD = BAND + 8;          // bf16 row stride of the block's dG (K5)
constexpr int LDP = BK + 8;            // bf16 row stride of p and dS (K5)
constexpr int GW_BYTES = WROWS * LDG * 4;   // one warp's G (its dG aliases it)
static_assert(WROWS * LDGB * 2 <= GW_BYTES, "a warp's dG must fit in its G buffer");

constexpr int TILE = BQ * LDH * 2;     // one staged [64, 128] bf16 tile
constexpr int Q_OFF = 0;
constexpr int K_OFF = Q_OFF + TILE;
constexpr int V_OFF = K_OFF + TILE;
constexpr int DO_OFF = V_OFF + TILE;
constexpr int R_OFF = DO_OFF + TILE;
constexpr int G_OFF = R_OFF + BAND * LDH * 2;
constexpr int RWK_OFF = G_OFF + WARPS * GW_BYTES;   // r_w . k_j  [BK]
constexpr int RRK_OFF = RWK_OFF + BK * 4;            // r_r . rk_t [BAND]
constexpr int SMEM_DQ = RRK_OFF + BAND * 4;

// K5: eight warps. In the query-major pass warp w takes row group w / 2
// (16 query rows) and key half w % 2 (32 keys), over a 48-row band slice.
constexpr int WARPS5 = 8;
constexpr int THREADS5 = 32 * WARPS5;
constexpr int KH5 = BK / 2;                  // keys per warp, query-major
constexpr int WBAND5 = WROWS + KH5;          // 48 band rows per warp (47 used)
constexpr int LDG5 = WBAND5 + 4;             // f32 row stride of a warp's G
constexpr int GW5_BYTES = WROWS * LDG5 * 4;  // one warp's G
static_assert(WROWS * LDD * 2 <= 2 * GW5_BYTES,
              "a row group's dG rows must fit in its two warps' G buffers");
constexpr int K5_K = 0;
constexpr int K5_V = K5_K + TILE;
constexpr int K5_Q = K5_V + TILE;                     // 2 stages
constexpr int K5_DO = K5_Q + 2 * TILE;                // 2 stages
constexpr int K5_R = K5_DO + 2 * TILE;                // rk band: a ring of 3 x 64 rows
constexpr int K5_G = K5_R + 3 * TILE;                 // 8 warps' G; the block's dG
constexpr int K5_P = K5_G + WARPS5 * GW5_BYTES;       // bf16 p  [BQ, LDP]
constexpr int K5_S = K5_P + BQ * LDP * 2;             // bf16 dS [BQ, LDP]
constexpr int K5_RRK = K5_S + BQ * LDP * 2;           // r_r . rk_t [2][BAND]
constexpr int K5_ST = K5_RRK + 2 * BAND * 4;          // m, l, delta [2][3][BQ]
constexpr int K5_RWK = K5_ST + 2 * 3 * BQ * 4;        // r_w . k_j [BK]
constexpr int K5_BIAS = K5_RWK + BK * 4;              // r_w, r_r [2][DH]
constexpr int K5_DSUM = K5_BIAS + 2 * DH * 4;         // sum_i dS_ij [BK]
constexpr int K5_DGSUM = K5_DSUM + BK * 4;            // sum_i dG_it [3][BAND]
constexpr int SMEM_DKV = K5_DGSUM + 3 * BAND * 4;
static_assert(SMEM_DKV <= 232448, "one block must fit one SM");

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* rk;
  const float* rw;
  const float* rr;
  const bf16* dout;    // [B, qlen, H, DH] contiguous
  const float* m;      // [B * H, qlen]
  const float* l;
  const float* delta;
  float* rwk;          // scratch [B * H, klen]: r_w . k_j
  float* rrk;          // scratch [H, klen]: r_r . rk_t
  bf16* dq;            // K4: [B, qlen, H, DH]
  bf16* dk;            // K5: [B, klen, H, DH]
  bf16* dv;
  float* drk;          // K5: [klen, H, DH] f32, zeroed by the caller
  float* drw;          // K5: [H, DH] f32, zeroed by the caller
  float* drr;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st;   // element strides
  int B, H, qlen, klen, mem_len, same_length;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: nothing is read, the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_group0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the 64 threads of row group rg (warps 2 rg, 2 rg + 1) meet; barrier 0 is
// __syncthreads
__device__ __forceinline__ void pair_barrier(int rg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rg), "r"(64) : "memory");
}

// four adjacent f32 adds into global memory, dst 16-byte aligned (one
// red.global.add.v4.f32 on sm_90)
__device__ __forceinline__ void red_add4(float* dst, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(dst), v);
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 rows x 16) of a row-major bf16 tile in shared memory
__device__ __forceinline__ void ld_a(uint32_t* r, const bf16* base, int ld, int lane) {
  ldsm_x4(r, base + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 8 * (lane >> 4));
}

// A fragment of the transpose: rows of A are columns of the stored tile
__device__ __forceinline__ void ld_a_t(uint32_t* r, const bf16* base, int ld, int lane) {
  ldsm_x4_t(r, base + ((lane & 7) + 8 * ((lane >> 4) & 1)) * ld + 8 * ((lane >> 3) & 1));
}

// B fragments for two n-tiles of 8 from rows [n, d] of a stored tile (k-dim d)
__device__ __forceinline__ void ld_b(uint32_t* r, const bf16* base, int ld, int lane) {
  ldsm_x4(r, base + (8 * (lane >> 4) + (lane & 7)) * ld + 8 * ((lane >> 3) & 1));
}

// B fragments for two n-tiles of 8 from rows [k, n] of a stored tile (k-dim rows)
__device__ __forceinline__ void ld_b_t(uint32_t* r, const bf16* base, int ld, int lane) {
  ldsm_x4_t(r, base + (8 * ((lane >> 3) & 1) + (lane & 7)) * ld + 8 * (lane >> 4));
}

// one warp per dot product: r_w . k_j for every (b, h, j), then r_r . rk_t
// for every (h, t), in f32 over the bf16 rows (K3's first kernel)
__global__ void key_terms_kernel(const Params p) {
  const long long w = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_k = static_cast<long long>(p.B) * p.H * p.klen;
  const long long n_r = static_cast<long long>(p.H) * p.klen;
  if (w >= n_k + n_r) return;
  const bf16* row;
  const float* bias;
  float* dst;
  if (w < n_k) {
    const int bh = static_cast<int>(w / p.klen), j = static_cast<int>(w % p.klen);
    const int b = bh / p.H, h = bh % p.H;
    row = p.k + b * p.k_sb + j * p.k_st + h * DH;
    bias = p.rw + h * DH;
    dst = p.rwk + w;
  } else {
    const long long w2 = w - n_k;
    const int h = static_cast<int>(w2 / p.klen), t = static_cast<int>(w2 % p.klen);
    row = p.rk + (static_cast<long long>(t) * p.H + h) * DH;
    bias = p.rr + h * DH;
    dst = p.rrk + w2;
  }
  const uint2 raw = *reinterpret_cast<const uint2*>(row + 4 * lane);
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 bb = *reinterpret_cast<const float4*>(bias + 4 * lane);
  const float2 x0 = __bfloat1622float2(x[0]), x1 = __bfloat1622float2(x[1]);
  float acc = bb.x * x0.x + bb.y * x0.y + bb.z * x1.x + bb.w * x1.y;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) *dst = acc;
}

struct Geometry {
  int mlen, shift;
};

__device__ __forceinline__ Geometry geometry(const Params& p) {
  const int mask_len = p.klen - p.mem_len;
  return {p.klen - p.qlen, mask_len > 0 ? p.qlen - mask_len : p.qlen};
}

// Stage the band of rk rows t0 + r (r < BAND - 1, zero outside [0, klen))
// and their r_r . rk_t terms for query tile r0 and key tile c0.
__device__ __forceinline__ void stage_band(const Params& p, int h, int r0, int c0, bf16* Rs,
                                           float* rrk_s, int tid) {
  const int t0 = c0 - r0 + p.qlen - BQ;
  for (int e = tid; e < BAND * VECS; e += THREADS) {
    const int r = e / VECS, c = (e % VECS) * 8;
    const int tr = t0 + r;
    const bool ok = r < BAND - 1 && tr >= 0 && tr < p.klen;
    cp_async16(Rs + r * LDH + c,
               ok ? p.rk + (static_cast<long long>(tr) * p.H + h) * DH + c : p.rk, ok);
  }
  const int tr = t0 + tid;
  rrk_s[tid] = (tid < BAND - 1 && tr >= 0 && tr < p.klen)
                   ? p.rrk[static_cast<long long>(h) * p.klen + tr] : 0.f;
}

// Stage 64 rows [row0, row0 + 64) of a [*, T, H, DH] operand, zero past T.
__device__ __forceinline__ void stage_rows(const bf16* base, long long st, int row0, int T,
                                           bf16* dst, int tid) {
  for (int e = tid; e < BQ * VECS; e += THREADS) {
    const int r = e / VECS, c = (e % VECS) * 8;
    const bool ok = row0 + r < T;
    cp_async16(dst + r * LDH + c, ok ? base + (row0 + r) * st + c : base, ok);
  }
}

// One warp's 16 query rows of a (query tile r0, key tile c0) pair, from the
// staged tiles: p and dS [16, 64] in the mma accumulator layout (rows g and
// g + 8 of the warp, columns 8n + 2t + e). Rows past qlen and banned
// entries give p = dS = 0. Leaves the warp's G buffer free for reuse.
__device__ __forceinline__ void tile_p_ds(const Params& p, const Geometry& geo,
                                          const bf16* Qs, const bf16* Ks, const bf16* Vs,
                                          const bf16* dOs, const bf16* Rs, float* Gw,
                                          const float* rwk_s, const float* rrk_s, int warp,
                                          int lane, int r0, int c0, float m0, float m1,
                                          float il0, float il1, float dl0, float dl1,
                                          float (&pr)[BK / 8][4], float (&ds)[BK / 8][4]) {
  const int g = lane >> 2, t = lane & 3;
  const int wb = BQ - WROWS - WROWS * warp;   // this warp's first band row
  const bf16* qw = Qs + WROWS * warp * LDH;
  {  // G = q . band^T over this warp's 80 band rows, kept as f32 in Gw
    float gacc[WBAND / 8][4];
#pragma unroll
    for (int n = 0; n < WBAND / 8; ++n) gacc[n][0] = gacc[n][1] = gacc[n][2] = gacc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t qa[4];
      ld_a(qa, qw + kk * 16, LDH, lane);
#pragma unroll
      for (int np = 0; np < WBAND / 16; ++np) {
        uint32_t bfr[4];
        ld_b(bfr, Rs + (wb + 16 * np) * LDH + kk * 16, LDH, lane);
        mma16816(gacc[2 * np], qa, bfr[0], bfr[1]);
        mma16816(gacc[2 * np + 1], qa, bfr[2], bfr[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < WBAND / 8; ++n) {
      *reinterpret_cast<float2*>(Gw + g * LDG + 8 * n + 2 * t) = make_float2(gacc[n][0], gacc[n][1]);
      *reinterpret_cast<float2*>(Gw + (g + 8) * LDG + 8 * n + 2 * t) =
          make_float2(gacc[n][2], gacc[n][3]);
    }
  }
  // S = q . k^T
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) pr[n][0] = pr[n][1] = pr[n][2] = pr[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t qa[4];
    ld_a(qa, qw + kk * 16, LDH, lane);
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t bfr[4];
      ld_b(bfr, Ks + 16 * np * LDH + kk * 16, LDH, lane);
      mma16816(pr[2 * np], qa, bfr[0], bfr[1]);
      mma16816(pr[2 * np + 1], qa, bfr[2], bfr[3]);
    }
  }
  __syncwarp();
  // p = exp(s - m) / l with K3's scores and mask
  const int i0 = WROWS * warp + g;
  const int row0 = r0 + i0, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * n + 2 * t + e, col = c0 + j;
      const int br0 = BQ - 1 - i0 + j;          // block band row of (i0, j)
      const int gc0 = WROWS - 1 - g + j;        // its column in Gw
      const float s0 = (pr[n][e] + rwk_s[j] + Gw[g * LDG + gc0] + rrk_s[br0]) * p.scale;
      const float s1 =
          (pr[n][2 + e] + rwk_s[j] + Gw[(g + 8) * LDG + gc0 - 8] + rrk_s[br0 - 8]) * p.scale;
      bool ban0 = col > row0 + geo.mlen || col >= p.klen || row0 >= p.qlen;
      bool ban1 = col > row1 + geo.mlen || col >= p.klen || row1 >= p.qlen;
      if (p.same_length) {
        ban0 = ban0 || col < row0 - (geo.shift - 1);
        ban1 = ban1 || col < row1 - (geo.shift - 1);
      }
      pr[n][e] = ban0 ? 0.f : expf(s0 - m0) * il0;
      pr[n][2 + e] = ban1 ? 0.f : expf(s1 - m1) * il1;
    }
  }
  __syncwarp();   // G is read: the buffer is free
  // dP = dO . V^T, then dS = p (dP - delta) scale
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
  const bf16* dow = dOs + WROWS * warp * LDH;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t da[4];
    ld_a(da, dow + kk * 16, LDH, lane);
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t bfr[4];
      ld_b(bfr, Vs + 16 * np * LDH + kk * 16, LDH, lane);
      mma16816(ds[2 * np], da, bfr[0], bfr[1]);
      mma16816(ds[2 * np + 1], da, bfr[2], bfr[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ds[n][e] = pr[n][e] * (ds[n][e] - dl0) * p.scale;
      ds[n][2 + e] = pr[n][2 + e] * (ds[n][2 + e] - dl1) * p.scale;
    }
  }
}

// K4: dq for 64 query rows of one (b, h)
__global__ void __launch_bounds__(THREADS, 1) k4_rel_bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + Q_OFF);
  bf16* Ks = reinterpret_cast<bf16*>(smem + K_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + V_OFF);
  bf16* dOs = reinterpret_cast<bf16*>(smem + DO_OFF);
  bf16* Rs = reinterpret_cast<bf16*>(smem + R_OFF);
  float* rwk_s = reinterpret_cast<float*>(smem + RWK_OFF);
  float* rrk_s = reinterpret_cast<float*>(smem + RRK_OFF);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* Gw = reinterpret_cast<float*>(smem + G_OFF + warp * GW_BYTES);
  bf16* dGw = reinterpret_cast<bf16*>(Gw);
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const Geometry geo = geometry(p);
  const int nq = (p.qlen + BQ - 1) / BQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.y);   // heaviest first
  const int r0 = iq * BQ;
  const int rows = min(BQ, p.qlen - r0);
  const int nk = (p.klen + BK - 1) / BK;
  const int j_hi = min(nk, (r0 + rows - 1 + geo.mlen) / BK + 1);
  int j_lo = 0;
  if (p.same_length) {
    const int lo_col = r0 - (geo.shift - 1);
    j_lo = lo_col > 0 ? lo_col / BK : 0;
  }

  stage_rows(p.q + b * p.q_sb + h * DH, p.q_st, r0, p.qlen, Qs, tid);
  stage_rows(p.dout + static_cast<long long>(b) * p.qlen * p.H * DH + h * DH,
             static_cast<long long>(p.H) * DH, r0, p.qlen, dOs, tid);
  const int i0 = WROWS * warp + g;
  const int row0 = r0 + i0, row1 = row0 + 8;
  const long long srow = static_cast<long long>(bh) * p.qlen;
  const float m0 = row0 < p.qlen ? p.m[srow + row0] : 0.f;
  const float m1 = row1 < p.qlen ? p.m[srow + row1] : 0.f;
  const float il0 = row0 < p.qlen ? 1.f / fmaxf(p.l[srow + row0], 1e-30f) : 0.f;
  const float il1 = row1 < p.qlen ? 1.f / fmaxf(p.l[srow + row1], 1e-30f) : 0.f;
  const float dl0 = row0 < p.qlen ? p.delta[srow + row0] : 0.f;
  const float dl1 = row1 < p.qlen ? p.delta[srow + row1] : 0.f;
  const int wb = BQ - WROWS - WROWS * warp;

  float dq[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const bf16* kb = p.k + b * p.k_sb + h * DH;
  const bf16* vb = p.v + b * p.v_sb + h * DH;
  for (int jb = j_lo; jb < j_hi; ++jb) {
    const int c0 = jb * BK;
    __syncthreads();   // every warp is done with the previous tile
    stage_rows(kb, p.k_st, c0, p.klen, Ks, tid);
    stage_rows(vb, p.v_st, c0, p.klen, Vs, tid);
    stage_band(p, h, r0, c0, Rs, rrk_s, tid);
    if (tid < BK) {
      const int j = c0 + tid;
      rwk_s[tid] = j < p.klen ? p.rwk[static_cast<long long>(bh) * p.klen + j] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    float pr[BK / 8][4], ds[BK / 8][4];
    tile_p_ds(p, geo, Qs, Ks, Vs, dOs, Rs, Gw, rwk_s, rrk_s, warp, lane, r0, c0, m0, m1, il0,
              il1, dl0, dl1, pr, ds);

    // dq += dS . K: the dS tiles 2k, 2k + 1 are the A fragment of keys 16k..16k+15
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq) {
      uint32_t a[4];
      a[0] = pack_bf16(ds[2 * kq][0], ds[2 * kq][1]);
      a[1] = pack_bf16(ds[2 * kq][2], ds[2 * kq][3]);
      a[2] = pack_bf16(ds[2 * kq + 1][0], ds[2 * kq + 1][1]);
      a[3] = pack_bf16(ds[2 * kq + 1][2], ds[2 * kq + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t bfr[4];
        ld_b_t(bfr, Ks + 16 * kq * LDH + 16 * dp, LDH, lane);
        mma16816(dq[2 * dp], a, bfr[0], bfr[1]);
        mma16816(dq[2 * dp + 1], a, bfr[2], bfr[3]);
      }
    }

    // dG[i, j + 15 - i] = dS[i, j] in the warp's buffer (bf16, zero elsewhere)
    for (int e = lane; e < WROWS * LDGB / 8; e += 32)
      reinterpret_cast<uint4*>(dGw)[e] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * n + 2 * t + e;
        dGw[g * LDGB + WROWS - 1 - g + j] = __float2bfloat16_rn(ds[n][e]);
        dGw[(g + 8) * LDGB + WROWS - 9 - g + j] = __float2bfloat16_rn(ds[n][2 + e]);
      }
    }
    __syncwarp();
    // dq += dG . band over this warp's 80 band rows
#pragma unroll
    for (int kq = 0; kq < WBAND / 16; ++kq) {
      uint32_t a[4];
      ld_a(a, dGw + kq * 16, LDGB, lane);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t bfr[4];
        ld_b_t(bfr, Rs + (wb + 16 * kq) * LDH + 16 * dp, LDH, lane);
        mma16816(dq[2 * dp], a, bfr[0], bfr[1]);
        mma16816(dq[2 * dp + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncwarp();   // the buffer is G again in the next tile
  }

  bf16* out0 = p.dq + ((static_cast<long long>(b) * p.qlen + row0) * p.H + h) * DH + 2 * t;
  bf16* out1 = out0 + 8LL * p.H * DH;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    if (row0 < p.qlen) *reinterpret_cast<uint32_t*>(out0 + 8 * n) = pack_bf16(dq[n][0], dq[n][1]);
    if (row1 < p.qlen) *reinterpret_cast<uint32_t*>(out1 + 8 * n) = pack_bf16(dq[n][2], dq[n][3]);
  }
}

// K5: stage 64 rk rows from t1 into ring slot `slot` (zero outside [0, klen))
__device__ __forceinline__ void k5_stage_rk(const Params& p, int h, int t1, unsigned char* smem,
                                            int slot, int tid) {
  bf16* Rs = reinterpret_cast<bf16*>(smem + K5_R + slot * TILE);
  for (int e = tid; e < BQ * VECS; e += THREADS5) {
    const int r = e / VECS, c = (e % VECS) * 8;
    const int tr = t1 + r;
    const bool ok = tr >= 0 && tr < p.klen;
    cp_async16(Rs + r * LDH + c,
               ok ? p.rk + (static_cast<long long>(tr) * p.H + h) * DH + c : p.rk, ok);
  }
}

// K5: stage query tile r0's Q, dO, r_r . rk_t and (m, l, delta) into stage
// s, and the low 64 rows of its rk band into ring slot `slot`, by cp.async
// (zero past qlen and outside [0, klen)). The band's high 64 rows are the
// previous tile's low ones.
__device__ __forceinline__ void k5_stage(const Params& p, int bh, int b, int h, int c0, int r0,
                                         unsigned char* smem, int s, int slot, int tid) {
  bf16* Qs = reinterpret_cast<bf16*>(smem + K5_Q + s * TILE);
  bf16* dOs = reinterpret_cast<bf16*>(smem + K5_DO + s * TILE);
  const bf16* qb = p.q + b * p.q_sb + h * DH;
  const bf16* dob = p.dout + static_cast<long long>(b) * p.qlen * p.H * DH + h * DH;
  const long long do_st = static_cast<long long>(p.H) * DH;
  for (int e = tid; e < BQ * VECS; e += THREADS5) {
    const int r = e / VECS, c = (e % VECS) * 8;
    const bool ok = r0 + r < p.qlen;
    cp_async16(Qs + r * LDH + c, ok ? qb + (r0 + r) * p.q_st + c : qb, ok);
    cp_async16(dOs + r * LDH + c, ok ? dob + (r0 + r) * do_st + c : dob, ok);
  }
  const int t0 = c0 - r0 + p.qlen - BQ;   // rk row of band row 0
  k5_stage_rk(p, h, t0, smem, slot, tid);
  float* rrk_s = reinterpret_cast<float*>(smem + K5_RRK) + s * BAND;
  float* st_s = reinterpret_cast<float*>(smem + K5_ST) + s * 3 * BQ;
  const long long srow = static_cast<long long>(bh) * p.qlen;
  for (int e = tid; e < BAND + 3 * BQ; e += THREADS5) {
    if (e < BAND) {
      const int tr = t0 + e;
      const bool ok = e < BAND - 1 && tr >= 0 && tr < p.klen;
      cp_async4(rrk_s + e, ok ? p.rrk + static_cast<long long>(h) * p.klen + tr : p.rrk, ok);
    } else {
      const int which = (e - BAND) / BQ, r = (e - BAND) % BQ;
      const float* src = which == 0 ? p.m : which == 1 ? p.l : p.delta;
      const bool ok = r0 + r < p.qlen;
      cp_async4(st_s + which * BQ + r, ok ? src + srow + r0 + r : src, ok);
    }
  }
}

// K5: dk, dv for 64 keys of one (b, h); drk, drw and drr by f32 atomics
__global__ void __launch_bounds__(THREADS5, 1) k5_rel_bwd_dkv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + K5_K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + K5_V);
  bf16* Ps = reinterpret_cast<bf16*>(smem + K5_P);
  bf16* dSs = reinterpret_cast<bf16*>(smem + K5_S);
  float* rwk_s = reinterpret_cast<float*>(smem + K5_RWK);
  float* rw_s = reinterpret_cast<float*>(smem + K5_BIAS);
  float* rr_s = rw_s + DH;
  float* dsum_s = reinterpret_cast<float*>(smem + K5_DSUM);
  float* dgsum_s = reinterpret_cast<float*>(smem + K5_DGSUM);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the block's dG [BQ, LDD] (bf16, skewed): the rows of row group rg lie
  // in the G buffers of warps 2 rg and 2 rg + 1
  const auto dg_row = [&](int r) {
    return reinterpret_cast<bf16*>(smem + K5_G + (r / WROWS) * 2 * GW5_BYTES) + (r % WROWS) * LDD;
  };
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const Geometry geo = geometry(p);
  const int jb = blockIdx.y;    // the first key tiles see the most query tiles
  const int c0 = jb * BK;
  const int nq = (p.qlen + BQ - 1) / BQ;
  const int lo_row = c0 - geo.mlen;
  const int i_lo = lo_row > 0 ? lo_row / BQ : 0;
  int i_hi = nq;
  if (p.same_length) i_hi = min(nq, (c0 + BK - 1 + (geo.shift - 1)) / BQ + 1);

  // query-major: row group rg, key half kh, band slice from block band row wb
  const int rg = warp >> 1, kh = warp & 1;
  const int wb = BQ - WROWS - WROWS * rg + KH5 * kh;
  const int i0 = WROWS * rg + g;            // block rows i0 and i0 + 8
  float* Gw = reinterpret_cast<float*>(smem + K5_G + warp * GW5_BYTES);
  bf16* dgp = dg_row(WROWS * rg);
  // key-major: keys 16 kq.., head dims 64 dh..
  const int kq = warp & 3, dh = warp >> 2;
  // drk: band-row blocks rbl = warp % 4 and rbl + 4 (16 rows each) over
  // head dims 64 dh... Block rb meets min(rb, 7 - rb) + 1 query blocks, so
  // the two sum to 5 products of 16 rows x 64 dims x 16 queries a warp. The
  // next query tile's band is this one's moved down 64 rows: its block
  // rbl + 4 holds this tile's block rbl, so the warp carries that block's
  // sums in registers to the next tile and adds them into drk once.
  const int rbl = warp & 3;

  {
    const bf16* kb = p.k + b * p.k_sb + h * DH;
    const bf16* vb = p.v + b * p.v_sb + h * DH;
    for (int e = tid; e < BK * VECS; e += THREADS5) {
      const int r = e / VECS, c = (e % VECS) * 8;
      const bool ok = c0 + r < p.klen;
      cp_async16(Ks + r * LDH + c, ok ? kb + (c0 + r) * p.k_st + c : kb, ok);
      cp_async16(Vs + r * LDH + c, ok ? vb + (c0 + r) * p.v_st + c : vb, ok);
    }
  }
  // band chunk c (64 rk rows) in ring slot c % 3: tile iq's band is chunks
  // iq - i_lo + 1 (low rows) and iq - i_lo (high rows)
  if (i_lo < i_hi) {
    k5_stage_rk(p, h, c0 - i_lo * BQ + p.qlen, smem, 0, tid);
    k5_stage(p, bh, b, h, c0, i_lo * BQ, smem, 0, 1, tid);
  }
  cp_async_commit();
  if (tid < BK) {
    const int j = c0 + tid;
    rwk_s[tid] = j < p.klen ? p.rwk[static_cast<long long>(bh) * p.klen + j] : 0.f;
    dsum_s[tid] = 0.f;
  }
  if (tid < DH) {
    rw_s[tid] = p.rw[h * DH + tid];
    rr_s[tid] = p.rr[h * DH + tid];
  }
  for (int e = tid; e < 3 * BAND; e += THREADS5) dgsum_s[e] = 0.f;

  float dk[DH / 16][4], dv[DH / 16][4];
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  float drr_acc[4] = {0.f, 0.f, 0.f, 0.f};   // dims 4 lane..
  float carry[DH / 16][4];   // drk of block rbl + 4 of the next tile
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) carry[n][0] = carry[n][1] = carry[n][2] = carry[n][3] = 0.f;

  for (int iq = i_lo; iq < i_hi; ++iq) {
    const int s = (iq - i_lo) & 1;
    const int r0 = iq * BQ;
    const int t0 = c0 - r0 + p.qlen - BQ;   // rk row of band row 0
    const bool has_next = iq + 1 < i_hi;
    cp_async_wait_group0();
    __syncthreads();   // tile iq has landed; every warp is done with tile iq - 1
    // dgsum: this tile's, the previous tile's (read by drr), the next's
    const int dg_cur = (iq - i_lo) % 3;
    float* dgs = dgsum_s + dg_cur * BAND;
    const float* dgs_prev = dgsum_s + (dg_cur + 2) % 3 * BAND;
    if (tid < BAND) dgsum_s[(dg_cur + 1) % 3 * BAND + tid] = 0.f;

    const bf16* Qs = reinterpret_cast<const bf16*>(smem + K5_Q + s * TILE);
    const bf16* dOs = reinterpret_cast<const bf16*>(smem + K5_DO + s * TILE);
    const int chunk = iq - i_lo + 1;
    const bf16* Rlo = reinterpret_cast<const bf16*>(smem + K5_R + chunk % 3 * TILE);
    const bf16* Rhi = reinterpret_cast<const bf16*>(smem + K5_R + (chunk + 2) % 3 * TILE);
    // band row r (a group of 16 never straddles the two chunks)
    const auto band_row = [&](int r) { return (r < BQ ? Rlo : Rhi) + (r % BQ) * LDH; };
    const float* rrk_s = reinterpret_cast<const float*>(smem + K5_RRK) + s * BAND;
    const float* st_s = reinterpret_cast<const float*>(smem + K5_ST) + s * 3 * BQ;

    {  // query-major: rows i0, i0 + 8 of row group rg, keys 32 kh..
      float pr[KH5 / 8][4], ds[KH5 / 8][4];
      const bf16* qw = Qs + WROWS * rg * LDH;
      {  // G = q . band^T over the warp's 48 band rows (f32 in Gw), S = q . k^T
        float gacc[WBAND5 / 8][4];
#pragma unroll
        for (int n = 0; n < WBAND5 / 8; ++n) gacc[n][0] = gacc[n][1] = gacc[n][2] = gacc[n][3] = 0.f;
#pragma unroll
        for (int n = 0; n < KH5 / 8; ++n) pr[n][0] = pr[n][1] = pr[n][2] = pr[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t qa[4];
          ld_a(qa, qw + kk * 16, LDH, lane);
#pragma unroll
          for (int np = 0; np < WBAND5 / 16; ++np) {
            uint32_t bfr[4];
            ld_b(bfr, band_row(wb + 16 * np) + kk * 16, LDH, lane);
            mma16816(gacc[2 * np], qa, bfr[0], bfr[1]);
            mma16816(gacc[2 * np + 1], qa, bfr[2], bfr[3]);
          }
#pragma unroll
          for (int np = 0; np < KH5 / 16; ++np) {
            uint32_t bfr[4];
            ld_b(bfr, Ks + (KH5 * kh + 16 * np) * LDH + kk * 16, LDH, lane);
            mma16816(pr[2 * np], qa, bfr[0], bfr[1]);
            mma16816(pr[2 * np + 1], qa, bfr[2], bfr[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < WBAND5 / 8; ++n) {
          *reinterpret_cast<float2*>(Gw + g * LDG5 + 8 * n + 2 * t) =
              make_float2(gacc[n][0], gacc[n][1]);
          *reinterpret_cast<float2*>(Gw + (g + 8) * LDG5 + 8 * n + 2 * t) =
              make_float2(gacc[n][2], gacc[n][3]);
        }
      }
      __syncwarp();
      // tile iq + 1 into the other stage, issued here, between the shared-
      // memory work, rather than in one burst after the barrier
      if (has_next) k5_stage(p, bh, b, h, c0, r0 + BQ, smem, s ^ 1, (chunk + 1) % 3, tid);
      cp_async_commit();
      // p = exp(s - m) / l with K3's scores and mask
      const int row0 = r0 + i0, row1 = row0 + 8;
      const float m0 = st_s[i0], m1 = st_s[i0 + 8];
      const float il0 = 1.f / fmaxf(st_s[BQ + i0], 1e-30f);
      const float il1 = 1.f / fmaxf(st_s[BQ + i0 + 8], 1e-30f);
      const float dl0 = st_s[2 * BQ + i0], dl1 = st_s[2 * BQ + i0 + 8];
      const auto scores = [&](int n, int e, float& s0, float& s1) {
        const int jl = 8 * n + 2 * t + e, j = KH5 * kh + jl;
        const int br0 = BQ - 1 - i0 + j;          // block band row of (i0, j)
        const int gc0 = WROWS - 1 - g + jl;       // its column in Gw
        s0 = (pr[n][e] + rwk_s[j] + Gw[g * LDG5 + gc0] + rrk_s[br0]) * p.scale;
        s1 = (pr[n][2 + e] + rwk_s[j] + Gw[(g + 8) * LDG5 + gc0 - 8] + rrk_s[br0 - 8]) * p.scale;
      };
      // most tiles ban nothing in the warp's 16 rows x 32 keys
      const int wrow = r0 + WROWS * rg, wcol = c0 + KH5 * kh;
      const bool full = wrow + WROWS <= p.qlen && wcol + KH5 <= p.klen &&
                        wcol + KH5 - 1 <= wrow + geo.mlen &&
                        (!p.same_length || wcol >= wrow + WROWS - 1 - (geo.shift - 1));
      if (full) {
#pragma unroll
        for (int n = 0; n < KH5 / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float s0, s1;
            scores(n, e, s0, s1);
            pr[n][e] = __expf(s0 - m0) * il0;
            pr[n][2 + e] = __expf(s1 - m1) * il1;
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < KH5 / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float s0, s1;
            scores(n, e, s0, s1);
            const int col = wcol + 8 * n + 2 * t + e;
            bool ban0 = col > row0 + geo.mlen || col >= p.klen || row0 >= p.qlen;
            bool ban1 = col > row1 + geo.mlen || col >= p.klen || row1 >= p.qlen;
            if (p.same_length) {
              ban0 = ban0 || col < row0 - (geo.shift - 1);
              ban1 = ban1 || col < row1 - (geo.shift - 1);
            }
            pr[n][e] = ban0 ? 0.f : __expf(s0 - m0) * il0;
            pr[n][2 + e] = ban1 ? 0.f : __expf(s1 - m1) * il1;
          }
        }
      }
      // dP = dO . V^T, then dS = p (dP - delta) scale
#pragma unroll
      for (int n = 0; n < KH5 / 8; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
      const bf16* dow = dOs + WROWS * rg * LDH;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t da[4];
        ld_a(da, dow + kk * 16, LDH, lane);
#pragma unroll
        for (int np = 0; np < KH5 / 16; ++np) {
          uint32_t bfr[4];
          ld_b(bfr, Vs + (KH5 * kh + 16 * np) * LDH + kk * 16, LDH, lane);
          mma16816(ds[2 * np], da, bfr[0], bfr[1]);
          mma16816(ds[2 * np + 1], da, bfr[2], bfr[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < KH5 / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ds[n][e] = pr[n][e] * (ds[n][e] - dl0) * p.scale;
          ds[n][2 + e] = pr[n][2 + e] * (ds[n][2 + e] - dl1) * p.scale;
        }
      }

      // The sums in f32: dS goes skewed into the warp's own G buffer (BD is
      // read), Gw[i, 15 - i + jl] = dS[i, jl]; then lane L sums key column
      // L (sum_i dS_ij) and band columns L and 32 + L (sum_i dG_it) over
      // the rows that wrote them, and adds each once.
      __syncwarp();
#pragma unroll
      for (int n = 0; n < KH5 / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jl = 8 * n + 2 * t + e;
          Gw[g * LDG5 + WROWS - 1 - g + jl] = ds[n][e];
          Gw[(g + 8) * LDG5 + WROWS - 9 - g + jl] = ds[n][2 + e];
        }
      }
      __syncwarp();
      {
        float cs = 0.f, d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int i = 0; i < WROWS; ++i) {
          cs += Gw[i * LDG5 + WROWS - 1 - i + lane];
          if (i >= WROWS - 1 - lane) d0 += Gw[i * LDG5 + lane];
          if (i < WROWS - 1 - lane) d1 += Gw[i * LDG5 + KH5 + lane];
        }
        atomicAdd(dsum_s + KH5 * kh + lane, cs);
        atomicAdd(dgs + wb + lane, d0);
        if (lane < WROWS - 1) atomicAdd(dgs + wb + KH5 + lane, d1);
      }

      // the row group's dG rows overlay both warps' G: both must be done
      pair_barrier(rg);
      // dG[i, 63 - i + j] = dS[i, j]. The drk product reads row group rg's
      // dG in band columns [48 - 16 rg, 128 - 16 rg): this warp's diagonal
      // plus a 16-column strip at its outer end, zeroed here.
      {
        const int zc = kh ? 2 * BQ - WROWS - WROWS * rg : BQ - WROWS - WROWS * rg;
        *reinterpret_cast<uint4*>(dgp + (lane >> 1) * LDD + zc + 8 * (lane & 1)) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      __syncwarp();
#pragma unroll
      for (int n = 0; n < KH5 / 8; ++n) {
        const int j = KH5 * kh + 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(Ps + i0 * LDP + j) = pack_bf16(pr[n][0], pr[n][1]);
        *reinterpret_cast<uint32_t*>(Ps + (i0 + 8) * LDP + j) = pack_bf16(pr[n][2], pr[n][3]);
        *reinterpret_cast<uint32_t*>(dSs + i0 * LDP + j) = pack_bf16(ds[n][0], ds[n][1]);
        *reinterpret_cast<uint32_t*>(dSs + (i0 + 8) * LDP + j) = pack_bf16(ds[n][2], ds[n][3]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bc0 = BQ - 1 - i0 + j + e;     // block band column of (i0, j + e)
          dgp[g * LDD + bc0] = __float2bfloat16_rn(ds[n][e]);
          dgp[(g + 8) * LDD + bc0 - 8] = __float2bfloat16_rn(ds[n][2 + e]);
        }
      }
    }
    __syncthreads();   // p, dS, dG and the sums are complete

    // drk rows of band block rb: A = dG^T (stored rows are queries 16 ks..,
    // columns band rows 16 rb..), zero outside query blocks 3 - rb..7 - rb
    const auto ld_dgt = [&](uint32_t* a, int ks, int rb) {
      const int qr = 16 * ks + (lane & 7) + 8 * ((lane >> 4) & 1);
      ldsm_x4_t(a, dg_row(qr) + 16 * rb + 8 * ((lane >> 3) & 1));
    };
    // + dgsum r_r for the rows of block rb (this tile's sums)
    const auto add_rr = [&](float (&acc)[DH / 16][4], int rb) {
      const float gA = dgs[16 * rb + g], gB = dgs[16 * rb + g + 8];
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) {
        const float2 r2 = *reinterpret_cast<const float2*>(rr_s + DH / 2 * dh + 8 * n + 2 * t);
        acc[n][0] += gA * r2.x;
        acc[n][1] += gA * r2.y;
        acc[n][2] += gB * r2.x;
        acc[n][3] += gB * r2.y;
      }
    };
    // into drk for the rows of block rb: lanes t and t ^ 1 swap halves, so
    // an even t adds dims d..d+3 of row A and an odd t dims d-2..d+1 of row B
    const auto flush_drk = [&](float (&acc)[DH / 16][4], int rb) {
      const bool odd = t & 1;
      const int tr = t0 + 16 * rb + g + (odd ? 8 : 0);
      const bool ok = tr >= 0 && tr < p.klen;
      float* dst = p.drk + (static_cast<long long>(tr) * p.H + h) * DH + DH / 2 * dh + 2 * (t & 2);
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) {
        const float sx = __shfl_xor_sync(0xffffffffu, odd ? acc[n][0] : acc[n][2], 1);
        const float sy = __shfl_xor_sync(0xffffffffu, odd ? acc[n][1] : acc[n][3], 1);
        if (ok)
          red_add4(dst + 8 * n, odd ? make_float4(sx, sy, acc[n][2], acc[n][3])
                                    : make_float4(acc[n][0], acc[n][1], sx, sy));
      }
    };

    {  // key-major: dV += p^T . dO, dK += dS^T . q for keys 16 kq.., dims
       // 64 dh..; drk of blocks rbl (fresh) and rbl + 4 (carried) on the
       // same q fragments
      float acc[DH / 16][4];
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks) {
        uint32_t ap[4], as[4], al[4], ah[4];
        ld_a_t(ap, Ps + 16 * ks * LDP + 16 * kq, LDP, lane);
        ld_a_t(as, dSs + 16 * ks * LDP + 16 * kq, LDP, lane);
        const bool in_l = ks >= 3 - rbl, in_h = ks <= 3 - rbl;   // the same for the warp
        if (in_l) ld_dgt(al, ks, rbl);
        if (in_h) ld_dgt(ah, ks, rbl + 4);
#pragma unroll
        for (int dp = 0; dp < DH / 32; ++dp) {
          uint32_t bfr[4];
          ld_b_t(bfr, dOs + 16 * ks * LDH + DH / 2 * dh + 16 * dp, LDH, lane);
          mma16816(dv[2 * dp], ap, bfr[0], bfr[1]);
          mma16816(dv[2 * dp + 1], ap, bfr[2], bfr[3]);
          ld_b_t(bfr, Qs + 16 * ks * LDH + DH / 2 * dh + 16 * dp, LDH, lane);
          mma16816(dk[2 * dp], as, bfr[0], bfr[1]);
          mma16816(dk[2 * dp + 1], as, bfr[2], bfr[3]);
          if (in_l) {
            mma16816(acc[2 * dp], al, bfr[0], bfr[1]);
            mma16816(acc[2 * dp + 1], al, bfr[2], bfr[3]);
          }
          if (in_h) {
            mma16816(carry[2 * dp], ah, bfr[0], bfr[1]);
            mma16816(carry[2 * dp + 1], ah, bfr[2], bfr[3]);
          }
        }
        if (ks == 3 - rbl) {   // block rbl + 4 is complete: out while the rest runs
          add_rr(carry, rbl + 4);
          flush_drk(carry, rbl + 4);
        }
      }
      // drr: sum_t dgsum_t rk_t over the rk rows no later tile touches: the
      // band's high 64 rows (this tile's sums and the previous tile's sums of
      // its low rows, the same rk rows), and on the last tile the low 64
      // too. Rows 8 warp.., dims 4 lane..; rows outside [0, klen) are zero.
      for (int half = has_next ? 1 : 0; half < 2; ++half) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = BQ * half + 8 * warp + i;
          const float gs = dgs[r] + (half ? dgs_prev[r - BQ] : 0.f);
          const uint2 raw = *reinterpret_cast<const uint2*>(band_row(r) + 4 * lane);
          const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
          const float2 x0 = __bfloat1622float2(x[0]), x1 = __bfloat1622float2(x[1]);
          drr_acc[0] += gs * x0.x;
          drr_acc[1] += gs * x0.y;
          drr_acc[2] += gs * x1.x;
          drr_acc[3] += gs * x1.y;
        }
      }
      add_rr(acc, rbl);
      if (has_next) {
#pragma unroll
        for (int n = 0; n < DH / 16; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) carry[n][e] = acc[n][e];
      } else {
        flush_drk(acc, rbl);
      }
    }
  }
  cp_async_wait_group0();   // K and V, should no query tile have been visited
  __syncthreads();

  // dK = dS^T . q + (sum_i dS_ij) r_w; dV; both cast to bf16
  const int j0 = 16 * kq + g, j1 = j0 + 8;
  const int key0 = c0 + j0, key1 = c0 + j1;
  const float s0 = dsum_s[j0], s1 = dsum_s[j1];
  const long long o0 =
      ((static_cast<long long>(b) * p.klen + key0) * p.H + h) * DH + DH / 2 * dh + 2 * t;
  const long long o1 = o0 + 8LL * p.H * DH;
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) {
    const int d = DH / 2 * dh + 8 * n + 2 * t;
    const float rx = rw_s[d], ry = rw_s[d + 1];
    if (key0 < p.klen) {
      *reinterpret_cast<uint32_t*>(p.dk + o0 + 8 * n) =
          pack_bf16(dk[n][0] + s0 * rx, dk[n][1] + s0 * ry);
      *reinterpret_cast<uint32_t*>(p.dv + o0 + 8 * n) = pack_bf16(dv[n][0], dv[n][1]);
    }
    if (key1 < p.klen) {
      *reinterpret_cast<uint32_t*>(p.dk + o1 + 8 * n) =
          pack_bf16(dk[n][2] + s1 * rx, dk[n][3] + s1 * ry);
      *reinterpret_cast<uint32_t*>(p.dv + o1 + 8 * n) = pack_bf16(dv[n][2], dv[n][3]);
    }
  }
  // drw: sum_j (sum_i dS_ij) k_j, dim tid % DH over half the keys (keys past
  // klen are zero rows)
  {
    const int d = tid % DH, jh = tid / DH;
    float drw_acc = 0.f;
    for (int j = BK / 2 * jh; j < BK / 2 * (jh + 1); ++j)
      drw_acc += dsum_s[j] * __bfloat162float(Ks[j * LDH + d]);
    atomicAdd(p.drw + h * DH + d, drw_acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) atomicAdd(p.drr + h * DH + 4 * lane + i, drr_acc[i]);
}

}  // namespace

extern "C" {

int bdm_rel_bwd_head_dim() { return DH; }
int bdm_rel_bwd_block_q() { return BQ; }
int bdm_rel_bwd_block_k() { return BK; }

const char* bdm_rel_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// which = 0: K4, dq [B, qlen, H, DH] bf16. which = 1: K5, dk and dv
// [B, klen, H, DH] bf16, and drk [klen, H, DH], drw and drr [H, DH] f32,
// which the caller zeroes and the kernel adds to. Pointers a kernel does not
// use may be null. q, k, v are bf16 with element strides (batch, token)
// given and the heads packed; rk and dout are contiguous bf16; rw and rr
// contiguous [H, DH] f32; m, l and delta contiguous [B, H, qlen] f32;
// rwk [B * H * klen] and rrk [H * klen] f32 scratch. Every pointer and
// stride must keep 16-byte alignment.
int bdm_flash_rel_attention_bwd(int which, const void* q, const void* k, const void* v,
                                const void* rk, const void* rw, const void* rr,
                                const void* dout, const void* m, const void* l,
                                const void* delta, void* rwk, void* rrk, void* dq, void* dk,
                                void* dv, void* drk, void* drw, void* drr, long long q_sb,
                                long long q_st, long long k_sb, long long k_st, long long v_sb,
                                long long v_st, int B, int H, int qlen, int klen, int mem_len,
                                int same_length, float scale, int device, void* stream) {
  const long long nq = (qlen + BQ - 1) / BQ;
  const long long nk = (klen + BK - 1) / BK;
  const long long dots = (static_cast<long long>(B) + 1) * H * klen;
  if ((which != 0 && which != 1) || B < 1 || H < 1 || qlen < 1 || klen < qlen ||
      static_cast<long long>(B) * H > 2147483647LL || nq > 65535 || nk > 65535 ||
      (dots * 32 + 255) / 256 > 2147483647LL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  static bool smem_set = false;   // above 48 KB only after this attribute
  if (!smem_set) {
    err = cudaFuncSetAttribute(k4_rel_bwd_dq_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DQ);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(k5_rel_bwd_dkv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DKV);
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
  p.dout = static_cast<const bf16*>(dout);
  p.m = static_cast<const float*>(m);
  p.l = static_cast<const float*>(l);
  p.delta = static_cast<const float*>(delta);
  p.rwk = static_cast<float*>(rwk);
  p.rrk = static_cast<float*>(rrk);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.drk = static_cast<float*>(drk);
  p.drw = static_cast<float*>(drw);
  p.drr = static_cast<float*>(drr);
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
  key_terms_kernel<<<static_cast<unsigned>((dots * 32 + 255) / 256), 256, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (which == 0) {
    const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>(nq));
    k4_rel_bwd_dq_kernel<<<grid, THREADS, SMEM_DQ, st>>>(p);
  } else {
    const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>(nk));
    k5_rel_bwd_dkv_kernel<<<grid, THREADS5, SMEM_DKV, st>>>(p);
  }
  return cudaGetLastError();
}

}  // extern "C"
