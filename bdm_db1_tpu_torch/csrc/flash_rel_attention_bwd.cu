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
// Layout. K4: one block of 4 warps takes 64 query rows of one (b, h), 16
// rows a warp, and walks the key tiles of K3's _tile_j_bounds; dq lives in
// registers. K5: one block takes 64 keys of one (b, h) and walks the query
// tiles of _tile_i_bounds. A tile is first computed query-major (each warp
// 16 query rows: p and dS in registers), written to shared memory as bf16
// p, dS and the skewed dG, then read key-major: each warp owns 16 keys for
// dV and dK (registers) and 32 band rows for the drk band product. Every
// (b, query tile) adds a band of 127 rows into the same rk rows: those sums
// go by f32 atomics (red.global.add) into one f32 [klen, H, Dh] buffer that
// the wrapper casts, so drk's summation order changes from run to run.
// (Summing the overlapping bands of a block's consecutive query tiles in a
// shared-memory ring first, with float4 atomics for the rows no later tile
// touches, read 1.648 ms against this version's 1.697 ms at the training
// shape on an H100 80GB HBM3 at 700 W, in two runs: the atomics are not
// what bounds K5.)
//
// What bounds it on an H100: operations. At the training shape (B 4,
// H 16, qlen = klen = 1024, Dh 128, causal: 33.6 M unbanned pairs) K4 runs
// 5 products of 2 * 128 FLOP a pair (AC, BD, dP, dq_ac, dq_bd): 43.0 GFLOP,
// 0.0435 ms at 989 TFLOP/s; K5 6 (AC, BD, dP, dV, dK, drk): 51.6 GFLOP,
// 0.0522 ms. This version is mma.sync from one 4-warp block an SM (K4
// uses 224 registers a thread and 124 KB of shared memory, K5 255 and
// 143 KB), with no copy/compute overlap: four warps an SM cannot hide the
// latency of the shared-memory round trips, so both run far above the
// bound. More warps an SM, wgmma and a TMA-fed ring of tiles are later
// work.
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
static_assert(WROWS * LDGB * 2 <= GW_BYTES && WROWS * LDD * 2 <= GW_BYTES,
              "a warp's dG must fit in its G buffer");

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
// K5 only
constexpr int P_OFF = SMEM_DQ;                       // bf16 p  [BQ, LDP]
constexpr int S_OFF = P_OFF + BQ * LDP * 2;          // bf16 dS [BQ, LDP]
constexpr int ST_OFF = S_OFF + BQ * LDP * 2;         // m, 1/l, delta [3, BQ]
constexpr int DSUM_OFF = ST_OFF + 3 * BQ * 4;        // sum_i dS_ij [BK]
constexpr int DGSUM_OFF = DSUM_OFF + BK * 4;         // sum_i dG_it [BAND]
constexpr int SMEM_DKV = DGSUM_OFF + BAND * 4;
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

// K5: dk, dv for 64 keys of one (b, h); drk, drw and drr by f32 atomics
__global__ void __launch_bounds__(THREADS, 1) k5_rel_bwd_dkv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + Q_OFF);
  bf16* Ks = reinterpret_cast<bf16*>(smem + K_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + V_OFF);
  bf16* dOs = reinterpret_cast<bf16*>(smem + DO_OFF);
  bf16* Rs = reinterpret_cast<bf16*>(smem + R_OFF);
  bf16* Ps = reinterpret_cast<bf16*>(smem + P_OFF);
  bf16* dSs = reinterpret_cast<bf16*>(smem + S_OFF);
  float* rwk_s = reinterpret_cast<float*>(smem + RWK_OFF);
  float* rrk_s = reinterpret_cast<float*>(smem + RRK_OFF);
  float* m_s = reinterpret_cast<float*>(smem + ST_OFF);
  float* il_s = m_s + BQ;
  float* dl_s = il_s + BQ;
  float* dsum_s = reinterpret_cast<float*>(smem + DSUM_OFF);
  float* dgsum_s = reinterpret_cast<float*>(smem + DGSUM_OFF);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* Gw = reinterpret_cast<float*>(smem + G_OFF + warp * GW_BYTES);
  // the block's dG [BQ, LDD]: rows 16w..16w+15 in warp w's G buffer
  const auto dg_row = [&](int r) {
    return reinterpret_cast<bf16*>(smem + G_OFF + (r / WROWS) * GW_BYTES) + (r % WROWS) * LDD;
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

  stage_rows(p.k + b * p.k_sb + h * DH, p.k_st, c0, p.klen, Ks, tid);
  stage_rows(p.v + b * p.v_sb + h * DH, p.v_st, c0, p.klen, Vs, tid);
  if (tid < BK) {
    const int j = c0 + tid;
    rwk_s[tid] = j < p.klen ? p.rwk[static_cast<long long>(bh) * p.klen + j] : 0.f;
    dsum_s[tid] = 0.f;
  }

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  float drr_acc = 0.f;   // thread tid: dim tid of sum_t dgsum_t rk_t
  const long long srow = static_cast<long long>(bh) * p.qlen;
  const bf16* qb = p.q + b * p.q_sb + h * DH;
  const bf16* dob = p.dout + static_cast<long long>(b) * p.qlen * p.H * DH + h * DH;

  for (int iq = i_lo; iq < i_hi; ++iq) {
    const int r0 = iq * BQ;
    const int t0 = c0 - r0 + p.qlen - BQ;   // rk row of band row 0
    __syncthreads();   // every warp is done with the previous tile
    stage_rows(qb, p.q_st, r0, p.qlen, Qs, tid);
    stage_rows(dob, static_cast<long long>(p.H) * DH, r0, p.qlen, dOs, tid);
    stage_band(p, h, r0, c0, Rs, rrk_s, tid);
    if (tid < BQ) {
      const int row = r0 + tid;
      const bool ok = row < p.qlen;
      m_s[tid] = ok ? p.m[srow + row] : 0.f;
      il_s[tid] = ok ? 1.f / fmaxf(p.l[srow + row], 1e-30f) : 0.f;
      dl_s[tid] = ok ? p.delta[srow + row] : 0.f;
    }
    dgsum_s[tid] = 0.f;
    cp_async_wait_all();
    __syncthreads();

    {  // query-major: this warp's 16 rows
      const int i0 = WROWS * warp + g;
      float pr[BK / 8][4], ds[BK / 8][4];
      tile_p_ds(p, geo, Qs, Ks, Vs, dOs, Rs, Gw, rwk_s, rrk_s, warp, lane, r0, c0, m_s[i0],
                m_s[i0 + 8], il_s[i0], il_s[i0 + 8], dl_s[i0], dl_s[i0 + 8], pr, ds);
      bf16* dg0 = dg_row(i0);
      bf16* dg1 = dg_row(i0 + 8);
      for (int e = lane; e < WROWS * LDD / 8; e += 32)
        reinterpret_cast<uint4*>(dg_row(WROWS * warp))[e] = make_uint4(0u, 0u, 0u, 0u);
      __syncwarp();
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const int j = 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(Ps + i0 * LDP + j) = pack_bf16(pr[n][0], pr[n][1]);
        *reinterpret_cast<uint32_t*>(Ps + (i0 + 8) * LDP + j) = pack_bf16(pr[n][2], pr[n][3]);
        *reinterpret_cast<uint32_t*>(dSs + i0 * LDP + j) = pack_bf16(ds[n][0], ds[n][1]);
        *reinterpret_cast<uint32_t*>(dSs + (i0 + 8) * LDP + j) = pack_bf16(ds[n][2], ds[n][3]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // block band column of (i, j) is BQ - 1 - i + j
          const int bc0 = BQ - 1 - i0 + j + e;
          dg0[bc0] = __float2bfloat16_rn(ds[n][e]);
          dg1[bc0 - 8] = __float2bfloat16_rn(ds[n][2 + e]);
          atomicAdd(dgsum_s + bc0, ds[n][e]);
          atomicAdd(dgsum_s + bc0 - 8, ds[n][2 + e]);
          // column sums of dS over the warp's 16 rows, then across warps
          float cs = ds[n][e] + ds[n][2 + e];
          cs += __shfl_xor_sync(0xffffffffu, cs, 4);
          cs += __shfl_xor_sync(0xffffffffu, cs, 8);
          cs += __shfl_xor_sync(0xffffffffu, cs, 16);
          if (g == 0) atomicAdd(dsum_s + j + e, cs);
        }
      }
    }
    __syncthreads();

    // key-major: this warp's 16 keys. dV += p^T . dO, dK += dS^T . q
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      uint32_t ap[4], as[4];
      ld_a_t(ap, Ps + 16 * kq * LDP + WROWS * warp, LDP, lane);
      ld_a_t(as, dSs + 16 * kq * LDP + WROWS * warp, LDP, lane);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t bfr[4];
        ld_b_t(bfr, dOs + 16 * kq * LDH + 16 * dp, LDH, lane);
        mma16816(dv[2 * dp], ap, bfr[0], bfr[1]);
        mma16816(dv[2 * dp + 1], ap, bfr[2], bfr[3]);
        ld_b_t(bfr, Qs + 16 * kq * LDH + 16 * dp, LDH, lane);
        mma16816(dk[2 * dp], as, bfr[0], bfr[1]);
        mma16816(dk[2 * dp + 1], as, bfr[2], bfr[3]);
      }
    }

    // drk band rows 32w..32w+31: dG^T . q + dgsum r_r, in 16-row, 64-dim pieces
#pragma unroll 1
    for (int mt = 0; mt < 2; ++mt) {
      const int br = 2 * WROWS * warp + WROWS * mt;   // first band row
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        float acc[DH / 16][4];
#pragma unroll
        for (int n = 0; n < DH / 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
        for (int kq = 0; kq < BQ / 16; ++kq) {
          uint32_t a[4];
          // A = dG^T: stored rows are queries 16kq.., columns band rows br..
          const int qr = 16 * kq + (lane & 7) + 8 * ((lane >> 4) & 1);
          ldsm_x4_t(a, dg_row(qr) + br + 8 * ((lane >> 3) & 1));
#pragma unroll
          for (int dp = 0; dp < DH / 32; ++dp) {
            uint32_t bfr[4];
            ld_b_t(bfr, Qs + 16 * kq * LDH + DH / 2 * half + 16 * dp, LDH, lane);
            mma16816(acc[2 * dp], a, bfr[0], bfr[1]);
            mma16816(acc[2 * dp + 1], a, bfr[2], bfr[3]);
          }
        }
        const int rA = br + g, rB = rA + 8;
        const int tA = t0 + rA, tB = t0 + rB;
        const bool okA = rA < BAND - 1 && tA >= 0 && tA < p.klen;
        const bool okB = rB < BAND - 1 && tB >= 0 && tB < p.klen;
        const float gA = dgsum_s[rA], gB = dgsum_s[rB];
        const float* rrh = p.rr + h * DH;
#pragma unroll
        for (int n = 0; n < DH / 16; ++n) {
          const int d = DH / 2 * half + 8 * n + 2 * t;
          const float2 rr2 = *reinterpret_cast<const float2*>(rrh + d);
          if (okA) {
            float* dst = p.drk + (static_cast<long long>(tA) * p.H + h) * DH + d;
            atomicAdd(dst, acc[n][0] + gA * rr2.x);
            atomicAdd(dst + 1, acc[n][1] + gA * rr2.y);
          }
          if (okB) {
            float* dst = p.drk + (static_cast<long long>(tB) * p.H + h) * DH + d;
            atomicAdd(dst, acc[n][2] + gB * rr2.x);
            atomicAdd(dst + 1, acc[n][3] + gB * rr2.y);
          }
        }
      }
    }

    // drr: sum_t dgsum_t rk_t, dim tid (band rows outside [0, klen) are zero)
    for (int r = 0; r < BAND - 1; ++r)
      drr_acc += dgsum_s[r] * __bfloat162float(Rs[r * LDH + tid]);
  }
  cp_async_wait_all();   // K and V, should no query tile have been visited
  __syncthreads();

  // dK = dS^T . q + (sum_i dS_ij) r_w; dV; both cast to bf16
  const int j0 = WROWS * warp + g, j1 = j0 + 8;
  const int key0 = c0 + j0, key1 = c0 + j1;
  const float s0 = dsum_s[j0], s1 = dsum_s[j1];
  const float* rwh = p.rw + h * DH;
  const long long o0 = ((static_cast<long long>(b) * p.klen + key0) * p.H + h) * DH + 2 * t;
  const long long o1 = o0 + 8LL * p.H * DH;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const float2 rw2 = *reinterpret_cast<const float2*>(rwh + 8 * n + 2 * t);
    if (key0 < p.klen) {
      *reinterpret_cast<uint32_t*>(p.dk + o0 + 8 * n) =
          pack_bf16(dk[n][0] + s0 * rw2.x, dk[n][1] + s0 * rw2.y);
      *reinterpret_cast<uint32_t*>(p.dv + o0 + 8 * n) = pack_bf16(dv[n][0], dv[n][1]);
    }
    if (key1 < p.klen) {
      *reinterpret_cast<uint32_t*>(p.dk + o1 + 8 * n) =
          pack_bf16(dk[n][2] + s1 * rw2.x, dk[n][3] + s1 * rw2.y);
      *reinterpret_cast<uint32_t*>(p.dv + o1 + 8 * n) = pack_bf16(dv[n][2], dv[n][3]);
    }
  }
  // drw: sum_j (sum_i dS_ij) k_j, dim tid (keys past klen are zero rows)
  float drw_acc = 0.f;
  for (int j = 0; j < BK; ++j) drw_acc += dsum_s[j] * __bfloat162float(Ks[j * LDH + tid]);
  atomicAdd(p.drw + h * DH + tid, drw_acc);
  atomicAdd(p.drr + h * DH + tid, drr_acc);
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
    k5_rel_bwd_dkv_kernel<<<grid, THREADS, SMEM_DKV, st>>>(p);
  }
  return cudaGetLastError();
}

}  // extern "C"
