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
// kernel runs q . k and q . rk as bf16 mma.sync products with f32
// accumulation (each bf16 x bf16 product is exact in f32) and adds those
// terms, so the scores keep the f32 arithmetic of the JAX kernel.
//
// One block of 8 warps takes 128 query rows of one (b, h), 16 rows a warp,
// one block an SM, and walks the 64-key tiles that hold any unbanned entry
// for its rows (fully banned tiles are skipped, as _tile_j_bounds does; a
// warp whose 16 rows ban the whole tile skips its products). Each staged
// K, V and band byte feeds 128 query rows. Q goes through shared memory
// once, into the A fragments each warp keeps in registers; the scores, the
// online softmax and the output accumulator live in registers (the score
// fragments become the bf16 A operand of the PV product without leaving
// the warp).
//
// The rel-shift. For 128 queries x 64 keys the rk rows a tile needs form a
// band of 191 rows (band row (127 - i) + j holds t = j - i + qlen - 1 for
// block row i and tile key j), and a warp's 16 rows need 79 of them: the
// warp's G = q_warp . band_warp^T over 80 rows goes to its shared memory as
// f32, with r_r . rk_t added, and BD[i, j] = G[i, j + (15 - i)] is read back
// in the score layout (the GPU form of the per-row pltpu.roll). Band rows
// outside [0, klen) are zero and pair only with banned positions.
//
// The copies. Key tile jb + 1 is in flight while tile jb is multiplied: a
// cp.async ring of two K/V stages, and for the band a ring of four 64-row
// chunks. Walking the key tiles upward moves the band up 64 rows a tile,
// so a tile brings only its 64 new band rows (the chunk's r_r . rk_t terms
// with them); band row r of tile tn lives in chunk tn + r / 64, ring slot
// (tn + r / 64) % 4, and both the G product and the skewed BD read address
// the slots. At the top of tile tn the block issues tile tn + 1 into the
// slots tile tn - 1 used, then waits (cp.async.wait_group 1) on the older
// group, tile tn's, and a barrier makes it visible; a second barrier at the
// end of the tile frees tile tn's slots.
//
// rk is read in place through its [klen, H, Dh] strides, q, k and v through
// their batch and token strides. The ragged query and key edges are masked
// here, so nothing is padded or copied: the JAX wrapper's rk pad and batch
// broadcast and the anylen wrapper's q/k/v pad have no counterpart (equal
// padding of q and k leaves shift unchanged on every real row). Query tiles
// are issued heaviest first (most key tiles).
//
// Shared memory (LDH = 136 bf16 a row, so ldmatrix rows hit distinct
// banks): Q 34.8 KB, two K/V stages 69.6 KB, the band ring 69.6 KB, eight
// warps' G 43 KB, the key terms 1.5 KB: 218,624 bytes. Registers: Q's A
// fragments (32), the output accumulator (64), the band product (40) and
// the scores (32), at the 255 a thread that one block of 8 warps an SM
// allows (a block of 12 warps would leave 170 a thread).
//
// What bounds it on an H100: operations. At the eval shape (B 4, H 16,
// qlen = klen = 1024, Dh 128, causal) each (b, h) has 524,800 unbanned
// pairs and three products (AC, BD, PV) of 2 * 128 FLOP each: 25.8 GFLOP,
// 0.026 ms at 989 TFLOP/s, against 71.8 MB of q, k, v, o, rk and stats,
// 0.021 ms at 3.35 TB/s. It executes more than the count (80 band rows for
// 64 keys, the masked halves of diagonal tiles) through mma.sync, which
// does not reach the wgmma peak; wgmma fed by TMA is the next step.
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
constexpr int WROWS = 16;        // query rows per warp
constexpr int WARPS = BQ / WROWS;
constexpr int THREADS = 32 * WARPS;
constexpr int NCH = (BQ + BK) / BK;    // band chunks a tile reads
constexpr int RING = NCH + 1;          // band chunks in the ring
constexpr int WBAND = WROWS + BK;      // 80 band rows per warp (79 used)
constexpr int VECS = DH / 8;           // 16-byte vectors per bf16 row
constexpr int LDH = DH + 8;            // bf16 row stride of Q, K, V, band
constexpr int LDG = WBAND + 4;         // f32 row stride of a warp's G
constexpr int TILE = BK * LDH * 2;     // one staged [64, 128] bf16 tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
static_assert(BQ % BK == 0 && WROWS % 16 == 0, "band groups of 16 rows stay in one chunk");

constexpr int Q_OFF = 0;
constexpr int K_OFF = Q_OFF + BQ * LDH * 2;                // 2 stages
constexpr int V_OFF = K_OFF + 2 * TILE;                    // 2 stages
constexpr int R_OFF = V_OFF + 2 * TILE;                    // band ring: RING chunks
constexpr int G_OFF = R_OFF + RING * TILE;                 // each warp's G
constexpr int RWK_OFF = G_OFF + WARPS * WROWS * LDG * 4;   // r_w . k_j  [2][BK]
constexpr int RRK_OFF = RWK_OFF + 2 * BK * 4;              // r_r . rk_t [RING][BK]
constexpr int SMEM = RRK_OFF + RING * BK * 4;
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// 2^x; underflow flushes to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// band chunk of 64 rk rows from t1 (and their r_r . rk_t) into ring slot
// `slot`, zero outside [0, klen)
__device__ __forceinline__ void stage_chunk(const Params& p, int h, int t1, unsigned char* smem,
                                            int slot, int tid) {
  bf16* Rs = reinterpret_cast<bf16*>(smem + R_OFF + slot * TILE);
  for (int e = tid; e < BK * VECS; e += THREADS) {
    const int r = e / VECS, c = (e % VECS) * 8;
    const int tr = t1 + r;
    const bool ok = tr >= 0 && tr < p.klen;
    cp_async16(Rs + r * LDH + c,
               ok ? p.rk + (static_cast<long long>(tr) * p.H + h) * DH + c : p.rk, ok);
  }
  if (tid < BK) {
    const int tr = t1 + tid;
    const bool ok = tr >= 0 && tr < p.klen;
    float* rrk_s = reinterpret_cast<float*>(smem + RRK_OFF) + slot * BK;
    cp_async4(rrk_s + tid, ok ? p.rrk + static_cast<long long>(h) * p.klen + tr : p.rrk, ok);
  }
}

// key tile c0's K, V and r_w . k_j into stage s, zero past klen
__device__ __forceinline__ void stage_kv(const Params& p, int bh, int b, int h, int c0,
                                         unsigned char* smem, int s, int tid) {
  bf16* Ks = reinterpret_cast<bf16*>(smem + K_OFF + s * TILE);
  bf16* Vs = reinterpret_cast<bf16*>(smem + V_OFF + s * TILE);
  const bf16* kb = p.k + b * p.k_sb + h * DH;
  const bf16* vb = p.v + b * p.v_sb + h * DH;
  for (int e = tid; e < BK * VECS; e += THREADS) {
    const int r = e / VECS, c = (e % VECS) * 8;
    const bool ok = c0 + r < p.klen;
    cp_async16(Ks + r * LDH + c, ok ? kb + (c0 + r) * p.k_st + c : kb, ok);
    cp_async16(Vs + r * LDH + c, ok ? vb + (c0 + r) * p.v_st + c : vb, ok);
  }
  if (tid >= THREADS - BK) {
    const int jl = tid - (THREADS - BK), j = c0 + jl;
    const bool ok = j < p.klen;
    float* rwk_s = reinterpret_cast<float*>(smem + RWK_OFF) + s * BK;
    cp_async4(rwk_s + jl, ok ? p.rwk + static_cast<long long>(bh) * p.klen + j : p.rwk, ok);
  }
}

__global__ void __launch_bounds__(THREADS, 1) k3_rel_attention_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + Q_OFF);
  const bf16* Rs = reinterpret_cast<const bf16*>(smem + R_OFF);
  const float* rrk_s = reinterpret_cast<const float*>(smem + RRK_OFF);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* Gw = reinterpret_cast<float*>(smem + G_OFF) + warp * WROWS * LDG;
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
  // r (rk row t_lo + 64 tn + r) is row r % 64 of chunk tn + r / 64
  const int t_lo = j_lo * BK - r0 + p.qlen - BQ;

  {  // Q, and tile 0: its K, V and the first NCH band chunks
    const bf16* qb = p.q + b * p.q_sb + h * DH;
    for (int e = tid; e < BQ * VECS; e += THREADS) {
      const int r = e / VECS, c = (e % VECS) * 8;
      const bool ok = r < rows;
      cp_async16(Qs + r * LDH + c, ok ? qb + (r0 + r) * p.q_st + c : qb, ok);
    }
    if (ntiles > 0) {
      stage_kv(p, bh, b, h, j_lo * BK, smem, 0, tid);
#pragma unroll
      for (int c = 0; c < NCH; ++c) stage_chunk(p, h, t_lo + BK * c, smem, c, tid);
    }
    cp_async_commit();
  }

  // rows il = g and g + 8 of this warp: block rows i0, i0 + 8
  const int i0 = WROWS * warp + g;
  const int row0 = r0 + i0, row1 = row0 + 8;
  const int wrow = r0 + WROWS * warp;          // the warp's first row
  const int wb = BQ - WROWS - WROWS * warp;    // the warp's first band row
  const float sl2 = p.scale * LOG2E;           // scores in log2 units
  uint32_t qa[DH / 16][4];                     // the warp's Q as A fragments
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // m in log2 units

  for (int tn = 0; tn < ntiles; ++tn) {
    const int s = tn & 1;
    const int c0 = (j_lo + tn) * BK;
    if (tn + 1 < ntiles) {   // tile tn + 1 into the slots tile tn - 1 used
      stage_kv(p, bh, b, h, c0 + BK, smem, s ^ 1, tid);
      stage_chunk(p, h, t_lo + BK * (tn + NCH), smem, (tn + NCH) % RING, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();   // tile tn's group (and Q's) has landed
    __syncthreads();
    if (tn == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldsm_x4(qa[kk], Qs + (WROWS * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDH +
                            kk * 16 + 8 * (lane >> 4));
    }
    // every entry of the warp's 16 rows x 64 keys banned (the upper half of
    // a diagonal tile, the window's edge, the ragged end)
    const bool empty = wrow >= p.qlen || c0 > wrow + WROWS - 1 + mlen ||
                       (p.same_length && c0 + BK - 1 < wrow - (shift - 1));
    if (!empty) {
      const bf16* Ks = reinterpret_cast<const bf16*>(smem + K_OFF + s * TILE);
      const bf16* Vs = reinterpret_cast<const bf16*>(smem + V_OFF + s * TILE);
      const float* rwk_s = reinterpret_cast<const float*>(smem + RWK_OFF) + s * BK;
      // the ring slot of the warp's band rows wb + 16 np .. + 15
      int slot[WBAND / 16];
#pragma unroll
      for (int np = 0; np < WBAND / 16; ++np) slot[np] = (tn + (wb + 16 * np) / BK) % RING;

      {  // G = q . band^T over the warp's 80 band rows, + r_r . rk_t, f32 in Gw
        float gacc[WBAND / 8][4];
#pragma unroll
        for (int n = 0; n < WBAND / 8; ++n) gacc[n][0] = gacc[n][1] = gacc[n][2] = gacc[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
          for (int np = 0; np < WBAND / 16; ++np) {
            uint32_t bfr[4];
            ldsm_x4(bfr, Rs + slot[np] * (TILE / 2) +
                             ((wb + 16 * np) % BK + 8 * (lane >> 4) + (lane & 7)) * LDH +
                             kk * 16 + 8 * ((lane >> 3) & 1));
            mma16816(gacc[2 * np], qa[kk], bfr[0], bfr[1]);
            mma16816(gacc[2 * np + 1], qa[kk], bfr[2], bfr[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < WBAND / 8; ++n) {
          const int c = 8 * n + 2 * t;
          const float2 rr = *reinterpret_cast<const float2*>(
              rrk_s + slot[n / 2] * BK + (wb + c) % BK);
          *reinterpret_cast<float2*>(Gw + g * LDG + c) =
              make_float2(gacc[n][0] + rr.x, gacc[n][1] + rr.y);
          *reinterpret_cast<float2*>(Gw + (g + 8) * LDG + c) =
              make_float2(gacc[n][2] + rr.x, gacc[n][3] + rr.y);
        }
      }
      // S = q . k^T: 8 tiles of 8 keys
      float sc[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t bfr[4];
          ldsm_x4(bfr, Ks + (16 * np + 8 * (lane >> 4) + (lane & 7)) * LDH + kk * 16 +
                           8 * ((lane >> 3) & 1));
          mma16816(sc[2 * np], qa[kk], bfr[0], bfr[1]);
          mma16816(sc[2 * np + 1], qa[kk], bfr[2], bfr[3]);
        }
      }
      __syncwarp();   // Gw is complete

      // scores (AC with r_w . k_j, the rel-shifted BD), mask, online softmax
      // most tiles ban nothing in the warp's 16 rows x 64 keys
      const bool full = wrow + WROWS <= p.qlen && c0 + BK <= p.klen &&
                        c0 + BK - 1 <= wrow + mlen &&
                        (!p.same_length || c0 >= wrow + WROWS - 1 - (shift - 1));
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const int jp = 8 * n + 2 * t;
        const float2 rw = *reinterpret_cast<const float2*>(rwk_s + jp);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = jp + e;
          const int gc0 = WROWS - 1 - g + j;        // G column of (row i0, key j)
          const float rwj = e ? rw.y : rw.x;
          float x0 = (sc[n][e] + rwj + Gw[g * LDG + gc0]) * sl2;
          float x1 = (sc[n][2 + e] + rwj + Gw[(g + 8) * LDG + gc0 - 8]) * sl2;
          if (!full) {
            const int col = c0 + j;
            bool ban0 = col > row0 + mlen || col >= p.klen;
            bool ban1 = col > row1 + mlen || col >= p.klen;
            if (p.same_length) {
              ban0 = ban0 || col < row0 - (shift - 1);
              ban1 = ban1 || col < row1 - (shift - 1);
            }
            x0 = ban0 ? NEG_INF : x0;
            x1 = ban1 ? NEG_INF : x1;
          }
          sc[n][e] = x0;
          sc[n][2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[n][e] = exp2_approx(sc[n][e] - mn0);
          sc[n][2 + e] = exp2_approx(sc[n][2 + e] - mn1);
          sum0 += sc[n][e];
          sum1 += sc[n][2 + e];
        }
      }
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
      const float a0 = exp2_approx(m0 - mn0), a1 = exp2_approx(m1 - mn1);
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        o[n][0] *= a0;
        o[n][1] *= a0;
        o[n][2] *= a1;
        o[n][3] *= a1;
      }

      // O += bf16(p) . V: the score tiles 2k, 2k + 1 are the A fragment of keys 16k..16k+15
#pragma unroll
      for (int kq = 0; kq < BK / 16; ++kq) {
        uint32_t pa[4];
        pa[0] = pack_bf16(sc[2 * kq][0], sc[2 * kq][1]);
        pa[1] = pack_bf16(sc[2 * kq][2], sc[2 * kq][3]);
        pa[2] = pack_bf16(sc[2 * kq + 1][0], sc[2 * kq + 1][1]);
        pa[3] = pack_bf16(sc[2 * kq + 1][2], sc[2 * kq + 1][3]);
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t vfr[4];
          ldsm_x4_t(vfr, Vs + (16 * kq + 8 * ((lane >> 3) & 1) + (lane & 7)) * LDH + 16 * dp +
                             8 * (lane >> 4));
          mma16816(o[2 * dp], pa, vfr[0], vfr[1]);
          mma16816(o[2 * dp + 1], pa, vfr[2], vfr[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with tile tn's slots
  }
  cp_async_wait<0>();   // Q, should no key tile have been visited

  // o = acc / max(l, 1e-30) in bf16; row stats in f32, m in natural units
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  bf16* out0 = p.o + ((static_cast<long long>(b) * p.qlen + row0) * p.H + h) * DH + 2 * t;
  bf16* out1 = out0 + 8LL * p.H * DH;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    if (row0 < p.qlen)
      *reinterpret_cast<uint32_t*>(out0 + 8 * n) = pack_bf16(o[n][0] / den0, o[n][1] / den0);
    if (row1 < p.qlen)
      *reinterpret_cast<uint32_t*>(out1 + 8 * n) = pack_bf16(o[n][2] / den1, o[n][3] / den1);
  }
  if (t == 0) {
    const long long srow = static_cast<long long>(bh) * p.qlen;
    if (row0 < p.qlen) {
      p.m[srow + row0] = m0 * LN2;
      p.l[srow + row0] = l0;
    }
    if (row1 < p.qlen) {
      p.m[srow + row1] = m1 * LN2;
      p.l[srow + row1] = l1;
    }
  }
}

}  // namespace

extern "C" {

int bdm_rel_head_dim() { return DH; }
int bdm_rel_block_q() { return BQ; }
int bdm_rel_block_k() { return BK; }

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
