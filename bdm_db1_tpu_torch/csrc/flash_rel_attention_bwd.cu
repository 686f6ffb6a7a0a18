// TransformerXL relative attention, backward, for Hopper (sm_90a): K4 and K5.
//
// Replaces the Pallas kernels _rel_attention_bwd_dq_kernel (K4, :244,
// launched at :470) and _rel_attention_bwd_dkv_kernel (K5, :299, launched
// at :487) of bdm_db1_tpu/ops/pallas_attention.py, with the assembly of
// _pallas_rel_attention_bwd_impl (:441). Contract: for the forward of K3
// (csrc/flash_rel_attention.cu; q [B, qlen, H, Dh], k/v [B, klen, H, Dh],
// rk [klen, H, Dh], f32 biases r_w, r_r [H, Dh]), its row stats (m, l)
// [B, H, qlen], the upstream gradient dO [B, qlen, H, Dh] and
// delta = rowsum(dO * O) [B, H, qlen] (f32):
//
//   p = exp(s - m) / max(l, 1e-30), s recomputed exactly as K3 computes it
//   dP = dO . V^T,  dS = p * (dP - delta) * scale
//   dG[i, j + (qlen - 1 - i)] = dS[i, j]      (the rel-shift, backward)
//   dq  = dS . K + dG . rk                     (K4)
//   dV  = p^T . dO,  dK = dS^T . (q + r_w)     (K5)
//   drk = sum_b dG^T . (q + r_r)               (K5, summed over the batch)
//   drw = sum_{b,i} (dS . K)_i,  drr = sum_{b,i} (dG . rk)_i   (K5)
//
// One backward is three launches on one stream: a preparation kernel
// (delta, and the f32 per-key terms r_w . k_j and r_r . rk_t, one warp per
// dot product over bf16 rows), then K4, then K5. Both kernels read the one
// delta and the one set of key terms (the JAX package also computes delta
// once, in XLA). A separate small kernel rather than K4's prologue: K5
// needs every row's delta, and the preparation reads ~55 MB at the
// training shape (0.016 ms at the memory rate), where a prologue would
// hold each K4 block on a second [64, 128] load before its first tile.
//
// Scores. Each tile recomputes q . k and q . rk_band as bf16 tensor-core
// products (K4: wgmma; K5: mma.sync) with f32 accumulation plus the
// per-key terms, with K3's mask
// from indices (a banned entry gets p = 0, as exp(-1e30 - m) gives it)
// and K3's skipping of fully banned tiles, so exp(s - m) / l gives back
// K3's probabilities. p and dS are rounded to bf16 for the tensor-core
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
// product G. The backward writes dS into shared memory at dG[i, j + (63 -
// i)] over the block's 64 rows (bf16, zero elsewhere) and runs dq += dG .
// band (K4) or drk_band += dG^T . q (K5). No row reversal or roll of the
// TPU kernels is needed: it is an addressing change.
//
// K4. One block of two warpgroups (8 warps) takes 64 query rows of one
// (b, h) and walks the key tiles of K3's _tile_j_bounds in order. All five
// products are wgmma (m64nNk16, f32 accumulators, B from 128-byte-swizzled
// shared memory); a tile runs in three passes between three block
// barriers:
// - Scores: warpgroup g computes G[:, 64 g..] = Q . (band chunk g)^T
//   (n64; chunk 0 the tile's low ring slot, chunk 1 its high one), S = Q .
//   K[32 g..]^T and dP = dO . V[32 g..]^T (n32), 8 k-steps over the head
//   dims, B K-major as staged. A is Q or dO from registers: the warp's A
//   fragments of the 8 k-steps, loaded once a block from the staged tiles
//   (64 registers). The next tile's copies go out under these products.
//   G goes to shared memory, f32 [64, 128] (row stride 136: the
//   accumulator stores are free of bank conflicts).
// - Elementwise, in the accumulator layout: warp w of warpgroup g holds
//   rows 16 (w % 4).. x keys 32 g.. of S and dP (16 x 32, the query-major
//   tile of the mma.sync design, so its all-banned and all-unbanned tests
//   carry over). It reads BD at G[i, 63 - i + j], and p scale = exp2(s scale
//   log2e - (m log2e + log2(l / scale))) and dS = p scale (dP - delta) are
//   one FFMA, one MUFU.EX2, one FADD and one FMUL an element past the sum
//   of the score terms; a masked entry takes a select, not a branch. dS
//   goes as bf16 into dS and, skewed, into dG (the cells no tile writes are
//   zeroed once).
// - dq, after fence.proxy.async: warpgroup g owns head dims 64 g..: dq +=
//   dS . K (4 k-steps) and dq += dG . band (8 k-steps, 4 a ring slot), B
//   the K tile's or chunk's half g, MN-major. dS and dG are A in wgmma's
//   interleaved layout (no swizzle: 8 x 16-byte core matrices, 128 bytes
//   apart along K), so each thread's 24 stores a tile sit at fixed offsets
//   from two bases, free of bank conflicts. dq is 32 f32 a thread.
// - Stages: Q and dO once; K, V and r_w . k_j in two stages; the band in a
//   ring of three 64-row chunks (a tile loads only its 64 new high rows).
//   Each thread copies the same four 16-byte chunks of every tile, so their
//   addresses are set up once a block and move on by a step a tile.
// - Budget: 209,408 bytes of shared memory (Q, dO 32 KB; two stages of K
//   and V 64 KB; the band ring 48 KB; G 34 KB; dG 16 KB; dS 8 KB; key terms
//   1.5 KB; 1 KB to align), 205 registers, one block an SM.
// With two warps a scheduler and nothing else on the SM, instruction
// throughput sets the pace: a first wgmma version, with the copy
// addresses, the swizzled stores and the descriptors computed anew for
// every tile, ran no faster than the mma.sync kernel it replaced. A branch
// around a warpgroup's products (to skip a fully banned one) makes ptxas
// serialize every wgmma of the kernel (its note C7520); so does keeping
// the dq group in flight under the next tile's score products (C7515).
// Pipelining the tiles (the dq products of one tile and the score
// products of the next as one batch, two barriers a tile) gained
// nothing: no pass overlaps another within a block.
//
// K5. One block of 8 warps (two warpgroups) takes 64 keys of one (b, h)
// and walks the query tiles of _tile_i_bounds in order. A tile runs in two
// passes between two block barriers:
// - Query-major, on mma.sync: warp w takes row group w / 2 (16 query rows)
//   and key half w % 2 (32 keys), so its band slice is 48 rows (G, p and dS
//   are [16, 48] and [16, 32] in registers). The sums of dS over rows (for
//   dK's r_w term and drw) and over diagonals (dgsum, for drk's r_r term
//   and drr) stay f32: dS goes skewed into the warp's own G buffer and each
//   lane adds one column, one shared add per sum. p and dS go to shared
//   memory transposed (keys x queries) as bf16 by stmatrix.trans, and dS
//   skewed and transposed into dG^T[63 - i + j, i] (band rows x queries;
//   a buffer of its own, so the cells no tile writes are zeroed once).
// - Key-major, on wgmma: warpgroup g takes head dims 64 g.. and issues
//   m64n64k16 products over the tile's 64 queries (4 k-steps), both
//   operands from shared memory: dV += p^T . dO, dK += dS^T . q, and drk
//   += dG^T . q over the band's low block (rows 0-63, fresh) and high block
//   (rows 64-127), then one commit and one wait. drr (dgsum . rk over the
//   rk rows no later tile touches, on CUDA cores) runs while the products
//   are in flight. Accumulators: dK, dV and the two drk blocks, 128 f32 a
//   thread (warp w of a warpgroup holds keys, or band rows, 16 (w % 4)..);
//   no A or B fragments, no ldmatrix in this pass.
// - drk. The next query tile's band is this one's moved down 64 rows, so
//   the low block is the next tile's high block: it stays in registers.
//   The high block, complete after this tile, goes to drk by
//   red.global.add.v4.f32, once per rk row per block and tile pair. Added
//   at once from the accumulator layout (16 rows of 32 bytes an
//   instruction) at the end of each tile, with nothing left to run under
//   them, these adds cost more than the products saved, so the block is
//   rearranged through shared memory and its adds spread: each warp writes
//   it into its own chunks of the Q/dO stage just read (the staging copies
//   of a warpgroup fill the head-dim half its products read, so between
//   that warpgroup's last product on a stage and the stage's next copy the
//   chunks are the thread's own), and each lane adds its chunk k at k-step
//   k of the next tile's query-major products, 2 rows whole (4 full
//   128-byte lines) an instruction, before its copies of the tile after
//   overwrite them. The last tile adds both blocks at once. Every (b, key
//   tile) adds into the same rk rows, so drk's summation order changes from
//   run to run.
// - Layouts: wgmma reads shared memory in its canonical layouts, so p^T,
//   dS^T and dG^T (A, K-major) and the staged Q and dO (B, rows of queries
//   x head dims: MN-major, the transpose bit) are 128-byte-swizzled tiles
//   of 64-value rows, 16-byte chunk c of row r at chunk c ^ (r % 8), each
//   1024-byte aligned; Q and dO as two [64, 64] halves, one a warpgroup.
//   The query-major pass reads Q and dO by ldmatrix through the same
//   swizzle. K, V and the rk band keep their padded rows (LDH): only
//   mma.sync reads them.
// - Stages: Q, dO, (m, l, delta) and r_r . rk_t in two stages; the band in
//   a ring of three 64-row chunks, so a tile loads only its 64 new rk rows.
//   The next tile's cp.async copies are issued inside the query-major pass
//   and waited for (wait_group 0) at the next tile's first barrier; the
//   generic writes (cp.async, stmatrix, stores) reach wgmma through
//   fence.proxy.async before the second barrier.
// - Budget: 218,624 bytes of shared memory (two stages of Q and dO 64 KB;
//   p^T, dS^T 16 KB; dG^T 16 KB; K, V 34.8 KB; the band ring 52.2 KB;
//   eight warps' G 26.6 KB; stats, biases and sums 5.5 KB; 1 KB to align),
//   one block an SM. Double-buffered p^T/dS^T/dG^T, which would let one
//   tile's products overlap the next tile's query-major pass, do not fit
//   beside the two Q/dO stages and the band ring. The 1024-byte alignment
//   is an offset from the shared array itself: through an integer the
//   pointer loses the shared state space, every plain access and atomic
//   becomes generic, and K5 runs 9-10% slower (a probe build on an H100).

// What bounds them on an H100: operations by the count, latency in fact.
// At the training shape (B 4, H 16, qlen = klen = 1024, Dh 128, causal:
// 33.6 M unbanned pairs) K4 runs 5 products of 2 * 128 FLOP a pair (AC,
// BD, dP, dq_ac, dq_bd): 43.0 GFLOP, 0.0435 ms at 989 TFLOP/s; K5 6 (AC,
// BD, dP, dV, dK, drk): 51.6 GFLOP, 0.0522 ms. Both execute more than that
// count (K4: G over 128 band rows and dG . band over 128 band columns, 7
// products' worth a tile for 5; K5: 48 band rows for 32 keys; both the
// masked halves of diagonal tiles). On an H100 80GB HBM3 at 700 W, K4
// takes 0.168 ms there: its passes run one after another in the SM's one
// block, and probe builds with one part removed at a time save 0.038 ms
// (the elementwise pass), 0.035 (the score products), 0.029 (the G round
// trip), 0.026 (the dq products) and 0.010 (the staging); on the memory
// trunk 0.019, 0.017, 0.015, 0.012 and 0.009 of 0.083. dS and dG in
// 128-byte-swizzled tiles instead of the interleaved layout cost 4-6%.
// K5's key-major products, half its tensor work, take 0.033 of its 0.44
// ms on wgmma; the drk adds 0.021, the drr sums 0.019, the p^T, dS^T and
// dG^T stores 0.011 (probe builds, training shape, the same card); the
// rest is the query-major pass on mma.sync.
// (Pairing the blocks of two batch elements in a cluster, to add their drk
// rows through distributed shared memory before the atomics, was slower:
// two cluster barriers a tile hold both blocks in step. Walking two key
// tiles a block, so that the first's last adds drain under the second,
// gained nothing.) Left: TMA for the staging, and overlap within a block
// (K4: the warpgroups out of phase, so that one's elementwise pass runs
// under the other's products; K5: one tile's key-major products under the
// next tile's query-major pass).
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
constexpr int WROWS = 16;              // query rows (or keys) per warp
constexpr int VECS = DH / 8;           // 16-byte vectors per bf16 row
constexpr int LDH = DH + 8;            // bf16 row stride of K5's K, V and band
constexpr int TILE = BQ * LDH * 2;     // one staged [64, 128] bf16 tile, padded rows

// K4 and K5: eight warps (two warpgroups). In K5's query-major pass warp w
// takes row group w / 2 (16 query rows) and key half w % 2 (32 keys), over
// a 48-row band slice.
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int KH = BK / 2;                 // keys per warp, query-major
constexpr int WBAND = WROWS + KH;          // 48 band rows per warp (47 used)
constexpr int LDG = WBAND + 4;             // f32 row stride of a warp's G
constexpr int GW_BYTES = WROWS * LDG * 4;  // one warp's G
// The wgmma operands: bf16 tiles of 128-byte rows (64 values) under the
// 128-byte swizzle, each 1024-byte aligned. A [64, 128] staged tile (Q,
// dO, K, V, a band chunk) is two such [64, 64] halves, head dims 0-63 and
// 64-127.
constexpr int SW_ROW = 64;                   // bf16 values of a swizzled row
constexpr int SW_HALF = BQ * SW_ROW;         // bf16 values of a [64, 64] tile
constexpr int SW_TILE = 2 * SW_HALF * 2;     // bytes of a staged [64, 128] tile
constexpr int K5_Q = 0;                               // 2 stages, swizzled
constexpr int K5_DO = K5_Q + 2 * SW_TILE;             // 2 stages, swizzled
constexpr int K5_P = K5_DO + 2 * SW_TILE;             // p^T [BK, BQ], swizzled
constexpr int K5_S = K5_P + SW_HALF * 2;              // dS^T [BK, BQ], swizzled
constexpr int K5_DG = K5_S + SW_HALF * 2;             // dG^T [BAND, BQ], swizzled
constexpr int K5_K = K5_DG + 2 * SW_HALF * 2;
constexpr int K5_V = K5_K + TILE;
constexpr int K5_R = K5_V + TILE;                     // rk band: a ring of 3 x 64 rows
constexpr int K5_G = K5_R + 3 * TILE;                 // 8 warps' G
constexpr int K5_RRK = K5_G + WARPS * GW_BYTES;       // r_r . rk_t [2][BAND]
constexpr int K5_ST = K5_RRK + 2 * BAND * 4;          // m, l, delta [2][3][BQ]
constexpr int K5_RWK = K5_ST + 2 * 3 * BQ * 4;        // r_w . k_j [BK]
constexpr int K5_BIAS = K5_RWK + BK * 4;              // r_w, r_r [2][DH]
constexpr int K5_DSUM = K5_BIAS + 2 * DH * 4;         // sum_i dS_ij [BK]
constexpr int K5_DGSUM = K5_DSUM + BK * 4;            // sum_i dG_it [3][BAND]
// and up to 1023 bytes to align the dynamic shared memory to 1024
constexpr int SMEM_DKV = K5_DGSUM + 3 * BAND * 4 + 1024;
static_assert(K5_K % 1024 == 0, "the swizzled tiles must stay 1024-byte aligned");
static_assert(SMEM_DKV <= 232448, "one block must fit one SM");
constexpr int LDG4 = BAND + 8;                        // f32 row stride of K4's G
constexpr int K4_Q = 0;                               // swizzled, as K4_DO
constexpr int K4_DO = K4_Q + SW_TILE;
constexpr int K4_K = K4_DO + SW_TILE;                 // 2 stages, swizzled
constexpr int K4_V = K4_K + 2 * SW_TILE;              // 2 stages, swizzled
constexpr int K4_R = K4_V + 2 * SW_TILE;              // rk band: a ring of 3 x 64 rows, swizzled
constexpr int K4_S = K4_R + 3 * SW_TILE;              // dS [BQ, BK], interleaved
constexpr int K4_DG = K4_S + SW_HALF * 2;             // dG [BQ, BAND], interleaved
constexpr int K4_G = K4_DG + 2 * SW_HALF * 2;         // f32 G [BQ, LDG4]
constexpr int K4_RRK = K4_G + BQ * LDG4 * 4;          // r_r . rk_t [2][BAND]
constexpr int K4_RWK = K4_RRK + 2 * BAND * 4;         // r_w . k_j [2][BK]
// and up to 1023 bytes to align the dynamic shared memory to 1024
constexpr int SMEM_DQ = K4_RWK + 2 * BK * 4 + 1024;
static_assert(K4_G % 1024 == 0, "the swizzled tiles must stay 1024-byte aligned");
static_assert(SMEM_DQ <= 232448, "one block must fit one SM");

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* rk;
  const float* rw;
  const float* rr;
  const bf16* dout;    // [B, qlen, H, DH] contiguous
  const bf16* out;     // [B, qlen, H, DH] contiguous: the forward's output
  const float* m;      // [B * H, qlen]
  const float* l;
  float* delta;        // [B * H, qlen]: rowsum(dO * O), made by the preparation
  float* rwk;          // [B * H, klen]: r_w . k_j, made by the preparation
  float* rrk;          // [H, klen]: r_r . rk_t, made by the preparation
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

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_group0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (MUFU.EX2)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four 8 x 8 bf16 matrices stored transposed: lane l's registers hold row
// l / 4, columns 2 (l % 4).. of each, which go to column l / 4 of rows
// 2 (l % 4).. in memory; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void stsm_x4_t(bf16* p, uint32_t r0, uint32_t r1, uint32_t r2,
                                          uint32_t r3) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n" ::"r"(a),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// element (r, c) of a tile of 128-byte bf16 rows under the 128-byte
// swizzle: 16-byte chunk c / 8 of row r lies at chunk (c / 8) ^ (r % 8)
__device__ __forceinline__ int sw128(int r, int c) {
  return r * SW_ROW + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

// element (r, d) of a staged swizzled [64, 128] tile (two [64, 64] halves)
__device__ __forceinline__ int sw_tile(int r, int d) { return (d >> 6) * SW_HALF + sw128(r, d & 63); }

// A fragment (16 rows from r0 x 16 head dims from 16 kk) of a staged
// swizzled tile
__device__ __forceinline__ void ld_a_sw(uint32_t* r, const bf16* base, int r0, int kk, int lane) {
  ldsm_x4(r, base + sw_tile(r0 + (lane & 7) + 8 * ((lane >> 3) & 1), 16 * kk + 8 * (lane >> 4)));
}

// ---- wgmma (all of K4's products, K5's key-major products) ------------------

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

// Descriptor of a K-major tile in the interleaved layout (no swizzle): 8 x
// 16-byte core matrices of 128 contiguous bytes, the two of a k16 slice
// 128 bytes apart, 8-row groups `sbo` bytes apart; a k16 slice starts 256
// bytes further.
__device__ __forceinline__ uint64_t desc_inter(uint32_t saddr, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// the descriptor of the tile `bytes` further: its start address field, the
// low 14 bits, never carries into the rest
__device__ __forceinline__ uint64_t desc_at(uint64_t d, uint32_t bytes) {
  return (d & 0xFFFFFFFF00000000ull) | (static_cast<uint32_t>(d) + (bytes >> 4));
}

// d[64 x 64] (+)= A . B, A K-major and B MN-major (transposed) from shared
// memory; thread l of warp w of the warpgroup holds d[n][0..1] at row
// 16 w + l / 4, columns 8 n + 2 (l % 4).., d[n][2..3] eight rows below.
// scale_d 0 ignores d's old values.
#define WG_D4(n) "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
__device__ __forceinline__ void wgmma_64x64(float (&d)[DH / 16][4], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3), WG_D4(4), WG_D4(5), WG_D4(6), WG_D4(7)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 64] (+)= A . B, A from registers (the mma.sync A fragment of the
// warp's 16 rows), B K-major from shared memory
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

// d[64 x 32] (+)= A . B, A from registers, B K-major from shared memory
__device__ __forceinline__ void wgmma_64x32_rs(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
#undef WG_D4

// after wgmma.wait_group: the accumulators are read only from here on
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

// B fragments for two n-tiles of 8 from rows [n, d] of a stored tile (k-dim d)
__device__ __forceinline__ void ld_b(uint32_t* r, const bf16* base, int ld, int lane) {
  ldsm_x4(r, base + (8 * (lane >> 4) + (lane & 7)) * ld + 8 * ((lane >> 3) & 1));
}

// The preparation, one warp per dot product over two rows of 128 read in
// bf16, summed in f32: r_w . k_j for every (b, h, j), r_r . rk_t for every
// (h, t), then, when out is given, delta = dO_i . O_i for every (b, h, i).
__global__ void prep_kernel(const Params p) {
  const long long w = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_k = static_cast<long long>(p.B) * p.H * p.klen;
  const long long n_r = static_cast<long long>(p.H) * p.klen;
  const long long n_d = p.out ? static_cast<long long>(p.B) * p.H * p.qlen : 0;
  if (w >= n_k + n_r + n_d) return;
  const bf16* row;
  float4 bb;
  float* dst;
  if (w < n_k) {
    const int bh = static_cast<int>(w / p.klen), j = static_cast<int>(w % p.klen);
    const int b = bh / p.H, h = bh % p.H;
    row = p.k + b * p.k_sb + j * p.k_st + h * DH;
    bb = *reinterpret_cast<const float4*>(p.rw + h * DH + 4 * lane);
    dst = p.rwk + w;
  } else if (w < n_k + n_r) {
    const long long w2 = w - n_k;
    const int h = static_cast<int>(w2 / p.klen), t = static_cast<int>(w2 % p.klen);
    row = p.rk + (static_cast<long long>(t) * p.H + h) * DH;
    bb = *reinterpret_cast<const float4*>(p.rr + h * DH + 4 * lane);
    dst = p.rrk + w2;
  } else {
    const long long w2 = w - n_k - n_r;   // (b * H + h) * qlen + i
    const int bh = static_cast<int>(w2 / p.qlen), i = static_cast<int>(w2 % p.qlen);
    const long long off = ((static_cast<long long>(bh / p.H) * p.qlen + i) * p.H + bh % p.H) * DH;
    row = p.dout + off;
    const uint2 raw = *reinterpret_cast<const uint2*>(p.out + off + 4 * lane);
    const __nv_bfloat162* o = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 o0 = __bfloat1622float2(o[0]), o1 = __bfloat1622float2(o[1]);
    bb = make_float4(o0.x, o0.y, o1.x, o1.y);
    dst = p.delta + w2;
  }
  const uint2 raw = *reinterpret_cast<const uint2*>(row + 4 * lane);
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
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

// Stage 64 rk rows from t1 into Rs (zero outside [0, klen)).
__device__ __forceinline__ void stage_rk(const Params& p, int h, int t1, bf16* Rs, int tid) {
  for (int e = tid; e < BQ * VECS; e += THREADS) {
    const int r = e / VECS, c = (e % VECS) * 8;
    const int tr = t1 + r;
    const bool ok = tr >= 0 && tr < p.klen;
    cp_async16(Rs + r * LDH + c,
               ok ? p.rk + (static_cast<long long>(tr) * p.H + h) * DH + c : p.rk, ok);
  }
}

// K4: thread tid's four 16-byte chunks of a swizzled [64, 128] tile at dst
// (rows row + 16 i, i < 4, row = tid / 16; head dims 8 (tid % 16)..) by
// cp.async from src + i * step bytes, zeroed where !ok(i). Every tile a
// thread copies the same chunks: their addresses are set up once a block
// and move on by a fixed step a tile.
template <typename Ok>
__device__ __forceinline__ void k4_copy(unsigned char* dst, const bf16* src, uint32_t step, Ok ok,
                                        const bf16* any) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
#pragma unroll
  for (int i = 0; i < BQ / WROWS; ++i) {
    const bool v = ok(i);
    cp_async16(dst + i * (WROWS * SW_ROW * 2), v ? reinterpret_cast<const bf16*>(s + i * step) : any, v);
  }
}

// K4: a thread's chunk of every staged tile: its row and its byte offset in
// a swizzled tile; its first element of the next key tile's K and V and of
// the next band chunk's rk rows, and the bytes from one of its chunks to
// the next (16 rows)
struct K4Chunk {
  int row, off;
  const bf16 *k, *v, *rk;
  uint32_t k16, v16, rk16;
};

// K4: one band chunk (64 rk rows from t1) into ring slot `slot` (zero
// outside [0, klen)); the chunk's pointer moves on 64 rows
__device__ __forceinline__ void k4_stage_rk(const Params& p, K4Chunk& ch, int t1, unsigned char* smem,
                                            int slot) {
  k4_copy(smem + K4_R + slot * SW_TILE + ch.off, ch.rk, ch.rk16, [&](int i) {
    const int tr = t1 + ch.row + WROWS * i;
    return tr >= 0 && tr < p.klen;
  }, p.rk);
  ch.rk += static_cast<long long>(BQ) * p.H * DH;
}

// K4: stage key tile c0's K, V and r_w . k_j into stage s, the r_r . rk_t
// terms of its band (rk rows from t0), and the band's high 64 rows into
// ring slot `slot`, by cp.async (zero past klen and outside [0, klen)). The
// band's low 64 rows are the previous tile's high ones.
__device__ __forceinline__ void k4_stage(const Params& p, K4Chunk& ch, int bh, int h, int c0, int t0,
                                         unsigned char* smem, int s, int slot, int tid) {
  const auto key_ok = [&](int i) { return c0 + ch.row + WROWS * i < p.klen; };
  k4_copy(smem + K4_K + s * SW_TILE + ch.off, ch.k, ch.k16, key_ok, p.k);
  k4_copy(smem + K4_V + s * SW_TILE + ch.off, ch.v, ch.v16, key_ok, p.v);
  ch.k += static_cast<long long>(BK) * p.k_st;
  ch.v += static_cast<long long>(BK) * p.v_st;
  k4_stage_rk(p, ch, t0 + BQ, smem, slot);
  float* rrk_s = reinterpret_cast<float*>(smem + K4_RRK) + s * BAND;
  float* rwk_s = reinterpret_cast<float*>(smem + K4_RWK) + s * BK;
  if (tid < BAND) {
    const int tr = t0 + tid;
    const bool ok = tr >= 0 && tr < p.klen;
    cp_async4(rrk_s + tid, ok ? p.rrk + static_cast<long long>(h) * p.klen + tr : p.rrk, ok);
  } else if (tid < BAND + BK) {
    const int j = c0 + tid - BAND;
    const bool ok = j < p.klen;
    cp_async4(rwk_s + tid - BAND, ok ? p.rwk + static_cast<long long>(bh) * p.klen + j : p.rwk, ok);
  }
}

// K4: dq for 64 query rows of one (b, h)
__global__ void __launch_bounds__(THREADS, 1) k4_rel_bwd_dq_kernel(const Params p) {
  // the swizzled tiles need 1024-byte alignment; an offset from the shared
  // array itself keeps every access in the shared state space
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - static_cast<unsigned>(__cvta_generic_to_shared(smem_raw))) & 1023u);
  float* Gs = reinterpret_cast<float*>(smem + K4_G);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
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

  // warpgroup wg: keys 32 wg.. of S and dP, band rows 64 wg.. of G, head
  // dims 64 wg.. of dq; warp rg = warp % 4 of it: accumulator rows 16 rg..
  // (rows i0 and i0 + 8). wg by a shuffle from lane 0, so that the compiler
  // keeps what depends on it (the descriptors) in uniform registers.
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0), rg = warp & 3;
  const int i0 = WROWS * rg + g;

  // band chunk c (64 rk rows from t_lo + 64 c) in ring slot c % 3: tile
  // jb's band is chunks jb - j_lo (low rows) and jb - j_lo + 1 (high rows)
  const int t_lo = j_lo * BK - r0 + p.qlen - BQ;
  K4Chunk ch;
  {
    ch.row = tid / VECS;
    const int c = (tid % VECS) * 8;
    ch.off = 2 * sw_tile(ch.row, c);
    const long long rk_st = static_cast<long long>(p.H) * DH;
    ch.k16 = static_cast<uint32_t>(2 * WROWS * p.k_st);
    ch.v16 = static_cast<uint32_t>(2 * WROWS * p.v_st);
    ch.rk16 = static_cast<uint32_t>(2 * WROWS * rk_st);
    const auto row_ok = [&](int i) { return r0 + ch.row + WROWS * i < p.qlen; };
    k4_copy(smem + K4_Q + ch.off, p.q + b * p.q_sb + (r0 + ch.row) * p.q_st + h * DH + c,
            static_cast<uint32_t>(2 * WROWS * p.q_st), row_ok, p.q);
    k4_copy(smem + K4_DO + ch.off, p.dout + (static_cast<long long>(b) * p.qlen + r0 + ch.row) * rk_st + h * DH + c,
            static_cast<uint32_t>(2 * WROWS * rk_st), row_ok, p.dout);
    // the first key tile and band chunk
    ch.k = p.k + b * p.k_sb + (j_lo * BK + ch.row) * p.k_st + h * DH + c;
    ch.v = p.v + b * p.v_sb + (j_lo * BK + ch.row) * p.v_st + h * DH + c;
    ch.rk = p.rk + (static_cast<long long>(t_lo) + ch.row) * rk_st + h * DH + c;
  }
  cp_async_commit();   // Q and dO: a group of their own
  if (j_lo < j_hi) {
    k4_stage_rk(p, ch, t_lo, smem, 0);
    k4_stage(p, ch, bh, h, j_lo * BK, t_lo, smem, 0, 1, tid);
  }
  cp_async_commit();
  // Every tile writes the same dG cells (row i's band columns 63 - i..
  // 126 - i), so the cells the product reads beside them are zeroed once.
  for (int e = tid; e < 2 * SW_HALF / 8; e += THREADS)
    reinterpret_cast<uint4*>(smem + K4_DG)[e] = make_uint4(0u, 0u, 0u, 0u);

  const long long srow = static_cast<long long>(bh) * p.qlen;
  const int row0 = r0 + i0, row1 = row0 + 8;
  // p scale = exp(s - m) scale / l = exp2(x log2e scale - e0), x the
  // unscaled score and e0 = m log2e + log2(l / scale), the row's term (0 for
  // rows past qlen: their p is set to 0)
  constexpr float LOG2E = 1.4426950408889634f;
  const float xs = p.scale * LOG2E;
  const auto row_term = [&](int row) {
    return row < p.qlen ? p.m[srow + row] * LOG2E + __log2f(fmaxf(p.l[srow + row], 1e-30f) / p.scale)
                        : 0.f;
  };
  const float e0 = row_term(row0), e1 = row_term(row1);
  const float dl0 = row0 < p.qlen ? p.delta[srow + row0] : 0.f;
  const float dl1 = row1 < p.qlen ? p.delta[srow + row1] : 0.f;

  // Q and dO as wgmma's A from registers: the A fragments of the warp's 16
  // rows for the 8 k-steps (register e: row i0 + 8 (e % 2), head dims
  // 16 kk + 8 (e / 2) + 2 t..), loaded once
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
  uint32_t qa[DH / 16][4], da[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = 2 * sw_tile(i0 + 8 * (e & 1), 16 * kk + 8 * (e >> 1) + 2 * t);
      qa[kk][e] = *reinterpret_cast<const uint32_t*>(smem + K4_Q + at);
      da[kk][e] = *reinterpret_cast<const uint32_t*>(smem + K4_DO + at);
    }
  }
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // dS and dG are wgmma's A in the interleaved layout: element (i, c) at
  // byte (i / 8) ldi + (c / 8) 128 + (i % 8) 16 + (c % 8) 2, ldi 1024 for dS
  // and 2048 for dG. This thread's cells of a tile: dS rows i0 (i0 + 8 a
  // row group below, + 1024), columns 32 wg + 8 n + 2 t.. at ds_at + 128 n;
  // dG[i0, 63 - i0 + j + e] at dg_at[e] + 128 n (row i0 + 8: + 1920).
  const uint32_t ds_at = (i0 >> 3) * 1024 + (4 * wg) * 128 + g * 16 + 4 * t;
  uint32_t dg_at[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int bc = BQ - 1 - i0 + KH * wg + 2 * t + e;   // band column of (i0, 32 wg + 2 t + e)
    dg_at[e] = (i0 >> 3) * 2048 + (bc >> 3) * 128 + g * 16 + (bc & 7) * 2;
  }
  unsigned char* dSb = smem + K4_S;
  unsigned char* dGb = smem + K4_DG;
  const uint64_t d_s = desc_inter(sa + K4_S, 1024), d_g = desc_inter(sa + K4_DG, 2048);
  float dq[DH / 16][4];   // rows i0, i0 + 8; dims 64 wg + 8 n + 2 t
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int jb = j_lo; jb < j_hi; ++jb) {
    const int tn = jb - j_lo, s = tn & 1;
    const int c0 = jb * BK;
    const int t0 = t_lo + BQ * tn;   // rk row of band row 0
    cp_async_wait_group0();
    fence_proxy_async();
    __syncthreads();   // tile jb has landed; every warp is done with tile jb - 1
    const uint32_t b_k = sa + K4_K + s * SW_TILE, b_v = sa + K4_V + s * SW_TILE;
    const uint32_t b_lo = sa + K4_R + tn % 3 * SW_TILE, b_hi = sa + K4_R + (tn + 1) % 3 * SW_TILE;
    const float* rrk_s = reinterpret_cast<const float*>(smem + K4_RRK) + s * BAND;
    const float* rwk_s = reinterpret_cast<const float*>(smem + K4_RWK) + s * BK;
    const int wrow = r0 + WROWS * rg, wcol = c0 + KH * wg;
    // every entry of the warp's 16 rows x 32 keys banned (the upper
    // triangle of a diagonal tile, the window's edge, the ragged end)
    const bool empty = wrow >= p.qlen || wcol >= p.klen || wcol > wrow + WROWS - 1 + geo.mlen ||
                       (p.same_length && wcol + KH - 1 < wrow - (geo.shift - 1));

    // The score products: G[:, 64 wg..] = Q . (band rows 64 wg..)^T, S and
    // dP over keys 32 wg.., B K-major, 8 k-steps over the head dims. No
    // warpgroup skips them: a branch around wgmma makes ptxas serialize
    // every product of the kernel, and a warpgroup's 64 rows leave its 32
    // keys of a tile all banned only at a window's edge.
    float pr[KH / 8][4], ds[KH / 8][4];
    {
      float gacc[DH / 16][4];
      const uint64_t d_b = desc_sw128(wg ? b_hi : b_lo);
      const uint64_t d_k = desc_sw128(b_k + KH * 128 * wg), d_v = desc_sw128(b_v + KH * 128 * wg);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        const uint32_t ko = (ks >> 2) * (SW_HALF * 2) + 32 * (ks & 3);
        wgmma_64x64_rs(gacc, qa[ks], desc_at(d_b, ko), ks > 0);
        wgmma_64x32_rs(pr, qa[ks], desc_at(d_k, ko), ks > 0);
        wgmma_64x32_rs(ds, da[ks], desc_at(d_v, ko), ks > 0);
      }
      wgmma_commit();
      // tile jb + 1 into the other stage, under the products
      if (jb + 1 < j_hi) k4_stage(p, ch, bh, h, c0 + BK, t0 + BQ, smem, s ^ 1, (tn + 2) % 3, tid);
      cp_async_commit();
      wgmma_wait0();
      fence_acc(gacc);
      fence_acc(pr);
      fence_acc(ds);
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) {
        const int c = BQ * wg + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(Gs + i0 * LDG4 + c) = make_float2(gacc[n][0], gacc[n][1]);
        *reinterpret_cast<float2*>(Gs + (i0 + 8) * LDG4 + c) = make_float2(gacc[n][2], gacc[n][3]);
      }
    }
    __syncthreads();   // G is complete

    // The elementwise pass: rows i0, i0 + 8 x keys 32 wg + 8 n + 2 t..
    if (empty) {
#pragma unroll
      for (int n = 0; n < KH / 8; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
    } else {
      // p scale with K3's scores and mask; BD[i, j] = G[i, 63 - i + j]
      const auto scores = [&](int n, int e, float& s0, float& s1) {
        const int j = KH * wg + 8 * n + 2 * t + e;
        const int br0 = BQ - 1 - i0 + j;          // band row of (i0, j)
        s0 = pr[n][e] + rwk_s[j] + Gs[i0 * LDG4 + br0] + rrk_s[br0];
        s1 = pr[n][2 + e] + rwk_s[j] + Gs[(i0 + 8) * LDG4 + br0 - 8] + rrk_s[br0 - 8];
      };
      // most tiles ban nothing in the warp's 16 rows x 32 keys
      const bool full = wrow + WROWS <= p.qlen && wcol + KH <= p.klen &&
                        wcol + KH - 1 <= wrow + geo.mlen &&
                        (!p.same_length || wcol >= wrow + WROWS - 1 - (geo.shift - 1));
      if (full) {
#pragma unroll
        for (int n = 0; n < KH / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float s0, s1;
            scores(n, e, s0, s1);
            pr[n][e] = ex2(fmaf(s0, xs, -e0));
            pr[n][2 + e] = ex2(fmaf(s1, xs, -e1));
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < KH / 8; ++n) {
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
            // exp of every score, then a select: no branch around the exp
            const float p0 = ex2(fmaf(s0, xs, -e0)), p1 = ex2(fmaf(s1, xs, -e1));
            pr[n][e] = ban0 ? 0.f : p0;
            pr[n][2 + e] = ban1 ? 0.f : p1;
          }
        }
      }
      // dS = p scale (dP - delta)
#pragma unroll
      for (int n = 0; n < KH / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ds[n][e] = pr[n][e] * (ds[n][e] - dl0);
          ds[n][2 + e] = pr[n][2 + e] * (ds[n][2 + e] - dl1);
        }
      }
    }
    // dS as bf16, and skewed into dG: dG[i, 63 - i + j] = dS[i, j]
#pragma unroll
    for (int n = 0; n < KH / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dSb + ds_at + 128 * n) = pack_bf16(ds[n][0], ds[n][1]);
      *reinterpret_cast<uint32_t*>(dSb + ds_at + 1024 + 128 * n) = pack_bf16(ds[n][2], ds[n][3]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        *reinterpret_cast<bf16*>(dGb + dg_at[e] + 128 * n) = __float2bfloat16_rn(ds[n][e]);
        *reinterpret_cast<bf16*>(dGb + dg_at[e] + 1920 + 128 * n) = __float2bfloat16_rn(ds[n][2 + e]);
      }
    }
    fence_proxy_async();
    __syncthreads();   // dS and dG are complete

    // The dq products, head dims 64 wg..: dq += dS . K (4 k-steps over the
    // keys), dq += dG . band (8 k-steps over the band rows, 4 in each chunk);
    // B is the K tile's or the chunk's half wg, MN-major
    {
      const uint32_t half = SW_HALF * 2 * wg;
      const uint64_t d_kh = desc_sw128(b_k + half);
      const uint64_t d_lo = desc_sw128(b_lo + half), d_hi = desc_sw128(b_hi + half);
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < BK / 16; ++kq)
        wgmma_64x64(dq, desc_at(d_s, 256 * kq), desc_at(d_kh, 2048 * kq), 1);
#pragma unroll
      for (int kq = 0; kq < BAND / 16; ++kq)
        wgmma_64x64(dq, desc_at(d_g, 256 * kq), desc_at(kq < 4 ? d_lo : d_hi, 2048 * (kq & 3)), 1);
      wgmma_commit();
      wgmma_wait0();
      fence_acc(dq);
    }
  }
  cp_async_wait_group0();   // Q and dO, should no key tile have been visited

  bf16* out0 =
      p.dq + ((static_cast<long long>(b) * p.qlen + row0) * p.H + h) * DH + DH / 2 * wg + 2 * t;
  bf16* out1 = out0 + 8LL * p.H * DH;
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) {
    if (row0 < p.qlen) *reinterpret_cast<uint32_t*>(out0 + 8 * n) = pack_bf16(dq[n][0], dq[n][1]);
    if (row1 < p.qlen) *reinterpret_cast<uint32_t*>(out1 + 8 * n) = pack_bf16(dq[n][2], dq[n][3]);
  }
}

// K5: stage 64 rk rows from t1 into ring slot `slot` (zero outside [0, klen))
__device__ __forceinline__ void k5_stage_rk(const Params& p, int h, int t1, unsigned char* smem,
                                            int slot, int tid) {
  stage_rk(p, h, t1, reinterpret_cast<bf16*>(smem + K5_R + slot * TILE), tid);
}

// K5: the 16-byte chunk i (0-7) of a staged Q/dO tile that thread tid
// copies: warpgroup tid / 128 copies the head-dim half that its wgmma reads
// (chunks 0-3 of Q, 4-7 of dO), so between that warpgroup's last product
// on a stage and the stage's next copy the chunks are the thread's own.
__device__ __forceinline__ int k5_chunk(int tid, int i, int& r, int& c) {
  const int e = (tid & 127) + 128 * (i & 3);
  r = e >> 3;
  c = DH / 2 * (tid >> 7) + 8 * (e & 7);
  return (i < 4 ? K5_Q : K5_DO) + 2 * sw_tile(r, c);   // bytes from the stage's Q
}

// K5: stage query tile r0's Q, dO (swizzled), r_r . rk_t and (m, l, delta)
// into stage s, and the low 64 rows of its rk band into ring slot `slot`,
// by cp.async (zero past qlen and outside [0, klen)). The band's high 64
// rows are the previous tile's low ones.
__device__ __forceinline__ void k5_stage(const Params& p, int bh, int b, int h, int c0, int r0,
                                         unsigned char* smem, int s, int slot, int tid) {
  const bf16* qb = p.q + b * p.q_sb + h * DH;
  const bf16* dob = p.dout + static_cast<long long>(b) * p.qlen * p.H * DH + h * DH;
  const long long do_st = static_cast<long long>(p.H) * DH;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int r, c;
    unsigned char* dst = smem + s * SW_TILE + k5_chunk(tid, i, r, c);
    const bool ok = r0 + r < p.qlen;
    const bf16* src = i < 4 ? qb + (r0 + r) * p.q_st : dob + (r0 + r) * do_st;
    cp_async16(dst, ok ? src + c : qb, ok);
  }
  const int t0 = c0 - r0 + p.qlen - BQ;   // rk row of band row 0
  k5_stage_rk(p, h, t0, smem, slot, tid);
  float* rrk_s = reinterpret_cast<float*>(smem + K5_RRK) + s * BAND;
  float* st_s = reinterpret_cast<float*>(smem + K5_ST) + s * 3 * BQ;
  const long long srow = static_cast<long long>(bh) * p.qlen;
  for (int e = tid; e < BAND + 3 * BQ; e += THREADS) {
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
__global__ void __launch_bounds__(THREADS, 1) k5_rel_bwd_dkv_kernel(const Params p) {
  // the swizzled tiles need 1024-byte alignment; an offset from the shared
  // array itself keeps every access in the shared state space
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - static_cast<unsigned>(__cvta_generic_to_shared(smem_raw))) & 1023u);
  bf16* Ks = reinterpret_cast<bf16*>(smem + K5_K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + K5_V);
  bf16* Pt = reinterpret_cast<bf16*>(smem + K5_P);
  bf16* dSt = reinterpret_cast<bf16*>(smem + K5_S);
  bf16* dGt = reinterpret_cast<bf16*>(smem + K5_DG);
  float* rwk_s = reinterpret_cast<float*>(smem + K5_RWK);
  float* rw_s = reinterpret_cast<float*>(smem + K5_BIAS);
  float* rr_s = rw_s + DH;
  float* dsum_s = reinterpret_cast<float*>(smem + K5_DSUM);
  float* dgsum_s = reinterpret_cast<float*>(smem + K5_DGSUM);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
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
  const int wb = BQ - WROWS - WROWS * rg + KH * kh;
  const int i0 = WROWS * rg + g;            // block rows i0 and i0 + 8
  float* Gw = reinterpret_cast<float*>(smem + K5_G + warp * GW_BYTES);
  // key-major: warpgroup dh takes head dims 64 dh..; the wgmma accumulator
  // rows of warp w % 4 are keys 16 (w % 4).. of dK and dV, and band rows
  // 16 (w % 4).. of each drk block. drk: the band's low block (rows 0-63,
  // fresh) and high block (rows 64-127). The next query tile's band is this
  // one's moved down 64 rows, so this tile's low block is the next tile's
  // high block: its sums are carried in registers and added into drk once,
  // when complete. Warp w holds band-row blocks rbl and rbl + 4 (16 rows).
  const int dh = warp >> 2, rbl = warp & 3;

  {
    const bf16* kb = p.k + b * p.k_sb + h * DH;
    const bf16* vb = p.v + b * p.v_sb + h * DH;
    for (int e = tid; e < BK * VECS; e += THREADS) {
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
  for (int e = tid; e < 3 * BAND; e += THREADS) dgsum_s[e] = 0.f;
  // Every tile writes the same dG^T cells (the skewed diagonal band), so
  // the cells the drk products read beside them are zeroed once.
  for (int e = tid; e < 2 * SW_HALF / 8; e += THREADS)
    reinterpret_cast<uint4*>(dGt)[e] = make_uint4(0u, 0u, 0u, 0u);

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

    const bf16* Qs = reinterpret_cast<const bf16*>(smem + K5_Q + s * SW_TILE);
    const bf16* dOs = reinterpret_cast<const bf16*>(smem + K5_DO + s * SW_TILE);
    const int chunk = iq - i_lo + 1;
    const bf16* Rlo = reinterpret_cast<const bf16*>(smem + K5_R + chunk % 3 * TILE);
    const bf16* Rhi = reinterpret_cast<const bf16*>(smem + K5_R + (chunk + 2) % 3 * TILE);
    // band row r (a group of 16 never straddles the two chunks)
    const auto band_row = [&](int r) { return (r < BQ ? Rlo : Rhi) + (r % BQ) * LDH; };
    const float* rrk_s = reinterpret_cast<const float*>(smem + K5_RRK) + s * BAND;
    const float* st_s = reinterpret_cast<const float*>(smem + K5_ST) + s * 3 * BQ;
    // the previous tile's high block (this tile's band rows 128 + 16 rbl..),
    // staged by drk_stage in the other stage: at k-step k of the
    // query-major products this lane adds its chunk k (rows 2 k, 2 k + 1)
    const int fl_tr = iq > i_lo ? t0 + 2 * BQ + 16 * rbl + (lane >> 4) : -p.klen;
    float* fl_dst = p.drk + (static_cast<long long>(fl_tr) * p.H + h) * DH + DH / 2 * dh;

    {  // query-major: rows i0, i0 + 8 of row group rg, keys 32 kh..
      float pr[KH / 8][4], ds[KH / 8][4];
      {  // G = q . band^T over the warp's 48 band rows (f32 in Gw), S = q . k^T
        float gacc[WBAND / 8][4];
#pragma unroll
        for (int n = 0; n < WBAND / 8; ++n) gacc[n][0] = gacc[n][1] = gacc[n][2] = gacc[n][3] = 0.f;
#pragma unroll
        for (int n = 0; n < KH / 8; ++n) pr[n][0] = pr[n][1] = pr[n][2] = pr[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          {
            int r, c;
            const float4 v = *reinterpret_cast<const float4*>(smem + (s ^ 1) * SW_TILE +
                                                              k5_chunk(tid, kk, r, c));
            const unsigned tr = static_cast<unsigned>(fl_tr + 2 * kk);
            if (tr < static_cast<unsigned>(p.klen))
              red_add4(fl_dst + 2 * kk * p.H * DH + 4 * ((lane & 15) ^ (2 * kk + (lane >> 4))), v);
          }
          uint32_t qa[4];
          ld_a_sw(qa, Qs, WROWS * rg, kk, lane);
#pragma unroll
          for (int np = 0; np < WBAND / 16; ++np) {
            uint32_t bfr[4];
            ld_b(bfr, band_row(wb + 16 * np) + kk * 16, LDH, lane);
            mma16816(gacc[2 * np], qa, bfr[0], bfr[1]);
            mma16816(gacc[2 * np + 1], qa, bfr[2], bfr[3]);
          }
#pragma unroll
          for (int np = 0; np < KH / 16; ++np) {
            uint32_t bfr[4];
            ld_b(bfr, Ks + (KH * kh + 16 * np) * LDH + kk * 16, LDH, lane);
            mma16816(pr[2 * np], qa, bfr[0], bfr[1]);
            mma16816(pr[2 * np + 1], qa, bfr[2], bfr[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < WBAND / 8; ++n) {
          *reinterpret_cast<float2*>(Gw + g * LDG + 8 * n + 2 * t) =
              make_float2(gacc[n][0], gacc[n][1]);
          *reinterpret_cast<float2*>(Gw + (g + 8) * LDG + 8 * n + 2 * t) =
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
        const int jl = 8 * n + 2 * t + e, j = KH * kh + jl;
        const int br0 = BQ - 1 - i0 + j;          // block band row of (i0, j)
        const int gc0 = WROWS - 1 - g + jl;       // its column in Gw
        s0 = (pr[n][e] + rwk_s[j] + Gw[g * LDG + gc0] + rrk_s[br0]) * p.scale;
        s1 = (pr[n][2 + e] + rwk_s[j] + Gw[(g + 8) * LDG + gc0 - 8] + rrk_s[br0 - 8]) * p.scale;
      };
      // most tiles ban nothing in the warp's 16 rows x 32 keys
      const int wrow = r0 + WROWS * rg, wcol = c0 + KH * kh;
      const bool full = wrow + WROWS <= p.qlen && wcol + KH <= p.klen &&
                        wcol + KH - 1 <= wrow + geo.mlen &&
                        (!p.same_length || wcol >= wrow + WROWS - 1 - (geo.shift - 1));
      if (full) {
#pragma unroll
        for (int n = 0; n < KH / 8; ++n) {
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
        for (int n = 0; n < KH / 8; ++n) {
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
      for (int n = 0; n < KH / 8; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t da[4];
        ld_a_sw(da, dOs, WROWS * rg, kk, lane);
#pragma unroll
        for (int np = 0; np < KH / 16; ++np) {
          uint32_t bfr[4];
          ld_b(bfr, Vs + (KH * kh + 16 * np) * LDH + kk * 16, LDH, lane);
          mma16816(ds[2 * np], da, bfr[0], bfr[1]);
          mma16816(ds[2 * np + 1], da, bfr[2], bfr[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < KH / 8; ++n) {
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
      for (int n = 0; n < KH / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jl = 8 * n + 2 * t + e;
          Gw[g * LDG + WROWS - 1 - g + jl] = ds[n][e];
          Gw[(g + 8) * LDG + WROWS - 9 - g + jl] = ds[n][2 + e];
        }
      }
      __syncwarp();
      {
        float cs = 0.f, d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int i = 0; i < WROWS; ++i) {
          cs += Gw[i * LDG + WROWS - 1 - i + lane];
          if (i >= WROWS - 1 - lane) d0 += Gw[i * LDG + lane];
          if (i < WROWS - 1 - lane) d1 += Gw[i * LDG + KH + lane];
        }
        atomicAdd(dsum_s + KH * kh + lane, cs);
        atomicAdd(dgs + wb + lane, d0);
        if (lane < WROWS - 1) atomicAdd(dgs + wb + KH + lane, d1);
      }

      // p^T and dS^T (keys x queries) as bf16 by stmatrix.trans: matrix
      // 2 (n % 2) + hi of a pair is keys 32 kh + 8 n.., queries 16 rg + 8 hi..
#pragma unroll
      for (int np = 0; np < KH / 16; ++np) {
        const int mi = lane >> 3;
        const int key = KH * kh + 8 * (2 * np + (mi >> 1)) + (lane & 7);
        const int off = sw128(key, WROWS * rg + 8 * (mi & 1));
        const int n0 = 2 * np, n1 = n0 + 1;
        stsm_x4_t(Pt + off, pack_bf16(pr[n0][0], pr[n0][1]), pack_bf16(pr[n0][2], pr[n0][3]),
                  pack_bf16(pr[n1][0], pr[n1][1]), pack_bf16(pr[n1][2], pr[n1][3]));
        stsm_x4_t(dSt + off, pack_bf16(ds[n0][0], ds[n0][1]), pack_bf16(ds[n0][2], ds[n0][3]),
                  pack_bf16(ds[n1][0], ds[n1][1]), pack_bf16(ds[n1][2], ds[n1][3]));
      }
      // dG^T[63 - i + j, i] = dS[i, j] (band rows x queries)
#pragma unroll
      for (int n = 0; n < KH / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int br = BQ - 1 - i0 + KH * kh + 8 * n + 2 * t + e;   // band row of (i0, j)
          dGt[sw128(br, i0)] = __float2bfloat16_rn(ds[n][e]);
          dGt[sw128(br - 8, i0 + 8)] = __float2bfloat16_rn(ds[n][2 + e]);
        }
      }
    }
    // p^T, dS^T, dG^T and the staged Q and dO are read by wgmma (the async
    // proxy) after the barrier
    fence_proxy_async();
    __syncthreads();   // p, dS, dG and the sums are complete

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
    // Into drk for the warp's 16 rows of block rb (64 dims a row, 4 KB),
    // through the warp's own chunks of this tile's Q/dO stage (its
    // warpgroup's products on them are done), so that add k of lane L is
    // row R = 2 k + L / 16, dims quad (L % 16) ^ R, from its own chunk k: one
    // red.global.add.v4.f32 of 4 full 128-byte lines a warp. Lane (g, t)
    // holds rows g and g + 8, dims 8 n + 2 t.. (quad 2 n + t / 2, half
    // t % 2), and stores each pair where its reader takes it; the xor by
    // the row keeps these stores free of bank conflicts.
    const auto drk_stage = [&](float (&acc)[DH / 16][4]) {
      unsigned char* stage = smem + s * SW_TILE;
      int r, c;
      __syncwarp();
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = g + 8 * e;
          const int reader = 16 * (row & 1) + ((2 * n + (t >> 1)) ^ row);
          *reinterpret_cast<float2*>(stage + k5_chunk((tid & ~31) | reader, row >> 1, r, c) + 8 * (t & 1)) =
              make_float2(acc[n][2 * e], acc[n][2 * e + 1]);
        }
      }
    };
    const auto flush_drk = [&](float (&acc)[DH / 16][4], int rb) {
      unsigned char* stage = smem + s * SW_TILE;
      int r, c;
      drk_stage(acc);
      __syncwarp();
#pragma unroll
      for (int k = 0; k < DH / 16; ++k) {
        const int tr = t0 + 16 * rb + 2 * k + (lane >> 4);
        const float4 v = *reinterpret_cast<const float4*>(stage + k5_chunk(tid, k, r, c));
        if (tr >= 0 && tr < p.klen)
          red_add4(p.drk + (static_cast<long long>(tr) * p.H + h) * DH + DH / 2 * dh +
                       4 * ((lane & 15) ^ (2 * k + (lane >> 4))), v);
      }
    };

    {  // key-major, by warpgroup dh on head dims 64 dh..: dV += p^T . dO,
       // dK += dS^T . q, drk's low block (fresh) and high block (carried)
       // += dG^T . q, over the tile's 64 queries (4 k-steps of 16)
      float acc[DH / 16][4];
      const uint32_t a_p = static_cast<uint32_t>(__cvta_generic_to_shared(Pt));
      const uint32_t a_s = static_cast<uint32_t>(__cvta_generic_to_shared(dSt));
      const uint32_t a_g = static_cast<uint32_t>(__cvta_generic_to_shared(dGt));
      const uint32_t b_q = static_cast<uint32_t>(__cvta_generic_to_shared(Qs + dh * SW_HALF));
      const uint32_t b_o = static_cast<uint32_t>(__cvta_generic_to_shared(dOs + dh * SW_HALF));
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks) {
        const uint64_t bq = desc_sw128(b_q + 2048 * ks);
        wgmma_64x64(carry, desc_sw128(a_g + SW_HALF * 2 + 32 * ks), bq, 1);
        wgmma_64x64(dv, desc_sw128(a_p + 32 * ks), desc_sw128(b_o + 2048 * ks), 1);
        wgmma_64x64(dk, desc_sw128(a_s + 32 * ks), bq, 1);
        wgmma_64x64(acc, desc_sw128(a_g + 32 * ks), bq, ks > 0);
      }
      wgmma_commit();
      // drr: sum_t dgsum_t rk_t over the rk rows no later tile touches: the
      // band's high 64 rows (this tile's sums and the previous tile's sums of
      // its low rows, the same rk rows), and on the last tile the low 64
      // too. Rows 8 warp.., dims 4 lane..; rows outside [0, klen) are zero.
      // It reads no operand or accumulator of the products in flight.
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
      wgmma_wait0();
      fence_acc(carry);
      fence_acc(acc);
      fence_acc(dk);
      fence_acc(dv);
      add_rr(carry, rbl + 4);   // the high block is complete
      add_rr(acc, rbl);
      if (has_next) {
        drk_stage(carry);   // added into drk during the next tile
#pragma unroll
        for (int n = 0; n < DH / 16; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) carry[n][e] = acc[n][e];
      } else {
        flush_drk(carry, rbl + 4);
        flush_drk(acc, rbl);
      }
    }
  }
  cp_async_wait_group0();   // K and V, should no query tile have been visited
  __syncthreads();

  // dK = dS^T . q + (sum_i dS_ij) r_w; dV; both cast to bf16
  const int j0 = 16 * rbl + g, j1 = j0 + 8;
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
// dynamic shared memory of K4 (which = 1) and K5 (which = 2), bytes
int bdm_rel_bwd_smem(int which) { return which == 1 ? SMEM_DQ : which == 2 ? SMEM_DKV : 0; }

const char* bdm_rel_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One step of the backward, all on `stream`: which = 0, the preparation:
// rwk [B * H * klen] and rrk [H * klen] f32, and delta [B, H, qlen] f32
// when out is given (out may be null: the key terms alone); which = 1, K4:
// dq [B, qlen, H, DH] bf16; which = 2, K5: dk and dv [B, klen, H, DH] bf16,
// and drk [klen, H, DH], drw and drr [H, DH] f32, which the caller zeroes
// and the kernel adds to. K4 and K5 read delta, rwk and rrk as the
// preparation left them. Pointers a step does not use may be null. q, k,
// v are bf16 with element strides (batch, token) given and the heads
// packed; rk, dout and out are contiguous bf16; rw and rr contiguous
// [H, DH] f32; m and l contiguous [B, H, qlen] f32. Every pointer and
// stride must keep 16-byte alignment.
int bdm_rel_bwd(int which, const void* q, const void* k, const void* v, const void* rk,
                const void* rw, const void* rr, const void* dout, const void* out,
                const void* m, const void* l, void* delta, void* rwk, void* rrk, void* dq,
                void* dk, void* dv, void* drk, void* drw, void* drr, long long q_sb,
                long long q_st, long long k_sb, long long k_st, long long v_sb, long long v_st,
                int B, int H, int qlen, int klen, int mem_len, int same_length, float scale,
                int device, void* stream) {
  const long long nq = (qlen + BQ - 1) / BQ;
  const long long nk = (klen + BK - 1) / BK;
  const long long dots = (static_cast<long long>(B) + 1) * H * klen +
                         (out ? static_cast<long long>(B) * H * qlen : 0);
  if (which < 0 || which > 2 || B < 1 || H < 1 || qlen < 1 || klen < qlen ||
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
  p.out = static_cast<const bf16*>(out);
  p.m = static_cast<const float*>(m);
  p.l = static_cast<const float*>(l);
  p.delta = static_cast<float*>(delta);
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
  if (which == 0) {
    prep_kernel<<<static_cast<unsigned>((dots * 32 + 255) / 256), 256, 0, st>>>(p);
  } else if (which == 1) {
    const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>(nq));
    k4_rel_bwd_dq_kernel<<<grid, THREADS, SMEM_DQ, st>>>(p);
  } else {
    const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>(nk));
    k5_rel_bwd_dkv_kernel<<<grid, THREADS, SMEM_DKV, st>>>(p);
  }
  return cudaGetLastError();
}

}  // extern "C"
