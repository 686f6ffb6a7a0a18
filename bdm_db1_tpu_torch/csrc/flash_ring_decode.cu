// Ring-cache decode attention for Hopper (sm_90a): the q == 1 decode kernel
// (K1 on a bf16 cache, K6 on an int8 one) and the 2 <= Q <= 32
// observation-prime kernel (K2 bf16, K7 int8, and K8: K7 with head-major
// scales), one launch each.
//
// Replaces the Pallas kernels of bdm_db1_tpu/ops/flash_ring_decode.py:
//   K1/K6  _flash_ring_decode_local (:249, body _decode_core :91,
//          int8 via _kernel_impl_q :166)
//   K2/K7  _flash_ring_prime_ap_local (:578, body _prime_ap_core :383,
//          int8 via _prime_ap_kernel_q :497)
//   K8     flash_ring_prime (:671, body _prime_core :322, int8 via
//          _prime_kernel_q :364; scales [L, B, H, M])
// Contract (not the TPU block layout): for one layer of the stacked ring
// cache [L, B, M, H, Dh] and queries qw (q + r_w_bias, compute dtype), return
// the unnormalised softmax-weighted value sum o and the row stats (m, l) of
// the scores s = bf16(qw * bf16(scale)) . k * k_scale + bias, where bias
// carries the scaled positional term and -1e30 at banned ring slots.
// p = exp(s - m); the PV operand is bf16(p * v_scale), l sums the raw p.
// With a bf16 cache there are no scales. int8 values convert to float (or
// to bf16 for the prime's tensor-core operands) exactly.
//
// What bounds them on an H100: bytes. Each launch streams one layer's K and
// V slice (2 * B * M * H * Dh * sizeof(elem): 335.5 MB in bf16 at B = 40,
// 234.9 MB in int8 at B = 56, M = 1024, H = 16, Dh = 128) plus the f32
// bias and scales. The arithmetic is ~1 FLOP/byte at q == 1 and ~Q
// FLOP/byte at the prime: below the tensor cores' ~295 FLOP/byte, but at
// Q = 19 above what the CUDA cores give (67 TFLOP/s: 0.095 ms of FMAs at
// B = 40 against a 0.118 ms byte bound), so the prime's products run on
// the tensor cores. Every cache byte is read once, straight out of the
// stacked buffer at the layer offset (no per-layer copy), in 16-byte pieces
// of contiguous rows (a 256-byte bf16 key row is 16 pieces, an int8 row 8).
// The keys are cut into splits of K1_SPLIT / K2_SPLIT keys, each one
// softmax block with the Pallas kernel's block semantics: its own max m_s,
// and p rounded against it. The splits merge as the JAX wrapper merges its
// blocks: m = max m_s, w_s = exp(m_s - m), o = sum w_s o_s, l = sum w_s l_s
// (an all-banned split, whose max is -1e30, gets weight 0). Both kernels
// take one (head, batch row) a block: K1 merges the splits in shared
// memory at its end (see k1_decode_kernel), the prime in registers as it
// goes (see k2_prime_kernel).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 128;          // head dim the kernels take
constexpr int K1_SPLIT = 64;     // keys per K1/K6 softmax block (split)
constexpr int K2_SPLIT = 128;    // keys per K2 softmax block (split)
constexpr int QMAX = 32;         // most query rows K2 takes
constexpr int VEC = 8;           // bf16 values per 16-byte load

__device__ __forceinline__ void bf16x8_to_float(const uint4& raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// round to the nearest bf16 (ties to even), as the compute-dtype casts do
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// What one 16-byte load of a cache row holds: EPL elements, as floats.
template <typename T> struct Cache;

template <> struct Cache<__nv_bfloat16> {
  static constexpr int EPL = 8;
  static constexpr bool kQuant = false;
  __device__ static void to_float(const uint4& raw, float* out) {
    bf16x8_to_float(raw, out);
  }
};

template <> struct Cache<int8_t> {
  static constexpr int EPL = 16;
  static constexpr bool kQuant = true;
  // exact: byte j of w ^ 0x80808080 (the int8 plus 128) becomes the low
  // mantissa of 2^23 + u in f32, and less 2^23 + 128 leaves the int8 value
  // (one PRMT and one FADD a value, where a cast is an I2F at a quarter of
  // their rate)
  __device__ static void to_float(const uint4& raw, float* out) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[4 * i + j] = __uint_as_float(__byte_perm(u, 0x4B00u, 0x5440u | j)) - 8388736.f;
    }
  }
};

// ---- K2/K7/K8: the prime on tensor cores ---------------------------------
//
// One block of 4 warps per (head, batch row) walks all the key splits of
// its row in order and merges them in registers, so no split partial goes
// through device memory. The Q <= 32 query rows are one or two m16 row
// tiles of mma.sync.m16n8k16 (bf16 in, f32 accumulate); bf16(qw * scale)
// is staged once and every warp keeps its A fragments in registers.
//
// The keys stream through a cp.async ring of 64-key tiles, consumed in the
// order K, K, V, V of each 128-key split (K2_SPLIT): a K tile also brings
// the f32 bias rows of its keys (and, int8, the k and v scales of its
// keys). On a K tile, warp w scores 16 of its keys against every query row
// (K's B fragments by ldmatrix); after the split's second K tile the split
// max of each row is exchanged through shared memory, and bf16(p *
// v_scale) is written there as P (l sums the raw p). On a V tile, warp w
// takes 32 of the head dims: P's A fragments and V's B fragments
// (ldmatrix.trans) into the split's own f32 accumulator, which is then
// merged into the running one in split order, w = exp(m_split - m_run):
// the JAX wrapper's merge (and K1's), online. int8 tiles stay int8 in
// shared memory (half the bytes of a bf16 tile); ldmatrix reads their rows as
// 16-bit pairs and each fragment word converts to bf16 in registers,
// exactly, with integer and f32 adds (i8pair_bf16).
//
// Two blocks share an SM (the registers allow two of 4 warps at up to 255
// a thread): a block stalls at its barriers, at its first tiles and after
// its last loads, and the other block's loads and products fill those
// gaps. The ring holds 4 tiles (bf16) or 6 (int8) a block.
constexpr int K2_TK = 64;               // keys per K or V tile of the ring
constexpr int K2_WARPS = 4;
constexpr int K2_THREADS = 32 * K2_WARPS;
constexpr int K2_BLOCKS = 2;            // blocks an SM holds
constexpr int K2_KN = K2_TK / (8 * K2_WARPS);   // key n-tiles a warp scores: 2
constexpr int K2_DN = DH / (8 * K2_WARPS);      // dim n-tiles a warp sums: 4
constexpr int LDT = DH + 8;             // bf16 row stride of a bf16 tile
constexpr int LDB = K2_TK + 8;          // f32 row stride of a bias tile
constexpr int LDP = K2_SPLIT + 8;       // bf16 row stride of P (and of Q)
static_assert(K2_SPLIT == 2 * K2_TK && K2_KN >= 1 && K2_DN % 2 == 0,
              "the warp layout of k2_prime_kernel");

template <typename T> struct PrimeTile;
template <> struct PrimeTile<__nv_bfloat16> {
  static constexpr int STAGES = 4;          // ring slots (tiles)
  static constexpr int ROW = LDT * 2;       // bytes a key row takes in a slot
};
template <> struct PrimeTile<int8_t> {
  static constexpr int STAGES = 6;
  static constexpr int ROW = DH + 16;
};

// dynamic shared memory of k2_prime_kernel<T>, in bytes from the start
template <typename T> struct PrimeSmem {
  using P = PrimeTile<T>;
  static constexpr int SLOT = K2_TK * P::ROW;
  // the most K tiles a window of STAGES tiles (K K V V K K ...) holds
  static constexpr int NB = P::STAGES / 4 * 2 + (P::STAGES % 4 < 2 ? P::STAGES % 4 : 2);
  static constexpr int BSLOT = QMAX * LDB * 4 + (Cache<T>::kQuant ? 2 * K2_TK * 4 : 0);
  static constexpr int BIAS = P::STAGES * SLOT;
  static constexpr int PS = BIAS + NB * BSLOT;
  static constexpr int RED = PS + QMAX * LDP * 2;
  static constexpr int BYTES = RED + 2 * K2_WARPS * QMAX * 4;
  static_assert(P::STAGES % 2 == 0 && BYTES * K2_BLOCKS <= 232448, "k2 shared memory");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: nothing is read, the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// 16 bytes, of which the first n come from gmem and the rest are zeroed
__device__ __forceinline__ void cp_async16n(void* smem, const void* gmem, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
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

// two int8 of a word (bytes lo and hi of w ^ 0x80808080, each the int8
// plus 128) -> bf16x2, exact: the byte is the low mantissa of 2^23 + u in
// f32, less 2^23 + 128 leaves the int8 value, whose f32 bits end in 16
// zeros, so its high half is its bf16
__device__ __forceinline__ uint32_t i8pair_bf16(uint32_t u, uint32_t lo, uint32_t hi) {
  const float a = __uint_as_float(__byte_perm(u, 0x4B00u, 0x5440u | lo)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(u, 0x4B00u, 0x5440u | hi)) - 8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632u);
}

__device__ __forceinline__ void zero4(float* c) { c[0] = c[1] = c[2] = c[3] = 0.f; }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Scales (int8 only): key m of head h at ((layer * B + b) * M * H) + m * sm
// + h * (sm == 1 ? M : 1), so sm = H reads [L, B, M, H] (K7) and sm = 1
// reads [L, B, H, M] (K8). Both strides run the same arithmetic in the same
// order.
template <typename T>
__global__ void __launch_bounds__(K2_THREADS, K2_BLOCKS) k2_prime_kernel(
    const T* __restrict__ k_cache,
    const T* __restrict__ v_cache,
    const float* __restrict__ k_scale,        // see above, or null
    const float* __restrict__ v_scale,
    const __nv_bfloat16* __restrict__ qw,     // [B, H, Q, DH]
    const float* __restrict__ bias,           // [B, H, Q, M]
    float* __restrict__ o,                    // [B, H, Q, DH]
    float* __restrict__ m_out,                // [B, H, Q]
    float* __restrict__ l_out,                // [B, H, Q]
    int layer, int B, int M, int H, int Q, int sm, float scale) {
  using C = Cache<T>;
  using SM = PrimeSmem<T>;
  constexpr int STAGES = PrimeTile<T>::STAGES;
  constexpr int ROWB = PrimeTile<T>::ROW;
  constexpr int CHUNKS = DH * static_cast<int>(sizeof(T)) / 16;   // per key row
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + SM::PS);
  float* red_max = reinterpret_cast<float*>(smem + SM::RED);   // [warp][row]
  float* red_l = red_max + K2_WARPS * QMAX;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t row = (size_t)H * DH;
  const size_t base = ((size_t)layer * B + b) * M * row + (size_t)h * DH;
  const size_t qrow0 = ((size_t)b * H + h) * Q;
  const size_t sbase = ((size_t)layer * B + b) * M * H + (size_t)h * (sm == 1 ? M : 1);
  const int ntiles = 4 * ((M + K2_SPLIT - 1) / K2_SPLIT);
  const bool two = Q > 16;                  // the second m16 row tile
  const bool bias16 = (M & 3) == 0;         // bias rows 16-byte aligned

  // bias rows past Q are never copied: zero them once in every slot
  for (int e = tid; e < SM::NB * (QMAX - Q) * (LDB / 4); e += K2_THREADS) {
    const int slot = e / ((QMAX - Q) * (LDB / 4)), r = e % ((QMAX - Q) * (LDB / 4));
    reinterpret_cast<float4*>(smem + SM::BIAS + slot * SM::BSLOT)[Q * (LDB / 4) + r] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // tile i: split i / 4, K (i / 2 even) or V, keys 64 (i % 2) on; one
  // commit group a call, empty past the last tile
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      const int kv = (i >> 1) & 1;
      const int key0 = (i >> 2) * K2_SPLIT + (i & 1) * K2_TK;
      const int nv = min(K2_TK, M - key0);          // valid keys, may be <= 0
      const char* src = reinterpret_cast<const char*>((kv ? v_cache : k_cache) + base +
                                                      (size_t)key0 * row);
      unsigned char* dst = smem + (i % STAGES) * SM::SLOT;
      for (int e = tid; e < K2_TK * CHUNKS; e += K2_THREADS) {
        const int r = e / CHUNKS, c = e % CHUNKS;
        const bool ok = r < nv;
        cp_async16(dst + r * ROWB + c * 16,
                   ok ? src + (size_t)r * row * sizeof(T) + c * 16
                      : reinterpret_cast<const char*>(k_cache), ok);
      }
      if (kv == 0) {
        float* bt = reinterpret_cast<float*>(smem + SM::BIAS +
                                             (2 * (i >> 2) + (i & 1)) % SM::NB * SM::BSLOT);
        const float* bs = bias + qrow0 * M + key0;
        if (bias16) {
          for (int e = tid; e < Q * (K2_TK / 4); e += K2_THREADS) {
            const int r = e / (K2_TK / 4), c = (e % (K2_TK / 4)) * 4;
            if (c < nv) cp_async16(bt + r * LDB + c, bs + (size_t)r * M + c, true);
          }
        } else {
          for (int e = tid; e < Q * K2_TK; e += K2_THREADS) {
            const int r = e / K2_TK, c = e % K2_TK;
            if (c < nv) cp_async4(bt + r * LDB + c, bs + (size_t)r * M + c, true);
          }
        }
        if constexpr (C::kQuant) {
          float* st = bt + QMAX * LDB;                // k scales, then v scales
          for (int e = tid; e < 2 * K2_TK; e += K2_THREADS) {
            const int c = e % K2_TK;
            const bool ok = c < nv;
            const float* sp = (e < K2_TK ? k_scale : v_scale) + sbase +
                              (size_t)(key0 + c) * sm;
            cp_async4(st + e, ok ? sp : k_scale, ok);
          }
        }
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) load_tile(i);

  // bf16(qw * scale) into P's buffer, rows past Q zero; A fragments
  for (int e = tid; e < QMAX * (DH / VEC); e += K2_THREADS) {
    const int r = e / (DH / VEC), c = (e % (DH / VEC)) * VEC;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (r < Q) {
      float f[VEC];
      bf16x8_to_float(load16(qw + (qrow0 + r) * DH + c), f);
      out = make_uint4(pack_bf16(f[0] * scale, f[1] * scale),
                       pack_bf16(f[2] * scale, f[3] * scale),
                       pack_bf16(f[4] * scale, f[5] * scale),
                       pack_bf16(f[6] * scale, f[7] * scale));
    }
    *reinterpret_cast<uint4*>(Ps + r * LDP + c) = out;
  }
  __syncthreads();
  // (int8: the k index of a step runs over the dims in the order the
  // int8 K fragments come, k 2t, 2t + 1, 2t + 8, 2t + 9 = dims 4t .. 4t + 3)
  uint32_t qa[2][DH / 16][4];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      if constexpr (C::kQuant) {
        const __nv_bfloat16* q0 = Ps + (16 * rt + g) * LDP + kk * 16 + 4 * t;
        const uint2 x0 = *reinterpret_cast<const uint2*>(q0);
        const uint2 x1 = *reinterpret_cast<const uint2*>(q0 + 8 * LDP);
        qa[rt][kk][0] = x0.x;
        qa[rt][kk][1] = x1.x;
        qa[rt][kk][2] = x0.y;
        qa[rt][kk][3] = x1.y;
      } else {
        ldsm_x4(qa[rt][kk], Ps + (16 * rt + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDP +
                                kk * 16 + 8 * (lane >> 4));
      }
    }

  // this thread's rows: 16 rt + g + 8 hr; its keys in a tile: kc(kn) =
  // 8 (K2_KN warp + kn) + 2t (+1); its dims in the PV product (bf16):
  // K2_DN * 8 warp + 8 nt + 2t (+1)
  float s[2][2][K2_KN][4];   // [rt][tile of the split][kn][C fragment]: scores
  float vsc[2][K2_KN][2];    // [tile][kn][e]: v scales of this thread's keys
  float os[2][K2_DN][4];     // [rt][nt]: the split's PV
  float ot[2][K2_DN][4];     // [rt][nt]: merged over the splits so far
  float ms[2][2], mrun[2][2], lrun[2][2];   // [rt][hr]
#pragma unroll
  for (int x = 0; x < 2; ++x) {
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      mrun[x][y] = -INFINITY;
      lrun[x][y] = 0.f;
    }
#pragma unroll
    for (int kn = 0; kn < K2_KN; ++kn) vsc[x][kn][0] = vsc[x][kn][1] = 1.f;
#pragma unroll
    for (int nt = 0; nt < K2_DN; ++nt) zero4(ot[x][nt]);
  }
  const int kc0 = 8 * K2_KN * warp + 2 * t;
  const int d0 = 8 * K2_DN * warp;          // this warp's first PV dim

  // one split a trip; the four tiles unrolled, so that which tile (K or V,
  // first or second half) is known at compile time and the score and scale
  // arrays stay in registers
  for (int i0 = 0; i0 < ntiles; i0 += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q;
      cp_async_wait<STAGES - 2>();
      __syncthreads();            // tile i has landed; tile i - 1 is done with
      load_tile(i + STAGES - 1);  // into the slot tile i - 1 held
      const int kv = q >> 1, j = q & 1;
      const int key0 = (i >> 2) * K2_SPLIT + j * K2_TK;
      const __nv_bfloat16* tile =
          reinterpret_cast<const __nv_bfloat16*>(smem + (i % STAGES) * SM::SLOT);

      if (kv == 0) {
        // scores of this warp's keys: K2_KN n-tiles of 8
        float acc[2][K2_KN][4];
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
          for (int kn = 0; kn < K2_KN; ++kn) zero4(acc[rt][kn]);
#pragma unroll
        for (int kn = 0; kn < K2_KN; ++kn) {
          const int key = 8 * (K2_KN * warp + kn) + (lane & 7);   // this lane's row
          if constexpr (C::kQuant) {
            // an int8 row read as 16-bit pairs: a matrix is 8 keys x 16 dims,
            // a thread's word the dims 4t .. 4t + 3 of key g: one k-step
#pragma unroll
            for (int kh = 0; kh < DH / 64; ++kh) {
              uint32_t kr[4];
              ldsm_x4(kr, tile + (key * ROWB + 16 * (4 * kh + (lane >> 3))) / 2);
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                const uint32_t u = kr[x] ^ 0x80808080u;
                const uint32_t b0 = i8pair_bf16(u, 0, 1), b1 = i8pair_bf16(u, 2, 3);
                mma16816(acc[0][kn], qa[0][4 * kh + x], b0, b1);
                if (two) mma16816(acc[1][kn], qa[1][4 * kh + x], b0, b1);
              }
            }
          } else {
            // ldmatrix gives two k-steps
#pragma unroll
            for (int k2 = 0; k2 < DH / 32; ++k2) {
              uint32_t kb[4];
              ldsm_x4(kb, tile + key * LDT + 32 * k2 + 8 * (lane >> 3));
              mma16816(acc[0][kn], qa[0][2 * k2], kb[0], kb[1]);
              mma16816(acc[0][kn], qa[0][2 * k2 + 1], kb[2], kb[3]);
              if (two) {
                mma16816(acc[1][kn], qa[1][2 * k2], kb[0], kb[1]);
                mma16816(acc[1][kn], qa[1][2 * k2 + 1], kb[2], kb[3]);
              }
            }
          }
        }
        const float* bt = reinterpret_cast<const float*>(
            smem + SM::BIAS + (2 * (i >> 2) + j) % SM::NB * SM::BSLOT);
#pragma unroll
        for (int kn = 0; kn < K2_KN; ++kn) {
          const int kc = kc0 + 8 * kn;
          float ks0 = 1.f, ks1 = 1.f;
          if constexpr (C::kQuant) {
            ks0 = bt[QMAX * LDB + kc];
            ks1 = bt[QMAX * LDB + kc + 1];
            vsc[j][kn][0] = bt[QMAX * LDB + K2_TK + kc];
            vsc[j][kn][1] = bt[QMAX * LDB + K2_TK + kc + 1];
          }
          const bool ok0 = key0 + kc < M, ok1 = key0 + kc + 1 < M;
#pragma unroll
          for (int rt = 0; rt < 2; ++rt)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const float2 bb =
                  *reinterpret_cast<const float2*>(bt + (16 * rt + g + 8 * hr) * LDB + kc);
              s[rt][j][kn][2 * hr] = ok0 ? acc[rt][kn][2 * hr] * ks0 + bb.x : -INFINITY;
              s[rt][j][kn][2 * hr + 1] = ok1 ? acc[rt][kn][2 * hr + 1] * ks1 + bb.y : -INFINITY;
            }
        }

        if (j == 1) {
          // the split max of each row over the warps' keys
#pragma unroll
          for (int rt = 0; rt < 2; ++rt)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              float mx = -INFINITY;
#pragma unroll
              for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                for (int kn = 0; kn < K2_KN; ++kn)
                  mx = fmaxf(mx, fmaxf(s[rt][jj][kn][2 * hr], s[rt][jj][kn][2 * hr + 1]));
              mx = quad_max(mx);
              if (t == 0) red_max[warp * QMAX + 16 * rt + g + 8 * hr] = mx;
            }
          __syncthreads();
#pragma unroll
          for (int rt = 0; rt < 2; ++rt)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              if (rt == 1 && !two) continue;
              const int r = 16 * rt + g + 8 * hr;
              float mx = red_max[r];
#pragma unroll
              for (int w = 1; w < K2_WARPS; ++w) mx = fmaxf(mx, red_max[w * QMAX + r]);
              ms[rt][hr] = mx;
              // p = exp(s - m); l sums p; P = bf16(p * v_scale)
              float lsum = 0.f;
#pragma unroll
              for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                for (int kn = 0; kn < K2_KN; ++kn) {
                  const float p0 = expf(s[rt][jj][kn][2 * hr] - mx);
                  const float p1 = expf(s[rt][jj][kn][2 * hr + 1] - mx);
                  lsum += p0 + p1;
                  *reinterpret_cast<uint32_t*>(Ps + r * LDP + K2_TK * jj + kc0 + 8 * kn) =
                      pack_bf16(p0 * vsc[jj][kn][0], p1 * vsc[jj][kn][1]);
                }
              lsum = quad_sum(lsum);
              if (t == 0) red_l[warp * QMAX + r] = lsum;
            }
        }
      } else {
        if (j == 0) {
#pragma unroll
          for (int rt = 0; rt < 2; ++rt)
#pragma unroll
            for (int nt = 0; nt < K2_DN; ++nt) zero4(os[rt][nt]);
        }
        // os += P[:, keys of this tile] . V[keys, this warp's dims]; bf16:
        // n-tile nt = dims d0 + 8 nt ..; int8 (rows read as 16-bit pairs,
        // transposed: a thread's word holds dims 2g, 2g + 1 of keys 2t,
        // 2t + 1): n-tiles 2dp and 2dp + 1 = the even and the odd dims of
        // d0 + 16 dp ..
#pragma unroll
        for (int kq = 0; kq < K2_TK / 16; ++kq) {
          const int key = 16 * kq + 8 * ((lane >> 3) & 1) + (lane & 7);   // this lane's row
          uint32_t vb[K2_DN / 2][4], pa[4];
#pragma unroll
          for (int dp = 0; dp < K2_DN / 2; ++dp) {
            if constexpr (C::kQuant) {
              uint32_t vr[2];
              ldsm_x2_t(vr, tile + (key * ROWB + d0 + 16 * dp) / 2);
              const uint32_t lo = vr[0] ^ 0x80808080u, hi = vr[1] ^ 0x80808080u;
              vb[dp][0] = i8pair_bf16(lo, 0, 2);
              vb[dp][1] = i8pair_bf16(hi, 0, 2);
              vb[dp][2] = i8pair_bf16(lo, 1, 3);
              vb[dp][3] = i8pair_bf16(hi, 1, 3);
            } else {
              ldsm_x4_t(vb[dp], tile + key * LDT + d0 + 16 * dp + 8 * (lane >> 4));
            }
          }
#pragma unroll
          for (int rt = 0; rt < 2; ++rt) {
            if (rt == 1 && !two) continue;
            ldsm_x4(pa, Ps + (16 * rt + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDP + K2_TK * j +
                            16 * kq + 8 * (lane >> 4));
#pragma unroll
            for (int dp = 0; dp < K2_DN / 2; ++dp) {
              mma16816(os[rt][2 * dp], pa, vb[dp][0], vb[dp][1]);
              mma16816(os[rt][2 * dp + 1], pa, vb[dp][2], vb[dp][3]);
            }
          }
        }
        if (j == 1) {
          // merge the split in split order: m = max, w = exp(m_split - m)
#pragma unroll
          for (int rt = 0; rt < 2; ++rt)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              if (rt == 1 && !two) continue;
              const int r = 16 * rt + g + 8 * hr;
              float ls = 0.f;
#pragma unroll
              for (int w = 0; w < K2_WARPS; ++w) ls += red_l[w * QMAX + r];
              const float mn = fmaxf(mrun[rt][hr], ms[rt][hr]);
              const float a = expf(mrun[rt][hr] - mn), wgt = expf(ms[rt][hr] - mn);
              mrun[rt][hr] = mn;
              lrun[rt][hr] = fmaf(wgt, ls, a * lrun[rt][hr]);
#pragma unroll
              for (int nt = 0; nt < K2_DN; ++nt)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  ot[rt][nt][2 * hr + e] =
                      fmaf(wgt, os[rt][nt][2 * hr + e], a * ot[rt][nt][2 * hr + e]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * rt + g + 8 * hr;
      if (r < Q) {
        float* orow = o + (qrow0 + r) * DH + d0;
        if constexpr (C::kQuant) {   // dims d0 + 16 dp + 4t + (0, 1, 2, 3)
#pragma unroll
          for (int dp = 0; dp < K2_DN / 2; ++dp)
            *reinterpret_cast<float4*>(orow + 16 * dp + 4 * t) =
                make_float4(ot[rt][2 * dp][2 * hr], ot[rt][2 * dp + 1][2 * hr],
                            ot[rt][2 * dp][2 * hr + 1], ot[rt][2 * dp + 1][2 * hr + 1]);
        } else {
#pragma unroll
          for (int nt = 0; nt < K2_DN; ++nt)
            *reinterpret_cast<float2*>(orow + 8 * nt + 2 * t) =
                make_float2(ot[rt][nt][2 * hr], ot[rt][nt][2 * hr + 1]);
        }
        if (warp == 0 && t == 0) {
          m_out[qrow0 + r] = mrun[rt][hr];
          l_out[qrow0 + r] = lrun[rt][hr];
        }
      }
    }
}


// ---- K1/K6: the q == 1 decode ------------------------------------------
//
// One block per (head, batch row), B * H blocks (640 at B = 40, 896 at
// B = 56). A block needs K1_THREADS threads and ~28 KB of shared memory, so
// 8 fit an SM and every block is resident from the start: one wave, with
// no ragged last one. Its K1_WARPS warps take the row's splits in turn
// (warp w the splits w, w + K1_WARPS, ...). A group of LPR lanes (16 for
// bf16, 8 for int8) x 16 bytes reads one key's head row, so a warp step
// covers KPW = 32 / LPR keys, and a split is NKS K steps, then NKS V steps.
//
// The steps stream through the warp's cp.async ring of K1_DEPTH steps
// (each lane copies, and later reads, its own 16 bytes), committed
// K1_GROUP steps a group, so K1_DEPTH - K1_GROUP steps (6 KB a warp) stay
// in flight across every boundary: a split's V rows are on their way
// before its max is known, and the next split's K rows while its PV runs.
// The first step of a split also brings the split's f32 bias (and, int8,
// its k and v scales) into the warp's side buffer.
// - K steps: the lane group's dot in f32, reduced over its LPR lanes; the
//   score goes to the warp's shared memory and into a running max.
// - V steps: p = exp(s - m_split), l += p, o += bf16(p * v_scale) * v.
// - A split's end: its (o, m, l) goes to the block's shared memory.
// When every split is in, the block merges them in split order with the
// arithmetic of the JAX wrapper's merge and writes o, m, l: one launch, no
// partials in device memory, no atomics. int8 converts to f32 exactly with
// an integer and an f32 add a value (Cache<int8_t>::to_float).
constexpr int K1_WARPS = 4;
constexpr int K1_THREADS = 32 * K1_WARPS;
constexpr int K1_GROUP = 2;                      // steps a cp.async group
constexpr int K1_GROUPS = 4;                     // groups in the ring
constexpr int K1_DEPTH = K1_GROUP * K1_GROUPS;   // ring steps a warp
constexpr int K1_STEP = 32 * 16;                 // bytes a warp step copies

// dynamic shared memory of k1_decode_kernel, in bytes from the start
constexpr int K1_RING = 0;                                            // [warp][step][lane] 16 B
constexpr int K1_SIDE = K1_RING + K1_WARPS * K1_DEPTH * K1_STEP;      // [warp][2][3][split] f32
constexpr int K1_SC = K1_SIDE + K1_WARPS * 2 * 3 * K1_SPLIT * 4;      // [warp][split] f32 scores
constexpr int K1_PART = K1_SC + K1_WARPS * K1_SPLIT * 4;              // [S][DH] o, [S] m, [S] l
constexpr long long k1_smem(long long S) { return K1_PART + S * (DH + 2) * 4; }

// Scales (int8 only) are [L, B, M, H].
template <typename T>
__global__ void __launch_bounds__(K1_THREADS) k1_decode_kernel(
    const T* __restrict__ k_cache,
    const T* __restrict__ v_cache,
    const float* __restrict__ k_scale,        // [L, B, M, H] or null
    const float* __restrict__ v_scale,
    const __nv_bfloat16* __restrict__ qw,     // [B, H, DH]
    const float* __restrict__ bias,           // [B, H, M]
    float* __restrict__ o_out,                // [B, H, DH]
    float* __restrict__ m_out,                // [B, H]
    float* __restrict__ l_out,                // [B, H]
    int layer, int B, int M, int H, float scale) {
  using C = Cache<T>;
  constexpr int EPL = C::EPL;         // dims per lane
  constexpr int LPR = DH / EPL;       // lanes per key row
  constexpr int KPW = 32 / LPR;       // keys per warp step
  constexpr int NKS = K1_SPLIT / KPW; // K (and V) steps a split
  constexpr int SPS = 2 * NKS;        // steps a split
  static_assert(NKS % K1_GROUP == 0 && K1_DEPTH <= SPS,
                "a group stays in one phase; the ring runs at most a split ahead");
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / LPR, sub = lane % LPR;
  const int S = (M + K1_SPLIT - 1) / K1_SPLIT;
  const int nls = S > warp ? (S - warp + K1_WARPS - 1) / K1_WARPS : 0;   // this warp's splits
  const int ngroups = nls * SPS / K1_GROUP;
  uint4* ring = reinterpret_cast<uint4*>(smem + K1_RING) + warp * K1_DEPTH * 32;
  float* side = reinterpret_cast<float*>(smem + K1_SIDE) + warp * 2 * 3 * K1_SPLIT;
  float* sc = reinterpret_cast<float*>(smem + K1_SC) + warp * K1_SPLIT;
  float* part_o = reinterpret_cast<float*>(smem + K1_PART);
  float* part_m = part_o + S * DH;
  float* part_l = part_m + S;

  const size_t row = (size_t)H * DH;
  const size_t lbase = ((size_t)layer * B + b) * M;   // key 0 of (layer, b)
  const size_t base = lbase * row + (size_t)h * DH + sub * EPL;
  const float* brow = bias + ((size_t)b * H + h) * M;

  // issue group gi: K1_GROUP steps, and at a split's first step its side data
  const auto produce = [&](int gi) {
    const int st0 = gi * K1_GROUP;
    const int ls = st0 / SPS, k0 = st0 % SPS;
    const int start = (warp + K1_WARPS * ls) * K1_SPLIT;
    const T* src = k0 < NKS ? k_cache : v_cache;
    const int key0 = start + (k0 % NKS) * KPW + grp;
#pragma unroll
    for (int u = 0; u < K1_GROUP; ++u) {
      const int key = key0 + u * KPW;
      const bool ok = key < M;
      cp_async16(ring + ((st0 + u) % K1_DEPTH) * 32 + lane,
                 ok ? src + base + (size_t)key * row : src, ok);
    }
    if (k0 == 0) {
      float* sd = side + (ls & 1) * 3 * K1_SPLIT;
#pragma unroll
      if (lane < K1_SPLIT / 4) {   // bias rows are 16-byte aligned when M % 4 == 0
        const int key = start + 4 * lane;
        if ((M & 3) == 0) {
          cp_async16n(sd + 4 * lane, key < M ? brow + key : brow, 4 * max(0, min(4, M - key)));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            cp_async4(sd + 4 * lane + e, key + e < M ? brow + key + e : brow, key + e < M);
        }
      }
#pragma unroll
      for (int i = lane; i < K1_SPLIT; i += 32) {
        const int key = start + i;
        const bool ok = key < M;
        if constexpr (C::kQuant) {
          const size_t si = (lbase + (ok ? key : 0)) * H + h;
          cp_async4(sd + K1_SPLIT + i, k_scale + si, ok);
          cp_async4(sd + 2 * K1_SPLIT + i, v_scale + si, ok);
        }
      }
    }
  };
#pragma unroll
  for (int gi = 0; gi < K1_GROUPS - 1; ++gi) {
    if (gi < ngroups) produce(gi);
    cp_async_commit();
  }

  float q[EPL];
#pragma unroll
  for (int c = 0; c < EPL; c += VEC)
    bf16x8_to_float(load16(qw + ((size_t)b * H + h) * DH + sub * EPL + c), q + c);
#pragma unroll
  for (int j = 0; j < EPL; ++j) q[j] = round_bf16(q[j] * scale);

  float o[EPL];
#pragma unroll
  for (int j = 0; j < EPL; ++j) o[j] = 0.f;
  float l = 0.f, mx = -INFINITY;
  for (int gi = 0; gi < ngroups; ++gi) {
    if (gi + K1_GROUPS - 1 < ngroups) produce(gi + K1_GROUPS - 1);
    cp_async_commit();
    cp_async_wait<K1_GROUPS - 1>();   // group gi has landed
    __syncwarp();                     // and the side data other lanes copied
    const int st0 = gi * K1_GROUP;
    const int ls = st0 / SPS, k0 = st0 % SPS;
    const int s = warp + K1_WARPS * ls, start = s * K1_SPLIT;
    const float* sd = side + (ls & 1) * 3 * K1_SPLIT;
    if (k0 < NKS) {   // K steps: the scores of keys k0 KPW .. and the running max
      float dot[K1_GROUP];
#pragma unroll
      for (int u = 0; u < K1_GROUP; ++u) {
        float kf[EPL];
        C::to_float(ring[((st0 + u) % K1_DEPTH) * 32 + lane], kf);
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < EPL; ++j) acc = fmaf(q[j], kf[j], acc);
        dot[u] = acc;
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < K1_GROUP; ++u) dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off);
#pragma unroll
      for (int u = 0; u < K1_GROUP; ++u) {
        const int i = (k0 + u) * KPW + grp;
        float sv = dot[u];
        if constexpr (C::kQuant) sv *= sd[K1_SPLIT + i];
        sv = start + i < M ? sv + sd[i] : -INFINITY;
        if (sub == 0) sc[i] = sv;
        mx = fmaxf(mx, sv);
      }
      if (k0 + K1_GROUP == NKS) {   // the split's last K steps: its max
#pragma unroll
        for (int off = LPR; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
    } else {          // V steps: p = exp(s - m), l += p, o += bf16(p * v_scale) * v
#pragma unroll
      for (int u = 0; u < K1_GROUP; ++u) {
        const int i = (k0 - NKS + u) * KPW + grp;
        if (start + i < M) {
          const float p = expf(sc[i] - mx);
          l += p;
          float pv = p;
          if constexpr (C::kQuant) pv *= sd[2 * K1_SPLIT + i];
          const float pb = round_bf16(pv);
          float vf[EPL];
          C::to_float(ring[((st0 + u) % K1_DEPTH) * 32 + lane], vf);
#pragma unroll
          for (int j = 0; j < EPL; ++j) o[j] = fmaf(pb, vf[j], o[j]);
        }
      }
      if (k0 + K1_GROUP == SPS) {   // the split's end: its (o, m, l)
        // the KPW lane groups hold disjoint keys of the same dims
#pragma unroll
        for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
          for (int j = 0; j < EPL; ++j) o[j] += __shfl_xor_sync(0xffffffffu, o[j], off);
          l += __shfl_xor_sync(0xffffffffu, l, off);
        }
        if (grp == 0) {
          float4* op = reinterpret_cast<float4*>(part_o + s * DH + sub * EPL);
#pragma unroll
          for (int j = 0; j < EPL / 4; ++j)
            op[j] = make_float4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
        }
        if (lane == 0) {
          part_m[s] = mx;
          part_l[s] = l;
        }
#pragma unroll
        for (int j = 0; j < EPL; ++j) o[j] = 0.f;
        l = 0.f;
        mx = -INFINITY;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the splits in split order: m = max_s m_s, w_s = exp(m_s - m),
  // o = sum_s w_s o_s, l = sum_s w_s l_s
  const size_t orow = (size_t)b * H + h;
  for (int d = threadIdx.x; d < DH; d += K1_THREADS) {
    float mf = -INFINITY;
    for (int s = 0; s < S; ++s) mf = fmaxf(mf, part_m[s]);
    float acc = 0.f, lacc = 0.f;
    for (int s = 0; s < S; ++s) {
      const float w = expf(part_m[s] - mf);
      acc = fmaf(w, part_o[s * DH + d], acc);
      lacc = fmaf(w, part_l[s], lacc);
    }
    o_out[orow * DH + d] = acc;
    if (d == 0) {
      m_out[orow] = mf;
      l_out[orow] = lacc;
    }
  }
}

template <typename T>
cudaError_t launch_k1(const void* k_cache, const void* v_cache,
                      const void* k_scale, const void* v_scale, const void* qw,
                      const void* bias, void* o, void* m, void* l, int layer,
                      int B, int M, int H, float scale, cudaStream_t st) {
  const int smem = static_cast<int>(k1_smem((M + K1_SPLIT - 1) / K1_SPLIT));
  static int smem_set = 48 * 1024;   // above 48 KB only after this attribute
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        k1_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  k1_decode_kernel<T><<<dim3(H, B), K1_THREADS, smem, st>>>(
      static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const __nv_bfloat16*>(qw), static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      layer, B, M, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k2(const void* k_cache, const void* v_cache,
                      const void* k_scale, const void* v_scale, const void* qw,
                      const void* bias, void* o, void* m, void* l, int layer,
                      int B, int M, int H, int Q, int sm, float scale,
                      cudaStream_t st) {
  static bool smem_set = false;   // above 48 KB only after this attribute
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        k2_prime_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        PrimeSmem<T>::BYTES);
    // all of the SM's unified memory as shared, so K2_BLOCKS blocks fit
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k2_prime_kernel<T>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  k2_prime_kernel<T><<<dim3(H, B), K2_THREADS, PrimeSmem<T>::BYTES, st>>>(
      static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const __nv_bfloat16*>(qw), static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      layer, B, M, H, Q, sm, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bdm_head_dim() { return DH; }
int bdm_k1_split() { return K1_SPLIT; }
int bdm_k2_split() { return K2_SPLIT; }
int bdm_k2_max_q() { return QMAX; }

const char* bdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1 (k_scale == v_scale == null: bf16 cache) / K6 (int8 cache, f32 scales
// [L, B, M, H]): o [B, H, DH], m [B, H], l [B, H] (all f32), in one launch.
// o_part, m_part and l_part are not read or written (the splits merge in
// shared memory) and may be null.
int bdm_flash_ring_decode(const void* k_cache, const void* v_cache,
                          const void* k_scale, const void* v_scale,
                          const void* qw, const void* bias, void* o_part,
                          void* m_part, void* l_part, void* o, void* m,
                          void* l, int layer, int B, int M, int H, float scale,
                          int device, void* stream) {
  (void)o_part;
  (void)m_part;
  (void)l_part;
  if (H < 1 || H > 65535 || B < 1 || M < 1 || B > 65535 ||
      k1_smem((M + K1_SPLIT - 1) / K1_SPLIT) > 232448 ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return k_scale ? launch_k1<int8_t>(k_cache, v_cache, k_scale, v_scale, qw,
                                     bias, o, m, l, layer, B, M, H, scale, st)
                 : launch_k1<__nv_bfloat16>(k_cache, v_cache, nullptr, nullptr,
                                            qw, bias, o, m, l, layer, B, M, H,
                                            scale, st);
}

// K2 (no scales) / K7 (int8, scales [L, B, M, H], sm = H) / K8 (int8,
// scales [L, B, H, M], sm = 1): o [B, H, Q, DH], m [B, H, Q], l [B, H, Q]
// (all f32), in one launch. o_part, m_part and l_part are not read or
// written (the splits merge in registers) and may be null.
int bdm_flash_ring_prime(const void* k_cache, const void* v_cache,
                         const void* k_scale, const void* v_scale,
                         const void* qw, const void* bias, void* o_part,
                         void* m_part, void* l_part, void* o, void* m,
                         void* l, int layer, int B, int M, int H, int Q,
                         int sm, float scale, int device, void* stream) {
  (void)o_part;
  (void)m_part;
  (void)l_part;
  if (Q < 1 || Q > QMAX || H < 1 || H > 65535 || B < 1 || B > 65535 ||
      M < 1 || (k_scale == nullptr) != (v_scale == nullptr) ||
      (sm != H && sm != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return k_scale ? launch_k2<int8_t>(k_cache, v_cache, k_scale, v_scale, qw,
                                     bias, o, m, l, layer, B, M, H, Q, sm,
                                     scale, st)
                 : launch_k2<__nv_bfloat16>(k_cache, v_cache, nullptr,
                                            nullptr, qw, bias, o, m, l, layer,
                                            B, M, H, Q, sm, scale, st);
}

}  // extern "C"
