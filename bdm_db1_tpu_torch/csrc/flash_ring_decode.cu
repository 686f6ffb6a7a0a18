// Ring-cache decode attention for Hopper (sm_90a): the q == 1 decode kernel
// (K1 on a bf16 cache, K6 on an int8 one) with the tiny epilogue that
// merges its per-split partials, and the 2 <= Q <= 32 observation-prime
// kernel (K2 bf16, K7 int8, and K8: K7 with head-major scales).
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
// (an all-banned split, whose max is -1e30, gets weight 0). K1 spreads the
// splits over blocks (B * splits blocks fill the 132 SMs) and merges them
// in a second kernel; the prime has B * H blocks of work and merges in
// registers (see k2_prime_kernel).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 128;          // head dim the kernels take
constexpr int K1_SPLIT = 64;     // keys per K1 block
constexpr int K1_UNROLL = 4;     // warp loads in flight per K1 warp
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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
  __device__ static void to_float(const uint4& raw, float* out) {
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(e[i]);
  }
};

// K1/K6: one block per (key split, batch row), one warp per head. A group
// of LPR lanes (16 for bf16, 8 for int8) x 16 bytes reads one key's head
// row, so each warp load covers KPW = 32 / LPR keys; K1_UNROLL loads are in
// flight per warp. Scales (int8 only) are [L, B, M, H].
template <typename T>
__global__ void __launch_bounds__(1024) k1_decode_kernel(
    const T* __restrict__ k_cache,
    const T* __restrict__ v_cache,
    const float* __restrict__ k_scale,        // [L, B, M, H] or null
    const float* __restrict__ v_scale,
    const __nv_bfloat16* __restrict__ qw,     // [B, H, DH]
    const float* __restrict__ bias,           // [B, H, M]
    float* __restrict__ o_part,               // [B, S, H, DH]
    float* __restrict__ m_part,               // [B, S, H]
    float* __restrict__ l_part,               // [B, S, H]
    int layer, int B, int M, int H, float scale) {
  using C = Cache<T>;
  constexpr int EPL = C::EPL;      // dims per lane
  constexpr int LPR = DH / EPL;    // lanes per key row
  constexpr int KPW = 32 / LPR;    // keys per warp load
  __shared__ float sc[32][K1_SPLIT];
  const int split = blockIdx.x, b = blockIdx.y, S = gridDim.x;
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / LPR, sub = lane % LPR;
  const int start = split * K1_SPLIT;
  const int n = min(K1_SPLIT, M - start);
  const size_t row = (size_t)H * DH;
  const size_t base = ((size_t)layer * B + b) * M * row + (size_t)h * DH + sub * EPL;
  // scale of key start + i: sbase + i * H
  const size_t sbase = (((size_t)layer * B + b) * M + start) * H + h;

  float q[EPL];
#pragma unroll
  for (int c = 0; c < EPL; c += VEC)
    bf16x8_to_float(load16(qw + ((size_t)b * H + h) * DH + sub * EPL + c), q + c);
#pragma unroll
  for (int j = 0; j < EPL; ++j) q[j] = round_bf16(q[j] * scale);
  const float* brow = bias + ((size_t)b * H + h) * M + start;

  // pass 1: scores of this split's keys -> shared memory
  for (int i0 = 0; i0 < n; i0 += KPW * K1_UNROLL) {
    uint4 kr[K1_UNROLL];
#pragma unroll
    for (int u = 0; u < K1_UNROLL; ++u) {
      const int i = i0 + KPW * u + grp;
      kr[u] = i < n ? load16(k_cache + base + (size_t)(start + i) * row)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < K1_UNROLL; ++u) {
      const int i = i0 + KPW * u + grp;
      float kf[EPL];
      C::to_float(kr[u], kf);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < EPL; ++j) s = fmaf(q[j], kf[j], s);
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (sub == 0 && i < n) {
        if constexpr (C::kQuant) s *= k_scale[sbase + (size_t)i * H];
        sc[h][i] = s + brow[i];
      }
    }
  }
  __syncwarp();
  float mx = -INFINITY;
  for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sc[h][i]);
  mx = warp_max(mx);

  // pass 2: p = exp(s - m), l += p, o += bf16(p * v_scale) * v
  float o[EPL];
#pragma unroll
  for (int j = 0; j < EPL; ++j) o[j] = 0.f;
  float l = 0.f;
  for (int i0 = 0; i0 < n; i0 += KPW * K1_UNROLL) {
    uint4 vr[K1_UNROLL];
#pragma unroll
    for (int u = 0; u < K1_UNROLL; ++u) {
      const int i = i0 + KPW * u + grp;
      vr[u] = i < n ? load16(v_cache + base + (size_t)(start + i) * row)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < K1_UNROLL; ++u) {
      const int i = i0 + KPW * u + grp;
      if (i < n) {
        const float p = expf(sc[h][i] - mx);
        l += p;
        float pv = p;
        if constexpr (C::kQuant) pv *= v_scale[sbase + (size_t)i * H];
        const float pb = round_bf16(pv);
        float vf[EPL];
        C::to_float(vr[u], vf);
#pragma unroll
        for (int j = 0; j < EPL; ++j) o[j] = fmaf(pb, vf[j], o[j]);
      }
    }
  }
  // the KPW lane groups hold disjoint keys of the same dims
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < EPL; ++j) o[j] += __shfl_xor_sync(0xffffffffu, o[j], off);
    l += __shfl_xor_sync(0xffffffffu, l, off);
  }
  const size_t prow = ((size_t)b * S + split) * H + h;
  if (grp == 0) {
    float4* op = reinterpret_cast<float4*>(o_part + prow * DH + sub * EPL);
#pragma unroll
    for (int j = 0; j < EPL / 4; ++j)
      op[j] = make_float4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
  }
  if (lane == 0) {
    m_part[prow] = mx;
    l_part[prow] = l;
  }
}

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
// the merge of merge_splits_kernel, online. int8 tiles stay int8 in shared
// memory (half the bytes of a bf16 tile); ldmatrix reads their rows as
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
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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


// merge the S split partials of each of the R rows of batch row b:
// m = max_s m_s, w_s = exp(m_s - m), o = sum_s w_s o_s, l = sum_s w_s l_s.
__global__ void __launch_bounds__(DH) merge_splits_kernel(
    const float* __restrict__ o_part,   // [B, S, R, DH]
    const float* __restrict__ m_part,   // [B, S, R]
    const float* __restrict__ l_part,   // [B, S, R]
    float* __restrict__ o,              // [B, R, DH]
    float* __restrict__ m,              // [B, R]
    float* __restrict__ l,              // [B, R]
    int S, int R) {
  const int r = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const size_t st0 = (size_t)b * S * R + r;
  float mf = -INFINITY;
  for (int s = 0; s < S; ++s) mf = fmaxf(mf, m_part[st0 + (size_t)s * R]);
  float acc = 0.f, lacc = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t i = st0 + (size_t)s * R;
    const float w = expf(m_part[i] - mf);
    acc = fmaf(w, o_part[i * DH + d], acc);
    lacc = fmaf(w, l_part[i], lacc);
  }
  o[((size_t)b * R + r) * DH + d] = acc;
  if (d == 0) {
    m[(size_t)b * R + r] = mf;
    l[(size_t)b * R + r] = lacc;
  }
}

template <typename T>
cudaError_t launch_k1(const void* k_cache, const void* v_cache,
                      const void* k_scale, const void* v_scale, const void* qw,
                      const void* bias, void* o_part, void* m_part,
                      void* l_part, int layer, int B, int M, int H,
                      float scale, int S, cudaStream_t st) {
  k1_decode_kernel<T><<<dim3(S, B), H * 32, 0, st>>>(
      static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const __nv_bfloat16*>(qw), static_cast<const float*>(bias),
      static_cast<float*>(o_part), static_cast<float*>(m_part),
      static_cast<float*>(l_part), layer, B, M, H, scale);
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
// [L, B, M, H]): o [B, H, DH], m [B, H], l [B, H] (all f32);
// o_part/m_part/l_part are scratch of [B, S, H(, DH)] with
// S = ceil(M / K1_SPLIT).
int bdm_flash_ring_decode(const void* k_cache, const void* v_cache,
                          const void* k_scale, const void* v_scale,
                          const void* qw, const void* bias, void* o_part,
                          void* m_part, void* l_part, void* o, void* m,
                          void* l, int layer, int B, int M, int H, float scale,
                          int device, void* stream) {
  if (H < 1 || H > 32 || B < 1 || M < 1 || B > 65535 ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int S = (M + K1_SPLIT - 1) / K1_SPLIT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = k_scale ? launch_k1<int8_t>(k_cache, v_cache, k_scale, v_scale, qw,
                                    bias, o_part, m_part, l_part, layer, B,
                                    M, H, scale, S, st)
                : launch_k1<__nv_bfloat16>(k_cache, v_cache, nullptr, nullptr,
                                           qw, bias, o_part, m_part, l_part,
                                           layer, B, M, H, scale, S, st);
  if (err != cudaSuccess) return err;
  merge_splits_kernel<<<dim3(H, B), DH, 0, st>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), S, H);
  return cudaGetLastError();
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
