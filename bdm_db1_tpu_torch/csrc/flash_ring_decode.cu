// Ring-cache decode attention for Hopper (sm_90a): the q == 1 decode kernel
// (K1 on a bf16 cache, K6 on an int8 one), the 2 <= Q <= 32 observation-
// prime kernel (K2 bf16, K7 int8, and K8: K7 with head-major scales), plus
// the tiny epilogue that merges their per-split partials.
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
// to bf16 for the prime's shared tile) exactly.
//
// What bounds them on an H100: bytes. Each launch streams one layer's K and
// V slice (2 * B * M * H * Dh * sizeof(elem): 335.5 MB in bf16 at B = 40,
// 234.9 MB in int8 at B = 56, M = 1024, H = 16, Dh = 128) plus the f32
// bias and scales; the arithmetic is ~1 FLOP/byte at q == 1 and ~Q
// FLOP/byte at the prime. The design therefore reads every cache byte
// exactly once, straight out of the stacked buffer at the layer offset (no
// per-layer copy), with 16-byte loads on contiguous rows (a 256-byte bf16
// key row is 16 lanes x 16 bytes, a 128-byte int8 row 8 lanes x 16 bytes),
// and cuts the keys into splits so that B * splits blocks fill the 132 SMs.
// Each split is two passes over its keys: scores (reading K) into shared
// memory, then the split max, then exp and PV (reading V). A split is
// therefore one softmax block with the Pallas kernel's block semantics, and
// the merge kernel combines the splits exactly as the JAX wrapper combines
// its blocks (w = exp(m_split - m_max), so an all-banned split whose max is
// -1e30 gets weight 0).
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
constexpr int K2_SPLIT = 128;    // keys per K2 block
constexpr int K2_TILE = 32;      // keys staged in shared memory per K2 step
constexpr int K2_THREADS = 128;
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

// What one 16-byte load of a cache row holds: EPL elements, as floats or
// staged as bf16 (8 values per 16 bytes) in shared memory.
template <typename T> struct Cache;

template <> struct Cache<__nv_bfloat16> {
  static constexpr int EPL = 8;
  static constexpr bool kQuant = false;
  __device__ static void to_float(const uint4& raw, float* out) {
    bf16x8_to_float(raw, out);
  }
  __device__ static void to_bf16(const uint4& raw, __nv_bfloat16* dst) {
    *reinterpret_cast<uint4*>(dst) = raw;
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
  // int8 values are exact in bf16
  __device__ static void to_bf16(const uint4& raw, __nv_bfloat16* dst) {
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

// K2/K7/K8: one block per (key split, head, batch row). The Q query rows of
// the head sit in shared memory; keys are staged 32 at a time as bf16 (int8
// converted on the way in). Scores: lane = key, warp w owns query rows
// [8w, 8w + 8). PV: thread = value dim. Scales (int8 only): key m of head h
// at ((layer * B + b) * M * H) + m * sm + h * (sm == 1 ? M : 1), so sm = H
// reads [L, B, M, H] (K7) and sm = 1 reads [L, B, H, M] (K8).
template <typename T>
__global__ void __launch_bounds__(K2_THREADS) k2_prime_kernel(
    const T* __restrict__ k_cache,
    const T* __restrict__ v_cache,
    const float* __restrict__ k_scale,        // see above, or null
    const float* __restrict__ v_scale,
    const __nv_bfloat16* __restrict__ qw,     // [B, H, Q, DH]
    const float* __restrict__ bias,           // [B, H, Q, M]
    float* __restrict__ o_part,               // [B, S, H, Q, DH]
    float* __restrict__ m_part,               // [B, S, H, Q]
    float* __restrict__ l_part,               // [B, S, H, Q]
    int layer, int B, int M, int H, int Q, int sm, float scale) {
  using C = Cache<T>;
  constexpr int EPL = C::EPL;
  constexpr int RV = DH / EPL;     // 16-byte loads per key row
  __shared__ __align__(16) float qs[QMAX][DH];
  __shared__ __align__(16) float ps[QMAX][K2_SPLIT];      // scores, then bf16(p)
  __shared__ __align__(16) __nv_bfloat16 tile[K2_TILE][DH + VEC];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z, S = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int start = split * K2_SPLIT;
  const int n = min(K2_SPLIT, M - start);
  const size_t row = (size_t)H * DH;
  const size_t base = ((size_t)layer * B + b) * M * row + (size_t)h * DH;
  const size_t qrow0 = ((size_t)b * H + h) * Q;
  // scale of key start + i: sbase + i * sm
  const size_t sbase = ((size_t)layer * B + b) * M * H
                       + (size_t)h * (sm == 1 ? M : 1) + (size_t)start * sm;

  for (int idx = tid; idx < QMAX * (DH / VEC); idx += K2_THREADS) {
    const int r = idx / (DH / VEC), c = (idx % (DH / VEC)) * VEC;
    float f[VEC];
    if (r < Q) {
      bf16x8_to_float(load16(qw + (qrow0 + r) * DH + c), f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = round_bf16(f[j] * scale);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) qs[r][c + j] = f[j];
  }

  // pass 1: scores
  const int q0 = warp * 8;
  for (int t0 = 0; t0 < n; t0 += K2_TILE) {
    __syncthreads();
    for (int idx = tid; idx < K2_TILE * RV; idx += K2_THREADS) {
      const int key = idx / RV, c = (idx % RV) * EPL;
      const int i = t0 + key;
      C::to_bf16(i < n ? load16(k_cache + base + (size_t)(start + i) * row + c)
                       : make_uint4(0u, 0u, 0u, 0u),
                 &tile[key][c]);
    }
    __syncthreads();
    if (q0 < Q) {
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < DH; c += VEC) {
        float kf[VEC];
        bf16x8_to_float(*reinterpret_cast<const uint4*>(&tile[lane][c]), kf);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 a = *reinterpret_cast<const float4*>(&qs[q0 + j][c]);
          const float4 e = *reinterpret_cast<const float4*>(&qs[q0 + j][c + 4]);
          acc[j] = fmaf(a.x, kf[0], acc[j]);
          acc[j] = fmaf(a.y, kf[1], acc[j]);
          acc[j] = fmaf(a.z, kf[2], acc[j]);
          acc[j] = fmaf(a.w, kf[3], acc[j]);
          acc[j] = fmaf(e.x, kf[4], acc[j]);
          acc[j] = fmaf(e.y, kf[5], acc[j]);
          acc[j] = fmaf(e.z, kf[6], acc[j]);
          acc[j] = fmaf(e.w, kf[7], acc[j]);
        }
      }
      const int i = t0 + lane;
      if (i < n) {
        float ks = 1.f;
        if constexpr (C::kQuant) ks = k_scale[sbase + (size_t)i * sm];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qq = q0 + j;
          if (qq < Q) {
            float s = acc[j];
            if constexpr (C::kQuant) s *= ks;
            ps[qq][i] = s + bias[(qrow0 + qq) * M + start + i];
          }
        }
      }
    }
  }
  __syncthreads();

  // split softmax stats per query row; ps becomes bf16(p * v_scale), zero
  // past n
  for (int qq = warp; qq < Q; qq += K2_THREADS / 32) {
    float mx = -INFINITY;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, ps[qq][i]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int i = lane; i < K2_SPLIT; i += 32) {
      float pb = 0.f;
      if (i < n) {
        const float p = expf(ps[qq][i] - mx);
        l += p;
        float pv = p;
        if constexpr (C::kQuant) pv *= v_scale[sbase + (size_t)i * sm];
        pb = round_bf16(pv);
      }
      ps[qq][i] = pb;
    }
    l = warp_sum(l);
    if (lane == 0) {
      const size_t prow = (((size_t)b * S + split) * H + h) * Q + qq;
      m_part[prow] = mx;
      l_part[prow] = l;
    }
  }

  // pass 2: o[q][d] = sum_i ps[q][i] * v[i][d], thread = d
  float o[QMAX];
#pragma unroll
  for (int qq = 0; qq < QMAX; ++qq) o[qq] = 0.f;
  for (int t0 = 0; t0 < n; t0 += K2_TILE) {
    __syncthreads();
    for (int idx = tid; idx < K2_TILE * RV; idx += K2_THREADS) {
      const int key = idx / RV, c = (idx % RV) * EPL;
      const int i = t0 + key;
      C::to_bf16(i < n ? load16(v_cache + base + (size_t)(start + i) * row + c)
                       : make_uint4(0u, 0u, 0u, 0u),
                 &tile[key][c]);
    }
    __syncthreads();
#pragma unroll 2
    for (int k4 = 0; k4 < K2_TILE; k4 += 4) {
      const float v0 = __bfloat162float(tile[k4][tid]);
      const float v1 = __bfloat162float(tile[k4 + 1][tid]);
      const float v2 = __bfloat162float(tile[k4 + 2][tid]);
      const float v3 = __bfloat162float(tile[k4 + 3][tid]);
#pragma unroll
      for (int qq = 0; qq < QMAX; ++qq) {
        if (qq < Q) {
          const float4 p = *reinterpret_cast<const float4*>(&ps[qq][t0 + k4]);
          o[qq] = fmaf(p.x, v0, o[qq]);
          o[qq] = fmaf(p.y, v1, o[qq]);
          o[qq] = fmaf(p.z, v2, o[qq]);
          o[qq] = fmaf(p.w, v3, o[qq]);
        }
      }
    }
  }
  const size_t orow0 = (((size_t)b * S + split) * H + h) * Q;
#pragma unroll
  for (int qq = 0; qq < QMAX; ++qq)
    if (qq < Q) o_part[(orow0 + qq) * DH + tid] = o[qq];
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
                      const void* bias, void* o_part, void* m_part,
                      void* l_part, int layer, int B, int M, int H, int Q,
                      int sm, float scale, int S, cudaStream_t st) {
  k2_prime_kernel<T><<<dim3(S, H, B), K2_THREADS, 0, st>>>(
      static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const __nv_bfloat16*>(qw), static_cast<const float*>(bias),
      static_cast<float*>(o_part), static_cast<float*>(m_part),
      static_cast<float*>(l_part), layer, B, M, H, Q, sm, scale);
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
// (all f32); scratch [B, S, H, Q(, DH)] with S = ceil(M / K2_SPLIT).
int bdm_flash_ring_prime(const void* k_cache, const void* v_cache,
                         const void* k_scale, const void* v_scale,
                         const void* qw, const void* bias, void* o_part,
                         void* m_part, void* l_part, void* o, void* m,
                         void* l, int layer, int B, int M, int H, int Q,
                         int sm, float scale, int device, void* stream) {
  if (Q < 1 || Q > QMAX || H < 1 || H > 65535 || B < 1 || B > 65535 ||
      M < 1 || (k_scale == nullptr) != (v_scale == nullptr) ||
      (sm != H && sm != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int S = (M + K2_SPLIT - 1) / K2_SPLIT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = k_scale ? launch_k2<int8_t>(k_cache, v_cache, k_scale, v_scale, qw,
                                    bias, o_part, m_part, l_part, layer, B,
                                    M, H, Q, sm, scale, S, st)
                : launch_k2<__nv_bfloat16>(k_cache, v_cache, nullptr, nullptr,
                                           qw, bias, o_part, m_part, l_part,
                                           layer, B, M, H, Q, sm, scale, S,
                                           st);
  if (err != cudaSuccess) return err;
  merge_splits_kernel<<<dim3(H * Q, B), DH, 0, st>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), S, H * Q);
  return cudaGetLastError();
}

}  // extern "C"
