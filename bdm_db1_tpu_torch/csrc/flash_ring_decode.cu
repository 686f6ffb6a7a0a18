// Ring-cache decode attention for Hopper (sm_90a): the q == 1 decode kernel
// (K1) and the 2 <= Q <= 32 observation-prime kernel (K2), plus the tiny
// epilogue that merges their per-split partials.
//
// Replaces the Pallas kernels of bdm_db1_tpu/ops/flash_ring_decode.py:
//   K1  _flash_ring_decode_local (:249, body _decode_core :91)
//   K2  _flash_ring_prime_ap_local (:578, body _prime_ap_core :383)
// Contract (not the TPU block layout): for one layer of the stacked ring
// cache [L, B, M, H, Dh] and queries qw (q + r_w_bias, compute dtype), return
// the unnormalised softmax-weighted value sum o and the row stats (m, l) of
// the scores s = bf16(qw * bf16(scale)) . k + bias, where bias carries the
// scaled positional term and -1e30 at banned ring slots. p = exp(s - m) is
// rounded to bf16 before the PV product, l sums the unrounded p.
//
// What bounds them on an H100: bytes. Each launch streams one layer's K and
// V slice (2 * B * M * H * Dh * 2 bytes, 335.5 MB at B = 40, M = 1024,
// H = 16, Dh = 128) plus the f32 bias; the arithmetic is ~1 FLOP/byte at
// q == 1 and ~Q FLOP/byte at the prime. The design therefore reads every
// cache byte exactly once, straight out of the stacked buffer at the layer
// offset (no per-layer copy), with 16-byte loads on contiguous rows, and
// cuts the keys into splits so that B * splits blocks fill the 132 SMs.
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
constexpr int K1_UNROLL = 4;     // key pairs in flight per K1 warp
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

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
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

// K1: one block per (key split, batch row), one warp per head. A half-warp
// (16 lanes x 16 bytes) reads one key's 256-byte head row, so each warp
// load covers two keys; K1_UNROLL pairs are in flight per warp.
__global__ void __launch_bounds__(1024) k1_decode_kernel(
    const __nv_bfloat16* __restrict__ k_cache,
    const __nv_bfloat16* __restrict__ v_cache,
    const __nv_bfloat16* __restrict__ qw,     // [B, H, DH]
    const float* __restrict__ bias,           // [B, H, M]
    float* __restrict__ o_part,               // [B, S, H, DH]
    float* __restrict__ m_part,               // [B, S, H]
    float* __restrict__ l_part,               // [B, S, H]
    int layer, int B, int M, int H, float scale) {
  __shared__ float sc[32][K1_SPLIT];
  const int split = blockIdx.x, b = blockIdx.y, S = gridDim.x;
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane >> 4, sub = lane & 15;
  const int start = split * K1_SPLIT;
  const int n = min(K1_SPLIT, M - start);
  const size_t row = (size_t)H * DH;
  const size_t base = ((size_t)layer * B + b) * M * row + (size_t)h * DH + sub * VEC;

  float q[VEC];
  bf16x8_to_float(load16(qw + ((size_t)b * H + h) * DH + sub * VEC), q);
#pragma unroll
  for (int j = 0; j < VEC; ++j) q[j] = round_bf16(q[j] * scale);
  const float* brow = bias + ((size_t)b * H + h) * M + start;

  // pass 1: scores of this split's keys -> shared memory
  for (int i0 = 0; i0 < n; i0 += 2 * K1_UNROLL) {
    uint4 kr[K1_UNROLL];
#pragma unroll
    for (int u = 0; u < K1_UNROLL; ++u) {
      const int i = i0 + 2 * u + half;
      kr[u] = i < n ? load16(k_cache + base + (size_t)(start + i) * row)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < K1_UNROLL; ++u) {
      const int i = i0 + 2 * u + half;
      float kf[VEC];
      bf16x8_to_float(kr[u], kf);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) s = fmaf(q[j], kf[j], s);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (sub == 0 && i < n) sc[h][i] = s + brow[i];
    }
  }
  __syncwarp();
  float mx = -INFINITY;
  for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sc[h][i]);
  mx = warp_max(mx);

  // pass 2: p = exp(s - m), l += p, o += bf16(p) * v
  float o[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) o[j] = 0.f;
  float l = 0.f;
  for (int i0 = 0; i0 < n; i0 += 2 * K1_UNROLL) {
    uint4 vr[K1_UNROLL];
#pragma unroll
    for (int u = 0; u < K1_UNROLL; ++u) {
      const int i = i0 + 2 * u + half;
      vr[u] = i < n ? load16(v_cache + base + (size_t)(start + i) * row)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < K1_UNROLL; ++u) {
      const int i = i0 + 2 * u + half;
      if (i < n) {
        const float p = expf(sc[h][i] - mx);
        l += p;
        const float pb = round_bf16(p);
        float vf[VEC];
        bf16x8_to_float(vr[u], vf);
#pragma unroll
        for (int j = 0; j < VEC; ++j) o[j] = fmaf(pb, vf[j], o[j]);
      }
    }
  }
  // the two half-warps hold disjoint keys of the same dims
#pragma unroll
  for (int j = 0; j < VEC; ++j) o[j] += __shfl_xor_sync(0xffffffffu, o[j], 16);
  l += __shfl_xor_sync(0xffffffffu, l, 16);
  const size_t prow = ((size_t)b * S + split) * H + h;
  if (half == 0) {
    float4* op = reinterpret_cast<float4*>(o_part + prow * DH + sub * VEC);
    op[0] = make_float4(o[0], o[1], o[2], o[3]);
    op[1] = make_float4(o[4], o[5], o[6], o[7]);
  }
  if (lane == 0) {
    m_part[prow] = mx;
    l_part[prow] = l;
  }
}

// K2: one block per (key split, head, batch row). The Q query rows of the
// head sit in shared memory; keys are staged 32 at a time. Scores: lane =
// key, warp w owns query rows [8w, 8w + 8). PV: thread = value dim.
__global__ void __launch_bounds__(K2_THREADS) k2_prime_kernel(
    const __nv_bfloat16* __restrict__ k_cache,
    const __nv_bfloat16* __restrict__ v_cache,
    const __nv_bfloat16* __restrict__ qw,     // [B, H, Q, DH]
    const float* __restrict__ bias,           // [B, H, Q, M]
    float* __restrict__ o_part,               // [B, S, H, Q, DH]
    float* __restrict__ m_part,               // [B, S, H, Q]
    float* __restrict__ l_part,               // [B, S, H, Q]
    int layer, int B, int M, int H, int Q, float scale) {
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
    for (int idx = tid; idx < K2_TILE * (DH / VEC); idx += K2_THREADS) {
      const int key = idx / (DH / VEC), c = (idx % (DH / VEC)) * VEC;
      const int i = t0 + key;
      *reinterpret_cast<uint4*>(&tile[key][c]) =
          i < n ? load16(k_cache + base + (size_t)(start + i) * row + c)
                : make_uint4(0u, 0u, 0u, 0u);
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
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qq = q0 + j;
          if (qq < Q) ps[qq][i] = acc[j] + bias[(qrow0 + qq) * M + start + i];
        }
      }
    }
  }
  __syncthreads();

  // split softmax stats per query row; ps becomes bf16(p), zero past n
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
        pb = round_bf16(p);
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

  // pass 2: o[q][d] = sum_i bf16(p[q][i]) * v[i][d], thread = d
  float o[QMAX];
#pragma unroll
  for (int qq = 0; qq < QMAX; ++qq) o[qq] = 0.f;
  for (int t0 = 0; t0 < n; t0 += K2_TILE) {
    __syncthreads();
    for (int idx = tid; idx < K2_TILE * (DH / VEC); idx += K2_THREADS) {
      const int key = idx / (DH / VEC), c = (idx % (DH / VEC)) * VEC;
      const int i = t0 + key;
      *reinterpret_cast<uint4*>(&tile[key][c]) =
          i < n ? load16(v_cache + base + (size_t)(start + i) * row + c)
                : make_uint4(0u, 0u, 0u, 0u);
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

}  // namespace

extern "C" {

int bdm_head_dim() { return DH; }
int bdm_k1_split() { return K1_SPLIT; }
int bdm_k2_split() { return K2_SPLIT; }
int bdm_k2_max_q() { return QMAX; }

const char* bdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1: o [B, H, DH], m [B, H], l [B, H] (all f32); o_part/m_part/l_part are
// scratch of [B, S, H(, DH)] with S = ceil(M / K1_SPLIT).
int bdm_flash_ring_decode(const void* k_cache, const void* v_cache,
                          const void* qw, const void* bias, void* o_part,
                          void* m_part, void* l_part, void* o, void* m,
                          void* l, int layer, int B, int M, int H, float scale,
                          int device, void* stream) {
  if (H < 1 || H > 32 || B < 1 || M < 1 || B > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int S = (M + K1_SPLIT - 1) / K1_SPLIT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  k1_decode_kernel<<<dim3(S, B), H * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache),
      static_cast<const __nv_bfloat16*>(qw), static_cast<const float*>(bias),
      static_cast<float*>(o_part), static_cast<float*>(m_part),
      static_cast<float*>(l_part), layer, B, M, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_splits_kernel<<<dim3(H, B), DH, 0, st>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), S, H);
  return cudaGetLastError();
}

// K2: o [B, H, Q, DH], m [B, H, Q], l [B, H, Q] (all f32); scratch
// [B, S, H, Q(, DH)] with S = ceil(M / K2_SPLIT).
int bdm_flash_ring_prime(const void* k_cache, const void* v_cache,
                         const void* qw, const void* bias, void* o_part,
                         void* m_part, void* l_part, void* o, void* m,
                         void* l, int layer, int B, int M, int H, int Q,
                         float scale, int device, void* stream) {
  if (Q < 1 || Q > QMAX || H < 1 || H > 65535 || B < 1 || B > 65535 || M < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int S = (M + K2_SPLIT - 1) / K2_SPLIT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  k2_prime_kernel<<<dim3(S, H, B), K2_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache),
      static_cast<const __nv_bfloat16*>(qw), static_cast<const float*>(bias),
      static_cast<float*>(o_part), static_cast<float*>(m_part),
      static_cast<float*>(l_part), layer, B, M, H, Q, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_splits_kernel<<<dim3(H * Q, B), DH, 0, st>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), S, H * Q);
  return cudaGetLastError();
}

}  // extern "C"
