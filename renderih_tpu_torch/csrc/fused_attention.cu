// Fused multi-head attention for the decoder's short token streams:
// out[b, n, h, :] = softmax(q[b, n, h] . k[b, :, h]^T / sqrt(D)) v[b, :, h],
// q (B, N, H, D), k/v (B, M, H, D) -> out (B, N, H, D) == (B, N, H*D).
//
// Replaces renderih_tpu/kernels/fused_attention.py:_mha_kernel (the Pallas
// kernel behind every attention core of the dual-graph decoder). Same
// contract: max-subtracted softmax, f32 accumulation, output in q's dtype,
// no mask, no dropout, forward only.
//
// What bounds it on an H100: the streams are short (N, M from 61 to 308
// tokens, D in {16, 32, 64}), so one (batch, head) pair is a few hundred
// KFLOP and the whole call is bound by launch overhead and the bytes of
// q, k, v and out, not by FLOPs. The design keeps the (N, M) score matrix
// out of device memory: each block owns BQ query rows of one (batch,
// head) pair, one thread per row holding its q row and output accumulator
// in registers, and loops over K/V tiles of BK keys staged in shared
// memory (every thread reads the same key: broadcast, no bank conflicts),
// with an online (running max / running sum) softmax in f32. N and M are
// ragged: the last query rows and key tiles are masked, with no
// assumption of a multiple of 16 or 64.
//
// C interface, loaded with ctypes: every launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows per block (one per thread)
constexpr int kBK = 32;  // keys per shared-memory tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBQ)
mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out, int N, int M, int H,
           float scale) {
  __shared__ float ks[kBK][D];
  __shared__ float vs[kBK][D];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int row = blockIdx.x * kBQ + threadIdx.x;
  const bool valid = row < N;
  const size_t ld = (size_t)H * D;  // stride between tokens
  const T* qb = q + ((size_t)b * N * H + h) * D;
  const T* kb = k + ((size_t)b * M * H + h) * D;
  const T* vb = v + ((size_t)b * M * H + h) * D;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = valid ? to_f32(qb[row * ld + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < M; k0 += kBK) {
    const int kn = min(kBK, M - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < kBK * D; idx += kBQ) {
      const int j = idx / D;
      const int d = idx % D;
      float kv = 0.f, vv = 0.f;
      if (j < kn) {
        kv = to_f32(kb[(k0 + j) * ld + d]);
        vv = to_f32(vb[(k0 + j) * ld + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    float s[kBK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      s[j] = dot * scale;
      if (j < kn) tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m_run, tile_max);
    const float corr = expf(m_run - m_new);  // 0 on the first tile
    l_run *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      if (j < kn) {
        const float p = expf(s[j] - m_new);
        l_run += p;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
      }
    }
    m_run = m_new;
  }

  if (valid) {
    T* op = out + ((size_t)b * N * H + h) * D + row * ld;
    const float inv = 1.f / l_run;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = from_f32<T>(acc[d] * inv);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int N, int M, int H, cudaStream_t s) {
  dim3 grid((N + kBQ - 1) / kBQ, B * H);
  const float scale = 1.f / sqrtf((float)D);
  mha_kernel<T, D><<<grid, kBQ, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), N, M, H, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int N, int M, int H, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, out, B, N, M, H, s);
    case 32: return launch_d<T, 32>(q, k, v, out, B, N, M, H, s);
    case 64: return launch_d<T, 64>(q, k, v, out, B, N, M, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int fused_mha_f32(const void* q, const void* k, const void* v,
                             void* out, int B, int N, int M, int H, int D,
                             void* stream) {
  return launch<float>(q, k, v, out, B, N, M, H, D, stream);
}

extern "C" int fused_mha_bf16(const void* q, const void* k, const void* v,
                              void* out, int B, int N, int M, int H, int D,
                              void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, N, M, H, D, stream);
}
