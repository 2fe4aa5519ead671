// Stride-1 SAME 3x3 convolution, NHWC x HWIO -> NHWC, f32 accumulation.
//
// Replaces renderih_tpu/kernels/conv_pallas.py:conv3x3_same (the Pallas
// implicit-GEMM kernel behind every stride-1 Conv3x3 of the ResNet trunks).
//
// What bounds it on an H100: at the ResNet-50 shapes of batch 256 the
// conv is bound by operations at layers 2-4 and sits near the ridge at
// layer1 (64x64x64: ~268 MB moved against 77 GFLOP, ~290 FLOP/byte, the
// card's bf16 ridge is ~295).
//
// Design: implicit GEMM with rows = output pixels, columns = output
// channels, depth = 9 taps x Cin. One block computes a TH x TW pixel tile
// of one image for 64 output channels. For each chunk of KC input
// channels it stages the (TH+2) x (TW+2) input halo (zeros outside the
// image: SAME padding is handled at the edge, with no padded copy in
// memory) and the 9 x KC x 64 weight slice in shared memory, then
// accumulates the nine shifted taps in f32 registers. Each input element
// is read from device memory about (TH+2)(TW+2)/(TH*TW) times per
// 64-channel output tile.
//
// Two kernels share that design:
//  * conv3x3_tc (bf16, Cin % 16 == 0, Cout % 8 == 0, 16-byte aligned: every
//    ResNet trunk conv): tensor cores through mma.sync m16n8k16 (bf16 in,
//    f32 accumulate). ldmatrix gathers each warp's A rows straight from the
//    halo at the tap's shift (a row per pixel, so the shifted window needs
//    no copy) and the B fragments from the [k][n] weight slice with .trans.
//    Not yet pipelined (no cp.async / TMA double buffering) and not wgmma:
//    later work.
//  * conv3x3_simt (f32, and bf16 at other channel counts): CUDA-core FMA,
//    each thread accumulating PM pixels x 8 channels. f32 must not round
//    through TF32, so the tensor cores are not used for it.
//
// C interface, loaded with ctypes: every launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;  // output channels per block
constexpr int kKC = 8;   // input channels per shared-memory stage
constexpr int kLanesN = 8;                     // threads across channels
constexpr int kLanesP = kThreads / kLanesN;    // threads across pixels
constexpr int kPN = kBN / kLanesN;             // channels per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int TH, int TW>
__global__ void __launch_bounds__(kThreads)
conv3x3_simt(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, int H, int W, int Cin, int Cout,
               int tiles_x) {
  constexpr int TP = TH * TW;        // pixels per tile
  constexpr int PM = TP / kLanesP;   // pixels per thread
  constexpr int HH = TH + 2;
  constexpr int HW = TW + 2;
  constexpr int HP = HH * HW;        // halo pixels
  static_assert(TP % kLanesP == 0, "tile must split evenly over the pixel lanes");

  __shared__ float halo[kKC][HP];
  __shared__ float wsm[9][kKC][kBN];

  const int tid = threadIdx.x;
  const int tn = tid % kLanesN;
  const int tp = tid / kLanesN;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const T* xb = x + (size_t)b * H * W * Cin;

  int hoff[PM];
#pragma unroll
  for (int i = 0; i < PM; ++i) {
    const int p = tp + i * kLanesP;
    hoff[i] = (p / TW) * HW + (p % TW);
  }

  float acc[PM][kPN];
#pragma unroll
  for (int i = 0; i < PM; ++i)
#pragma unroll
    for (int j = 0; j < kPN; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kKC) {
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = tid; idx < HP * kKC; idx += kThreads) {
      const int k = idx % kKC;
      const int hp = idx / kKC;
      const int gy = ty0 - 1 + hp / HW;
      const int gx = tx0 - 1 + hp % HW;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + k < Cin)
        v = to_f32(xb[((size_t)gy * W + gx) * Cin + c0 + k]);
      halo[k][hp] = v;
    }
    for (int idx = tid; idx < 9 * kKC * kBN; idx += kThreads) {
      const int n = idx % kBN;
      const int k = (idx / kBN) % kKC;
      const int tap = idx / (kBN * kKC);
      float v = 0.f;
      if (n0 + n < Cout && c0 + k < Cin)
        v = to_f32(w[((size_t)tap * Cin + c0 + k) * Cout + n0 + n]);
      wsm[tap][k][n] = v;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * HW + (tap % 3);
#pragma unroll
      for (int k = 0; k < kKC; ++k) {
        float a[PM];
        float bv[kPN];
#pragma unroll
        for (int i = 0; i < PM; ++i) a[i] = halo[k][hoff[i] + shift];
#pragma unroll
        for (int j = 0; j < kPN; ++j) bv[j] = wsm[tap][k][tn + j * kLanesN];
#pragma unroll
        for (int i = 0; i < PM; ++i)
#pragma unroll
          for (int j = 0; j < kPN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < PM; ++i) {
    const int p = tp + i * kLanesP;
    const int gy = ty0 + p / TW;
    const int gx = tx0 + p % TW;
    if (gy >= H || gx >= W) continue;
    T* yp = y + (((size_t)b * H + gy) * W + gx) * Cout;
#pragma unroll
    for (int j = 0; j < kPN; ++j) {
      const int n = n0 + tn + j * kLanesN;
      if (n < Cout) yp[n] = from_f32<T>(acc[i][j]);
    }
  }
}


// ---- tensor-core kernel (bf16) --------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps: 2 along pixels x 2 along channels
constexpr int kTcKC = 16;        // input channels per stage (one k16 step)
constexpr int kTcAStride = kTcKC + 8;  // halo row stride (bf16): 48 B, no bank conflicts
constexpr int kTcBStride = kBN + 8;    // weight row stride (bf16): 144 B, no bank conflicts

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int TH, int TW>
__global__ void __launch_bounds__(kTcThreads)
conv3x3_tc(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
           __nv_bfloat16* __restrict__ y, int H, int W, int Cin, int Cout,
           int tiles_x) {
  constexpr int TP = TH * TW;
  constexpr int WM = TP / 2;   // pixels per warp
  constexpr int MT = WM / 16;  // m16 tiles per warp
  constexpr int NT = 4;        // n8 tiles per warp (32 channels)
  constexpr int HW = TW + 2;
  constexpr int HP = (TH + 2) * HW;
  static_assert(WM % 16 == 0, "a warp takes whole m16 tiles");

  __shared__ __align__(16) __nv_bfloat16 halo[HP * kTcAStride];
  __shared__ __align__(16) __nv_bfloat16 wsm[9 * kTcKC * kTcBStride];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 1;
  const int warp_n = warp >> 1;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const __nv_bfloat16* xb = x + (size_t)b * H * W * Cin;

  // ldmatrix row of this lane in each m16 tile: the halo slot of its pixel
  int a_slot[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int p = warp_m * WM + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    a_slot[i] = (p / TW) * HW + (p % TW);
  }
  const int a_k = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_n = warp_n * 32 + (lane >> 4) * 8;
  const unsigned halo_base = smem_u32(halo);
  const unsigned w_base = smem_u32(wsm);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c0 = 0; c0 < Cin; c0 += kTcKC) {
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = tid; idx < HP * 2; idx += kTcThreads) {  // 2 x 16 B per pixel
      const int hp = idx >> 1;
      const int half = idx & 1;
      const int gy = ty0 - 1 + hp / HW;
      const int gx = tx0 - 1 + hp % HW;
      uint4 v = zero;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = *reinterpret_cast<const uint4*>(
            xb + ((size_t)gy * W + gx) * Cin + c0 + half * 8);
      *reinterpret_cast<uint4*>(halo + hp * kTcAStride + half * 8) = v;
    }
    for (int idx = tid; idx < 9 * kTcKC * (kBN / 8); idx += kTcThreads) {
      const int n8 = idx % (kBN / 8);
      const int row = idx / (kBN / 8);  // tap * KC + k
      const int tap = row / kTcKC;
      const int k = row % kTcKC;
      uint4 v = zero;
      if (n0 + n8 * 8 < Cout)
        v = *reinterpret_cast<const uint4*>(
            w + ((size_t)tap * Cin + c0 + k) * Cout + n0 + n8 * 8);
      *reinterpret_cast<uint4*>(wsm + row * kTcBStride + n8 * 8) = v;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * HW + (tap % 3);
      unsigned bf[NT / 2][4];
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp)
        ldmatrix_x4_trans(
            w_base + ((tap * kTcKC + b_k) * kTcBStride + b_n + jp * 16) * 2, bf[jp]);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        unsigned af[4];
        ldmatrix_x4(halo_base + ((a_slot[i] + shift) * kTcAStride + a_k) * 2, af);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc[i][j], af, bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
      }
    }
  }

  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = warp_m * WM + i * 16 + g + half * 8;
      const int gy = ty0 + p / TW;
      const int gx = tx0 + p % TW;
      if (gy >= H || gx >= W) continue;
      __nv_bfloat16* yp = y + (((size_t)b * H + gy) * W + gx) * Cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + warp_n * 32 + j * 8 + t * 2;
        if (n < Cout)
          *reinterpret_cast<__nv_bfloat162*>(yp + n) = __floats2bfloat162_rn(
              acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
      }
    }
  }
}

bool tc_eligible(const void* x, const void* w, const void* y, int Cin, int Cout) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(y);
  return Cin % kTcKC == 0 && Cout % 8 == 0 && (mis & 15) == 0;
}

template <typename T>
int launch(const void* x, const void* w, void* y, int B, int H, int W,
           int Cin, int Cout, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (Cout + kBN - 1) / kBN;
  // 8 x 16 pixel tiles, or 8 x 8 for the narrow maps (layer4 at 256^2)
  const int tw = W >= 16 ? 16 : 8;
  const int tiles_x = (W + tw - 1) / tw, tiles_y = (H + 7) / 8;
  const dim3 grid(tiles_x * tiles_y, n_tiles, B);
  if (std::is_same<T, __nv_bfloat16>::value && tc_eligible(x, w, y, Cin, Cout)) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    auto* yb = static_cast<__nv_bfloat16*>(y);
    if (tw == 16)
      conv3x3_tc<8, 16><<<grid, kTcThreads, 0, s>>>(xb, wb, yb, H, W, Cin, Cout, tiles_x);
    else
      conv3x3_tc<8, 8><<<grid, kTcThreads, 0, s>>>(xb, wb, yb, H, W, Cin, Cout, tiles_x);
  } else if (tw == 16) {
    conv3x3_simt<T, 8, 16><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
        H, W, Cin, Cout, tiles_x);
  } else {
    conv3x3_simt<T, 8, 8><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
        H, W, Cin, Cout, tiles_x);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int conv3x3_same_f32(const void* x, const void* w, void* y, int B,
                                int H, int W, int Cin, int Cout, void* stream) {
  return launch<float>(x, w, y, B, H, W, Cin, Cout, stream);
}

extern "C" int conv3x3_same_bf16(const void* x, const void* w, void* y, int B,
                                 int H, int W, int Cin, int Cout, void* stream) {
  return launch<__nv_bfloat16>(x, w, y, B, H, W, Cin, Cout, stream);
}
