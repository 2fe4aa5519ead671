// Stride-1 SAME 3x3 convolution, NHWC x HWIO -> NHWC, f32 accumulation.
//
// Replaces renderih_tpu/kernels/conv_pallas.py:conv3x3_same (the Pallas
// implicit-GEMM kernel behind every stride-1 Conv3x3 of the ResNet trunks).
//
// What bounds it on an H100: at the ResNet-50 shapes of batch 256 the
// conv is bound by operations at layers 2-4 and sits near the ridge at
// layer1 (64x64x64: ~268 MB moved against 77 GFLOP, ~290 FLOP/byte, the
// card's bf16 ridge is ~295). Inside the kernel the scarce resource is
// the L2 -> SM traffic of the weights: every block of BM output pixels
// reads the whole 9 x Cin x BN weight slice, so the weight bytes per
// FLOP fall as 1/BM.
//
// Two kernels, one implicit GEMM (rows = output pixels, columns = output
// channels, depth = 9 taps x Cin):
//
//  * conv3x3_wgmma (bf16, Cin % 16 == 0, Cout % 8 == 0, 16-byte aligned:
//    every ResNet trunk conv). A block of 256 threads, two consumer
//    warpgroups, computes BM = 256 output pixels x BN output channels
//    (BN = 128, or 64 where Cout <= 64); each warpgroup owns 128 pixels
//    as two m64 tiles and issues wgmma.mma_async m64nBNk16 (bf16 in, f32
//    accumulate in registers). The pixels are a 16 x 16 tile of one image
//    or, for maps of at most 8 x 8 (layer4 at 256^2), four whole 8 x 8
//    images folded into M (as the TPU kernel folds tile_b images into a
//    grid step); the last group of images may be ragged. Folding quarters
//    the weight traffic of layer4 against one image a block.
//    - The depth streams in chunks of 16 input channels (all 9 taps)
//      through a ring of STAGES stages filled by TMA: per chunk one 4-D
//      box of x (16 channels x (TW+2) x (TH+2) x IMGS images, at
//      (c0, tx0 - 1, ty0 - 1, b0)), whose out-of-bounds zero fill is the
//      SAME padding and the images past the batch, and BN/64 3-D boxes of
//      w read as (9, Cin, Cout) (64 channels x 16 k x 9 taps), zero past
//      Cout. Thread 0 issues the copies; a full mbarrier per stage takes
//      their bytes, an empty one the 8 warps' release, and the stage
//      chunk c held is refilled with chunk c + STAGES once every warp is
//      done with it, so the copies of the next STAGES - 1 chunks are in
//      flight while the warpgroups run chunk c. The tensor maps are
//      encoded on the host per call (the pointers change) with
//      cuTensorMapEncodeTiled, reached through the runtime's driver entry
//      point (no -lcuda), and passed as __grid_constant__.
//      TMA rather than cp.async: the same ring copied 16 B a thread kept
//      the warpgroups waiting on their copies (per-thread address work and
//      the SM's cap on outstanding requests); one thread's box copies do not.
//    - A (pixels x 16 channels, one tap) comes from registers: ldmatrix
//      reads each lane's row straight out of the (TH+2) x (TW+2) halo at
//      the tap's shift. A shifted window of the halo has no uniform stride
//      along M, so no shared-memory descriptor can describe it. The halo
//      box lands with TMA's 32 B swizzle: the two 16 B halves of slot s
//      are swapped where bit 2 of s is set, so the 8 rows of every
//      ldmatrix (8 consecutive slots) fall in 8 different bank groups.
//    - B (16 channels x BN, one tap) is read by wgmma from shared memory
//      through a descriptor. HWIO is N-major, so B sits in the 128 B
//      swizzled MN-major layout the weight box lands in (rows of 64
//      channels, 8 rows a 1024 B atom; SBO = 1024 B between the two k
//      atoms, LBO = 18,432 B between 64-channel blocks) and wgmma takes it
//      with its transpose flag.
//    - Shared memory per stage: weights 9 x 16 x BN x 2 B = 36,864 B
//      (BN 128) or 18,432 B (BN 64), halo 324 slots (16 x 16 tile) or 400
//      (4 images of 10 x 10) x 32 B = 10,368 or 12,800 B, rounded up to
//      1024 B. BN 128: 4 stages, at most 200,704 B (+ 1 KB of alignment
//      and the barriers), one block per SM; BN 64: 3 stages, at most
//      95,232 B, two blocks per SM. Dynamic, after cudaFuncSetAttribute.
//    - Each tap's wgmma is committed as its own group and the warpgroup
//      waits for the previous tap only, so the ldmatrix of tap t + 1
//      overlaps the wgmma of tap t (two register sets for A). Each chunk
//      ends with a drain (wait_group 0): with groups left in flight across
//      the chunk loop's back edge ptxas serializes every wgmma (C7513,
//      A registers defined inside the pipeline stage), which is slower.
//    - Epilogue through shared memory (the ring, free by then): bf16 pairs
//      from the accumulators into a [pixel][BN + 8] tile, then 16 B
//      stores of whole rows of a pixel's channels, masked at the ragged
//      pixel edge and past Cout.
//  * conv3x3_simt (f32, and bf16 at other channel counts or misaligned
//    pointers): CUDA-core FMA, each thread accumulating PM pixels x 8
//    channels over 8-channel chunks of a TH x TW tile's halo. f32 must not
//    round through TF32, so the tensor cores are not used for it.
//
// C interface, loaded with ctypes: every launch goes on the caller's
// stream, the function returns cudaGetLastError() and writes the kernel it
// launched to *route (kRouteSimt or kRouteWgmma).

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRouteSimt = 0;
constexpr int kRouteWgmma = 1;

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

// ---- Hopper kernel (bf16): wgmma fed by TMA through an mbarrier ring -----

constexpr int kWgThreads = 256;  // two consumer warpgroups
constexpr int kWarps = kWgThreads / 32;
constexpr int kBM = 256;         // output pixels per block, 128 per warpgroup
constexpr int kWgKC = 16;        // input channels per stage: one k16 step
constexpr int kWBlock = 9 * kWgKC * 128;  // B of 64 channels, all taps: 18,432 B

__host__ __device__ constexpr int wg_stages(int bn) { return bn == 64 ? 3 : 4; }
__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ constexpr int max_of(int a, int b) { return a > b ? a : b; }

template <int TH, int TW, int IMGS, int BN>
struct WgTile {
  static constexpr int HW = TW + 2;                  // halo row
  static constexpr int HP = (TH + 2) * HW;           // halo slots an image
  static constexpr int SLOTS = IMGS * HP;
  static constexpr int HALO_BYTES = SLOTS * 32;      // the halo box: 16 channels a slot
  static constexpr int W_BYTES = BN / 64 * kWBlock;  // BN/64 weight boxes
  static constexpr int TX_BYTES = W_BYTES + HALO_BYTES;  // TMA bytes a stage
  static constexpr int STAGE_BYTES = W_BYTES + round_up(HALO_BYTES, 1024);
  static constexpr int STAGES = wg_stages(BN);
  static constexpr int OUT_STRIDE = BN + 8;          // epilogue tile row (bf16)
  static constexpr int RING_BYTES = max_of(STAGES * STAGE_BYTES, kBM * OUT_STRIDE * 2);
  // + 1024 to align the ring to the 128 B swizzle's 1024 B atom, + barriers
  static constexpr int SMEM_BYTES = 1024 + RING_BYTES + 2 * STAGES * 8;
  static_assert(TH * TW * IMGS == kBM, "a block covers kBM pixels");
  static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep registers that an in-flight wgmma reads or writes where they are.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
__device__ __forceinline__ void fence_regs(unsigned (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// Descriptor of B in shared memory, 128 B swizzle, MN-major: rows of 64
// channels (128 B), 8 rows a 1024 B atom; LBO = between 64-channel
// blocks, SBO = between the two 8-row (k) atoms (16 B units).
__device__ __forceinline__ uint64_t b_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kWBlock >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// Byte offset of 16 B half h of halo slot s: TMA's 32 B swizzle swaps the
// halves where bit 2 of s is set, so ldmatrix over 8 consecutive slots is
// conflict-free.
__device__ __forceinline__ unsigned halo_off(int s, int h) {
  return (unsigned)(s * 32 + ((h ^ ((s >> 2) & 1)) << 4));
}

// D (m64 x N, f32) += A (m64 x k16, bf16 registers) * B (k16 x N, bf16,
// shared memory, N-major: transpose flag set)
template <int N> struct Wgmma;

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const unsigned (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const unsigned (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <int TH, int TW, int IMGS, int BN>
__global__ void __launch_bounds__(kWgThreads, BN == 64 ? 2 : 1)
conv3x3_wgmma(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap, __nv_bfloat16* __restrict__ y,
              int B, int H, int W, int Cin, int Cout, int tiles_x, int tiles_y) {
  using Tile = WgTile<TH, TW, IMGS, BN>;
  constexpr int HW = Tile::HW, HP = Tile::HP;
  constexpr int STAGES = Tile::STAGES;
  constexpr int NJ = BN / 8;     // n8 blocks of a row
  constexpr int NACC = BN / 2;   // accumulators a thread per m64 tile
  constexpr int PIX = TH * TW;   // pixels an image

  extern __shared__ unsigned char smem_raw[];
  const unsigned ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned bars = ring + Tile::RING_BYTES;  // full[STAGES], empty[STAGES]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;   // warpgroup
  const int wq = warp & 3;    // warp within it: rows 16 wq .. 16 wq + 15 of each m64 tile
  int b0, ty0 = 0, tx0 = 0;
  if (IMGS == 1) {
    int t = blockIdx.x;
    tx0 = (t % tiles_x) * TW;
    t /= tiles_x;
    ty0 = (t % tiles_y) * TH;
    b0 = t / tiles_y;
  } else {
    b0 = blockIdx.x * IMGS;
  }
  const int n0 = blockIdx.y * BN;
  const int chunks = Cin / kWgKC;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 fills stage c % STAGES with chunk c: the BN/64 weight boxes
  // (64 channels x 16 k x 9 taps each; the 128 B swizzle zero-fills past
  // Cout) and the halo box (16 channels x (TW+2) x (TH+2) x IMGS images;
  // zero outside the image and past the batch: the SAME padding)
  auto issue = [&](int c) {
    const int s = c % STAGES;
    const unsigned st = ring + s * Tile::STAGE_BYTES, full = bars + 8 * s;
    mbar_expect_tx(full, Tile::TX_BYTES);
#pragma unroll
    for (int nh = 0; nh < BN / 64; ++nh)
      tma_load_3d(st + nh * kWBlock, &wmap, full, n0 + nh * 64, c * kWgKC, 0);
    tma_load_4d(st + Tile::W_BYTES, &xmap, full, c * kWgKC, tx0 - 1, ty0 - 1, b0);
  };
  if (tid == 0)
    for (int c = 0; c < STAGES && c < chunks; ++c) issue(c);

  // ldmatrix row of this lane in each m64 tile (rows 16 wq + 0..15): its
  // pixel's halo slot at tap (0, 0); the lane's 16 B half of the chunk
  int a_slot[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int p = wg * 128 + mt * 64 + wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int img = p / PIX, q = p % PIX;
    a_slot[mt] = img * HP + (q / TW) * HW + q % TW;
  }
  const int a_half = lane >> 4;

  float acc[2][NACC];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[mt][i] = 0.f;
  unsigned afrag[2][2][4];  // [tap parity][m64 tile]

  for (int c = 0; c < chunks; ++c) {
    // refill the stage that chunk c - 1 held, once every warp is done with it
    if (tid == 0 && c >= 1 && c - 1 + STAGES < chunks) {
      mbar_wait(bars + 8 * (STAGES + (c - 1) % STAGES), ((c - 1) / STAGES) & 1);
      issue(c - 1 + STAGES);
    }
    const int s = c % STAGES;
    mbar_wait(bars + 8 * s, (c / STAGES) & 1);
    __syncwarp();  // converged again for ldmatrix and wgmma (.sync.aligned)
    const unsigned st = ring + s * Tile::STAGE_BYTES;
    const unsigned halo = st + Tile::W_BYTES;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * HW + tap % 3;
      unsigned (&a)[2][4] = afrag[tap & 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(halo + halo_off(a_slot[mt] + shift, a_half), a[mt]);
      wgmma_fence();
      const uint64_t desc = b_desc(st + tap * (kWBlock / 9));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) Wgmma<BN>::mma(acc[mt], a[mt], desc);
      wgmma_commit();
      wgmma_wait<1>();  // tap - 1 is done: its A registers may be reloaded
      fence_regs(afrag[(tap + 1) & 1][0]);
      fence_regs(afrag[(tap + 1) & 1][1]);
    }
    wgmma_wait<0>();  // this warp has read the stage
    fence_regs(afrag[0][0]);
    fence_regs(afrag[0][1]);
    fence_regs(afrag[1][0]);
    fence_regs(afrag[1][1]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (STAGES + s));
  }
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  // Epilogue through shared memory (the ring is free: every chunk has
  // been consumed): bf16 pairs into a [pixel][BN + 8] tile, then 16 B
  // stores, whole rows of a pixel's channels, masked at the ragged pixel
  // edge and past Cout (a multiple of 8).
  // Accumulator i of a thread: row g (+8 for bit 1 of i), channel
  // 8 (i / 4) + 2 t + (i & 1), with g = lane / 4, t = lane % 4.
  __syncthreads();
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(smem_raw + (ring - smem_u32(smem_raw)));
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = wg * 128 + mt * 64 + wq * 16 + g + half * 8;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + p * Tile::OUT_STRIDE + j * 8 + t * 2) =
            __floats2bfloat162_rn(acc[mt][j * 4 + half * 2], acc[mt][j * 4 + half * 2 + 1]);
    }
  __syncthreads();
  for (int idx = tid; idx < kBM * NJ; idx += kWgThreads) {
    const int p = idx / NJ, j = idx % NJ;
    const int img = p / PIX, q = p % PIX;
    const int b = b0 + img, gy = ty0 + q / TW, gx = tx0 + q % TW, n = n0 + j * 8;
    if (b < B && gy < H && gx < W && n < Cout)
      *reinterpret_cast<uint4*>(y + (((size_t)b * H + gy) * W + gx) * Cout + n) =
          *reinterpret_cast<const uint4*>(out + p * Tile::OUT_STRIDE + j * 8);
  }
}

bool wgmma_eligible(const void* x, const void* w, const void* y, int Cin, int Cout) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(y);
  return Cin % kWgKC == 0 && Cout % 8 == 0 && (mis & 15) == 0;
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

template <int TH, int TW, int IMGS, int BN>
cudaError_t launch_wgmma(const void* x, const void* w, void* y, int B, int H, int W,
                         int Cin, int Cout, cudaStream_t s) {
  using Tile = WgTile<TH, TW, IMGS, BN>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // x (B, H, W, Cin): box 16 channels x (TW+2) x (TH+2) x IMGS, 32 B swizzle
  CUtensorMap xmap, wmap;
  const cuuint64_t xdim[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstride[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                                 (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t xbox[4] = {kWgKC, TW + 2, TH + 2, IMGS};
  // w (9, Cin, Cout): box 64 channels x 16 k x 9 taps, 128 B swizzle
  const cuuint64_t wdim[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin, 9};
  const cuuint64_t wstride[2] = {(cuuint64_t)Cout * 2, (cuuint64_t)Cin * Cout * 2};
  const cuuint32_t wbox[3] = {64, kWgKC, 9};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdim, xstride,
             xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
          CUDA_SUCCESS ||
      encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), wdim, wstride,
             wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
          CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kernel = conv3x3_wgmma<TH, TW, IMGS, BN>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int pix_tiles = IMGS == 1 ? B * tiles_y * tiles_x : (B + IMGS - 1) / IMGS;
  const dim3 grid(pix_tiles, (Cout + BN - 1) / BN);
  kernel<<<grid, kWgThreads, Tile::SMEM_BYTES, s>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(y), B, H, W, Cin, Cout, tiles_x, tiles_y);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_wgmma_bn(const void* x, const void* w, void* y, int B, int H, int W,
                            int Cin, int Cout, cudaStream_t s) {
  if (H <= 8 && W <= 8)  // four whole images a block
    return launch_wgmma<8, 8, 4, BN>(x, w, y, B, H, W, Cin, Cout, s);
  return launch_wgmma<16, 16, 1, BN>(x, w, y, B, H, W, Cin, Cout, s);
}

template <typename T>
int launch(const void* x, const void* w, void* y, int B, int H, int W,
           int Cin, int Cout, void* stream, int* route) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (std::is_same<T, __nv_bfloat16>::value && wgmma_eligible(x, w, y, Cin, Cout)) {
    *route = kRouteWgmma;
    return static_cast<int>(
        Cout <= 64 ? launch_wgmma_bn<64>(x, w, y, B, H, W, Cin, Cout, s)
                   : launch_wgmma_bn<128>(x, w, y, B, H, W, Cin, Cout, s));
  }
  *route = kRouteSimt;
  const int n_tiles = (Cout + kBN - 1) / kBN;
  // 8 x 16 pixel tiles, or 8 x 8 for the narrow maps
  const int tw = W >= 16 ? 16 : 8;
  const int tiles_x = (W + tw - 1) / tw, tiles_y = (H + 7) / 8;
  const dim3 grid(tiles_x * tiles_y, n_tiles, B);
  if (tw == 16) {
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
                                int H, int W, int Cin, int Cout, void* stream,
                                int* route) {
  return launch<float>(x, w, y, B, H, W, Cin, Cout, stream, route);
}

extern "C" int conv3x3_same_bf16(const void* x, const void* w, void* y, int B,
                                 int H, int W, int Cin, int Cout, void* stream,
                                 int* route) {
  return launch<__nv_bfloat16>(x, w, y, B, H, W, Cin, Cout, stream, route);
}
