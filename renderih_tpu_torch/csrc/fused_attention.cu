// Fused multi-head attention for the decoder's short token streams and the
// ViT encoders' 256-token ones, on Hopper's tensor cores:
// out[b, n, h, :] = softmax(q[b, n, h] . k[b, :, h]^T / sqrt(D)) v[b, :, h],
// q (B, N, H, D), k/v (B, M, H, D) -> out (B, N, H, D) == (B, N, H*D).
//
// Replaces renderih_tpu/kernels/fused_attention.py:_mha_kernel (the Pallas
// kernel behind every attention core of the dual-graph decoder and of the
// ViT encoders). Same contract: max-subtracted softmax, f32 accumulation,
// output in q's dtype, no mask, no dropout, forward only. D in {8, 16, 32,
// 64, 96, 128}; any N, M >= 1.
//
// What bounds it on an H100: bytes. The streams are short (N, M from 61 to
// 308 tokens in the decoder, 256 keys in the ViT), so a (batch, head) pair
// is at most some tens of MFLOP; at every path shape q, k, v and out over 3.35
// TB/s take longer than the FLOPs over the 495 TFLOP/s TF32 (989 bf16)
// tensor-core peak or the exponentials over the MUFU rate, by 2x or more
// at the ViT's. The design keeps the (N, M) score matrix in registers, reads
// each input once from device memory (K/V re-reads of a pair's other query
// tiles hit L2) and keeps copies in flight while the tensor cores work. The
// f32 route pays for its accuracy in instructions: three TF32 passes, the
// hi/lo splits of every operand and the softmax's per-score work are what
// keep it above its bound, so those are kept to the fewest instructions.
//
// Design (FlashAttention-2's shape, sized to these streams):
// - Work split: a block is 4 warps and takes one (batch, head) pair and a
//   tile of 64 query rows; each warp owns 16 rows, whose Q fragments stay
//   in registers for the whole key loop (but f32 at D >= 96, below). The
//   blocks of one pair are neighbours in the (1-D) grid, so the pair's K/V,
//   fetched from device memory by the first of them, is still in L2 for the
//   others. A block
//   per query tile rather than one walking all of its pair's tiles: at
//   N = 61..64 a pair has one tile either way, and at N = 308 five blocks
//   fill the card five times faster than one.
// - Products: mma.sync, not wgmma. wgmma's tile is 64 query rows per
//   warpgroup, which the ragged N = 61/63 streams leave partly empty, and
//   TF32 wgmma takes both operands K-major, so V would have to be staged
//   transposed. mma.sync's 16-row tiles per warp need neither.
//   - f32: m16n8k8 TF32 with f32 accumulation, split three ways: each f32
//     operand x = hi + lo, hi = x rounded to TF32 (to nearest) and lo the
//     residual, which the tensor core truncates to TF32 (split_tf32); the
//     split is made in registers as a fragment is loaded (staging both
//     halves in shared memory would double it), and a product is lo.hi +
//     hi.lo + hi.hi. One-pass TF32 errs by up to ~9e-4 on the flagship
//     shapes, outside the f32 tolerance of 1e-4; 3xTF32 by ~1e-6, on a par
//     with f32 FMA (tests/test_torch_kernels.py models both on the CPU). At
//     D <= 32 the small terms of P.V go to a second accumulator, so that no
//     chain of dependent mma is longer than 16 (the chains are D / 8 wide).
//   - bf16: m16n8k16 in one pass, P rounded to bf16 before P.V as the
//     Pallas kernel casts p to v's dtype.
// - Fragment layouts (PTX ISA, mma.m16n8k8 .tf32): the accumulator of S
//   holds columns (2t, 2t+1) of each 8-key tile, but the A operand of P.V
//   wants columns (t, t+4). Rather than shuffle, the key order inside each
//   8-key slice is permuted consistently: the k-index t of P.V is key 2t and
//   t+4 is key 2t+1, so P's A fragment is S's accumulator as it stands and
//   V's B fragment reads rows 2t and 2t+1 (a sum over keys does not care
//   about their order). Q.K^T permutes its head-dim order the same way (k
//   index t is d = 2t, t+4 is d = 2t+1), so a lane's Q and K fragments are
//   8-byte loads. bf16 m16n8k16 needs no permutation for P (as in
//   FlashAttention-2); V's B fragment comes from ldmatrix.trans.
// - Online softmax over key chunks of 64: a running max and sum per row in
//   f32, the max on raw scores and p = 2^(s c - m c) with c = log2(e) /
//   sqrt(D), one FFMA and one ex2.approx a score; keys past M are masked to
//   -inf before the max in the one chunk that runs past M (their staged K/V
//   rows are zero-filled).
// - Staging: K/V chunks of 64 keys through a ring of cp.async stages, 16 B
//   a thread (a head's row is D * 4 = 64..256 contiguous bytes at a stride
//   of H * D * 4); chunk c + STAGES - 1 is copied while chunk c is on the
//   tensor cores. Any M works: the ring never holds more than STAGES chunks.
// - Shared memory, padded so that every fragment load is free of bank
//   conflicts. f32: K rows D + 8 floats (8-byte loads: half-warp rows land
//   8 banks apart), V rows D + 4 (rows 2t land 8 banks apart); bf16: K and V
//   rows D + 8 halves (32-bit loads, 16-byte ldmatrix rows). One stage is
//   64 * (2D + 12) * 4 B in f32 = 35,840 / 19,456 / 11,264 B at D = 64 / 32
//   / 16, and 64 * 2 * (D + 8) * 2 B in bf16 = 18,432 / 10,240 / 6,144 B.
//   Two stages at D >= 64, three below: 71,680 / 58,368 / 33,792 B in f32,
//   36,864 / 30,720 / 18,432 B in bf16 at D = 64 / 32 / 16, dynamic (above
//   48 KB after cudaFuncSetAttribute, set once per kernel instance). Two
//   stages still overlap the copy of chunk c + 1 with chunk c's products
//   at the ViT's M = 256 (four chunks); a third would cost f32 D = 64 its
//   third block an SM by shared memory, and its registers (Q's hi and lo
//   fragments are 64 of them) already hold it to two, which ptxas keeps
//   without spills (a cap at three blocks' worth made it spill).
// - D = 96 and 128 (the ViT's pooled-KV attention, 8 heads of 768 or 1024):
//   in bf16 as at D <= 64, 53,248 / 69,632 B. In f32, Q's split fragments
//   alone would be 96 / 128 registers a thread beside O's 48 / 64 and S's
//   32, past the 255 a thread can hold without spilling. There Q's tile of
//   64 rows stays in shared memory (rows D + 8 floats, as K's; copied with
//   chunk 0) and each k-step's fragment is loaded and split as it is used,
//   a few instructions a chunk beside its 3 x 8 x D / 8 mma: 2 x 52,224 +
//   26,624 = 131,072 B at D = 96, 2 x 68,608 + 34,816 = 172,032 B at
//   D = 128, one block an SM. Registers a thread (ptxas, none spilled):
//   f32 214 / 246, bf16 190 / 218 at D = 96 / 128 (launch bounds per
//   instance: Layout::kMinBlocks).
// - D = 8 (the experimental InterPoint's 8 heads at width 64): in f32 one
//   k-step of m16n8k8 on QK^T and one 8-wide d-tile on P.V, as at larger D.
//   bf16's m16n8k16 wants k = 16 on QK^T: Q's and K's fragments are
//   zero-padded to 16 in registers (their upper 8 columns are zeros, which
//   leaves Q.K^T as it is), and P.V's n = 8 is native, one d-tile from
//   ldmatrix.x2.trans. Rows are unpadded there (K and V rows of 8 halves, K
//   rows of 8 floats): 16 B or 32 B apart, every fragment load and ldmatrix
//   row falls on distinct banks; f32 V keeps D + 4. A bf16 chunk is 64
//   16-byte pieces of K (and of V) for 128 threads, so half the threads
//   copy nothing.
// - Ragged edges: rows past N load zeros and are not stored; a warp with no
//   row computes nothing but still copies its share and meets the barriers.
//
// C interface, loaded with ctypes: every launch goes on the caller's
// stream and the function returns its cudaError_t. q, k, v and out must
// be 16-byte aligned (the wrapper sees to it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows a block
constexpr int kBK = 64;           // keys a chunk
constexpr int kNT = kBK / 8;      // 8-key tiles of S a chunk
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory geometry of one K/V stage (see the note above).
template <typename T, int D>
struct Layout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kLdK = D == 8 ? D : D + 8;  // elements a K row
  static constexpr int kLdV = kF32 ? D + 4 : kLdK;   // elements a V row
  static constexpr int kStages = D >= 64 ? 2 : 3;
  // f32 P.V: a second accumulator for 3xTF32's small terms where registers
  // allow (D <= 32), so that no chain of dependent mma is longer than 16
  static constexpr bool kSplitAcc = kF32 && D <= 32;
  // f32 at D >= 96: Q's tile in shared memory after the stages, K's row pitch
  static constexpr bool kQSmem = kF32 && D >= 96;
  static constexpr int kVBytes = kBK * kLdK * (int)sizeof(T);  // V after K
  static constexpr int kStageBytes = kBK * (kLdK + kLdV) * (int)sizeof(T);
  static constexpr int kQBytes = kQSmem ? kBQ * kLdK * (int)sizeof(T) : 0;
  static constexpr int kSmem = kStages * kStageBytes + kQBytes;
  // Blocks an SM the launch bounds name; 0 names none (ptxas's own register
  // budget). At bf16 D = 96 that budget (168 a thread) spilled; told to fit
  // two blocks it takes 190 and spills nothing. Naming one block lets ptxas
  // take more registers: faster at the ViT's instances (f32 D = 96 by 23%,
  // bf16 D = 64 and 128 by 6%), slower at the decoder's short ones (up to
  // 15% at D <= 32), so those keep ptxas's budget (timed in PERF.md).
  static constexpr int kMinBlocks =
      !kF32 && D == 96 ? 2 : (D == 96 || (!kF32 && D >= 64)) ? 1 : 0;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero fill where !valid (src is not read then)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo. hi is x rounded to TF32, to nearest with ties away from zero:
// the bits of cvt.rna.tf32.f32 for every finite x, in two integer ops (cvt
// was measurably slower on the card). lo = x - hi is exact in f32 and goes
// to the mma as it is: the tensor core reads a TF32 operand's top 19 bits,
// so lo enters as tf32(x - hi) truncated, |error| <= 2^-21 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 3xTF32: lo.hi + hi.lo into `small`, then hi.hi into `c` (`small` may be
// `c` itself; a second accumulator shortens the chain of dependent mma)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], float (&small)[4],
                                           const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(small, alo, bh0, bh1);
  mma_tf32(small, ahi, bl0, bl1);
  mma_tf32(c, ahi, bh0, bh1);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU op; 0 at -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two products of one warp (16 query rows) on one staged chunk, per
// dtype. Lane = 4 g + t. S and O fragments: [tile][e], e = 0, 1 row g
// columns (2t, 2t + 1), e = 2, 3 row g + 8.
template <typename T, int D>
struct Warp;

template <int D>
struct Warp<float, D> {
  static constexpr bool kQSmem = Layout<float, D>::kQSmem;
  // Q's A fragments, split; with kQSmem only the rows' shared-memory addresses
  uint32_t qhi[kQSmem ? 1 : D / 8][4], qlo[kQSmem ? 1 : D / 8][4];
  const float *q0, *q1;

  // Q's A fragment of k-step ks from rows r0, r1 (null: a row past N).
  // k-index t of step ks is d = 8 ks + 2t, t + 4 is d = 8 ks + 2t + 1
  static __device__ __forceinline__ void q_frag(const float* r0, const float* r1, int ks, int t,
                                                uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const float2 x0 = r0 ? *reinterpret_cast<const float2*>(r0 + 8 * ks + 2 * t)
                         : make_float2(0.f, 0.f);
    const float2 x1 = r1 ? *reinterpret_cast<const float2*>(r1 + 8 * ks + 2 * t)
                         : make_float2(0.f, 0.f);
    split_tf32(x0.x, hi[0], lo[0]);
    split_tf32(x1.x, hi[1], lo[1]);
    split_tf32(x0.y, hi[2], lo[2]);
    split_tf32(x1.y, hi[3], lo[3]);
  }

  __device__ __forceinline__ void load_q(const float* r0, const float* r1, int t) {
    q0 = r0;
    q1 = r1;
    if constexpr (!kQSmem) {
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) q_frag(r0, r1, ks, t, qhi[ks], qlo[ks]);
    }
  }

  // S[16 x 64] += Q_ks K_ks^T for one k-step; K's B fragment for key g of
  // tile nt: row nt*8 + g
  static __device__ __forceinline__ void qk_step(float (&s)[kNT][4], const uint32_t (&hi)[4],
                                                 const uint32_t (&lo)[4], const float* ks_,
                                                 int ks, int g, int t) {
    constexpr int ld = Layout<float, D>::kLdK;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float2 b = *reinterpret_cast<const float2*>(ks_ + (nt * 8 + g) * ld + 8 * ks + 2 * t);
      mma_3xtf32(s[nt], s[nt], hi, lo, b.x, b.y);
    }
  }

  // S[16 x 64] = Q K^T
  __device__ __forceinline__ void qk(float (&s)[kNT][4], const float* ks_, int g, int t) const {
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      if constexpr (kQSmem) {
        uint32_t hi[4], lo[4];
        q_frag(q0, q1, ks, t, hi, lo);
        qk_step(s, hi, lo, ks_, ks, g, t);
      } else {
        qk_step(s, qhi[ks], qlo[ks], ks_, ks, g, t);
      }
    }
  }

  // O[16 x D] += P V, the small 3xTF32 terms into `o_small`; k-index t of
  // slice kk is key 8 kk + 2t, t + 4 is key 8 kk + 2t + 1: P's A fragment
  // is S's accumulator, reordered in place
  static __device__ __forceinline__ void pv(float (&o)[D / 8][4], float (&o_small)[D / 8][4],
                                            const float (&p)[kNT][4], const float* vs,
                                            int lane) {
    constexpr int ld = Layout<float, D>::kLdV;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      uint32_t ahi[4], alo[4];
      split_tf32(p[kk][0], ahi[0], alo[0]);  // row g, key 2t
      split_tf32(p[kk][2], ahi[1], alo[1]);  // row g + 8, key 2t
      split_tf32(p[kk][1], ahi[2], alo[2]);  // row g, key 2t + 1
      split_tf32(p[kk][3], ahi[3], alo[3]);  // row g + 8, key 2t + 1
      const float* v0 = vs + (8 * kk + 2 * t) * ld + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        mma_3xtf32(o[dt], o_small[dt], ahi, alo, v0[8 * dt], v0[ld + 8 * dt]);
    }
  }

  static __device__ __forceinline__ void store(float* row, int dt, int t, float x, float y) {
    *reinterpret_cast<float2*>(row + 8 * dt + 2 * t) = make_float2(x, y);
  }
};

template <int D>
struct Warp<__nv_bfloat16, D> {
  static constexpr int kKS = (D + 15) / 16;  // k-steps of 16; D = 8 pads to one
  uint32_t qa[kKS][4];                       // Q's A fragments (bf16 pairs)

  __device__ __forceinline__ void load_q(const __nv_bfloat16* r0, const __nv_bfloat16* r1,
                                         int t) {
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const int d = 16 * ks + 2 * t;
      qa[ks][0] = r0 ? *reinterpret_cast<const uint32_t*>(r0 + d) : 0u;
      qa[ks][1] = r1 ? *reinterpret_cast<const uint32_t*>(r1 + d) : 0u;
      if constexpr (D == 8) {  // columns 8..15: the zero padding
        qa[ks][2] = qa[ks][3] = 0u;
      } else {
        qa[ks][2] = r0 ? *reinterpret_cast<const uint32_t*>(r0 + d + 8) : 0u;
        qa[ks][3] = r1 ? *reinterpret_cast<const uint32_t*>(r1 + d + 8) : 0u;
      }
    }
  }

  __device__ __forceinline__ void qk(float (&s)[kNT][4], const __nv_bfloat16* ks_, int g,
                                     int t) const {
    constexpr int ld = Layout<__nv_bfloat16, D>::kLdK;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const uint32_t* b =
            reinterpret_cast<const uint32_t*>(ks_ + (nt * 8 + g) * ld + 16 * ks + 2 * t);
        mma_bf16(s[nt], qa[ks], b[0], D == 8 ? 0u : b[4]);
      }
    }
  }

  // O[16 x D] += P V in one pass (no small terms). P's A fragment for keys
  // 16 kk .. 16 kk + 15 is S's tiles 2 kk, 2 kk + 1 rounded to bf16; V's B
  // fragments come from ldmatrix.trans, two d-tiles at a time (matrices:
  // keys +0 / +8 x d +0 / +8)
  static __device__ __forceinline__ void pv(float (&o)[D / 8][4], float (&)[D / 8][4],
                                            const float (&p)[kNT][4], const __nv_bfloat16* vs,
                                            int lane) {
    constexpr int ld = Layout<__nv_bfloat16, D>::kLdV;
    const int row = (lane & 7) + ((lane >> 3) & 1) * 8, col = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                             pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                             pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
      if constexpr (D == 8) {  // one d-tile: matrices keys +0 / +8 (lanes 0-15)
        uint32_t b[2];
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                     : "=r"(b[0]), "=r"(b[1])
                     : "r"(smem_u32(vs + (16 * kk + row) * ld)));
        mma_bf16(o[0], a, b[0], b[1]);
      } else {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b[4];
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
              : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
              : "r"(smem_u32(vs + (16 * kk + row) * ld + 16 * dp + col)));
          mma_bf16(o[2 * dp], a, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
        }
      }
    }
  }

  static __device__ __forceinline__ void store(__nv_bfloat16* row, int dt, int t, float x,
                                               float y) {
    *reinterpret_cast<__nv_bfloat162*>(row + 8 * dt + 2 * t) = __floats2bfloat162_rn(x, y);
  }
};

// Copy query rows r0 .. r0 + 63 of Q (zeros past N) to shared memory at
// `dst`, rows K's pitch apart (f32 at D >= 96).
template <typename T, int D>
__device__ __forceinline__ void load_q_tile(unsigned dst, const T* qb, int r0, int N, size_t ld) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  static_assert(kBQ * kPerRow % kThreads == 0, "every thread copies alike");
#pragma unroll
  for (int r = 0; r < kBQ * kPerRow / kThreads; ++r) {
    const int i = threadIdx.x + r * kThreads;
    const int j = i / kPerRow, c = (i % kPerRow) * kVec;
    const bool valid = r0 + j < N;
    cp_async16(dst + (j * Layout<T, D>::kLdK + c) * sizeof(T),
               qb + (valid ? (size_t)(r0 + j) * ld + c : 0), valid);
  }
}

// Copy keys j0 .. j0 + 63 of K and V (zeros past M) into one stage.
template <typename T, int D>
__device__ __forceinline__ void load_chunk(unsigned char* stage, const T* kb, const T* vb,
                                           int j0, int M, size_t ld) {
  using L = Layout<T, D>;
  constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte piece
  constexpr int kPerRow = D / kVec;
  constexpr int kPieces = kBK * kPerRow;
  static_assert(kPieces % kThreads == 0 || kPieces < kThreads,
                "every thread copies alike, or a piece at most");
  const unsigned ks = smem_u32(stage), vs = ks + L::kVBytes;
#pragma unroll
  for (int r = 0; r < (kPieces + kThreads - 1) / kThreads; ++r) {
    const int i = threadIdx.x + r * kThreads;
    if (kPieces < kThreads && i >= kPieces) break;  // bf16 D = 8
    const int j = i / kPerRow, c = (i % kPerRow) * kVec;
    const bool valid = j0 + j < M;
    const size_t off = valid ? (size_t)(j0 + j) * ld + c : 0;
    cp_async16(ks + (j * L::kLdK + c) * sizeof(T), kb + off, valid);
    cp_async16(vs + (j * L::kLdV + c) * sizeof(T), vb + off, valid);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Layout<T, D>::kMinBlocks)
mha_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ out, int N, int M, int H, int q_tiles, float scale_log2) {
  using L = Layout<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int pair = blockIdx.x / q_tiles;
  const int tile = blockIdx.x - pair * q_tiles;
  const int b = pair / H, h = pair - b * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t ld = (size_t)H * D;  // stride between tokens
  const T* kb = k + ((size_t)b * M * H + h) * D;
  const T* vb = v + ((size_t)b * M * H + h) * D;
  const int n_chunks = (M + kBK - 1) / kBK;
  const T* qb = q + ((size_t)b * N * H + h) * D;
  unsigned char* q_smem = smem + L::kStages * L::kStageBytes;
  if constexpr (L::kQSmem)  // lands with chunk 0 (the first group)
    load_q_tile<T, D>(smem_u32(q_smem), qb, tile * kBQ, N, ld);

#pragma unroll
  for (int c = 0; c < L::kStages - 1; ++c) {
    if (c < n_chunks) load_chunk<T, D>(smem + c * L::kStageBytes, kb, vb, c * kBK, M, ld);
    cp_async_commit();
  }

  const int row0 = tile * kBQ + warp * 16 + g, row1 = row0 + 8;
  const bool active = tile * kBQ + warp * 16 < N;  // warp-uniform
  Warp<T, D> w;
  if constexpr (L::kQSmem) {  // read after chunk 0's barrier, zeros past N
    const T* r0 = reinterpret_cast<const T*>(q_smem) + (warp * 16 + g) * L::kLdK;
    w.load_q(r0, r0 + 8 * L::kLdK, t);
  } else {
    w.load_q(row0 < N ? qb + row0 * ld : nullptr, row1 < N ? qb + row1 * ld : nullptr, t);
  }

  // O's accumulators; f32 at D <= 32 keeps 3xTF32's small terms apart
  float o[D / 8][4], o_small[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = o_small[dt][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // raw units

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<L::kStages - 2>();  // this thread's copies of chunk c landed
    __syncthreads();                  // everyone's; and chunk c - 1's stage is free
    const int next = c + L::kStages - 1;
    if (next < n_chunks)
      load_chunk<T, D>(smem + (next % L::kStages) * L::kStageBytes, kb, vb, next * kBK, M, ld);
    cp_async_commit();
    if (!active) continue;

    const unsigned char* stage = smem + (c % L::kStages) * L::kStageBytes;
    const T* ks = reinterpret_cast<const T*>(stage);
    const T* vs = reinterpret_cast<const T*>(stage + L::kVBytes);
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    w.qk(s, ks, g, t);

    // online softmax; a lane holds rows g (e < 2) and g + 8. The max is
    // taken on the raw scores and p = 2^(s c - m c), c = log2(e) / sqrt(D):
    // one FFMA and one ex2 a score (FlashAttention-2's form)
    if ((c + 1) * kBK > M) {  // the chunk runs past M: mask those keys
      const int j0 = c * kBK + 2 * t;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + nt * 8 + (e & 1) >= M) s[nt][e] = -INFINITY;
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    float corr[2], mc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the quad of lanes t = 0..3 shares a row
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = ex2((m_run[i] - mx[i]) * scale_log2);  // 0 on the first chunk
      mc[i] = mx[i] * scale_log2;
      m_run[i] = mx[i];
      l_run[i] *= corr[i];
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = ex2(fmaf(s[nt][e], scale_log2, -mc[e >> 1]));
        l_run[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[dt][e] *= corr[e >> 1];
        if constexpr (L::kSplitAcc) o_small[dt][e] *= corr[e >> 1];
      }

    Warp<T, D>::pv(o, L::kSplitAcc ? o_small : o, s, vs, lane);
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  if constexpr (L::kSplitAcc) {
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] += o_small[dt][e];
  }
  T* ob = out + ((size_t)b * N * H + h) * D;
  const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    if (row0 < N) Warp<T, D>::store(ob + row0 * ld, dt, t, o[dt][0] * inv0, o[dt][1] * inv0);
    if (row1 < N) Warp<T, D>::store(ob + row1 * ld, dt, t, o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, int B, int N,
                     int M, int H, cudaStream_t s) {
  using L = Layout<T, D>;
  auto kernel = mha_mma_kernel<T, D>;
  static const cudaError_t attr =  // once per kernel instance
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return attr;
  const int q_tiles = (N + kBQ - 1) / kBQ;
  const long long blocks = (long long)q_tiles * B * H;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const float scale_log2 = kLog2e / sqrtf((float)D);
  kernel<<<(unsigned)blocks, kThreads, L::kSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), N, M, H, q_tiles, scale_log2);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int N, int M,
           int H, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return static_cast<int>(launch_d<T, 8>(q, k, v, out, B, N, M, H, s));
    case 16: return static_cast<int>(launch_d<T, 16>(q, k, v, out, B, N, M, H, s));
    case 32: return static_cast<int>(launch_d<T, 32>(q, k, v, out, B, N, M, H, s));
    case 64: return static_cast<int>(launch_d<T, 64>(q, k, v, out, B, N, M, H, s));
    case 96: return static_cast<int>(launch_d<T, 96>(q, k, v, out, B, N, M, H, s));
    case 128: return static_cast<int>(launch_d<T, 128>(q, k, v, out, B, N, M, H, s));
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

// Dynamic shared memory of a kernel instance (bf16 0: float32, 1:
// bfloat16), for reports; -1 for a D it does not take.
extern "C" int fused_mha_smem_bytes(int bf16, int D) {
  switch (D) {
    case 8: return bf16 ? Layout<__nv_bfloat16, 8>::kSmem : Layout<float, 8>::kSmem;
    case 16: return bf16 ? Layout<__nv_bfloat16, 16>::kSmem : Layout<float, 16>::kSmem;
    case 32: return bf16 ? Layout<__nv_bfloat16, 32>::kSmem : Layout<float, 32>::kSmem;
    case 64: return bf16 ? Layout<__nv_bfloat16, 64>::kSmem : Layout<float, 64>::kSmem;
    case 96: return bf16 ? Layout<__nv_bfloat16, 96>::kSmem : Layout<float, 96>::kSmem;
    case 128: return bf16 ? Layout<__nv_bfloat16, 128>::kSmem : Layout<float, 128>::kSmem;
    default: return -1;
  }
}
