// SDF voxelisation of one triangle mesh (kernel B3): for each voxel centre
// p of a G^3 grid over the mesh's bbox (cubed, padded x1.1),
//   phi[z, y, x] = sqrt(min_f dist^2(p, face f))  if the ray from p along
//                  RAY_DIR crosses the surface an odd number of times,
//                  0                             otherwise.
// verts (V, 3) f32, faces (F, 3) int32 or int64, bbox_min (3,) and scale ()
// f32 on the device -> phi (G, G, G) f32.
//
// Replaces renderih_tpu/kernels/sdf_pallas.py:_sdf_kernel (with its
// _pair_dist_sq and _crossings), which computes the same field as the XLA
// renderih_tpu/ops/sdf.py:sdf_grid. The distance is Eberly's: the least of
// the interior minimiser (where it lies inside the triangle) and the three
// clamped edge minimisers; the crossing test is Moller-Trumbore.
//
// What bounds it on an H100: operations. Per (voxel, face) pair it does
// ~80 FLOP (the Pallas cost estimate; ~110 as written here, with three to
// five IEEE divisions) against 4 bytes per voxel out and 36 per face in,
// so at G=32, F=1552 the call is ~4.1 GFLOP, 0.061 ms at 67 TFLOP/s f32,
// against 0.0002 ms of bytes. No pair touches device memory.
//
// Design: a warp per voxel, kVoxels = 8 voxels in a 256-thread block. The
// block streams the faces through shared memory in tiles of kTile, each
// face staged once per block with its per-face terms precomputed (v0, e0,
// e1, a00, a01, a11, the clamped det and edge denominators, the ray's pvec
// and inv_det), so the pair loop reads shared memory only. The 32 lanes
// of a warp split its voxel's face loop: lane l takes faces l, l + 32,
// ..., keeping a running fminf of the squared distance and an integer
// crossing count; a shuffle reduction ends the voxel, and sqrtf and the
// parity are taken once. Both reductions are exact and independent of
// order (fminf returns one of its operands; the count is an integer), so
// the field is bit for bit the plain version's with no atomics and no
// scratch. At G=16 (the refinement's size) that is 512 blocks, ~31 warps
// on each of the 132 SMs and ~49 faces a lane at F=1552, where one thread
// per voxel gave 32 blocks on 132 SMs. Staging costs ~1/8 of the pair work
// (each block stages every face for 8 voxels); a per-call table of face
// terms would need scratch memory and a second pass, and splitting faces
// across blocks atomics and a finalising pass: neither is needed to fill
// the card. The face count is ragged (1552 synthetic, 1538 real, 12 for a
// cube, fewer than the lanes): the last tile is short and idle lanes keep
// the identities (inf, 0). The voxel centre comes from bbox_min, scale and
// G, not from an array.
//
// Exactness: the crossing parity is discontinuous, so the kernel does the
// plain version's float32 arithmetic (renderih_tpu_torch/kernels/sdf.py)
// in the same order, and is built with -fmad=false so that no multiply-add
// is contracted. The constants are the reference's: |det| > 1e-10,
// t > 1e-9, and the 1e-12 clamps.
//
// C interface, loaded with ctypes: the launch goes on the caller's stream
// and the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kVoxels = kThreads / 32;  // voxels per block: a warp each
constexpr int kTile = kThreads;         // faces per shared-memory tile (one per thread)
constexpr float kEps = 1e-12f;
constexpr float kRayX = 0.801783726f, kRayY = 0.534522484f, kRayZ = 0.267261242f;

struct FaceTile {  // structure of arrays: lanes read one face at a time
  float v0[3][kTile];
  float e0[3][kTile];
  float e1[3][kTile];
  float a00[kTile], a01[kTile], a11[kTile];
  float det[kTile];                 // max(a00 a11 - a01^2, eps)
  float a00c[kTile], a11c[kTile];   // max(a00, eps), max(a11, eps)
  float diag[kTile];                // max(a00 - 2 a01 + a11, eps)
  float pvec[3][kTile];             // cross(RAY_DIR, e1)
  float inv_det[kTile];             // 1 / (e0 . pvec), 0 where |.| <= 1e-10
};

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

template <typename I>
__device__ void stage_face(FaceTile& tile, int slot, const float* __restrict__ verts,
                           const I* __restrict__ faces, int f) {
  const int64_t i0 = faces[3 * (int64_t)f], i1 = faces[3 * (int64_t)f + 1],
                i2 = faces[3 * (int64_t)f + 2];
  float b[3], e0[3], e1[3];
  for (int c = 0; c < 3; ++c) {
    b[c] = verts[3 * i0 + c];
    e0[c] = verts[3 * i1 + c] - b[c];
    e1[c] = verts[3 * i2 + c] - b[c];
    tile.v0[c][slot] = b[c];
    tile.e0[c][slot] = e0[c];
    tile.e1[c][slot] = e1[c];
  }
  const float a00 = dot3(e0[0], e0[1], e0[2], e0[0], e0[1], e0[2]);
  const float a01 = dot3(e0[0], e0[1], e0[2], e1[0], e1[1], e1[2]);
  const float a11 = dot3(e1[0], e1[1], e1[2], e1[0], e1[1], e1[2]);
  tile.a00[slot] = a00;
  tile.a01[slot] = a01;
  tile.a11[slot] = a11;
  tile.det[slot] = fmaxf(a00 * a11 - a01 * a01, kEps);
  tile.a00c[slot] = fmaxf(a00, kEps);
  tile.a11c[slot] = fmaxf(a11, kEps);
  tile.diag[slot] = fmaxf(a00 - 2.f * a01 + a11, kEps);
  // ray test: edge1 = e0, edge2 = e1 (both from vertex 0)
  const float px = kRayY * e1[2] - kRayZ * e1[1];
  const float py = kRayZ * e1[0] - kRayX * e1[2];
  const float pz = kRayX * e1[1] - kRayY * e1[0];
  tile.pvec[0][slot] = px;
  tile.pvec[1][slot] = py;
  tile.pvec[2][slot] = pz;
  const float det = dot3(e0[0], e0[1], e0[2], px, py, pz);
  tile.inv_det[slot] = fabsf(det) > 1e-10f ? 1.f / det : 0.f;
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
sdf_kernel(const float* __restrict__ verts, const I* __restrict__ faces,
           const float* __restrict__ bbox_min, const float* __restrict__ scale_ptr,
           float* __restrict__ phi, int num_faces, int G) {
  __shared__ FaceTile tile;
  const int lane = threadIdx.x & 31;
  const int64_t n_vox = (int64_t)G * G * G;
  const int64_t vox = (int64_t)blockIdx.x * kVoxels + (threadIdx.x >> 5);
  const bool active = vox < n_vox;
  const int gx = (int)(vox % G), gy = (int)((vox / G) % G), gz = (int)(vox / ((int64_t)G * G));
  const float scale = scale_ptr[0];
  const float g_f = (float)G;
  const float p0 = bbox_min[0] + scale * (((float)gx + 0.5f) / g_f);
  const float p1 = bbox_min[1] + scale * (((float)gy + 0.5f) / g_f);
  const float p2 = bbox_min[2] + scale * (((float)gz + 0.5f) / g_f);

  float best = INFINITY;
  int crossings = 0;
  for (int start = 0; start < num_faces; start += kTile) {
    const int n = min(kTile, num_faces - start);
    __syncthreads();  // the previous tile is consumed
    if (threadIdx.x < n) stage_face(tile, threadIdx.x, verts, faces, start + threadIdx.x);
    __syncthreads();
    if (!active) continue;
    for (int j = lane; j < n; j += 32) {
      const float v0x = tile.v0[0][j], v0y = tile.v0[1][j], v0z = tile.v0[2][j];
      const float e0x = tile.e0[0][j], e0y = tile.e0[1][j], e0z = tile.e0[2][j];
      const float e1x = tile.e1[0][j], e1y = tile.e1[1][j], e1z = tile.e1[2][j];
      const float a00 = tile.a00[j], a01 = tile.a01[j], a11 = tile.a11[j];
      const float det = tile.det[j];

      // --- squared point-triangle distance (Eberly), d = v0 - p
      const float dx = v0x - p0, dy = v0y - p1, dz = v0z - p2;
      const float b0 = dot3(e0x, e0y, e0z, dx, dy, dz);
      const float b1 = dot3(e1x, e1y, e1z, dx, dy, dz);
      const float s = a01 * b1 - a11 * b0;
      const float t = a01 * b0 - a00 * b1;
      float qx, qy, qz, q;
      if (s + t <= det && s >= 0.f && t >= 0.f) {  // interior minimiser
        const float ss = s / det, tt = t / det;
        qx = dx + ss * e0x + tt * e1x;
        qy = dy + ss * e0y + tt * e1y;
        qz = dz + ss * e0z + tt * e1z;
        best = fminf(best, dot3(qx, qy, qz, qx, qy, qz));
      }
      const float t_s0 = clamp01(-b1 / tile.a11c[j]);  // edge s = 0
      qx = dx + t_s0 * e1x;
      qy = dy + t_s0 * e1y;
      qz = dz + t_s0 * e1z;
      q = dot3(qx, qy, qz, qx, qy, qz);
      const float s_t0 = clamp01(-b0 / tile.a00c[j]);  // edge t = 0
      qx = dx + s_t0 * e0x;
      qy = dy + s_t0 * e0y;
      qz = dz + s_t0 * e0z;
      q = fminf(q, dot3(qx, qy, qz, qx, qy, qz));
      const float s_dg = clamp01(((a11 + b1) - (a01 + b0)) / tile.diag[j]);  // s + t = 1
      const float t_dg = 1.f - s_dg;
      qx = dx + s_dg * e0x + t_dg * e1x;
      qy = dy + s_dg * e0y + t_dg * e1y;
      qz = dz + s_dg * e0z + t_dg * e1z;
      q = fminf(q, dot3(qx, qy, qz, qx, qy, qz));
      best = fminf(best, q);

      // --- ray crossing (Moller-Trumbore), tvec = p - v0
      const float inv_det = tile.inv_det[j];
      const float tx = p0 - v0x, ty = p1 - v0y, tz = p2 - v0z;
      const float u = dot3(tx, ty, tz, tile.pvec[0][j], tile.pvec[1][j], tile.pvec[2][j]) * inv_det;
      const float cx = ty * e0z - tz * e0y;  // qvec = cross(tvec, edge1 = e0)
      const float cy = tz * e0x - tx * e0z;
      const float cz = tx * e0y - ty * e0x;
      const float v = dot3(cx, cy, cz, kRayX, kRayY, kRayZ) * inv_det;
      const float tr = dot3(cx, cy, cz, e1x, e1y, e1z) * inv_det;
      crossings += (inv_det != 0.f && u >= 0.f && u <= 1.f && v >= 0.f &&
                    u + v <= 1.f && tr > 1e-9f);
    }
  }
  // the warp's partial results: exact and order-free, so no atomics
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    best = fminf(best, __shfl_xor_sync(0xffffffffu, best, off));
    crossings += __shfl_xor_sync(0xffffffffu, crossings, off);
  }
  if (active && lane == 0) phi[vox] = (crossings & 1) ? sqrtf(best) : 0.f;
}

template <typename I>
int launch(const void* verts, const void* faces, const void* bbox_min,
           const void* scale, void* phi, int num_faces, int G, void* stream) {
  if (G < 1 || num_faces < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_vox = (int64_t)G * G * G;
  const int64_t blocks = (n_vox + kVoxels - 1) / kVoxels;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  sdf_kernel<I><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(verts), static_cast<const I*>(faces),
      static_cast<const float*>(bbox_min), static_cast<const float*>(scale),
      static_cast<float*>(phi), num_faces, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sdf_grid_i32(const void* verts, const void* faces, const void* bbox_min,
                            const void* scale, void* phi, int num_faces, int G,
                            void* stream) {
  return launch<int32_t>(verts, faces, bbox_min, scale, phi, num_faces, G, stream);
}

extern "C" int sdf_grid_i64(const void* verts, const void* faces, const void* bbox_min,
                            const void* scale, void* phi, int num_faces, int G,
                            void* stream) {
  return launch<int64_t>(verts, faces, bbox_min, scale, phi, num_faces, G, stream);
}
