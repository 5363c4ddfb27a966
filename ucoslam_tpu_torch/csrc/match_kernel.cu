// Kernel B1: fused projection matching for Hopper (sm_90a).
//
// Replaces ucoslam_tpu/ops/pallas/match_kernel.py::project_match_pallas
// (kernel body _match_kernel). For each projected map point p and every frame
// keypoint k it takes the Hamming distance of the two 256-bit descriptors,
// applies the gates
//     (u_p - u_k)^2 + (v_p - v_k)^2 < radius2[k],  |oct_p - oct_k| <= 1,
//     valid_a[p], valid_b[k]
// and keeps a running best, a second best at a different column, and the
// argbest (lowest column on ties, -1 when no pair passes the gates). Only the
// three (P,) outputs are written; the (P, N) distance matrix never exists.
//
// What bounds it on this card: integer issue rate and latency, not memory.
// At the slice's shape (P = 16384 map slots, N = 2048 keypoints) the inputs
// are under 1 MB and stay in L2, while the sweep is 33.5 M point-keypoint
// pairs. The radius gate passes a small fraction of pairs, so most of the
// work is the gate test itself.
//
// Design: the TPU kernel carried the running best-2 across a sequential grid
// axis of keypoint tiles in VMEM; Hopper runs blocks in no order, so that
// axis becomes a loop inside the block. One thread owns one point and keeps
// its 8 descriptor words and the best-2 state in registers. The block stages
// a tile of keypoints (descriptors, uv, radius2, octave, validity) in shared
// memory; every thread of a warp reads the same keypoint at the same time,
// which is a broadcast with no bank conflicts. The gates run first and the
// XOR + __popc over 8 words only for pairs that pass. Columns are visited in
// increasing order and the best is replaced only on a strict <, which gives
// the lowest column on ties. The squared radius uses __fmul_rn / __fadd_rn so
// that no fused multiply-add changes its rounding: the gate then agrees bit
// for bit with the plain PyTorch version. Any P and N are accepted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInvalidDist = 10000;  // ucoslam_tpu.ops.hamming.INVALID_DIST
constexpr int kThreads = 64;         // points per block, one per thread
constexpr int kTile = 256;           // keypoints staged in shared memory

__global__ void __launch_bounds__(kThreads) project_match_kernel(
    const uint32_t* __restrict__ desc_a, const float* __restrict__ uv_a,
    const int* __restrict__ oct_a, const uint8_t* __restrict__ valid_a, int n_pts,
    const uint32_t* __restrict__ desc_b, const float* __restrict__ uv_b,
    const int* __restrict__ oct_b, const uint8_t* __restrict__ valid_b,
    const float* __restrict__ radius2, int n_kpts,
    int* __restrict__ idx_out, int* __restrict__ best_out, int* __restrict__ second_out) {
  __shared__ uint4 s_desc[kTile][2];
  __shared__ float s_u[kTile];
  __shared__ float s_v[kTile];
  __shared__ float s_r2[kTile];
  __shared__ int s_oct[kTile];
  __shared__ uint8_t s_ok[kTile];

  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < n_pts && valid_a[p] != 0;
  uint4 a0 = make_uint4(0, 0, 0, 0), a1 = a0;
  float ua = 0.f, va = 0.f;
  int oa = 0;
  if (live) {
    const uint4* row = reinterpret_cast<const uint4*>(desc_a + 8 * (size_t)p);
    a0 = row[0];
    a1 = row[1];
    ua = uv_a[2 * (size_t)p];
    va = uv_a[2 * (size_t)p + 1];
    oa = oct_a[p];
  }
  int best = kInvalidDist, second = kInvalidDist, bidx = -1;

  for (int base = 0; base < n_kpts; base += kTile) {
    const int n = min(kTile, n_kpts - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const size_t k = (size_t)base + j;
      const uint4* row = reinterpret_cast<const uint4*>(desc_b + 8 * k);
      s_desc[j][0] = row[0];
      s_desc[j][1] = row[1];
      s_u[j] = uv_b[2 * k];
      s_v[j] = uv_b[2 * k + 1];
      s_r2[j] = radius2[k];
      s_oct[j] = oct_b[k];
      s_ok[j] = valid_b[k];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float du = __fsub_rn(ua, s_u[j]);
      const float dv = __fsub_rn(va, s_v[j]);
      const float r2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
      const int doct = oa - s_oct[j];
      if (!(r2 < s_r2[j]) || doct > 1 || doct < -1 || !s_ok[j]) continue;
      const uint4 b0 = s_desc[j][0], b1 = s_desc[j][1];
      const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) +
                    __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
                    __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                    __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
      if (d < best) {
        second = best;
        best = d;
        bidx = base + j;
      } else if (d < second) {
        second = d;
      }
    }
  }
  if (p < n_pts) {
    idx_out[p] = bidx;
    best_out[p] = best;
    second_out[p] = second;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and returns
// the cudaError_t of the launch; it neither allocates nor synchronises.
extern "C" int project_match_launch(
    const void* desc_a, const void* uv_a, const void* oct_a, const void* valid_a, int n_pts,
    const void* desc_b, const void* uv_b, const void* oct_b, const void* valid_b,
    const void* radius2, int n_kpts,
    void* idx_out, void* best_out, void* second_out, void* stream) {
  if (n_pts <= 0) return 0;
  const int blocks = (n_pts + kThreads - 1) / kThreads;
  project_match_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(desc_a), static_cast<const float*>(uv_a),
      static_cast<const int*>(oct_a), static_cast<const uint8_t*>(valid_a), n_pts,
      static_cast<const uint32_t*>(desc_b), static_cast<const float*>(uv_b),
      static_cast<const int*>(oct_b), static_cast<const uint8_t*>(valid_b),
      static_cast<const float*>(radius2), n_kpts,
      static_cast<int*>(idx_out), static_cast<int*>(best_out), static_cast<int*>(second_out));
  return static_cast<int>(cudaGetLastError());
}
