// Kernel B2: fused robust motion-only Levenberg-Marquardt for Hopper (sm_90a).
//
// Replaces ucoslam_tpu/ops/pallas/lm_kernel.py::motion_only_lm_fused (kernel
// body _lm_kernel). One launch runs the whole refine of one camera pose:
// `rounds` x `iters` LM iterations. Each iteration projects the B rows,
// forms the analytic left-perturbation Jacobian (plus the stereo row
// u - bf/z when has_depth) and the Huber IRLS weight, builds the 6x6 normal
// equations plus lambda*I, solves them with 8 steps of conjugate gradients,
// applies exp(-delta) * T, and keeps the step if the cost capped at
// 4*delta2 drops (lambda x0.5 on accept, x4 on reject, clipped to
// [1e-8, 1e4], restarted at 1e-3 each round). Between rounds the inlier mask
// is re-classified (chi2 < delta2 and z > 0).
//
// What bounds it on this card: latency. B is about 2k rows, so one pass over
// the rows is a few hundred floating-point operations per thread, and the
// 40 iterations are a chain of dependent block-wide reductions and a serial
// 6x6 solve. Device memory is not a factor: the rows (about 60 KB) stay in
// L1/L2 for the whole launch.
//
// Design: one block per problem, so the loop never leaves the SM and costs
// one launch instead of the ~40 small operations per iteration of the plain
// version. Each thread owns the rows i = tid, tid + blockDim, ...; it keeps
// its running sums of the 21 unique entries of H, the 6 entries of g and the
// two capped costs in registers, and the block reduces them with warp
// shuffles and one shared-memory stage. Thread 0 then solves the damped
// system with CG(8) and the SE(3) exponential; the pose, lambda and the
// accept flag pass to the other threads through shared memory. The inlier
// mask lives in the output array, written only by the thread that owns the
// row. No library solver is used.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRed = 27;  // 21 unique H entries + 6 g entries

struct Problem {
  const float* X;       // (B, 3)
  const float* uv;      // (B, 2)
  const float* sigma2;  // (B,)
  const uint8_t* valid; // (B,)
  const float* depth;   // (B,) or nullptr
  int B;
  float fx, fy, cx, cy, bf, delta2;
  bool has_depth;
};

// Sums v[0..NV) over the block; every thread gets the totals in out[].
template <int NV>
__device__ void block_sum(float (&v)[NV], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) red[warp * NV + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * NV + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

struct Row {
  float X0, X1, X2, uo, vo, w_obs, dmask, ur_obs;
};

__device__ Row load_row(const Problem& pb, int i) {
  Row r;
  r.X0 = pb.X[3 * i];
  r.X1 = pb.X[3 * i + 1];
  r.X2 = pb.X[3 * i + 2];
  r.uo = pb.uv[2 * i];
  r.vo = pb.uv[2 * i + 1];
  r.w_obs = 1.f / fmaxf(pb.sigma2[i], 1e-9f);
  const float d = pb.depth ? pb.depth[i] : 0.f;
  r.dmask = pb.has_depth && d > 0.f ? 1.f : 0.f;
  r.ur_obs = r.uo - pb.bf * (1.f / fmaxf(d, 1e-6f));
  return r;
}

// Squared error of one row under pose T (3x4 row-major); qz through *qz_out.
__device__ float chi2_row(const Problem& pb, const float* T, const Row& r, float* qz_out) {
  const float qx = T[0] * r.X0 + T[1] * r.X1 + T[2] * r.X2 + T[3];
  const float qy = T[4] * r.X0 + T[5] * r.X1 + T[6] * r.X2 + T[7];
  const float qz = T[8] * r.X0 + T[9] * r.X1 + T[10] * r.X2 + T[11];
  const float iz = 1.f / fmaxf(qz, 1e-6f);
  const float u = pb.fx * qx * iz + pb.cx;
  const float v = pb.fy * qy * iz + pb.cy;
  const float ru = u - r.uo, rv = v - r.vo;
  float c2 = (ru * ru + rv * rv) * r.w_obs;
  if (pb.has_depth) {
    const float rs = (u - pb.bf / fmaxf(qz, 1e-6f)) - r.ur_obs;
    c2 += r.dmask * rs * rs * r.w_obs;
  }
  *qz_out = qz;
  return c2;
}

// Solve H x = g for the SPD 6x6 H with 8 fixed CG steps (as the TPU kernel).
__device__ void cg6(const float (&H)[6][6], const float (&g)[6], float (&x)[6]) {
  float r[6], p[6], Hp[6];
  float rs = 0.f;
  for (int j = 0; j < 6; ++j) {
    x[j] = 0.f;
    r[j] = g[j];
    p[j] = g[j];
    rs += r[j] * r[j];
  }
  for (int it = 0; it < 8; ++it) {
    float pHp = 0.f;
    for (int j = 0; j < 6; ++j) {
      float s = 0.f;
      for (int k = 0; k < 6; ++k) s += H[j][k] * p[k];
      Hp[j] = s;
      pHp += p[j] * s;
    }
    const float alpha = rs / (pHp + 1e-30f);
    float rs_new = 0.f;
    for (int j = 0; j < 6; ++j) {
      x[j] += alpha * p[j];
      r[j] -= alpha * Hp[j];
      rs_new += r[j] * r[j];
    }
    const float beta = rs_new / (rs + 1e-30f);
    for (int j = 0; j < 6; ++j) p[j] = r[j] + beta * p[j];
    rs = rs_new;
  }
}

// E = exp(-delta) for delta = [rho, phi]; E as a 3x4 row-major matrix.
__device__ void se3_exp_neg(const float (&delta)[6], float (&E)[12]) {
  const float rho[3] = {-delta[0], -delta[1], -delta[2]};
  const float x = -delta[3], y = -delta[4], z = -delta[5];
  const float K[3][3] = {{0.f, -z, y}, {z, 0.f, -x}, {-y, x, 0.f}};
  float KK[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) KK[i][j] = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
  const float t2 = x * x + y * y + z * z;
  const float th = sqrtf(t2 + 1e-16f);
  float a, b, c;
  if (t2 < 1e-8f) {
    a = 1.f - t2 / 6.f;
    b = 0.5f - t2 / 24.f;
    c = 1.f / 6.f - t2 / 120.f;
  } else {
    a = sinf(th) / th;
    b = (1.f - cosf(th)) / fmaxf(t2, 1e-16f);
    c = (th - sinf(th)) / fmaxf(t2 * th, 1e-24f);
  }
  for (int i = 0; i < 3; ++i) {
    float t = 0.f;
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.f : 0.f;
      E[4 * i + j] = eye + a * K[i][j] + b * KK[i][j];
      t += (eye + b * K[i][j] + c * KK[i][j]) * rho[j];
    }
    E[4 * i + 3] = t;
  }
}

__global__ void __launch_bounds__(kThreads) motion_only_lm_kernel(
    Problem pb, const float* __restrict__ pose_in, int iters, int rounds,
    float* __restrict__ pose_out, uint8_t* __restrict__ mask) {
  __shared__ float s_pose[16];
  __shared__ float s_new[16];
  __shared__ float s_red[kWarps * kRed];
  __shared__ float s_sum[kRed];
  __shared__ float s_lam;

  const int tid = threadIdx.x;
  if (tid < 16) s_pose[tid] = pose_in[tid];
  for (int i = tid; i < pb.B; i += kThreads) mask[i] = pb.valid[i] ? 1 : 0;
  __syncthreads();
  const float cap = pb.delta2 * 4.f;

  for (int round = 0; round < rounds; ++round) {
    if (tid == 0) s_lam = 1e-3f;
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
      // ---- normal equations over the rows owned by this thread ----
      float acc[kRed];
#pragma unroll
      for (int k = 0; k < kRed; ++k) acc[k] = 0.f;
      for (int i = tid; i < pb.B; i += kThreads) {
        const Row r = load_row(pb, i);
        const float* T = s_pose;
        const float qx = T[0] * r.X0 + T[1] * r.X1 + T[2] * r.X2 + T[3];
        const float qy = T[4] * r.X0 + T[5] * r.X1 + T[6] * r.X2 + T[7];
        const float qz = T[8] * r.X0 + T[9] * r.X1 + T[10] * r.X2 + T[11];
        const float iz = 1.f / fmaxf(qz, 1e-6f);
        const float u = pb.fx * qx * iz + pb.cx;
        const float v = pb.fy * qy * iz + pb.cy;
        const float ru = u - r.uo, rv = v - r.vo;
        const float c2 = (ru * ru + rv * rv) * r.w_obs;
        const float w_hub = fminf(1.f, sqrtf(pb.delta2 / fmaxf(c2, 1e-12f)));
        const float w = r.w_obs * w_hub * (float)mask[i];
        const float a = pb.fx * iz, b = pb.fy * iz;
        const float cu = -pb.fx * qx * iz * iz, dv = -pb.fy * qy * iz * iz;
        const float Ju[6] = {a, 0.f, cu, cu * qy, a * qz - cu * qx, -a * qy};
        const float Jv[6] = {0.f, b, dv, dv * qy - b * qz, -dv * qx, b * qx};
        float Js[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        float rs = 0.f;
        if (pb.has_depth) {
          const float Jz[6] = {0.f, 0.f, 1.f, qy, -qx, 0.f};
          const float s = pb.bf * iz * iz;
#pragma unroll
          for (int j = 0; j < 6; ++j) Js[j] = (Ju[j] + s * Jz[j]) * r.dmask;
          rs = (u - pb.bf * iz) - r.ur_obs;
        }
        int k = 0;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
#pragma unroll
          for (int l = j; l < 6; ++l) acc[k++] += w * (Ju[j] * Ju[l] + Jv[j] * Jv[l] + Js[j] * Js[l]);
        }
#pragma unroll
        for (int j = 0; j < 6; ++j) acc[21 + j] += w * (Ju[j] * ru + Jv[j] * rv + Js[j] * rs);
      }
      block_sum<kRed>(acc, s_red, s_sum);

      // ---- damped solve + candidate pose (one thread) ----
      if (tid == 0) {
        float H[6][6], g[6], delta[6], E[12];
        int k = 0;
        for (int j = 0; j < 6; ++j)
          for (int l = j; l < 6; ++l) H[j][l] = H[l][j] = s_sum[k++];
        for (int j = 0; j < 6; ++j) {
          H[j][j] += s_lam;
          g[j] = s_sum[21 + j];
        }
        cg6(H, g, delta);
        se3_exp_neg(delta, E);
        for (int i = 0; i < 3; ++i)
          for (int j = 0; j < 4; ++j)
            s_new[4 * i + j] = E[4 * i] * s_pose[j] + E[4 * i + 1] * s_pose[4 + j] +
                               E[4 * i + 2] * s_pose[8 + j] + E[4 * i + 3] * s_pose[12 + j];
        for (int j = 0; j < 4; ++j) s_new[12 + j] = s_pose[12 + j];
      }
      __syncthreads();

      // ---- capped costs of the candidate and the current pose ----
      float cost[2] = {0.f, 0.f};
      for (int i = tid; i < pb.B; i += kThreads) {
        if (!mask[i]) continue;
        const Row r = load_row(pb, i);
        float qz;
        cost[0] += fminf(chi2_row(pb, s_new, r, &qz), cap);
        cost[1] += fminf(chi2_row(pb, s_pose, r, &qz), cap);
      }
      block_sum<2>(cost, s_red, s_sum);
      if (tid == 0) {
        const bool improved = s_sum[0] < s_sum[1];
        if (improved)
          for (int j = 0; j < 16; ++j) s_pose[j] = s_new[j];
        s_lam = fminf(fmaxf(improved ? s_lam * 0.5f : s_lam * 4.f, 1e-8f), 1e4f);
      }
      __syncthreads();
    }
    // ---- re-classify the inliers for the next round ----
    for (int i = tid; i < pb.B; i += kThreads) {
      const Row r = load_row(pb, i);
      float qz;
      const float c2 = chi2_row(pb, s_pose, r, &qz);
      mask[i] = pb.valid[i] && c2 < pb.delta2 && qz > 0.f ? 1 : 0;
    }
    __syncthreads();
  }
  if (tid < 16) pose_out[tid] = s_pose[tid];
}

}  // namespace

// Plain C entry point (loaded with ctypes). `depth` may be null when
// has_depth is 0. Launches on `stream` and returns the cudaError_t of the
// launch; it neither allocates nor synchronises.
extern "C" int motion_only_lm_launch(
    const void* pose_in, const void* X, const void* uv, const void* sigma2,
    const void* valid, const void* depth, int B, float fx, float fy, float cx,
    float cy, float bf, float delta2, int iters, int rounds, int has_depth,
    void* pose_out, void* mask_out, void* stream) {
  Problem pb;
  pb.X = static_cast<const float*>(X);
  pb.uv = static_cast<const float*>(uv);
  pb.sigma2 = static_cast<const float*>(sigma2);
  pb.valid = static_cast<const uint8_t*>(valid);
  pb.depth = has_depth ? static_cast<const float*>(depth) : nullptr;
  pb.B = B;
  pb.fx = fx;
  pb.fy = fy;
  pb.cx = cx;
  pb.cy = cy;
  pb.bf = bf;
  pb.delta2 = delta2;
  pb.has_depth = has_depth != 0;
  motion_only_lm_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pb, static_cast<const float*>(pose_in), iters, rounds,
      static_cast<float*>(pose_out), static_cast<uint8_t*>(mask_out));
  return static_cast<int>(cudaGetLastError());
}
