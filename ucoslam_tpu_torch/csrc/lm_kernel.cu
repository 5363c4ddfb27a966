// Kernel B2: fused robust motion-only Levenberg-Marquardt for Hopper (sm_90a).
//
// Replaces ucoslam_tpu/ops/pallas/lm_kernel.py::motion_only_lm_fused (kernel
// body _lm_kernel). One launch runs the whole refine of one camera pose:
// `rounds` x `iters` LM iterations. Each iteration projects the inlier rows,
// forms the analytic left-perturbation Jacobian (plus the stereo row
// u - bf/z when has_depth) and the Huber IRLS weight, builds the 6x6 normal
// equations plus lambda*I, solves them with 8 steps of conjugate gradients,
// applies exp(-delta) * T, and keeps the step if the cost capped at
// 4*delta2 drops (lambda x0.5 on accept, x4 on reject, clipped to
// [1e-8, 1e4], restarted at 1e-3 each round). Between rounds the inlier mask
// is re-classified (chi2 < delta2 and z > 0).
//
// What bounds it on this card: latency. The work is tiny (~222 floating-
// point operations a row and iteration: ~1.9e7 for B = 2112 and 40
// iterations, 0.2 us at the card's float32 rate; the rows are ~60 KB, 0.02
// us of memory time), but the iterations form a chain: each needs a pass
// over the rows, a block-wide reduction of 28 sums and a serial 6x6 solve
// before the next can start. A floor for that chain on one SM, ~1 us an
// iteration (a few barriers, a pass of 2-3 rows a thread, a warp-wide
// solve), gives ~40 us for 40 iterations.
//
// Design, against that chain:
// - Rows stay on the SM. Each block loads its rows once per launch into
//   dynamic shared memory as a structure of arrays (X, uv, 1/sigma2, the
//   depth mask and the observed right-image u: 32 bytes a row, plus the
//   mask, validity and a compaction index: 36 bytes). A block holds at most
//   kMaxRowsPerBlock rows (216 KB): B is limited to kMaxRowsPerBlock x the
//   cluster size, and the wrapper raises above that (the port's B is
//   maxKeyPointsPerFrame + 64 = 2112).
// - Only inliers are visited. At the start of each round the block
//   re-classifies its rows and compacts the indices of the inliers
//   (__ballot_sync, a warp prefix scan of the counts); the passes walk that
//   list. An outlier's terms are zero in the sums anyway.
// - One pass a step. A pass at a pose sums H, g and the capped cost at that
//   pose. Step 0 of a round evaluates the current pose; every later step
//   evaluates the candidate of the step before, and warp 0 accepts it when
//   its cost is lower. Accepted, the candidate's H and g are the next
//   system; rejected, the current pose's are, kept from before (same pose,
//   same rows), with the larger lambda. So `iters` solves take iters + 1
//   passes, where the plain version takes three evaluations an iteration.
// - A short serial tail. Each warp reduces its 28 partial sums with a
//   transposing butterfly (31 shuffles, lane l ends with sum l) into one
//   shared stage; warp 0 finishes the reduction, decides, and solves: every
//   lane gathers the system and runs the same CG(8) with tree-summed dot
//   products and the fast reciprocal for its two divisions (spreading the
//   mat-vec over lanes with shuffles measured slower, PERF.md); the
//   exponential (sincosf at full precision) runs in every lane and lanes
//   0..11 write one entry each of the candidate pose. Two block barriers a
//   step; the current and candidate poses are double-buffered in shared
//   memory.
// - A cluster of C blocks on neighbouring SMs, each holding B/C rows, cuts
//   the pass C-fold. Each block pushes its 28 totals into every block's
//   shared memory with st.async, which counts the bytes on the receiving
//   block's mbarrier, and waits on its own mbarrier for the C x 112 bytes;
//   no cluster-wide barrier and no memory fence runs inside the loop. Every block sums the C rows in rank order and takes the same
//   decision and solve. The receive rows and the mbarriers are doubled by
//   step parity: a block can be at most one step ahead of another, so the
//   arrivals of two steps never meet on one barrier phase.
// - In the pass, 1/z uses the fast reciprocal and the Huber weight
//   sqrt(delta2) * rsqrt(chi2); the re-classification keeps IEEE division.
//
// Batched over problems (the counterpart of jax.vmap over the pallas_call,
// as relocalization and loop verification refine up to 5 candidate poses at
// once): one launch of n_problems clusters, cluster p solving problem p with
// the algorithm above, unchanged. Problem p's rows are rows p*B .. p*B+B-1 of
// the stacked inputs, its start and result poses entries p of (n, 4, 4). The
// clusters never communicate, so n clusters fill n x C SMs side by side (five
// single launches would run one after another on 8 of the 132 SMs). The
// single launch is the batched one with n_problems = 1.
//
// The block size T and the cluster size C are template parameters. The
// library holds one launch, kThreads x kCluster. Built with
// -DUCOSLAM_VARIANTS (tools/port/kernel_builds.py) it also holds the other
// launches measured in PERF.md (tools/port/bench_kernels.py --variants).
// The shared-memory limit is raised once per device, not per launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

#ifdef UCOSLAM_PROBES
// Cycles spent in each phase, summed over the launch by thread 0 of block 0
// (tools/port/probe_kernels.py builds with -DUCOSLAM_PROBES and reads them).
__device__ long long g_probe[8];
#define PROBE_INIT long long probe_t = clock64(), probe_acc[8] = {};
#define PROBE(k)                                           \
  if (threadIdx.x == 0) {                                  \
    const long long t_ = clock64();                        \
    probe_acc[k] += t_ - probe_t;                          \
    probe_t = t_;                                          \
  }
#define PROBE_SAVE \
  if (threadIdx.x == 0 && blockIdx.x == 0)                 \
    for (int k_ = 0; k_ < 8; ++k_) g_probe[k_] = probe_acc[k_];
extern "C" int probe_read(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe)));
}
#else
#define PROBE_INIT
#define PROBE(k)
#define PROBE_SAVE
#endif

namespace {

constexpr int kThreads = 256;  // the default launch: a cluster of 8 blocks of 256 threads
constexpr int kCluster = 8;
constexpr int kMaxRowsPerBlock = 6000;
constexpr int kRowBytes = 8 * 4 + 2 + 1 + 1;  // 8 floats, act index, mask, valid
constexpr int kMaxProblems = 4096;  // clusters a batched launch takes
constexpr int kMaxCounts = 192;  // inlier counts per (chunk of T rows, warp): 6000 / 32 rounded up
constexpr unsigned kFull = 0xffffffffu;

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

// One block's rows in dynamic shared memory, a structure of arrays.
struct Rows {
  float *X0, *X1, *X2, *uo, *vo, *w_obs, *dmask, *ur_obs;
  uint16_t* act;  // compacted indices of the inlier rows
  uint8_t *mask, *valid;
};

__device__ __forceinline__ Rows carve_rows(unsigned char* smem, int cap) {
  Rows r;
  float* f = reinterpret_cast<float*>(smem);
  r.X0 = f;
  r.X1 = f + cap;
  r.X2 = f + 2 * cap;
  r.uo = f + 3 * cap;
  r.vo = f + 4 * cap;
  r.w_obs = f + 5 * cap;
  r.dmask = f + 6 * cap;
  r.ur_obs = f + 7 * cap;
  r.act = reinterpret_cast<uint16_t*>(f + 8 * cap);
  r.mask = reinterpret_cast<uint8_t*>(r.act + cap);
  r.valid = r.mask + cap;
  return r;
}

// One butterfly stage of the transposing warp reduction: lanes with bit OFF
// set keep the upper half of v[0, 2*OFF), the others the lower half, and
// each adds its partner's copy of the half it keeps.
template <int OFF>
__device__ __forceinline__ void transpose_step(float (&v)[32], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int k = 0; k < OFF; ++k) {
    const float send = upper ? v[k] : v[k + OFF];
    const float keep = upper ? v[k + OFF] : v[k];
    v[k] = keep + __shfl_xor_sync(kFull, send, OFF);
  }
}

// Lane l returns the sum over the warp of v[l] (31 shuffles for 32 values).
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32], int lane) {
  transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  return v[0];
}

// Squared error of row i under the pose whose first 12 entries are T (3x4
// row-major), with the depth term when has_depth; qz through *qz_out.
__device__ __forceinline__ float chi2_row(const Problem& pb, const float (&T)[12], const Rows& R,
                                          int i, float* qz_out) {
  const float X0 = R.X0[i], X1 = R.X1[i], X2 = R.X2[i];
  const float qx = T[0] * X0 + T[1] * X1 + T[2] * X2 + T[3];
  const float qy = T[4] * X0 + T[5] * X1 + T[6] * X2 + T[7];
  const float qz = T[8] * X0 + T[9] * X1 + T[10] * X2 + T[11];
  const float iz = 1.f / fmaxf(qz, 1e-6f);
  const float u = pb.fx * qx * iz + pb.cx;
  const float v = pb.fy * qy * iz + pb.cy;
  const float ru = u - R.uo[i], rv = v - R.vo[i];
  float c2 = (ru * ru + rv * rv) * R.w_obs[i];
  if (pb.has_depth) {
    const float rs = (u - pb.bf / fmaxf(qz, 1e-6f)) - R.ur_obs[i];
    c2 += R.dmask[i] * rs * rs * R.w_obs[i];
  }
  *qz_out = qz;
  return c2;
}

__device__ __forceinline__ void load_pose(const float* P, float (&T)[12]) {
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = P[k];
}

// E = exp(-delta) for delta = [rho, phi]; E as a 3x4 row-major matrix.
__device__ __forceinline__ void se3_exp_neg(const float (&delta)[6], float (&E)[12]) {
  const float rho[3] = {-delta[0], -delta[1], -delta[2]};
  const float x = -delta[3], y = -delta[4], z = -delta[5];
  const float K[3][3] = {{0.f, -z, y}, {z, 0.f, -x}, {-y, x, 0.f}};
  float KK[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) KK[i][j] = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
  const float t2 = x * x + y * y + z * z;
  const float th = sqrtf(t2 + 1e-16f);
  float a, b, c;
  if (t2 < 1e-8f) {
    a = 1.f - t2 / 6.f;
    b = 0.5f - t2 / 24.f;
    c = 1.f / 6.f - t2 / 120.f;
  } else {
    float sn, cs;
    sincosf(th, &sn, &cs);
    a = sn / th;
    b = (1.f - cs) / fmaxf(t2, 1e-16f);
    c = (th - sn) / fmaxf(t2 * th, 1e-24f);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.f : 0.f;
      E[4 * i + j] = eye + a * K[i][j] + b * KK[i][j];
      t += (eye + b * K[i][j] + c * KK[i][j]) * rho[j];
    }
    E[4 * i + 3] = t;
  }
}

__device__ __forceinline__ float dot6(const float (&a)[6], const float (&b)[6]) {
  return (a[0] * b[0] + a[1] * b[1]) + (a[2] * b[2] + a[3] * b[3]) + (a[4] * b[4] + a[5] * b[5]);
}

// Warp 0: solve (H + lam I) x = g with 8 CG steps, where lane l holds the
// total s of reduced entry l (0..20 the unique H entries, 21..26 g). Every
// lane gathers the whole system and runs the same CG, so every lane ends with
// the same x; the dot products are summed as trees and the two divisions of
// a step use the fast reciprocal (one multi-function-unit instruction).
__device__ __forceinline__ void solve_cg(float s, float lam, float (&x)[6]) {
  float H[6][6], r[6], p[6], Hp[6];
  int k = 0;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int l = j; l < 6; ++l) {
      const float h = __shfl_sync(kFull, s, k++);
      H[j][l] = h;
      H[l][j] = h;
    }
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    H[j][j] += lam;
    r[j] = __shfl_sync(kFull, s, 21 + j);
    p[j] = r[j];
    x[j] = 0.f;
  }
  float rs = dot6(r, r);
#pragma unroll 1
  for (int it = 0; it < 8; ++it) {
#pragma unroll
    for (int j = 0; j < 6; ++j) Hp[j] = dot6(H[j], p);
    const float alpha = __fdividef(rs, dot6(p, Hp) + 1e-30f);
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      x[j] += alpha * p[j];
      r[j] -= alpha * Hp[j];
    }
    const float rs_new = dot6(r, r);
    const float beta = __fdividef(rs_new, rs + 1e-30f);
#pragma unroll
    for (int j = 0; j < 6; ++j) p[j] = r[j] + beta * p[j];
    rs = rs_new;
  }
}

// Warp 0: Pn = exp(-x) * P (16 floats). Every lane forms exp(-x); lane l < 12
// writes entry l, lanes 12..15 copy P's last row.
__device__ __forceinline__ void step_pose(const float (&x)[6], const float* P, float* Pn, int lane) {
  float E[12];
  se3_exp_neg(x, E);
  if (lane < 12) {
    const int i = lane >> 2, k = lane & 3;
    const float e0 = i == 0 ? E[0] : i == 1 ? E[4] : E[8];
    const float e1 = i == 0 ? E[1] : i == 1 ? E[5] : E[9];
    const float e2 = i == 0 ? E[2] : i == 1 ? E[6] : E[10];
    const float e3 = i == 0 ? E[3] : i == 1 ? E[7] : E[11];
    Pn[lane] = e0 * P[k] + e1 * P[4 + k] + e2 * P[8 + k] + e3 * P[12 + k];
  } else if (lane < 16) {
    Pn[lane] = P[lane];
  }
}

// One pass over the compacted inlier rows under pose T: adds the 21 unique
// entries of J^T W J (acc[0..20]), J^T W r (acc[21..26]) and the capped cost
// (acc[27]) of this thread's rows k = tid, tid + nthreads, ...
template <bool DEPTH>
__device__ __forceinline__ void accumulate_rows(const Problem& pb, const Rows& R, const float (&T)[12],
                                                int n_act, int tid, int nthreads, float cap,
                                                float (&acc)[32]) {
  const float sqrt_delta2 = sqrtf(pb.delta2);
  for (int k = tid; k < n_act; k += nthreads) {
    const int i = R.act[k];
    const float X0 = R.X0[i], X1 = R.X1[i], X2 = R.X2[i];
    const float qx = T[0] * X0 + T[1] * X1 + T[2] * X2 + T[3];
    const float qy = T[4] * X0 + T[5] * X1 + T[6] * X2 + T[7];
    const float qz = T[8] * X0 + T[9] * X1 + T[10] * X2 + T[11];
    const float iz = __fdividef(1.f, fmaxf(qz, 1e-6f));
    const float u = pb.fx * qx * iz + pb.cx;
    const float v = pb.fy * qy * iz + pb.cy;
    const float ru = u - R.uo[i], rv = v - R.vo[i];
    const float w_obs = R.w_obs[i];
    const float c2 = (ru * ru + rv * rv) * w_obs;
    const float w = w_obs * fminf(1.f, sqrt_delta2 * rsqrtf(fmaxf(c2, 1e-12f)));
    const float a = pb.fx * iz, b = pb.fy * iz;
    const float cu = -pb.fx * qx * iz * iz, dv = -pb.fy * qy * iz * iz;
    const float Ju[6] = {a, 0.f, cu, cu * qy, a * qz - cu * qx, -a * qy};
    const float Jv[6] = {0.f, b, dv, dv * qy - b * qz, -dv * qx, b * qx};
    float wu[6], wv[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      wu[j] = Ju[j] * w;
      wv[j] = Jv[j] * w;
    }
    float chi2 = c2;
    if constexpr (DEPTH) {
      const float dm = R.dmask[i], ur_obs = R.ur_obs[i];
      const float rc = (u - pb.bf / fmaxf(qz, 1e-6f)) - ur_obs;  // as the cost is taken
      chi2 += dm * rc * rc * w_obs;
      const float Jz[6] = {0.f, 0.f, 1.f, qy, -qx, 0.f};
      const float sd = pb.bf * iz * iz;
      float Js[6], ws[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        Js[j] = (Ju[j] + sd * Jz[j]) * dm;
        ws[j] = Js[j] * w;
      }
      const float rs = (u - pb.bf * iz) - ur_obs;
      int k2 = 0;
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int l = j; l < 6; ++l) acc[k2++] += wu[j] * Ju[l] + wv[j] * Jv[l] + ws[j] * Js[l];
#pragma unroll
      for (int j = 0; j < 6; ++j) acc[21 + j] += wu[j] * ru + wv[j] * rv + ws[j] * rs;
    } else {
      int k2 = 0;
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int l = j; l < 6; ++l) acc[k2++] += wu[j] * Ju[l] + wv[j] * Jv[l];
#pragma unroll
      for (int j = 0; j < 6; ++j) acc[21 + j] += wu[j] * ru + wv[j] * rv;
    }
    acc[27] += fminf(chi2, cap);
  }
}

// Warp 0: exclusive prefix sums of a[0..m) in place (m <= kMaxCounts); the
// total goes to *total.
__device__ __forceinline__ void warp_exclusive_scan(int* a, int m, int lane, int* total) {
  constexpr int kPer = kMaxCounts / 32;
  int v[kPer];
  int sum = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int idx = lane * kPer + q;
    v[q] = idx < m ? a[idx] : 0;
    sum += v[q];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  int run = incl - sum;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int idx = lane * kPer + q;
    if (idx < m) a[idx] = run;
    run += v[q];
  }
  if (lane == 31) *total = incl;
}

// ---- cluster exchange: asynchronous stores into another block's shared
//      memory that complete on its mbarrier; waits (acquire) on our own ----
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  return remote;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Store v at `addr` in another block's shared memory and count its 16 bytes
// against the transaction count of that block's mbarrier at `bar`.
__device__ __forceinline__ void store_async_remote(unsigned addr, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// This block's own arrival on its mbarrier, announcing `bytes` to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      "  .reg .pred done;\n"
      "WAIT_%=:\n"
      "  mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "  @!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

template <int T, int C>
__global__ void __launch_bounds__(T) motion_only_lm_kernel(
    Problem pb, const float* __restrict__ pose_in, int iters, int rounds,
    float* __restrict__ pose_out, uint8_t* __restrict__ mask_out) {
  constexpr int W = T / 32;
  __shared__ float s_red[W][32];
  __shared__ int s_cnt[kMaxCounts];
  __shared__ float s_pose[2][16];
  __shared__ int s_cur, s_cand, s_nact;
  __shared__ __align__(16) float s_tot[32];         // this block's totals (cluster launch)
  __shared__ __align__(16) float s_recv[2][C][32];  // every block's totals, by step parity
  __shared__ uint64_t s_bar[2];                     // completes on the C blocks' bytes, by parity
  extern __shared__ __align__(16) unsigned char smem[];

  PROBE_INIT
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int prob = blockIdx.x / C;  // the cluster's place in the grid
  const size_t base = static_cast<size_t>(prob) * pb.B;  // its first row of the stacked inputs
  pose_in += 16 * prob;
  pose_out += 16 * prob;
  mask_out += base;
  int rank = 0;
  if constexpr (C > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int cap_rows = (pb.B + C - 1) / C;
  const int row0 = rank * cap_rows;
  const int n = max(0, min(pb.B - row0, cap_rows));
  const int n_chunks = (n + T - 1) / T;
  const Rows R = carve_rows(smem, cap_rows);

  // ---- the rows, once: thread t owns rows t, t + T, ... ----
  for (int i = tid; i < n; i += T) {
    const size_t g = base + row0 + i;
    R.X0[i] = pb.X[3 * g];
    R.X1[i] = pb.X[3 * g + 1];
    R.X2[i] = pb.X[3 * g + 2];
    const float uo = pb.uv[2 * g];
    R.uo[i] = uo;
    R.vo[i] = pb.uv[2 * g + 1];
    R.w_obs[i] = 1.f / fmaxf(pb.sigma2[g], 1e-9f);
    const float d = pb.has_depth ? pb.depth[g] : 0.f;
    R.dmask[i] = pb.has_depth && d > 0.f ? 1.f : 0.f;
    R.ur_obs[i] = uo - pb.bf * (1.f / fmaxf(d, 1e-6f));
    R.valid[i] = pb.valid[g] ? 1 : 0;
    R.mask[i] = R.valid[i];
  }
  if (tid < 16) s_pose[0][tid] = pose_in[tid];
  if (tid == 0) s_cur = 0;
  if constexpr (C > 1) {
    if (tid < 2) mbar_init(&s_bar[tid], 1);
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  const float cap = pb.delta2 * 4.f;
  const unsigned lanes_below = (1u << lane) - 1u;
  float T12[12];
  int xstep = 0;  // steps taken, for the parity of the cluster buffers

  for (int round = 0; round < rounds; ++round) {
    // ---- re-classify (after the first round) and compact the inliers ----
    load_pose(s_pose[s_cur], T12);
    for (int c = 0; c < n_chunks; ++c) {
      const int i = c * T + tid;  // rows are owned by the same thread throughout
      bool on = false;
      if (i < n) {
        if (round > 0) {
          float qz;
          const float c2 = chi2_row(pb, T12, R, i, &qz);
          R.mask[i] = R.valid[i] && c2 < pb.delta2 && qz > 0.f ? 1 : 0;
        }
        on = R.mask[i] != 0;
      }
      const unsigned bal = __ballot_sync(kFull, on);
      if (lane == 0) s_cnt[c * W + warp] = __popc(bal);
    }
    __syncthreads();
    if (warp == 0) warp_exclusive_scan(s_cnt, n_chunks * W, lane, &s_nact);
    __syncthreads();
    for (int c = 0; c < n_chunks; ++c) {
      const int i = c * T + tid;
      const bool on = i < n && R.mask[i];
      const unsigned bal = __ballot_sync(kFull, on);
      if (on) R.act[s_cnt[c * W + warp] + __popc(bal & lanes_below)] = static_cast<uint16_t>(i);
    }
    __syncthreads();
    const int n_act = s_nact;
    PROBE(7)  // re-classification and compaction

    // ---- LM: step 0 evaluates the current pose, step s > 0 the candidate
    //      of step s - 1; warp 0 decides, solves and writes the next one ----
    float lam = 1e-3f, cost_old = 0.f, h_keep = 0.f;  // warp 0: lane l keeps sum l
    int w0_cur = s_cur;
    for (int step = 0; step <= iters; ++step) {
      const int cand = step == 0 ? s_cur : s_cand;
      float acc[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = 0.f;
      load_pose(s_pose[cand], T12);
      if (pb.has_depth) accumulate_rows<true>(pb, R, T12, n_act, tid, T, cap, acc);
      else accumulate_rows<false>(pb, R, T12, n_act, tid, T, cap, acc);
      PROBE(0)  // the pass
      s_red[warp][lane] = warp_transpose_sum(acc, lane);
      PROBE(1)  // the warp reduction
      __syncthreads();  // A: the per-warp sums are in s_red
      PROBE(2)

      float total = 0.f;
      if (warp == 0) {
        for (int w = 0; w < W; ++w) total += s_red[w][lane];
      }
      if constexpr (C > 1) {
        if (warp == 0) {
          // lane r < C pushes this block's 28 totals (112 bytes) to block r,
          // counted on block r's barrier; lane 0 announces the C x 112 bytes
          // this block receives. Every block then sums the C rows in rank order.
          float(&recv)[C][32] = s_recv[xstep & 1];
          uint64_t* bar = &s_bar[xstep & 1];
          s_tot[lane] = total;
          __syncwarp();
          if (lane == 0) mbar_expect_tx(bar, C * 28 * 4);
          if (lane < C) {
            const unsigned dst = cluster_addr(&recv[rank][0], lane);
            const unsigned dst_bar = cluster_addr(bar, lane);
            const float4* src = reinterpret_cast<const float4*>(s_tot);
#pragma unroll
            for (int q = 0; q < 7; ++q) store_async_remote(dst + 16 * q, src[q], dst_bar);
          }
          mbar_wait(bar, (xstep >> 1) & 1);
          total = 0.f;
#pragma unroll
          for (int r = 0; r < C; ++r) total += recv[r][lane];
        }
      }
      ++xstep;
      PROBE(3)  // warp 0: block sum and cluster exchange
      if (warp == 0) {
        const float cost = __shfl_sync(kFull, total, 27);
        bool accept = true;  // step 0: the current pose itself
        if (step > 0) {
          accept = cost < cost_old;
          lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.f, 1e-8f), 1e4f);
        }
        if (accept) {  // the evaluated pose becomes current, with its sums
          h_keep = total;
          cost_old = cost;
          w0_cur = cand;
        }
        if (step < iters) {
          float x[6];
          solve_cg(h_keep, lam, x);
          PROBE(4)
          step_pose(x, s_pose[w0_cur], s_pose[1 - w0_cur], lane);
          PROBE(5)
        }
        if (lane == 0) {
          s_cur = w0_cur;
          s_cand = 1 - w0_cur;
        }
      }
      __syncthreads();  // B: the candidate and the current pose's buffer
      PROBE(6)
    }
  }

  PROBE_SAVE
  // ---- the final re-classification is the returned mask ----
  if (rounds > 0) load_pose(s_pose[s_cur], T12);
  for (int i = tid; i < n; i += T) {
    uint8_t m = R.mask[i];
    if (rounds > 0) {
      float qz;
      const float c2 = chi2_row(pb, T12, R, i, &qz);
      m = R.valid[i] && c2 < pb.delta2 && qz > 0.f ? 1 : 0;
    }
    mask_out[row0 + i] = m;
  }
  if (rank == 0 && tid < 16) pose_out[tid] = s_pose[s_cur][tid];
  if constexpr (C > 1) cg::this_cluster().sync();  // shared memory stays live until all are done
}

// Raise the kernel's dynamic shared-memory limit to kMaxRowsPerBlock rows,
// once for each device (bit d of `done`): the launches then do no host work
// but the launch itself.
template <int T, int C>
cudaError_t raise_smem_limit() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(motion_only_lm_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxRowsPerBlock * kRowBytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int T, int C>
int launch(const Problem& pb, int n_problems, const float* pose_in, int iters, int rounds, float* pose_out,
           uint8_t* mask_out, cudaStream_t stream) {
  const int cap_rows = (pb.B + C - 1) / C;
  if (cap_rows > kMaxRowsPerBlock || n_problems < 1 || n_problems > kMaxProblems)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = motion_only_lm_kernel<T, C>;
  const int smem = cap_rows * kRowBytes;
  cudaError_t err = raise_smem_limit<T, C>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * n_problems);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, pb, pose_in, iters, rounds, pose_out, mask_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

Problem make_problem(const void* X, const void* uv, const void* sigma2, const void* valid,
                     const void* depth, int B, float fx, float fy, float cx, float cy, float bf,
                     float delta2, int has_depth) {
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
  return pb;
}

}  // namespace

// Largest B a launch takes, and most problems a batched launch takes; the
// wrapper raises above them.
extern "C" int motion_only_lm_max_rows() { return kMaxRowsPerBlock * kCluster; }
extern "C" int motion_only_lm_max_problems() { return kMaxProblems; }

// Plain C entry point: one launch of kThreads x kCluster. `depth` may be null
// when has_depth is 0. Launches on `stream` and returns the cudaError_t of the
// launch; it neither allocates nor synchronises.
extern "C" int motion_only_lm_launch(
    const void* pose_in, const void* X, const void* uv, const void* sigma2,
    const void* valid, const void* depth, int B, float fx, float fy, float cx,
    float cy, float bf, float delta2, int iters, int rounds, int has_depth,
    void* pose_out, void* mask_out, void* stream) {
  const Problem pb = make_problem(X, uv, sigma2, valid, depth, B, fx, fy, cx, cy, bf, delta2, has_depth);
  return launch<kThreads, kCluster>(pb, 1, static_cast<const float*>(pose_in), iters, rounds,
                                    static_cast<float*>(pose_out), static_cast<uint8_t*>(mask_out),
                                    static_cast<cudaStream_t>(stream));
}

// The batched launch: n_problems problems of B rows each, stacked (pose_in
// and pose_out (n, 4, 4); X (n, B, 3); uv (n, B, 2); sigma2, valid, depth
// and mask_out (n, B)); one cluster of kCluster blocks a problem.
extern "C" int motion_only_lm_launch_batched(
    const void* pose_in, const void* X, const void* uv, const void* sigma2,
    const void* valid, const void* depth, int n_problems, int B, float fx, float fy,
    float cx, float cy, float bf, float delta2, int iters, int rounds, int has_depth,
    void* pose_out, void* mask_out, void* stream) {
  const Problem pb = make_problem(X, uv, sigma2, valid, depth, B, fx, fy, cx, cy, bf, delta2, has_depth);
  return launch<kThreads, kCluster>(pb, n_problems, static_cast<const float*>(pose_in), iters, rounds,
                                    static_cast<float*>(pose_out), static_cast<uint8_t*>(mask_out),
                                    static_cast<cudaStream_t>(stream));
}

#ifdef UCOSLAM_VARIANTS
// The launches measured against the default (tools/port/kernel_builds.py):
// `threads` a block and `cluster` blocks, one of the pairs below; the same
// arguments as motion_only_lm_launch otherwise.
extern "C" int motion_only_lm_launch_variant(
    const void* pose_in, const void* X, const void* uv, const void* sigma2,
    const void* valid, const void* depth, int B, float fx, float fy, float cx,
    float cy, float bf, float delta2, int iters, int rounds, int has_depth,
    void* pose_out, void* mask_out, int threads, int cluster, void* stream) {
  const Problem pb = make_problem(X, uv, sigma2, valid, depth, B, fx, fy, cx, cy, bf, delta2, has_depth);
  const float* pin = static_cast<const float*>(pose_in);
  float* pout = static_cast<float*>(pose_out);
  uint8_t* mout = static_cast<uint8_t*>(mask_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UCOSLAM_LM_CASE(TT, CC) \
  if (threads == TT && cluster == CC) return launch<TT, CC>(pb, 1, pin, iters, rounds, pout, mout, s);
  UCOSLAM_LM_CASE(256, 1)
  UCOSLAM_LM_CASE(512, 1)
  UCOSLAM_LM_CASE(1024, 1)
  UCOSLAM_LM_CASE(256, 2)
  UCOSLAM_LM_CASE(128, 4)
  UCOSLAM_LM_CASE(256, 4)
  UCOSLAM_LM_CASE(128, 8)
  UCOSLAM_LM_CASE(256, 8)
#undef UCOSLAM_LM_CASE
  return static_cast<int>(cudaErrorInvalidConfiguration);
}
#endif
