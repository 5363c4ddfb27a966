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
// What bounds it on this card: the gate's instruction count over the live
// pairs, and at the slice's share the latency of a short sweep. Every pair
// of a live point (valid_a) and a valid keypoint needs one 16-byte shared
// load and 8 instructions (2 subtracts, 2 multiplies, an add and a compare
// for the radius, a subtract and a compare for the octave); only the ~1% of
// pairs inside the gate pay for the distance (8 XOR, 7 adds, the best-2
// update's 2 compares, and 8 popcounts). None of these is a fused
// multiply-add, so they issue at one instruction a lane and cycle: 132 SMs x
// 128 lanes x 1.98 GHz = 33.5 T/s, and popcounts at a quarter of the integer
// rate, 16 a cycle an SM (4.2 T/s). At chip_smoke's shape with 90% of the
// rows live (14.7k points x 1945 valid keypoints = 28.6 M pairs, 108k inside
// the gate) that is 6.9 us for the gates and 0.26 us for the pairs inside:
// ~7.1 us; at the slice's share (3154 live rows, 24k pairs inside) ~1.5 us.
// The shared loads, the loop and the branches are not counted. The inputs
// are under 1 MB (0.3 us at 3.35 TB/s).
//
// Design:
// - A group of G lanes owns one point. Lane l of the group visits the
//   columns j = l (mod G) in increasing order and replaces its best only on
//   a strict <, so it holds the best, the lowest column reaching it and the
//   second best of its columns. The G lanes then merge with shuffles by the
//   rule of the sequential sweep: best = min(b1, b2), idx = the idx of the
//   smaller best and the lower column on a tie, second = min(s1, s2,
//   max(b1, b2)). The result is bit for bit that of one sweep over all
//   columns. G is chosen per window of rows: the largest of 32, 16 and 8
//   that still gives every live point its own group, so few live points get
//   short sweeps and many get all lanes busy.
// - Only live rows are swept. A persistent grid (as many 1024-thread blocks
//   as the SMs hold at once, worked out once per device) takes the rows
//   round robin (row p to block p mod grid), so the live
//   rows, which sit together at the front of the map arena, spread over
//   every SM. Each block compacts its live rows with __ballot_sync and a
//   shuffle prefix scan of the warp counts; dead rows are written out at
//   once.
// - The keypoints are staged once per block, in dynamic shared memory, as
//   structures of arrays: one float4 per keypoint for the gate (u, v,
//   radius2 or -inf when the keypoint is invalid, octave bits), read with one
//   16-byte load, and the descriptor as two uint4, read only for the pairs
//   that pass. N = 2048 takes 96 KB and is loaded while the rows are
//   compacted; larger N is swept in tiles of kTile keypoints, re-staged for
//   every group of points.
// - The squared radius uses __fsub_rn / __fmul_rn / __fadd_rn so that no
//   fused multiply-add changes its rounding: the gate agrees bit for bit
//   with the plain PyTorch version. Any P and N are accepted.
//
// Built with -DUCOSLAM_VARIANTS (tools/port/kernel_builds.py) the library
// also holds launches with a fixed number of lanes a point, measured against
// the per-window choice in PERF.md (tools/port/bench_kernels.py --variants).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#ifdef UCOSLAM_PROBES
// Cycles spent in each phase by thread 0 of block 0 (tools/port/probe_kernels.py
// builds with -DUCOSLAM_PROBES and reads them).
__device__ long long g_probe[4];
#define PROBE_INIT long long probe_t = clock64(), probe_acc[4] = {};
#define PROBE(k)                                           \
  if (threadIdx.x == 0) {                                  \
    const long long t_ = clock64();                        \
    probe_acc[k] += t_ - probe_t;                          \
    probe_t = t_;                                          \
  }
#define PROBE_SAVE \
  if (threadIdx.x == 0 && blockIdx.x == 0)                 \
    for (int k_ = 0; k_ < 4; ++k_) g_probe[k_] = probe_acc[k_];
extern "C" int probe_read(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe)));
}
#else
#define PROBE_INIT
#define PROBE(k)
#define PROBE_SAVE
#endif

namespace {

constexpr int kInvalidDist = 10000;  // ucoslam_tpu_torch.ops.hamming.INVALID_DIST
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the live-row prefix scan takes one warp count a lane");
constexpr int kTile = 2048;  // keypoints staged in shared memory at once
constexpr unsigned kFull = 0xffffffffu;

struct Inputs {
  const uint32_t* desc_a;
  const float* uv_a;
  const int* oct_a;
  const uint8_t* valid_a;
  int n_pts;
  const uint32_t* desc_b;
  const float* uv_b;
  const int* oct_b;
  const uint8_t* valid_b;
  const float* radius2;
  int n_kpts;
  int* idx_out;
  int* best_out;
  int* second_out;
};

__device__ __forceinline__ int hamming(uint4 a0, uint4 a1, uint4 b0, uint4 b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
         __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) + __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// The gate of one point against one staged keypoint: the radius (rounded as
// the plain version rounds it) and the octave; radius2 is -inf for an
// invalid keypoint.
__device__ __forceinline__ bool gate(float ua, float va, int oa, float4 k) {
  const float du = __fsub_rn(ua, k.x);
  const float dv = __fsub_rn(va, k.y);
  const float r2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
  const int doct = oa - __float_as_int(k.w);
  return r2 < k.z && doct <= 1 && doct >= -1;
}

struct Best2 {
  int best = kInvalidDist, second = kInvalidDist, idx = -1;
  // columns arrive in increasing order: strict < keeps the lowest on ties
  __device__ __forceinline__ void add(int d, int col) {
    if (d < best) {
      second = best;
      best = d;
      idx = col;
    } else if (d < second) {
      second = d;
    }
  }
};

// Lanes a point: the largest of 32, 16, 8 that still gives every live point
// of the window its own group of lanes (or `group` in a variant launch).
__device__ __forceinline__ int lanes_per_point(int group, int n_live) {
  if (group > 0) return group;
  return n_live <= kThreads / 32 ? 32 : n_live <= kThreads / 16 ? 16 : 8;
}

// Stage keypoints [col0, col0 + nt) into shared memory (the caller syncs).
__device__ __forceinline__ void stage_tile(const Inputs& in, int col0, int nt, float4* s_gate,
                                           uint4* s_desc) {
  for (int j = threadIdx.x; j < nt; j += kThreads) {
    const size_t c = (size_t)col0 + j;
    const float r2 = in.valid_b[c] ? in.radius2[c] : -INFINITY;
    s_gate[j] = make_float4(in.uv_b[2 * c], in.uv_b[2 * c + 1], r2, __int_as_float(in.oct_b[c]));
    const uint4* row = reinterpret_cast<const uint4*>(in.desc_b + 8 * c);
    s_desc[2 * j] = row[0];
    s_desc[2 * j + 1] = row[1];
  }
}

// Match the window's n_live compacted points (s_live), one per group of G
// lanes, against all keypoints; `staged` is the tile in shared memory.
template <int G>
__device__ __forceinline__ void match_window(const Inputs& in, int n_live, const int* s_live,
                                             float4* s_gate, uint4* s_desc, int n_tiles,
                                             int& staged) {
  constexpr int kGroups = kThreads / G;
  const int tid = threadIdx.x, grp = tid / G, gl = tid % G;
  for (int q0 = 0; q0 < n_live; q0 += kGroups) {
    const int q = q0 + grp;
    const bool has = q < n_live;
    const int pt = has ? s_live[q] : 0;
    uint4 a0 = make_uint4(0, 0, 0, 0), a1 = a0;
    float ua = 0.f, va = 0.f;
    int oa = 0;
    if (has) {
      const uint4* row = reinterpret_cast<const uint4*>(in.desc_a + 8 * (size_t)pt);
      a0 = row[0];
      a1 = row[1];
      ua = in.uv_a[2 * (size_t)pt];
      va = in.uv_a[2 * (size_t)pt + 1];
      oa = in.oct_a[pt];
    }
    Best2 acc;
    for (int t = 0; t < n_tiles; ++t) {
      const int col0 = t * kTile;
      const int nt = min(kTile, in.n_kpts - col0);
      if (staged != t) {
        __syncthreads();  // the previous tile is no longer read
        stage_tile(in, col0, nt, s_gate, s_desc);
        __syncthreads();
        staged = t;
      }
      if (!has) continue;
      // lane gl visits columns gl, gl + G, ... in increasing order
#pragma unroll 4
      for (int j = gl; j < nt; j += G) {
        if (gate(ua, va, oa, s_gate[j])) acc.add(hamming(a0, a1, s_desc[2 * j], s_desc[2 * j + 1]), col0 + j);
      }
    }
    // ---- merge the group's lanes (all 32 lanes of the warp take part) ----
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      const int ob = __shfl_xor_sync(kFull, acc.best, o);
      const int oi = __shfl_xor_sync(kFull, acc.idx, o);
      const int os = __shfl_xor_sync(kFull, acc.second, o);
      acc.second = min(min(acc.second, os), max(acc.best, ob));
      acc.idx = ob < acc.best ? oi : acc.best < ob ? acc.idx : min(acc.idx, oi);
      acc.best = min(acc.best, ob);
    }
    if (has && gl == 0) {
      in.idx_out[pt] = acc.idx;
      in.best_out[pt] = acc.best;
      in.second_out[pt] = acc.second;
    }
  }
}

__global__ void __launch_bounds__(kThreads) project_match_kernel(Inputs in, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_cap = min(in.n_kpts, kTile);
  float4* s_gate = reinterpret_cast<float4*>(smem);
  uint4* s_desc = reinterpret_cast<uint4*>(s_gate + tile_cap);
  int* s_live = reinterpret_cast<int*>(s_desc + 2 * tile_cap);
  __shared__ int s_wcount[kWarps];

  PROBE_INIT
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = (in.n_kpts + kTile - 1) / kTile;
  const int blk = blockIdx.x, grid = gridDim.x;
  const int my_rows = in.n_pts > blk ? (in.n_pts - blk - 1) / grid + 1 : 0;
  int staged = -1;  // the tile in shared memory (block-uniform)
  if (n_tiles == 1 && my_rows > 0) {  // one tile: load it while the rows are compacted
    stage_tile(in, 0, in.n_kpts, s_gate, s_desc);
    staged = 0;
  }

  for (int base = 0; base < my_rows; base += kThreads) {
    // ---- compact this window's live rows; write the dead ones out ----
    const int k = base + tid;
    const int p = blk + k * grid;
    const bool in_range = k < my_rows;
    const bool live = in_range && in.valid_a[p] != 0;
    if (in_range && !live) {
      in.idx_out[p] = -1;
      in.best_out[p] = kInvalidDist;
      in.second_out[p] = kInvalidDist;
    }
    const unsigned bal = __ballot_sync(kFull, live);
    if (lane == 0) s_wcount[warp] = __popc(bal);
    __syncthreads();  // also publishes a tile staged above
    const int cnt = s_wcount[lane];  // kWarps == 32: lane w reads warp w's count
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const int off = __shfl_sync(kFull, incl - cnt, warp);
    const int n_live = __shfl_sync(kFull, incl, 31);
    if (live) s_live[off + __popc(bal & ((1u << lane) - 1u))] = p;
    __syncthreads();
    PROBE(0)  // compaction (and the early staging)

    // ---- one point per group of G lanes ----
    const int G = lanes_per_point(group, n_live);
    if (G == 32) match_window<32>(in, n_live, s_live, s_gate, s_desc, n_tiles, staged);
    else if (G == 16) match_window<16>(in, n_live, s_live, s_gate, s_desc, n_tiles, staged);
    else match_window<8>(in, n_live, s_live, s_gate, s_desc, n_tiles, staged);
    PROBE(1)  // the sweep and merge of thread 0's points
    __syncthreads();  // s_wcount and s_live are rewritten by the next window
    PROBE(2)  // waiting for the block's other points
  }
  PROBE_SAVE
}

constexpr int kMaxSmem = kTile * (16 + 32) + kThreads * 4;  // a full tile and the live list

// The persistent grid of the current device: the blocks that fit on all its
// SMs at once with a full tile. Worked out once per device, where the
// kernel's shared-memory limit is raised too; 0 with *err set on failure.
int persistent_grid(cudaError_t* err) {
  static std::atomic<int> grid_of[64];
  int dev = 0;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  std::atomic<int>& slot = grid_of[dev & 63];
  int grid = slot.load(std::memory_order_relaxed);
  if (grid > 0) return grid;
  int sms = 0, per_sm = 0;
  if ((*err = cudaFuncSetAttribute(project_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kMaxSmem)) != cudaSuccess ||
      (*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, project_match_kernel, kThreads,
                                                            kMaxSmem)) != cudaSuccess)
    return 0;
  grid = max(per_sm, 1) * sms;
  slot.store(grid, std::memory_order_relaxed);
  return grid;
}

int launch(const Inputs& in, int group, cudaStream_t stream) {
  if (in.n_pts <= 0) return 0;
  cudaError_t err = cudaSuccess;
  const int grid = persistent_grid(&err);
  if (grid == 0) return static_cast<int>(err);
  const int smem = min(in.n_kpts, kTile) * (16 + 32) + kThreads * 4;
  project_match_kernel<<<min(in.n_pts, grid), kThreads, smem, stream>>>(in, group);
  return static_cast<int>(cudaGetLastError());
}

Inputs make_inputs(const void* desc_a, const void* uv_a, const void* oct_a, const void* valid_a,
                   int n_pts, const void* desc_b, const void* uv_b, const void* oct_b,
                   const void* valid_b, const void* radius2, int n_kpts, void* idx_out,
                   void* best_out, void* second_out) {
  Inputs in;
  in.desc_a = static_cast<const uint32_t*>(desc_a);
  in.uv_a = static_cast<const float*>(uv_a);
  in.oct_a = static_cast<const int*>(oct_a);
  in.valid_a = static_cast<const uint8_t*>(valid_a);
  in.n_pts = n_pts;
  in.desc_b = static_cast<const uint32_t*>(desc_b);
  in.uv_b = static_cast<const float*>(uv_b);
  in.oct_b = static_cast<const int*>(oct_b);
  in.valid_b = static_cast<const uint8_t*>(valid_b);
  in.radius2 = static_cast<const float*>(radius2);
  in.n_kpts = n_kpts;
  in.idx_out = static_cast<int*>(idx_out);
  in.best_out = static_cast<int*>(best_out);
  in.second_out = static_cast<int*>(second_out);
  return in;
}

}  // namespace

// Plain C entry point: lanes a point chosen per window of rows. Launches on
// `stream` and returns the cudaError_t of the launch; it neither allocates
// nor synchronises.
extern "C" int project_match_launch(
    const void* desc_a, const void* uv_a, const void* oct_a, const void* valid_a, int n_pts,
    const void* desc_b, const void* uv_b, const void* oct_b, const void* valid_b,
    const void* radius2, int n_kpts,
    void* idx_out, void* best_out, void* second_out, void* stream) {
  const Inputs in = make_inputs(desc_a, uv_a, oct_a, valid_a, n_pts, desc_b, uv_b, oct_b, valid_b,
                                radius2, n_kpts, idx_out, best_out, second_out);
  return launch(in, 0, static_cast<cudaStream_t>(stream));
}

#ifdef UCOSLAM_VARIANTS
// The launches measured against the default (tools/port/kernel_builds.py):
// `group` lanes for every point, 8, 16 or 32; the same arguments as
// project_match_launch otherwise.
extern "C" int project_match_launch_variant(
    const void* desc_a, const void* uv_a, const void* oct_a, const void* valid_a, int n_pts,
    const void* desc_b, const void* uv_b, const void* oct_b, const void* valid_b,
    const void* radius2, int n_kpts,
    void* idx_out, void* best_out, void* second_out, int group, void* stream) {
  if (group != 8 && group != 16 && group != 32) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Inputs in = make_inputs(desc_a, uv_a, oct_a, valid_a, n_pts, desc_b, uv_b, oct_b, valid_b,
                                radius2, n_kpts, idx_out, best_out, second_out);
  return launch(in, group, static_cast<cudaStream_t>(stream));
}
#endif
