// Kernels F1 and F2: the frontend's detect stage over every pyramid level,
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package computes this stage in plain
// jnp (ucoslam_tpu/ops/fast.py: fast_score_map, nms3x3, topk_grid;
// ucoslam_tpu/features/orb.py::_detect_level, _extract_support_patches) and
// leaves the fusion to XLA. The port dispatches eagerly: the same chain as
// PyTorch ops (ucoslam_tpu_torch/ops/cuda/fast_kernel.py, the plain
// versions) is ~100 launches a level, 8 levels a frame, each a few us of
// host dispatch for a few us of device work. These two launches take the
// whole stage for every level of a frame.
//
// F1 (fast_cells_kernel): one block a cell of a level, every cell of every
// level in one grid. The block loads its cell and a 4-pixel halo (3 for the
// Bresenham circle, 1 for the suppression) into shared memory, with the
// level's edge replicated, and computes:
// - the FAST-9/16 score of the cell and of a 1-pixel ring around it: the
//   largest, over the 16 arcs of 9 consecutive circle pixels, of the arc's
//   smallest difference to the centre (brighter and darker), kept where it
//   is above the threshold and the pixel lies 3 or more from the level's
//   border, else 0; -1 outside the level;
// - the 3x3 suppression: a strict maximum stays, and on a plateau the first
//   pixel in scan order; then 0 within `margin` of the border and on the
//   padding beyond the level's right and bottom edges;
// - the cell's k best, stable: the largest value first, and the lower
//   in-cell index first among equal values (k block-wide arg-max rounds,
//   each over the pixels below the previous pick in that order).
// It writes k (value, in-cell index) pairs a cell, cell-major.
//
// F2 (select_keypoints_kernel): for each level the stable top-`budget` of
// its candidates in the same cell-major order, zero-padded when a level has
// fewer candidates than its budget. A block takes 32 candidate slots of one
// level; 8 lanes count, for each slot, the slots ahead of it in that order
// over the level's slots staged in shared memory: its rank. A slot ranked
// below the budget writes its keypoint row (level-0 xy, response, octave,
// valid) at the level's offset + rank, and the block then gathers the
// (2r+1)^2 support patches of its kept slots from the level, the origin
// clamped into the level, zero beyond it (levels smaller than one patch).
//
// The results are bit for bit the plain versions': FAST takes float32
// differences and min / max, exact in any order; the scale multiply rounds
// once (__fmul_rn); nothing else is arithmetic. Both kernels take every
// shape, the cell size, k, the margin, the budgets and the threshold at run
// time.
//
// What bounds it on this card: bytes, and no single kernel is near its bound.
// A 640x480 frame at 8 levels and scale 1.2 is 0.95 M level pixels (3.8 MB
// read by F1, with the halo ~1.5x that from L2) and 2048 patches of 37 x 37
// (11.2 MB written by F2): ~4.5 us at 3.35 TB/s. F1 is 213 instructions a
// level pixel (FAST's 32 subtractions, 160 min / max in the arcs and 3 for
// the threshold; the suppression's 7 maxima and 3 compares; 4 rounds of the
// cell ranking's compare and select: chip_smoke.py's DETECT_OPS_PER_PIXEL),
// ~0.2 G for the frame: ~6 us at 132 SMs x 128 lanes x 1.98 GHz, so F1 is
// bound by instructions and F2 by bytes. The design
// answers the dispatch that the plain chain pays, and the bytes: each level
// is read once into shared memory, the scores, the suppression and the cell
// ranking stay there, and no 16-plane circle stack or score map is ever
// written to device memory; F2 reads the candidates (8 bytes each) and the
// patches' pixels, and writes only the outputs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kMaxCell = 64;       // F1's tile: (64 + 8)^2 + (64 + 2)^2 floats, 38 KB
constexpr int kHalo = 4;           // 3 for the circle, 1 for the suppression
constexpr int kBorder = 3;         // ucoslam_tpu_torch.ops.fast.BORDER
constexpr int kF1Threads = 256;
constexpr int kF2Threads = 256;
constexpr int kSlotLanes = 8;      // lanes that rank one slot
constexpr int kSlotsPerBlock = kF2Threads / kSlotLanes;  // fast_kernel.py::SLOTS_PER_BLOCK
constexpr int kMaxSlots = 32768;   // a level's slots staged in F2's shared memory (128 KB)
constexpr unsigned kFull = 0xffffffffu;

// Where each level and its candidates and keypoints lie (the host's layout,
// checked by make_levels; passed by value).
struct Levels {
  int n, cell, k, margin, radius;
  int h[kMaxLevels], w[kMaxLevels], gw[kMaxLevels];
  long long pix[kMaxLevels];       // first pixel of the level in the packed buffer
  int cell_off[kMaxLevels + 1];    // first cell of the level; [n] = all cells
  int slots[kMaxLevels];           // max(cells x k, budget)
  int budget[kMaxLevels];
  int out_off[kMaxLevels];         // first keypoint row of the level
  int chunk_off[kMaxLevels + 1];   // first F2 block of the level; [n] = all blocks
  float scale[kMaxLevels];
};

// One level's fields. Kernels read Levels with constant indices only: a
// kernel parameter indexed at run time would be copied to local memory.
struct Level {
  int h, w, gw, first_cell, n_cells, slots, budget, out_off, first_chunk;
  long long pix;
  float scale;
};

__device__ __forceinline__ Level level_at(const Levels& L, int lv) {
  Level out{};
#pragma unroll
  for (int q = 0; q < kMaxLevels; ++q)
    if (q == lv) {
      out.h = L.h[q];
      out.w = L.w[q];
      out.gw = L.gw[q];
      out.first_cell = L.cell_off[q];
      out.n_cells = L.cell_off[q + 1] - L.cell_off[q];
      out.slots = L.slots[q];
      out.budget = L.budget[q];
      out.out_off = L.out_off[q];
      out.first_chunk = L.chunk_off[q];
      out.pix = L.pix[q];
      out.scale = L.scale[q];
    }
  return out;
}

// The level of block b: the last level whose first block is b or an earlier
// one (every level has a block).
__device__ __forceinline__ int level_of(const int (&first)[kMaxLevels + 1], int n, int b) {
  int lv = 0;
#pragma unroll
  for (int q = 1; q < kMaxLevels; ++q)
    if (q < n && first[q] <= b) lv = q;
  return lv;
}

// The largest, over the 16 arcs of 9 consecutive values of the circle, of
// the arc's smallest value (ops/fast.py::_min_over_arc, then amax).
__device__ __forceinline__ float max_arc_min(const float* v) {
  float m2[16], m4[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m2[i] = fminf(v[i], v[(i + 1) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) m4[i] = fminf(m2[i], m2[(i + 2) & 15]);
  float best = -INFINITY;
#pragma unroll
  for (int i = 0; i < 16; ++i) best = fmaxf(best, fminf(fminf(m4[i], m4[(i + 4) & 15]), v[(i + 8) & 15]));
  return best;
}

// FAST score of the tile pixel (ty, tx), whose circle lies in the tile.
__device__ __forceinline__ float fast_score(const float* tile, int tw, int ty, int tx) {
  // ucoslam_tpu_torch.ops.fast.CIRCLE, in circular order
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const float c = tile[ty * tw + tx];
  float brighter[16], darker[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float v = tile[(ty + kDy[i]) * tw + tx + kDx[i]];
    brighter[i] = __fsub_rn(v, c);
    darker[i] = __fsub_rn(c, v);
  }
  return fmaxf(max_arc_min(brighter), max_arc_min(darker));
}

// (v, i) ahead of (bv, bi): the larger value, the lower index on a tie.
__device__ __forceinline__ bool ahead(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kF1Threads)
fast_cells_kernel(const float* __restrict__ levels, const Levels L, float threshold,
                  float* __restrict__ cand_val, int* __restrict__ cand_idx) {
  extern __shared__ float smem[];
  __shared__ float warp_v[kF1Threads / 32];
  __shared__ int warp_i[kF1Threads / 32];
  __shared__ float pick_v;
  __shared__ int pick_i;

  const Level lvl = level_at(L, level_of(L.cell_off, L.n, blockIdx.x));
  const int c = blockIdx.x - lvl.first_cell;
  const int h = lvl.h, w = lvl.w, cell = L.cell;
  const float* img = levels + lvl.pix;
  const int y0 = (c / lvl.gw) * cell, x0 = (c % lvl.gw) * cell;
  const int tw = cell + 2 * kHalo;  // the tile: the cell and its halo
  const int sw = cell + 2;          // the scores: the cell and a 1-pixel ring
  float* tile = smem;
  float* score = smem + tw * tw;

  for (int i = threadIdx.x; i < tw * tw; i += blockDim.x) {
    const int ty = i / tw, tx = i - ty * tw;
    const int y = min(max(y0 - kHalo + ty, 0), h - 1);
    const int x = min(max(x0 - kHalo + tx, 0), w - 1);
    tile[i] = __ldg(img + static_cast<long long>(y) * w + x);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < sw * sw; i += blockDim.x) {
    const int sy = i / sw, sx = i - sy * sw;
    const int y = y0 - 1 + sy, x = x0 - 1 + sx;
    float s = -1.0f;  // outside the level: the suppression's padding
    if (y >= 0 && y < h && x >= 0 && x < w) {
      s = 0.0f;
      if (y >= kBorder && y < h - kBorder && x >= kBorder && x < w - kBorder) {
        const float f = fast_score(tile, tw, sy - 1 + kHalo, sx - 1 + kHalo);
        s = f > threshold ? f : 0.0f;
      }
    }
    score[i] = s;
  }
  __syncthreads();

  // suppression, margin and padding, over the tile's memory (read no more)
  float* kept = tile;
  const int m = L.margin;
  for (int i = threadIdx.x; i < cell * cell; i += blockDim.x) {
    const int ly = i / cell, lx = i - ly * cell;
    const int y = y0 + ly, x = x0 + lx;
    float v = 0.0f;
    if (y >= m && y < h - m && x >= m && x < w - m) {
      const float* p = score + (ly + 1) * sw + lx + 1;
      const float s = p[0];
      const float earlier = fmaxf(fmaxf(p[-sw - 1], p[-sw]), fmaxf(p[-sw + 1], p[-1]));
      const float neigh = fmaxf(earlier, fmaxf(fmaxf(p[1], p[sw - 1]), fmaxf(p[sw], p[sw + 1])));
      if (s > neigh || (s == neigh && s > earlier)) v = s;
    }
    kept[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int out = (lvl.first_cell + c) * L.k;
  float pv = INFINITY;  // the previous pick: every pixel lies below (+inf, -1)
  int pi = -1;
  for (int r = 0; r < L.k; ++r) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int i = threadIdx.x; i < cell * cell; i += blockDim.x) {
      const float v = kept[i];
      if (ahead(pv, pi, v, i) && ahead(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_down_sync(kFull, bv, o);
      const int oi = __shfl_down_sync(kFull, bi, o);
      if (ahead(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int q = 1; q < kF1Threads / 32; ++q)
        if (ahead(warp_v[q], warp_i[q], bv, bi)) {
          bv = warp_v[q];
          bi = warp_i[q];
        }
      pick_v = bv;
      pick_i = bi;
      cand_val[out + r] = bv;
      cand_idx[out + r] = bi;
    }
    __syncthreads();
    pv = pick_v;
    pi = pick_i;
  }
}

__global__ void __launch_bounds__(kF2Threads)
select_keypoints_kernel(const float* __restrict__ levels, const Levels L,
                        const float* __restrict__ cand_val, const int* __restrict__ cand_idx,
                        float* __restrict__ xy, float* __restrict__ response, int* __restrict__ octave,
                        bool* __restrict__ valid, float* __restrict__ patches) {
  extern __shared__ float slot_val[];
  __shared__ int kept_row[kSlotsPerBlock], kept_y0[kSlotsPerBlock], kept_x0[kSlotsPerBlock];
  __shared__ int n_kept;

  const int lv = level_of(L.chunk_off, L.n, blockIdx.x);
  const Level lvl = level_at(L, lv);
  const int n_cand = lvl.n_cells * L.k;
  const int n_slot = lvl.slots;
  const long long first_cand = static_cast<long long>(lvl.first_cell) * L.k;
  const float* val = cand_val + first_cand;
  for (int i = threadIdx.x; i < n_slot; i += blockDim.x) slot_val[i] = i < n_cand ? val[i] : 0.0f;
  if (threadIdx.x == 0) n_kept = 0;
  __syncthreads();

  const int lane = threadIdx.x % kSlotLanes;
  const int j = (blockIdx.x - lvl.first_chunk) * kSlotsPerBlock + threadIdx.x / kSlotLanes;
  const float v = j < n_slot ? slot_val[j] : 0.0f;
  int rank = 0;
  if (j < n_slot)
    for (int i = lane; i < n_slot; i += kSlotLanes) rank += ahead(slot_val[i], i, v, j);
#pragma unroll
  for (int o = kSlotLanes / 2; o > 0; o >>= 1) rank += __shfl_down_sync(kFull, rank, o, kSlotLanes);

  const int h = lvl.h, w = lvl.w, cell = L.cell, r = L.radius, P = 2 * r + 1;
  if (lane == 0 && j < n_slot && rank < lvl.budget) {
    int x = 0, y = 0;  // a padding slot: (0, 0)
    if (j < n_cand) {
      const int c = j / L.k, idx = cand_idx[first_cand + j];
      y = (c / lvl.gw) * cell + idx / cell;
      x = (c % lvl.gw) * cell + idx % cell;
    }
    const int row = lvl.out_off + rank;
    xy[2 * row] = __fmul_rn(static_cast<float>(x), lvl.scale);
    xy[2 * row + 1] = __fmul_rn(static_cast<float>(y), lvl.scale);
    response[row] = v;
    octave[row] = lv;
    valid[row] = v > 0.0f;
    const int q = atomicAdd(&n_kept, 1);
    kept_row[q] = row;
    kept_y0[q] = min(max(y - r, 0), max(h, P) - P);
    kept_x0[q] = min(max(x - r, 0), max(w, P) - P);
  }
  __syncthreads();

  const float* img = levels + lvl.pix;
  const int pp = P * P, n = n_kept;
  for (int e = threadIdx.x; e < n * pp; e += blockDim.x) {
    const int q = e / pp, at = e - q * pp;
    const int a = at / P;
    const int y = kept_y0[q] + a, x = kept_x0[q] + at - a * P;
    patches[static_cast<long long>(kept_row[q]) * pp + at] =
        y < h && x < w ? __ldg(img + static_cast<long long>(y) * w + x) : 0.0f;
  }
}

// The layout of n levels, as the host computed it (fast_kernel.py::_layout:
// tiles across, first cells, and for F2 slots, first rows and first
// blocks; budget null for F1), checked here against the shapes, cell, k and
// budgets it follows from; false when an argument is out of range or the
// layout does not follow.
bool make_levels(Levels* L, int n, const int* h, const int* w, const long long* pix, const int* gw,
                 const int* cell_off, int cell, int k, int margin, const int* budget, const int* slots,
                 const int* out_off, const int* chunk_off, const float* scale, int radius) {
  if (n < 1 || n > kMaxLevels || cell < 1 || cell > kMaxCell || k < 1 || k > cell * cell || margin < 0 ||
      radius < 0 || cell_off[0] != 0 || (budget && chunk_off[0] != 0))
    return false;
  L->n = n;
  L->cell = cell;
  L->k = k;
  L->margin = margin;
  L->radius = radius;
  L->cell_off[0] = 0;
  L->chunk_off[0] = 0;
  int rows = 0;
  for (int lv = 0; lv < n; ++lv) {
    if (h[lv] < 1 || w[lv] < 1 || gw[lv] != (w[lv] + cell - 1) / cell ||
        cell_off[lv + 1] - cell_off[lv] != (h[lv] + cell - 1) / cell * gw[lv])
      return false;
    L->h[lv] = h[lv];
    L->w[lv] = w[lv];
    L->gw[lv] = gw[lv];
    L->pix[lv] = pix[lv];
    L->cell_off[lv + 1] = cell_off[lv + 1];
    L->slots[lv] = L->budget[lv] = L->out_off[lv] = 0;
    L->chunk_off[lv + 1] = 0;
    L->scale[lv] = 1.0f;
    if (!budget) continue;  // F1 reads no more
    const int b = budget[lv];
    if (b < 0 || slots[lv] != max((cell_off[lv + 1] - cell_off[lv]) * k, b) || slots[lv] > kMaxSlots ||
        out_off[lv] != rows ||
        chunk_off[lv + 1] - chunk_off[lv] != (slots[lv] + kSlotsPerBlock - 1) / kSlotsPerBlock)
      return false;
    L->slots[lv] = slots[lv];
    L->budget[lv] = b;
    L->out_off[lv] = out_off[lv];
    rows += b;
    L->chunk_off[lv + 1] = chunk_off[lv + 1];
    L->scale[lv] = scale[lv];
  }
  return true;
}

}  // namespace

// Plain C entry points. Each launches on `stream` and returns the
// cudaError_t of the launch (cudaErrorInvalidValue for arguments out of
// range); neither allocates nor synchronises.

// F1: levels (packed float32, level lv at pix[lv], h[lv] x w[lv] row-major)
// -> cand_val (float32) and cand_idx (int32), k a cell, the cells of every
// level row-major, level after level.
extern "C" int fast_cells_launch(const void* levels, int n_levels, const int* h, const int* w,
                                 const long long* pix, const int* gw, const int* cell_off, int cell, int k,
                                 int margin, float threshold, void* cand_val, void* cand_idx, void* stream) {
  Levels L;
  if (!make_levels(&L, n_levels, h, w, pix, gw, cell_off, cell, k, margin, nullptr, nullptr, nullptr, nullptr,
                   nullptr, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = L.cell_off[L.n];
  const int tw = cell + 2 * kHalo, sw = cell + 2;
  fast_cells_kernel<<<blocks, kF1Threads, (tw * tw + sw * sw) * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(levels), L, threshold, static_cast<float*>(cand_val),
      static_cast<int*>(cand_idx));
  return static_cast<int>(cudaGetLastError());
}

// F2: F1's candidates -> for each level its budget[lv] rows at the sum of
// the earlier budgets: xy (float32 pairs, times scale[lv]), response
// (float32), octave (int32), valid (bool), and patches (float32, (2 radius +
// 1)^2 a row).
extern "C" int select_keypoints_launch(const void* levels, int n_levels, const int* h, const int* w,
                                       const long long* pix, const int* gw, const int* cell_off, int cell,
                                       int k, const int* budget, const int* slots, const int* out_off,
                                       const int* chunk_off, const float* scale, int radius,
                                       const void* cand_val, const void* cand_idx, void* xy, void* response,
                                       void* octave, void* valid, void* patches, void* stream) {
  Levels L;
  if (!make_levels(&L, n_levels, h, w, pix, gw, cell_off, cell, k, 0, budget, slots, out_off, chunk_off, scale,
                   radius))
    return static_cast<int>(cudaErrorInvalidValue);
  int most = 0;
  for (int lv = 0; lv < L.n; ++lv) most = max(most, L.slots[lv]);
  const int smem = most * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_keypoints_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSlots * sizeof(float));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  select_keypoints_kernel<<<L.chunk_off[L.n], kF2Threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(levels), L, static_cast<const float*>(cand_val),
      static_cast<const int*>(cand_idx), static_cast<float*>(xy), static_cast<float*>(response),
      static_cast<int*>(octave), static_cast<bool*>(valid), static_cast<float*>(patches));
  return static_cast<int>(cudaGetLastError());
}
