// Attention through a paged KV cache:
//
//     out[s, c, h] = softmax(q[s, c, h] · K[s, :, h]ᵀ / √D) · V[s, :, h]
//
// where slot s's keys and values are read through its page table: logical
// key k lives in physical block pages[s, k / bt] (clamped to [0, N-1]) at
// row k % bt of the pools k_pool / v_pool (N, bt, H, D).  Keys are masked
// to k < lengths[s] and, when causal, to k <= q_pos[s, c].  Softmax and
// sums are float32 with l clamped at 1e-20, so a row with no visible key
// (an empty slot) returns 0.  q, pools and out are float32; pages,
// lengths and q_pos int32.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:220
// (_paged_kernel, launched by paged_attention at line 262).  On the TPU the
// grid walked (slot, logical block) in order and carried m/l/acc in VMEM
// scratch from one grid step to the next; here the keys are cut into
// partitions that blocks take in parallel, and a second kernel merges them.
//
// What bounds it.  Per key it reads 2·D floats (K and V) and does 4·D
// flops per query row: at C = 1 (decode) one flop per byte, at C = 32
// (chunked prefill) 32.  The card balances float32 outside the tensor cores
// against memory near 20 flop/byte, so decode is bound by the bytes of the
// live context and a chunk-width step sits near the balance point.  To
// stream the context at the memory's rate, many bytes must be in flight at
// once on every SM.
//
// Design.  Split-K: each slot's keys are cut into partitions of part_keys
// logical keys (a multiple of 32 the caller passes: 256 by default, 128,
// 512 or 1024 as the kernel search chooses), and a block owns one (slot,
// head, partition, tile of query rows: one row when C = 1, else up to
// 16).  With n_part > 1 the block
// writes its partial (m, l, acc) to scratch and paged_attention_merge_kernel
// combines the partials of a row in partition order, clamping l at 1e-20
// once at the end; a partition wholly past the slot's limit writes m = -inf,
// l = 0 and returns.  With n_part == 1 (the caller's choice) the block
// normalises and writes the output itself.  Inside a block, the partition's
// 32-key chunks go to the block's W warps (four; two when D > 64, whose
// rings would not fit four times) in logical order: warp w takes chunks w,
// w+W, ...  Each warp streams its chunks through its own ring of kStages
// shared-memory stages, filled by cp.async (16-byte copies when D % 4 == 0
// and the pools are aligned), and looks up the physical rows of the next
// chunk it will copy (page entries clamped to [0, N-1]) while it scores the
// current one.  K and V rows are padded to an odd number of 16-byte units,
// so lanes reading different keys hit distinct banks.  One query row (C =
// 1, OneRow): lane j scores key j (the row read as float4 broadcasts), the
// row's max takes a butterfly of shuffles and its sum stays per lane until
// the end, p goes to the warp's p slab and is read back as float4
// broadcasts while lane t accumulates head dims t, t+32, ... of p · V.  A
// tile of 16 rows (C > 1, RowTile): Q·Kᵀ and P·V on the tensor cores in
// 3xTF32, each chunk through attention.cuh's attention_tile, the key-tile
// step flash_attention.cu takes.  Scores and maxima are in log2 units
// throughout, as there.  The warps' (m, l, acc) are merged in warp order
// through shared memory.  Partition bounds,
// chunk-to-warp assignment and every sum's order depend on logical key
// position alone (no atomics, no split that depends on physical block
// ids), so the same logical cache under any page table gives bitwise the
// same output: the engine's dense-stripe and paged layouts emit identical
// tokens.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention.cuh"

namespace {

using mxtt::cp_async16;
using mxtt::cp_async4;
using mxtt::cp_async_commit;
using mxtt::cp_async_wait;
using mxtt::split_tf32;

constexpr int kTileQ = 16;                       // query rows per block, C > 1
constexpr int kChunk = 32;                       // keys per chunk: one per lane
constexpr int kStages = 2;                       // chunks in flight per warp
constexpr int kMaxD = 128;                       // head dim limit
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// Warps per block: four, or two when D > 64, where four warps' rings would
// not fit in a block's shared memory.
__host__ __device__ constexpr int warps_for(int dpl) {
  return dpl > 2 ? 2 : 4;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Shared-memory geometry, in floats.  A stage row holds `width` head dims
// (D rounded up to 4 for one query row; the MMA depth bucket kD for a
// tile of 16 rows, whose fragments read all kD); K and V rows are padded
// to an odd multiple of 4, so lanes reading different keys' float4s, and
// the (g, t) MMA fragment reads, hit distinct banks.  Per warp: kStages
// stages of one K and one V chunk, then, for one query row, a p slab.
struct Geometry {
  int width, qstride, kstride, stage, slab;
  __host__ __device__ Geometry(int D, int rows, int kd) {
    qstride = (D + 3) / 4 * 4;
    width = rows > 1 ? kd : qstride;
    kstride = (width / 4) % 2 ? width : width + 4;
    stage = 2 * kChunk * kstride;
    slab = kStages * stage + (rows > 1 ? 0 : kChunk);
  }
  __host__ __device__ size_t bytes(int rows, int warps) const {
    return sizeof(float) *
           ((rows > 1 ? 0 : (size_t)qstride) + (size_t)warps * slab);
  }
};

// One query row (C = 1): lane j scores key j of a chunk, the row read from
// shared memory as float4 broadcasts; lane t accumulates head dims t,
// t+32, ... of p · V, p read back from the warp's p slab as float4s.
template <int kDpl>
struct OneRow {
  float m = -INFINITY, l = 0.f;                  // l: this lane's share
  float acc[kDpl];

  __device__ void init() {
#pragma unroll
    for (int t = 0; t < kDpl; ++t) acc[t] = 0.f;
  }

  __device__ void chunk(const Geometry& g, const float* qs, const float* ks,
                        const float* vs, float* ps, int k0, int hi,
                        const int* pos_s, int causal, float scale_log2, int D,
                        int lane) {
    const float* krow = ks + lane * g.kstride;
    float sc = 0.f;
    for (int d = 0; d < g.qstride; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
      const float4 qv = *reinterpret_cast<const float4*>(qs + d);
      sc = fmaf(qv.x, kv.x, sc);
      sc = fmaf(qv.y, kv.y, sc);
      sc = fmaf(qv.z, kv.z, sc);
      sc = fmaf(qv.w, kv.w, sc);
    }
    // online softmax update (pallas_kernels.py:241-259)
    const int key = k0 + lane;
    const bool seen = key < hi && (!causal || key <= pos_s[0]);
    const float sv = seen ? sc * scale_log2 : -INFINITY;
    const float new_m = fmaxf(m, warp_max(sv));
    const float safe_m = isinf(new_m) ? 0.f : new_m;
    const float p = isinf(sv) ? 0.f : exp2f(sv - safe_m);
    const float corr = isinf(m) ? 0.f : exp2f(m - safe_m);
    l = l * corr + p;
    m = new_m;
    ps[lane] = p;
#pragma unroll
    for (int t = 0; t < kDpl; ++t) acc[t] *= corr;
    __syncwarp();
    // p · V (V rows past the chunk's keys are 0, so are their p)
    const int kn = min(kChunk, hi - k0);
    for (int j = 0; j < kn; j += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(ps + j);
#pragma unroll
      for (int t = 0; t < kDpl; ++t) {
        const int d = lane + 32 * t;
        if (d < D) {
          const float* vc = vs + j * g.kstride + d;
          float a = acc[t];
          a = fmaf(p4.x, vc[0], a);
          a = fmaf(p4.y, vc[g.kstride], a);
          a = fmaf(p4.z, vc[2 * g.kstride], a);
          a = fmaf(p4.w, vc[3 * g.kstride], a);
          acc[t] = a;
        }
      }
    }
  }

  // (m, l, acc) of the row into the warp's slab, for the warp merge
  __device__ void publish(float* slab, int rows, int D, int lane) {
    l = warp_sum(l);
    if (lane == 0) {
      slab[0] = m;
      slab[kTileQ] = l;
    }
#pragma unroll
    for (int t = 0; t < kDpl; ++t) {
      const int d = lane + 32 * t;
      if (d < D) slab[2 * kTileQ + d] = acc[t];
    }
  }
};

// A tile of 16 query rows (C > 1) on the tensor cores in 3xTF32, with the
// key-tile step flash_attention.cu takes (attention.cuh's attention_tile):
// the rows as m16n8k8 A fragments in registers, S = Q·Kᵀ over the chunk's
// 32 keys, the online softmax on the accumulator fragments, P·V.  Each
// chunk belongs to one warp, so each K and V element is split into its
// TF32 parts once.
template <int kDpl>
struct RowTile {
  static constexpr int kD = 32 * kDpl;           // MMA depth bucket
  static constexpr int kDSteps = kD / 8;
  uint32_t qh[kDSteps][4], ql[kDSteps][4];
  float o[kDSteps][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // q_tile: the tile's first row; rows `row_stride` floats apart
  __device__ void init(const float* q_tile, size_t row_stride, int rows,
                       int D, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ds = 0; ds < kDSteps; ++ds) {
      const int d0 = 8 * ds + t, d1 = d0 + 4;
      const float* qa = q_tile + (size_t)g * row_stride;
      const float* qb = q_tile + (size_t)(g + 8) * row_stride;
      split_tf32(g < rows && d0 < D ? qa[d0] : 0.f, qh[ds][0], ql[ds][0]);
      split_tf32(g + 8 < rows && d0 < D ? qb[d0] : 0.f, qh[ds][1],
                 ql[ds][1]);
      split_tf32(g < rows && d1 < D ? qa[d1] : 0.f, qh[ds][2], ql[ds][2]);
      split_tf32(g + 8 < rows && d1 < D ? qb[d1] : 0.f, qh[ds][3],
                 ql[ds][3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[ds][e] = 0.f;
    }
  }

  // One 32-key chunk through attention.cuh's attention_tile, K and V split
  // into their TF32 parts as they are read (V rows past the chunk's keys
  // are 0, so are their p).
  __device__ void chunk(const Geometry& geo, const float* ks,
                        const float* vs, int k0, int hi, const int* pos_s,
                        int causal, float scale_log2, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const int stride = geo.kstride;
    auto k_frag = [&](int j, int ds, uint32_t& h0, uint32_t& h1,
                      uint32_t& l0, uint32_t& l1) {
      const float* kr = ks + (8 * j + g) * stride + 8 * ds + t;
      split_tf32(kr[0], h0, l0);
      split_tf32(kr[4], h1, l1);
    };
    auto v_frag = [&](int j, int n, uint32_t& h0, uint32_t& h1,
                      uint32_t& l0, uint32_t& l1) {
      const float* vr = vs + (8 * j + 2 * t) * stride + g + 8 * n;
      split_tf32(vr[0], h0, l0);
      split_tf32(vr[stride], h1, l1);
    };
    const int pos[2] = {pos_s[g], pos_s[g + 8]};
    auto seen = [&](int key, int r) {
      key += k0;
      return key < hi && (!causal || key <= pos[r]);
    };
    mxtt::attention_tile<kChunk / 8>(qh, ql, o, m, l, scale_log2, true,
                                     k_frag, v_frag, seen);
  }

  // (m, l, acc) of the tile's rows into the warp's slab, row-major
  __device__ void publish(float* slab, int rows, int D, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      const int row = g + 8 * r;
      if (t == 0 && row < rows) {
        slab[row] = m[r];
        slab[kTileQ + row] = l[r];
      }
    }
#pragma unroll
    for (int n = 0; n < kDSteps; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e >> 1), d = 8 * n + 2 * t + (e & 1);
        if (row < rows && d < D) slab[2 * kTileQ + row * D + d] = o[n][e];
      }
  }
};

// kRows: query rows per block (1 or kTileQ); kDpl: head dims per lane of
// the warp merge (D <= 32 kDpl).
template <int kRows, int kDpl>
__global__ void __launch_bounds__(warps_for(kDpl) * 32)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k_pool,
                       const float* __restrict__ v_pool,
                       const int* __restrict__ pages,
                       const int* __restrict__ lengths,
                       const int* __restrict__ q_pos,
                       float* __restrict__ out, float* __restrict__ part_ml,
                       float* __restrict__ part_acc, int C, int H, int D,
                       int N, int bt, int B, int causal,
                       float scale_log2, int n_part, int part_keys,
                       bool vec) {
  constexpr int kWarps = warps_for(kDpl);
  constexpr int kThreads = kWarps * 32;
  extern __shared__ __align__(16) float smem[];
  __shared__ int pos_s[kTileQ];

  const Geometry g(D, kRows, 32 * kDpl);
  const int s = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int part = blockIdx.y;
  const int c0 = blockIdx.z * kRows;
  const int rows = min(kRows, C - c0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t tok_stride = (size_t)H * D;       // one token's K in the pool
  const float* q_tile = q + ((size_t)(s * C + c0) * H + h) * D;
  float* qs = smem;                              // one query row (C = 1)
  float* slab = smem + (kRows > 1 ? 0 : g.qstride) + warp * g.slab;

  // rows past the tile's end: no visible key when causal
  if (threadIdx.x < kTileQ)
    pos_s[threadIdx.x] = threadIdx.x < rows
                             ? q_pos[(size_t)s * C + c0 + threadIdx.x] : -1;
  __syncthreads();

  // Keys any row of this tile can see; every thread computes the same.
  int limit = min(lengths[s], B * bt);
  if (causal) {
    int last = -1;
    for (int r = 0; r < rows; ++r) last = max(last, pos_s[r]);
    limit = min(limit, last + 1);
  }
  limit = max(limit, 0);
  const int lo = part * part_keys;
  const int hi = n_part > 1 ? min(lo + part_keys, limit) : limit;
  if (n_part > 1 && lo >= limit) {               // an empty partial
    if (threadIdx.x < rows) {
      const size_t rr = ((size_t)(s * C + c0 + threadIdx.x) * H + h) * n_part +
                        part;
      part_ml[2 * rr] = -INFINITY;
      part_ml[2 * rr + 1] = 0.f;
    }
    return;
  }

  if (kRows == 1)
    for (int d = threadIdx.x; d < g.qstride; d += kThreads)
      qs[d] = d < D ? q_tile[d] : 0.f;
  // Head dims D .. width-1 are never copied: zero them in every stage
  const int pad = g.width - D;
  for (int i = lane; i < kStages * 2 * kChunk * pad; i += 32) {
    const int r = i / pad;                       // stage rows, K then V
    slab[r * g.kstride + D + (i - r * pad)] = 0.f;
  }
  __syncthreads();

  const int n_chunks = (hi - lo + kChunk - 1) / kChunk;
  const int mine = n_chunks > warp ? (n_chunks - warp + kWarps - 1) / kWarps
                                   : 0;
  // The pool row (block * bt + key % bt) of this lane's key in the warp's
  // i-th chunk, or -1 past the partition.
  auto lookup = [&](int i) -> int {
    const int key = lo + (warp + i * kWarps) * kChunk + lane;
    if (i >= mine || key >= hi) return -1;
    const int blk = min(max(pages[(size_t)s * B + key / bt], 0), N - 1);
    return blk * bt + key % bt;
  };
  // The warp's i-th chunk into its stage as one cp.async group; zeros for
  // keys past the partition.
  auto issue = [&](int i, int row_at) {
    if (i < mine) {
      float* ks = slab + (i % kStages) * g.stage;
      float* vs = ks + kChunk * g.kstride;
      const size_t hd = (size_t)h * D;
      if (vec) {
        const int d4n = D / 4;
        for (int x = lane; x < kChunk * d4n; x += 32) {
          const int j = x / d4n, d = (x - j * d4n) * 4;
          const int row = __shfl_sync(kFull, row_at, j);
          const size_t at = (size_t)max(row, 0) * tok_stride + hd + d;
          cp_async16(ks + j * g.kstride + d, k_pool + at, row >= 0);
          cp_async16(vs + j * g.kstride + d, v_pool + at, row >= 0);
        }
      } else {
        for (int x = lane; x < kChunk * D; x += 32) {
          const int j = x / D, d = x - j * D;
          const int row = __shfl_sync(kFull, row_at, j);
          const size_t at = (size_t)max(row, 0) * tok_stride + hd + d;
          cp_async4(ks + j * g.kstride + d, k_pool + at, row >= 0);
          cp_async4(vs + j * g.kstride + d, v_pool + at, row >= 0);
        }
      }
    }
    cp_async_commit();
  };

  using Rows = typename std::conditional<kRows == 1, OneRow<kDpl>,
                                         RowTile<kDpl>>::type;
  Rows rs;
  if constexpr (kRows == 1)
    rs.init();
  else
    rs.init(q_tile, tok_stride, rows, D, lane);

  for (int i = 0; i < kStages; ++i) issue(i, lookup(i));
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kStages - 1>();                // chunk i has landed
    __syncwarp();
    const int row_next = lookup(i + kStages);    // in flight while we score
    const float* ks = slab + (i % kStages) * g.stage;
    const float* vs = ks + kChunk * g.kstride;
    const int k0 = lo + (warp + i * kWarps) * kChunk;
    if constexpr (kRows == 1)
      rs.chunk(g, qs, ks, vs, slab + kStages * g.stage, k0, hi, pos_s,
               causal, scale_log2, D, lane);
    else
      rs.chunk(g, ks, vs, k0, hi, pos_s, causal, scale_log2, lane);
    __syncwarp();                                // stage and p slab free
    issue(i + kStages, row_next);
  }
  cp_async_wait<0>();

  // Merge the warps' partial softmaxes in warp order.  Each warp publishes
  // (m, l, acc) of its rows in its own slab.
  __syncthreads();
  rs.publish(slab, rows, D, lane);
  __syncthreads();
  const float* slabs = smem + (kRows > 1 ? 0 : g.qstride);
  for (int r = warp; r < rows; r += kWarps) {
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, slabs[w * g.slab + r]);
    const float safe_m = isinf(mx) ? 0.f : mx;
    float lsum = 0.f, a[kDpl];
#pragma unroll
    for (int t = 0; t < kDpl; ++t) a[t] = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = slabs + w * g.slab;
      const float f = isinf(pw[r]) ? 0.f : exp2f(pw[r] - safe_m);
      lsum = fmaf(pw[kTileQ + r], f, lsum);
#pragma unroll
      for (int t = 0; t < kDpl; ++t) {
        const int d = lane + 32 * t;
        if (d < D) a[t] = fmaf(pw[2 * kTileQ + r * D + d], f, a[t]);
      }
    }
    const size_t row = (size_t)(s * C + c0 + r) * H + h;
    if (n_part > 1) {                            // the partition's partial
      const size_t rr = row * n_part + part;
      if (lane == 0) {
        part_ml[2 * rr] = mx;
        part_ml[2 * rr + 1] = lsum;
      }
#pragma unroll
      for (int t = 0; t < kDpl; ++t) {
        const int d = lane + 32 * t;
        if (d < D) part_acc[rr * D + d] = a[t];
      }
    } else {
      const float li = fmaxf(lsum, 1e-20f);
#pragma unroll
      for (int t = 0; t < kDpl; ++t) {
        const int d = lane + 32 * t;
        if (d < D) out[row * D + d] = a[t] / li;
      }
    }
  }
}

// One warp per output row (s, c, h): the row's n_part partials merged in
// partition order, l clamped at 1e-20 once at the end.
template <int kDpl>
__global__ void __launch_bounds__(128)
paged_attention_merge_kernel(const float* __restrict__ part_ml,
                             const float* __restrict__ part_acc,
                             float* __restrict__ out, int n_rows, int D,
                             int n_part) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const float* ml = part_ml + (size_t)row * n_part * 2;
  const float* pa = part_acc + (size_t)row * n_part * D;
  float mx = -INFINITY;
  for (int p = 0; p < n_part; ++p) mx = fmaxf(mx, ml[2 * p]);
  const float safe_m = isinf(mx) ? 0.f : mx;
  float lsum = 0.f, a[kDpl];
#pragma unroll
  for (int t = 0; t < kDpl; ++t) a[t] = 0.f;
  for (int p = 0; p < n_part; ++p) {
    if (isinf(ml[2 * p])) continue;              // empty: nothing written
    const float f = exp2f(ml[2 * p] - safe_m);
    lsum = fmaf(ml[2 * p + 1], f, lsum);
#pragma unroll
    for (int t = 0; t < kDpl; ++t) {
      const int d = lane + 32 * t;
      if (d < D) a[t] = fmaf(pa[(size_t)p * D + d], f, a[t]);
    }
  }
  const float li = fmaxf(lsum, 1e-20f);
#pragma unroll
  for (int t = 0; t < kDpl; ++t) {
    const int d = lane + 32 * t;
    if (d < D) out[(size_t)row * D + d] = a[t] / li;
  }
}

template <int kRows, int kDpl>
cudaError_t launch(const float* q, const float* k_pool, const float* v_pool,
                   const int* pages, const int* lengths, const int* q_pos,
                   float* out, float* part_ml, float* part_acc, int S, int C,
                   int H, int D, int N, int bt, int B, int causal,
                   float scale, int n_part, int part_keys, bool vec,
                   int device, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<kRows, kDpl>;
  constexpr int kWarps = warps_for(kDpl);
  const size_t bytes = Geometry(D, kRows, 32 * kDpl).bytes(kRows, kWarps);
  // the largest dynamic shared memory opted into so far, per device
  static int opted[kMaxDevices];
  if (bytes > 48 * 1024 && (int)bytes > opted[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted[device] = (int)bytes;
  }
  const dim3 grid(S * H, n_part, (C + kRows - 1) / kRows);
  kernel<<<grid, kWarps * 32, bytes, stream>>>(
      q, k_pool, v_pool, pages, lengths, q_pos, out, part_ml, part_acc, C, H,
      D, N, bt, B, causal, scale * kLog2e, n_part, part_keys, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_part == 1) return err;
  const long long n_rows = (long long)S * C * H;
  paged_attention_merge_kernel<kDpl>
      <<<(unsigned)((n_rows + 3) / 4), 128, 0, stream>>>(
          part_ml, part_acc, out, (int)n_rows, D, n_part);
  return cudaGetLastError();
}

template <int kRows>
cudaError_t launch_rows(int D, const float* q, const float* k_pool,
                        const float* v_pool, const int* pages,
                        const int* lengths, const int* q_pos, float* out,
                        float* part_ml, float* part_acc, int S, int C, int H,
                        int N, int bt, int B, int causal, float scale,
                        int n_part, int part_keys, bool vec, int device,
                        cudaStream_t stream) {
  if (D <= 32)
    return launch<kRows, 1>(q, k_pool, v_pool, pages, lengths, q_pos, out,
                            part_ml, part_acc, S, C, H, D, N, bt, B, causal,
                            scale, n_part, part_keys, vec, device, stream);
  if (D <= 64)
    return launch<kRows, 2>(q, k_pool, v_pool, pages, lengths, q_pos, out,
                            part_ml, part_acc, S, C, H, D, N, bt, B, causal,
                            scale, n_part, part_keys, vec, device, stream);
  return launch<kRows, 4>(q, k_pool, v_pool, pages, lengths, q_pos, out,
                          part_ml, part_acc, S, C, H, D, N, bt, B, causal,
                          scale, n_part, part_keys, vec, device, stream);
}

}  // namespace

// q (S, C, H, D), k_pool / v_pool (N, bt, H, D), out (S, C, H, D): float32,
// contiguous.  pages (S, B), lengths (S,), q_pos (S, C): int32, contiguous.
// n_part: 1 (one block per row tile writes out) or ceil(B * bt /
// part_keys), part_keys a positive multiple of 32, with scratch part_ml
// (S * C * H * n_part * 2) and part_acc (S * C * H * n_part * D) float32.
// Returns a cudaError_t: the launches' configuration error, if any.  Faults during the run surface at the
// caller's next synchronisation.
extern "C" int mxtt_paged_attention(const void* q, const void* k_pool,
                                    const void* v_pool, const void* pages,
                                    const void* lengths, const void* q_pos,
                                    void* out, void* part_ml, void* part_acc,
                                    int S, int C, int H, int D, int N, int bt,
                                    int B, int causal, float scale,
                                    int part_keys, int n_part, int device,
                                    void* stream) {
  if (S <= 0 || C <= 0 || H <= 0 || D <= 0 || D > kMaxD || N <= 0 ||
      bt <= 0 || B <= 0 || (long long)S * H > 0x7fffffffLL ||
      (long long)S * C * H > 0x7fffffffLL || C > 65535 * kTileQ ||
      device < 0 || device >= kMaxDevices || n_part < 1 ||
      (n_part > 1 &&
       (part_keys <= 0 || part_keys % kChunk != 0 ||
        (long long)(n_part - 1) * part_keys >= (long long)B * bt ||
        n_part > 65535 || !part_ml || !part_acc)))
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  const bool vec = D % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(k_pool) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v_pool) % 16 == 0;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k_pool);
  const float* vf = static_cast<const float*>(v_pool);
  const int* pg = static_cast<const int*>(pages);
  const int* ln = static_cast<const int*>(lengths);
  const int* qp = static_cast<const int*>(q_pos);
  float* o = static_cast<float*>(out);
  float* pm = static_cast<float*>(part_ml);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 1)
    return launch_rows<1>(D, qf, kf, vf, pg, ln, qp, o, pm, pa, S, C, H, N,
                          bt, B, causal, scale, n_part, part_keys, vec,
                          device, st);
  return launch_rows<kTileQ>(D, qf, kf, vf, pg, ln, qp, o, pm, pa, S, C, H,
                             N, bt, B, causal, scale, n_part, part_keys, vec,
                             device, st);
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
