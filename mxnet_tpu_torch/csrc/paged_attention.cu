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
// scratch from one grid step to the next; here one thread block owns one
// (slot, head, tile of queries) and its warps walk the slot's keys in
// loops, so nothing is carried between blocks.
//
// What bounds it.  Per key it reads 2·D floats (K and V) and does 4·D
// flops per query row: at C = 1 (decode) one flop per byte, at C = 32
// (chunked prefill) 32.  The card balances float32 outside the tensor cores
// against memory near 20 flop/byte, so decode is bound by the bytes of the
// live context and a chunk-width step sits near the balance point.
//
// Design.  A block is 4 warps and owns one (slot, head) and a tile of query
// rows: one row when C = 1, else up to 16.  The rows sit in shared memory.
// The block's keys 0 .. limit-1 (the slot's length, cut to the tile's last
// query position + 1 when causal: keys past it are masked for every row,
// so skipping them is exact) are cut into chunks of 32 in logical order,
// and warp w takes chunks w, w+4, w+8, ...: at C = 1 all four warps work,
// and a warp stages and consumes its chunks with no block barrier.  For
// each chunk the warp looks up the 32 keys' physical rows (page entries
// clamped to [0, N-1]), stages their K (row stride padded odd, so lanes
// reading different keys hit different banks) and V for this head in its
// own shared-memory slab, zero past limit.  Lane j scores key j against
// every row of the tile at once (each K element read from shared memory
// once for all rows, the rows read as float4 broadcasts); the warp reduces
// max and sum with butterfly shuffles and updates each row's float32
// m/l/acc as _paged_kernel does (pallas_kernels.py:241-259); lane t
// accumulates head dims t, t+32, ... of p · V.  At the end the four warps'
// partial (m, l, acc) are merged in warp order through shared memory.
// Which warp takes which chunk and every sum's order depend on logical key
// position alone (no atomics, no split that depends on physical block ids),
// so the same logical cache under any page table gives bitwise the same
// output: the engine's dense-stripe and paged layouts emit identical tokens.
// cp.async/TMA pipelines, split-K across blocks and tensor cores are left to
// later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                        // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTileQ = 16;                       // query rows per block, C > 1
constexpr int kChunk = 32;                       // keys per chunk: one per lane
constexpr int kMaxD = 128;                       // head dim limit
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

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

// Shared-memory geometry for head dim D: rows padded to a multiple of 4
// floats (float4 reads of q and V), K rows one float longer (odd stride).
struct Geometry {
  int qstride, kstride, vstride, slab;           // in floats
  __host__ __device__ explicit Geometry(int D) {
    qstride = (D + 3) / 4 * 4;
    kstride = qstride + 1;
    vstride = qstride;
    slab = (kChunk * kstride + 3) / 4 * 4 + kChunk * vstride;
  }
  __host__ __device__ size_t bytes(int rows) const {
    return sizeof(float) * ((size_t)rows * qstride + (size_t)kWarps * slab);
  }
};

// kRows: query rows per block (1 or kTileQ); kDpl: head dims per lane.
template <int kRows, int kDpl>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k_pool,
                       const float* __restrict__ v_pool,
                       const int* __restrict__ pages,
                       const int* __restrict__ lengths,
                       const int* __restrict__ q_pos,
                       float* __restrict__ out, int C, int H, int D, int N,
                       int bt, int B, int causal, float scale, bool vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ long long rows_at[kWarps][kChunk];  // pool offset of each key
  __shared__ int pos_s[kRows];

  const Geometry g(D);
  const int s = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int c0 = blockIdx.y * kRows;
  const int rows = min(kRows, C - c0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t tok_stride = (size_t)H * D;       // one token's K in the pool
  float* qs = smem;
  float* slab = smem + kRows * g.qstride + warp * g.slab;
  float* ks = slab;
  float* vs = slab + (kChunk * g.kstride + 3) / 4 * 4;

  for (int i = threadIdx.x; i < kRows * g.qstride; i += kThreads) {
    const int r = i / g.qstride, d = i % g.qstride;
    qs[i] = r < rows && d < D
                ? q[((size_t)(s * C + c0 + r) * H + h) * D + d] : 0.f;
  }
  // rows past the tile's end: zero queries, no visible key when causal
  if (threadIdx.x < kRows)
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

  float m[kRows], l[kRows], acc[kRows][kDpl];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kDpl; ++t) acc[r][t] = 0.f;
  }

  for (int k0 = warp * kChunk; k0 < limit; k0 += kWarps * kChunk) {
    const int kn = min(kChunk, limit - k0);
    __syncwarp();                                // slab free again
    {
      long long at = -1;
      if (lane < kn) {
        const int key = k0 + lane;
        int blk = pages[(size_t)s * B + key / bt];
        blk = min(max(blk, 0), N - 1);           // sentinel -> scratch row
        at = ((long long)blk * bt + key % bt) * (long long)tok_stride +
             (long long)h * D;
      }
      rows_at[warp][lane] = at;
    }
    __syncwarp();
    if (vec) {                                   // D % 4 == 0, aligned rows
      const int d4n = D / 4;
      for (int i = lane; i < kChunk * d4n; i += 32) {
        const int j = i / d4n, d = (i % d4n) * 4;
        const long long at = rows_at[warp][j];
        float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
        if (at >= 0) {
          kv = __ldg(reinterpret_cast<const float4*>(k_pool + at + d));
          vv = __ldg(reinterpret_cast<const float4*>(v_pool + at + d));
        }
        float* kd = ks + j * g.kstride + d;
        kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
        *reinterpret_cast<float4*>(vs + j * g.vstride + d) = vv;
      }
    } else {
      for (int i = lane; i < kChunk * g.qstride; i += 32) {
        const int j = i / g.qstride, d = i % g.qstride;
        const long long at = rows_at[warp][j];
        const bool live = at >= 0 && d < D;
        ks[j * g.kstride + d] = live ? __ldg(k_pool + at + d) : 0.f;
        vs[j * g.vstride + d] = live ? __ldg(v_pool + at + d) : 0.f;
      }
    }
    __syncwarp();

    // scores: lane j against every row, K element read once for all rows
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
    const float* krow = ks + lane * g.kstride;
    for (int d = 0; d < g.qstride; d += 4) {
      const float k0v = krow[d], k1v = krow[d + 1], k2v = krow[d + 2],
                  k3v = krow[d + 3];
      // every row of the tile, padded ones too: no branch splits the
      // unrolled rows, so their latencies overlap
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + r * g.qstride + d);
        float a = sc[r];
        a = fmaf(qv.x, k0v, a);
        a = fmaf(qv.y, k1v, a);
        a = fmaf(qv.z, k2v, a);
        a = fmaf(qv.w, k3v, a);
        sc[r] = a;
      }
    }

    // online softmax update, then p · V
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool seen = lane < kn && (!causal || key <= pos_s[r]);
      const float sv = seen ? sc[r] * scale : -INFINITY;
      const float new_m = fmaxf(m[r], warp_max(sv));
      const float safe_m = isinf(new_m) ? 0.f : new_m;
      const float p = isinf(sv) ? 0.f : expf(sv - safe_m);
      const float corr = isinf(m[r]) ? 0.f : expf(m[r] - safe_m);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = new_m;
      sc[r] = p;
#pragma unroll
      for (int t = 0; t < kDpl; ++t) acc[r][t] *= corr;
    }
    for (int j = 0; j < kn; ++j) {
      float v[kDpl];
#pragma unroll
      for (int t = 0; t < kDpl; ++t) {
        const int d = lane + 32 * t;
        v[t] = d < D ? vs[j * g.vstride + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(kFull, sc[r], j);
#pragma unroll
        for (int t = 0; t < kDpl; ++t) acc[r][t] = fmaf(pj, v[t], acc[r][t]);
      }
    }
  }

  // Merge the warps' partial softmaxes in warp order.  Each warp publishes
  // (m, l, acc) of its rows in its own slab.
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
      if (lane == 0) {
        slab[r] = m[r];
        slab[kTileQ + r] = l[r];
      }
#pragma unroll
      for (int t = 0; t < kDpl; ++t) {
        const int d = lane + 32 * t;
        if (d < D) slab[2 * kTileQ + r * D + d] = acc[r][t];
      }
    }
  }
  __syncthreads();
  const float* slabs = smem + kRows * g.qstride;
  for (int r = warp; r < rows; r += kWarps) {
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, slabs[w * g.slab + r]);
    const float safe_m = isinf(mx) ? 0.f : mx;
    float lsum = 0.f, a[kDpl];
#pragma unroll
    for (int t = 0; t < kDpl; ++t) a[t] = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* part = slabs + w * g.slab;
      const float f = isinf(part[r]) ? 0.f : expf(part[r] - safe_m);
      lsum = fmaf(part[kTileQ + r], f, lsum);
#pragma unroll
      for (int t = 0; t < kDpl; ++t) {
        const int d = lane + 32 * t;
        if (d < D) a[t] = fmaf(part[2 * kTileQ + r * D + d], f, a[t]);
      }
    }
    const float li = fmaxf(lsum, 1e-20f);
    float* dst = out + ((size_t)(s * C + c0 + r) * H + h) * D;
#pragma unroll
    for (int t = 0; t < kDpl; ++t) {
      const int d = lane + 32 * t;
      if (d < D) dst[d] = a[t] / li;
    }
  }
}

template <int kRows, int kDpl>
cudaError_t launch(const float* q, const float* k_pool, const float* v_pool,
                   const int* pages, const int* lengths, const int* q_pos,
                   float* out, int S, int C, int H, int D, int N, int bt,
                   int B, int causal, float scale, bool vec, int device,
                   cudaStream_t stream) {
  auto kernel = paged_attention_kernel<kRows, kDpl>;
  const size_t bytes = Geometry(D).bytes(kRows);
  // the largest dynamic shared memory opted into so far, per device
  static int opted[kMaxDevices];
  if (bytes > 48 * 1024 && (int)bytes > opted[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted[device] = (int)bytes;
  }
  const dim3 grid(S * H, (C + kRows - 1) / kRows);
  kernel<<<grid, kThreads, bytes, stream>>>(q, k_pool, v_pool, pages,
                                            lengths, q_pos, out, C, H, D, N,
                                            bt, B, causal, scale, vec);
  return cudaGetLastError();
}

template <int kRows>
cudaError_t launch_rows(int D, const float* q, const float* k_pool,
                        const float* v_pool, const int* pages,
                        const int* lengths, const int* q_pos, float* out,
                        int S, int C, int H, int N, int bt, int B, int causal,
                        float scale, bool vec, int device,
                        cudaStream_t stream) {
  if (D <= 32)
    return launch<kRows, 1>(q, k_pool, v_pool, pages, lengths, q_pos, out, S,
                            C, H, D, N, bt, B, causal, scale, vec, device,
                            stream);
  if (D <= 64)
    return launch<kRows, 2>(q, k_pool, v_pool, pages, lengths, q_pos, out, S,
                            C, H, D, N, bt, B, causal, scale, vec, device,
                            stream);
  return launch<kRows, 4>(q, k_pool, v_pool, pages, lengths, q_pos, out, S,
                          C, H, D, N, bt, B, causal, scale, vec, device,
                          stream);
}

}  // namespace

// q (S, C, H, D), k_pool / v_pool (N, bt, H, D), out (S, C, H, D): float32,
// contiguous.  pages (S, B), lengths (S,), q_pos (S, C): int32, contiguous.
// Returns a cudaError_t: the launch's configuration error, if any.  Faults
// during the run surface at the caller's next synchronisation.
extern "C" int mxtt_paged_attention(const void* q, const void* k_pool,
                                    const void* v_pool, const void* pages,
                                    const void* lengths, const void* q_pos,
                                    void* out, int S, int C, int H, int D,
                                    int N, int bt, int B, int causal,
                                    float scale, int device, void* stream) {
  if (S <= 0 || C <= 0 || H <= 0 || D <= 0 || D > kMaxD || N <= 0 ||
      bt <= 0 || B <= 0 || (long long)S * H > 0x7fffffffLL || C > 65535 ||
      device < 0 || device >= kMaxDevices)
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 1)
    return launch_rows<1>(D, qf, kf, vf, pg, ln, qp, o, S, C, H, N, bt, B,
                          causal, scale, vec, device, st);
  return launch_rows<kTileQ>(D, qf, kf, vf, pg, ln, qp, o, S, C, H, N, bt, B,
                             causal, scale, vec, device, st);
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
