// Causal attention over a paged KV pool, walked through a page table.
//
// Replaces the Pallas kernels of skycomputing_tpu/ops/paged_attention.py:
// _paged_kernel (the fp pool) and _paged_kernel_int8 (the int8 pool),
// each with its _accumulate step; one template serves both, on the
// stored K/V type.  Same contract: q [R, Lq, H, D]; k/v pages
// [P, page_size, H, D] in q's dtype, or int8 with float32 scales
// k_scale/v_scale [P, H] (one per page and head, fetched through the
// same clamped table entry as the page); page_table [R, W] int32 padded
// with sentinels >= P; index [R] int32.  Query j of row r sits at
// index[r] + j and sees logical positions <= index[r] + j.  Sentinel
// entries clamp to page P-1 and are masked by that causal rule.  Softmax
// statistics and the accumulator are float32; the output is rounded to
// q's dtype.  An int8 element is dequantized as k.astype(f32) * k_scale
// before it meets q, in the Pallas kernel's order (the tensor-core body
// folds the scale in after the product instead, the same in exact
// arithmetic; see that body).
//
// What bounds it on an H100: the K/V bytes it reads.  A decode step
// (Lq = 1) does 4*D flops per key position against 2*D*sizeof(KV) bytes
// of K/V, far below the card's ~295 flops per byte, so it is memory
// bound; a prefill wave of Lq queries does Lq times the flops over the
// same bytes, which at Lq <= 256 and D = 64 stays below that line too.
// The int8 pool halves those bytes against bf16 (plus 8 bytes of scales
// per page and head), and no dequantized copy ever goes to device memory.
// A row holds only a few hundred positions, so what keeps the card from
// that bound is latency: how many page round trips run one after another,
// and, in prefill, how fast each gathered tile is consumed.
//
// Three bodies, chosen by the wrapper's plan
// (skycomputing_tpu_torch/ops/paged_attention.py) from the q and page
// types, Lq, D and the page size alone; together they take every head
// dim D from 1 to 128 over every page type:
//
// * Lq <= 16 (decode, speculative verify): paged_attention_kernel_decode.
//   One block of eight warps per (row, head) (four where eight would not
//   fit in shared memory: float32 at D = 128).  The row's positions are
//   cut into chunks of 16; warp w of W takes chunks w, w + W, ..., each
//   with a private float32 online-softmax state, and the warps' states
//   are merged through shared memory at the end.  A warp copies a
//   chunk's K and V into its own double buffer in shared memory with
//   cp.async (the table entry of each position read from a copy of the
//   row's table in shared memory), so the next chunk is in flight while
//   this one is consumed, and nothing but __syncwarp orders the walk.
//   Each score is a dot product split over two half-warps and joined
//   with one shuffle; the softmax statistics are shuffles over 16 lanes;
//   in P.V each lane owns head dims lane + 32 j.  Positions past the
//   causal bound are never read.
// * Lq > 16 (prefill and chunked-prefill waves) with bfloat16 q, D a
//   multiple of 16 and page_size a multiple of 16:
//   paged_attention_kernel_mma, the tensor-core prefill body (B1's
//   design over gathered pages).  One block of four warps per (row,
//   head, tile of 64 queries), 16 queries per warp.  Each warp keeps its
//   16 query rows as mma.sync A fragments for the whole walk.  K/V tiles
//   of 64 positions (four pages of 16) are gathered with 16-byte
//   cp.async, each chunk's address from the row's table copied once
//   into shared memory, through a ring of three tiles, so that tiles
//   t + 1 and t + 2 are in flight while tile t is consumed (int8 pages:
//   their scales ride with them); rows are
//   padded by 16 bytes so that ldmatrix / ldmatrix.trans are free of bank
//   conflicts.  S = Q.K^T and O += P.V run on mma.sync.m16n8k16 (bf16 in,
//   f32 accumulate); the f32 scores are multiplied by the softmax scale
//   (q is never rounded after scaling), the online softmax runs in f32
//   registers, and P enters P.V as a bf16 head and tail (two products),
//   so the output is the f32 result's to about 16 bits before its own
//   rounding.  Tiles wholly past a warp's last query are skipped, and the
//   causal mask (by logical position index[r] + j) is applied only on the
//   tiles that reach past a warp's first query.  Int8 pages (B3) are
//   converted to bf16 in shared memory (exact), their scales folded into
//   the f32 scores and into P (see the body).
// * every other call with Lq > 16 (float32 prefill and chunk waves over
//   float32 or int8 pages; bf16 q over pages of 4 or 8, or at a head_dim
//   that is not a multiple of 16): paged_attention_kernel_tile, the
//   register-tile body.  One block of four warps per (row, head, tile of
//   32 queries; 16 past head_dim 64) walks the tile's positions as the
//   decode body does, in chunks of 16 split over the warps, each chunk
//   gathered with cp.async into the warp's own double buffer, nothing but
//   __syncwarp inside the walk, the warps' states merged at the end.
//   Each lane holds a 4-query x 4-key tile of scores (4 x 2 past
//   head_dim 64) and the accumulator of its 4 queries over 16 head dims
//   in registers (8 at head_dim 32 and below); every product is a
//   float32 FMA, so the float32 results are the exact body's to float32
//   roundoff (the serving bench's float32 identity gates rest on that).
//
// Rows of any length.  The decode and register-tile bodies read a staged
// K/V row a whole 16-byte slot at a time (8 bf16, 4 float32 or 16 int8
// values widened to float32).  A row of D elements that is not whole
// slots (an int8 row of 40 bytes, a float32 row of 120) is staged padded
// to whole slots (padded_dim), its padding zeroed once per buffer and
// never copied to, so a slot widens to zeros past D, which add nothing to
// Q.K^T; P.V's columns past D are never stored.  A position's row is
// copied in the widest granule that divides its D * sizeof(KV) bytes
// (copy_granule in common.cuh: 16, 8 or 4 bytes by cp.async; 2 or 1 by
// an ordinary load, for a bf16 row of odd D or an int8 row of D % 4 !=
// 0), since every row starts at a multiple of those bytes.  The int8
// scales ride as for whole rows.  (Until this design such rows ran a
// query-tile body, each page staged in float32 through shared memory for
// 16 queries, every product a float32 FMA: 1.3-1.5x slower than SDPA at
// a forced float32 prefill.)
//
// Pad rows (index 0, every entry a sentinel) are computed like any other
// row, over clamped page P-1, so the output equals the plain version on
// every row.
//
// On the TPU the page walk was a grid axis carrying its state in VMEM
// scratch; here blocks run in no order and share nothing, so the walk is
// a loop inside one block.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see skycomputing_tpu_torch/ops/_build.py) and bound
// with ctypes through the plain C functions at the end of this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxHeadDim = 128;  // the accumulator lives in registers

__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

// ---------------------------------------------------------------------------
// The decode body (Lq <= 16)
// ---------------------------------------------------------------------------

constexpr int kMaxWarps = 8;       // warps per (row, head) block: 8, or 4
constexpr int kChunk = 16;         // positions a warp takes per step
constexpr int kStages = 2;         // chunks in flight per warp
constexpr int kMaxDecodeQ = 16;    // the largest Lq of the decode body
constexpr int kDimsPerLane = kMaxHeadDim / 32;  // P.V: head dims lane + 32 j
constexpr size_t kMaxSmem = 232448;  // an H100 block's shared memory

// one 16-byte slot of a staged K/V row as float32
__device__ __forceinline__ void unpack16(const uint4& raw, float* out, float) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
// (a bf16 is the high half of a float32: widening is a shift)
__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack16(const uint4& raw, float* out,
                                         __nv_bfloat16) {
  unpack_bf16x2(raw.x, out);
  unpack_bf16x2(raw.y, out + 2);
  unpack_bf16x2(raw.z, out + 4);
  unpack_bf16x2(raw.w, out + 6);
}
__device__ __forceinline__ void unpack_int8x4(uint32_t w, float* out) {
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = (float)(int8_t)((w >> (8 * j)) & 0xff);
}
__device__ __forceinline__ void unpack16(const uint4& raw, float* out,
                                         int8_t) {
  unpack_int8x4(raw.x, out);
  unpack_int8x4(raw.y, out + 4);
  unpack_int8x4(raw.z, out + 8);
  unpack_int8x4(raw.w, out + 12);
}

// four floats to four elements of T (16 bytes of float32, 8 of bf16)
__device__ __forceinline__ void store4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float4& v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y),
                                           pack_bf16(v.z, v.w));
}

// A K/V row of D elements of kv_size bytes as the decode and
// register-tile bodies stage it: padded to whole 16-byte slots, the
// padding zeroed once and never copied to (so that a slot widens to
// float32 with zeros past D), held padded_dim elements wide
__host__ __device__ inline int padded_row_bytes(int D, int kv_size) {
  return (D * kv_size + 15) / 16 * 16;
}
__host__ __device__ inline int padded_dim(int D, int kv_size) {
  return padded_row_bytes(D, kv_size) / kv_size;
}
// ... and 16 bytes more between two staged rows
__host__ __device__ inline size_t decode_row_bytes(int D, int kv_size) {
  return (size_t)padded_row_bytes(D, kv_size) + 16;
}

// Shared memory of the decode body, in bytes: the scaled queries (rows
// of the padded head dims), each warp's probabilities and (int8) scales,
// the row's clamped table, and each warp's double buffer of K and V
// chunks, which the merge of the warps' states reuses at the end.
__host__ __device__ inline size_t decode_staging_offset(int D, int kv_size,
                                                        int max_q, int width,
                                                        int warps) {
  return (size_t)max_q * padded_dim(D, kv_size) * sizeof(float)  // q_s
         + (size_t)warps * max_q * kChunk * sizeof(float)      // p_s
         + (size_t)warps * kStages * 2 * kChunk * sizeof(float)  // scales
         + (size_t)((width + 3) / 4 * 4) * sizeof(int32_t);   // table
}
__host__ __device__ inline size_t decode_smem_bytes(int D, int kv_size,
                                                    int max_q, int width,
                                                    int warps) {
  const size_t staging =
      (size_t)warps * kStages * 2 * kChunk * decode_row_bytes(D, kv_size);
  const size_t merge = (size_t)warps * max_q * (D + 2) * sizeof(float);
  return decode_staging_offset(D, kv_size, max_q, width, warps) +
         (staging > merge ? staging : merge);
}
// 8 warps per block, or 4 where 8 would not fit in shared memory (0: no
// number of warps fits)
inline int decode_warps(int D, int kv_size, int max_q, int width) {
  for (int warps = kMaxWarps; warps >= 4; warps /= 2)
    if (decode_smem_bytes(D, kv_size, max_q, width, warps) <= kMaxSmem)
      return warps;
  return 0;
}

template <typename T, typename KV, int kMaxQ>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_attention_kernel_decode(
    const T* __restrict__ q, const KV* __restrict__ k_pages,
    const KV* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ index, T* __restrict__ out, int Lq, int H,
    int D, int copy, int num_pages, int page_size, int width, float scale) {
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  constexpr int kElems = 16 / (int)sizeof(KV);  // elements of a 16-byte slot
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int threads = blockDim.x;
  const int warps = threads / 32;
  const int row_bytes = (int)decode_row_bytes(D, sizeof(KV));
  const int Dp = padded_dim(D, sizeof(KV));
  float* q_s = reinterpret_cast<float*>(smem_raw);         // [kMaxQ][Dp]
  float* p_all = q_s + kMaxQ * Dp;                         // [warp][kMaxQ][16]
  float* sc_all = p_all + warps * kMaxQ * kChunk;          // [warp][stage][2][16]
  int32_t* table_s = reinterpret_cast<int32_t*>(sc_all + warps * kStages * 2 * kChunk);
  unsigned char* staging =  // [warp][stage][2][16][row]
      smem_raw + decode_staging_offset(D, sizeof(KV), kMaxQ, width, warps);
  float* merge = reinterpret_cast<float*>(staging);        // [warp][kMaxQ][D + 2]

  const int h = blockIdx.x;
  const int r = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t pos_stride = (int64_t)H * D;  // one position of q or a page
  const int idx = index[r];
  // positions 0 .. n_pos - 1 are the only ones a query of this row sees
  const int n_pos = min(width * page_size, idx + Lq);
  const int n_pages = (n_pos + page_size - 1) / page_size;
  const int n_chunks = (n_pos + kChunk - 1) / kChunk;

  const int32_t* table_row = page_table + (int64_t)r * width;
  for (int i = tid; i < n_pages; i += threads)
    table_s[i] = min(max(table_row[i], 0), num_pages - 1);
  const T* q_row = q + (int64_t)r * Lq * pos_stride + (int64_t)h * D;
  for (int e = tid; e < Lq * Dp; e += threads) {
    const int qq = e / Dp, d = e % Dp;
    q_s[e] = d < D ? to_float(q_row[qq * pos_stride + d]) * scale : 0.f;
  }

  const int data_bytes = D * (int)sizeof(KV);  // a stored K/V row
  const int chunks_per_row = (data_bytes + 15) / 16;  // its staged slots
  float* p_s = p_all + warp * kMaxQ * kChunk;
  float* sc_w = sc_all + warp * kStages * 2 * kChunk;
  unsigned char* st_w = staging + (size_t)warp * kStages * 2 * kChunk * row_bytes;
  // the padding of this warp's staged rows is zero for the whole walk
  zero_padding(st_w, kStages * 2 * kChunk, row_bytes, data_bytes,
               chunks_per_row * 16, lane, 32);
  __syncthreads();

  // queue chunk ci's K, V (and scales) into stage s, then commit a group
  // (an empty one past the row's end, so every step waits the same way)
  auto issue = [&](int ci, int s) {
    if (ci < n_chunks) {
      unsigned char* kb = st_w + (size_t)(2 * s) * kChunk * row_bytes;
      unsigned char* vb = kb + (size_t)kChunk * row_bytes;
      with_slot_copy(data_bytes, copy, [&](auto slot) {
        for (int e = lane; e < kChunk * chunks_per_row; e += 32) {
          const int j = e / chunks_per_row, c = e % chunks_per_row;
          const int pos = ci * kChunk + j;
          const bool ok = pos < n_pos;
          int64_t off = 0;
          if (ok)
            off = ((int64_t)table_s[pos / page_size] * page_size +
                   pos % page_size) * pos_stride +
                  (int64_t)h * D;
          slot(kb + j * row_bytes,
               reinterpret_cast<const unsigned char*>(k_pages + off), c, ok);
          slot(vb + j * row_bytes,
               reinterpret_cast<const unsigned char*>(v_pages + off), c, ok);
        }
      });
      if (kInt8 && lane < kChunk) {
        const int pos = ci * kChunk + lane;
        const bool ok = pos < n_pos;
        const int64_t off =
            ok ? (int64_t)table_s[pos / page_size] * H + h : 0;
        cp_async4(sc_w + (2 * s) * kChunk + lane, k_scale + off, ok);
        cp_async4(sc_w + (2 * s + 1) * kChunk + lane, v_scale + off, ok);
      }
    }
    cp_async_commit();
  };

  float m[kMaxQ], l[kMaxQ], acc[kMaxQ][kDimsPerLane];
#pragma unroll
  for (int qq = 0; qq < kMaxQ; ++qq) {
    m[qq] = -INFINITY;
    l[qq] = 0.f;
#pragma unroll
    for (int j = 0; j < kDimsPerLane; ++j) acc[qq][j] = 0.f;
  }
  // scores: lane (p, half) dots position p of the chunk with the queries
  // over half of the 16-byte slots of its staged row
  const int p = lane % kChunk;
  const int half = lane / kChunk;
  const int per_half = (chunks_per_row + 1) / 2;
  const int vec_begin = half * per_half;
  const int vec_end = min(chunks_per_row, vec_begin + per_half);

#pragma unroll
  for (int s = 0; s < kStages; ++s) issue(warp + s * warps, s);
  for (int t = 0;; ++t) {
    const int ci = warp + t * warps;
    if (ci >= n_chunks) break;
    const int s = t % kStages;
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* kb = st_w + (size_t)(2 * s) * kChunk * row_bytes;
    const unsigned char* vb = kb + (size_t)kChunk * row_bytes;
    const float* ksc = sc_w + (2 * s) * kChunk;
    const float* vsc = ksc + kChunk;

    float dot[kMaxQ];
#pragma unroll
    for (int qq = 0; qq < kMaxQ; ++qq) dot[qq] = 0.f;
    const float k_sc = kInt8 ? ksc[p] : 1.f;
    for (int vi = vec_begin; vi < vec_end; ++vi) {
      float kv[kElems];
      unpack16(*reinterpret_cast<const uint4*>(kb + p * row_bytes + vi * 16),
               kv, KV());
      if (kInt8) {
#pragma unroll
        for (int e = 0; e < kElems; ++e) kv[e] *= k_sc;
      }
#pragma unroll
      for (int qq = 0; qq < kMaxQ; ++qq) {
        if (qq < Lq) {
          const float4* qv =
              reinterpret_cast<const float4*>(q_s + qq * Dp + vi * kElems);
#pragma unroll
          for (int e4 = 0; e4 < kElems / 4; ++e4) {
            const float4 x = qv[e4];
            dot[qq] = fmaf(x.x, kv[4 * e4], dot[qq]);
            dot[qq] = fmaf(x.y, kv[4 * e4 + 1], dot[qq]);
            dot[qq] = fmaf(x.z, kv[4 * e4 + 2], dot[qq]);
            dot[qq] = fmaf(x.w, kv[4 * e4 + 3], dot[qq]);
          }
        }
      }
    }

    // online softmax over the chunk's 16 positions, per query
    const int pos = ci * kChunk + p;
#pragma unroll
    for (int qq = 0; qq < kMaxQ; ++qq) {
      if (qq < Lq) {
        const float full = dot[qq] + __shfl_xor_sync(0xffffffffu, dot[qq], 16);
        const bool visible = pos < n_pos && pos <= idx + qq;
        const float x = visible ? full : -INFINITY;
        float cm = x;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
        const float m_new = fmaxf(m[qq], cm);
        const float pr = visible ? expf(x - m_new) : 0.f;
        float cs = pr;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          cs += __shfl_xor_sync(0xffffffffu, cs, o);
        const float corr = (m_new == -INFINITY) ? 1.f : expf(m[qq] - m_new);
        l[qq] = l[qq] * corr + cs;
        m[qq] = m_new;
#pragma unroll
        for (int j = 0; j < kDimsPerLane; ++j) acc[qq][j] *= corr;
        if (half == 0) p_s[qq * kChunk + p] = pr;
      }
    }
    __syncwarp();

    // acc += p . v, lane owning head dims lane + 32 j
    const int n_here = min(kChunk, n_pos - ci * kChunk);
    for (int jj = 0; jj < n_here; ++jj) {
      const KV* vrow = reinterpret_cast<const KV*>(vb + jj * row_bytes);
      const float v_sc = kInt8 ? vsc[jj] : 1.f;
      float vv[kDimsPerLane];
#pragma unroll
      for (int j = 0; j < kDimsPerLane; ++j) {
        const int d = lane + 32 * j;
        float x = 0.f;
        if (d < D) {
          x = to_float(vrow[d]);
          if (kInt8) x *= v_sc;
        }
        vv[j] = x;
      }
#pragma unroll
      for (int qq = 0; qq < kMaxQ; ++qq) {
        if (qq < Lq) {
          const float pr = p_s[qq * kChunk + jj];
#pragma unroll
          for (int j = 0; j < kDimsPerLane; ++j)
            acc[qq][j] = fmaf(pr, vv[j], acc[qq][j]);
        }
      }
    }
    __syncwarp();  // stage s is read: refill it
    issue(ci + kStages * warps, s);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp's buffers are read; the merge reuses them

  // merge the warps' (m, l, acc); a warp that saw nothing has m = -inf
  const int mrow = D + 2;
  float* mw = merge + warp * kMaxQ * mrow;
#pragma unroll
  for (int qq = 0; qq < kMaxQ; ++qq) {
    if (qq < Lq) {
      if (lane == 0) {
        mw[qq * mrow + D] = m[qq];
        mw[qq * mrow + D + 1] = l[qq];
      }
#pragma unroll
      for (int j = 0; j < kDimsPerLane; ++j) {
        const int d = lane + 32 * j;
        if (d < D) mw[qq * mrow + d] = acc[qq][j];
      }
    }
  }
  __syncthreads();
  T* o_row = out + (int64_t)r * Lq * pos_stride + (int64_t)h * D;
  for (int e = tid; e < Lq * D; e += threads) {
    const int qq = e / D, d = e % D;
    float mx = -INFINITY;
    for (int w = 0; w < warps; ++w)
      mx = fmaxf(mx, merge[(w * kMaxQ + qq) * mrow + D]);
    float sum = 0.f, o = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float* st = merge + (w * kMaxQ + qq) * mrow;
      const float wt = st[D] == -INFINITY ? 0.f : expf(st[D] - mx);
      sum = fmaf(st[D + 1], wt, sum);
      o = fmaf(st[d], wt, o);
    }
    o_row[qq * pos_stride + d] = from_float<T>(o / fmaxf(sum, 1e-30f));
  }
}

template <typename T, typename KV, int kMaxQ>
cudaError_t launch_decode_q(const void* q, const void* k, const void* v,
                            const float* k_scale, const float* v_scale,
                            const int32_t* table, const int32_t* index,
                            void* out, int R, int Lq, int H, int D, int copy,
                            int num_pages, int page_size, int width,
                            float scale, cudaStream_t stream) {
  const int warps = decode_warps(D, sizeof(KV), kMaxQ, width);
  if (warps == 0) return cudaErrorInvalidValue;
  const size_t smem = decode_smem_bytes(D, sizeof(KV), kMaxQ, width, warps);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel_decode<T, KV, kMaxQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(H, R);
  paged_attention_kernel_decode<T, KV, kMaxQ>
      <<<grid, warps * 32, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const KV*>(k),
          static_cast<const KV*>(v), k_scale, v_scale, table, index,
          static_cast<T*>(out), Lq, H, D, copy, num_pages, page_size, width,
          scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core prefill body (bfloat16 q, Lq > 16, D a multiple of 16,
// page_size a multiple of 16)
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 16;    // query rows of one warp (the mma's M)
constexpr int kKTile = 64;      // positions of one K/V tile: 4 pages of 16
constexpr int kMmaStages = 3;   // K/V tiles in the ring: two in flight
// Warps per block.  A block's walk (its gathers, the int8 conversion and
// the barriers), not the number of blocks, sets the time, and more warps
// share that walk: 4 beat 1 and 2 at every prefill and chunk wave timed
// on an H100 (prefill_ab.py builds the body at 1, 2 and 4 to compare).
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaQTile = kMmaWarps * kMmaRows;  // queries of one block

// two floats as two bf16 pairs whose sum holds them to about 16
// significant bits: `head` rounded to bf16, `tail` the rounded remainder
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& head,
                                          uint32_t& tail) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  head = *reinterpret_cast<const uint32_t*>(&h);
  tail = pack_bf16(a - hf.x, b - hf.y);
}

// Shared memory of the tensor-core prefill body, in bytes: the block's
// query rows (then its output rows) and a ring of kMmaStages bf16 K and V
// tiles, all with rows of D + 8 bf16 (16 bytes of padding); over int8
// pages one bf16 K/V tile, fed by a ring of kMmaStages raw int8 tiles
// (rows of D + 16 bytes) with each position's k and v scale; then the
// row's clamped table.
__host__ __device__ inline size_t mma_smem_bytes(int D, int kv_size,
                                                 int width) {
  const size_t row = (size_t)(D + 8) * sizeof(__nv_bfloat16);
  const bool int8 = kv_size == 1;
  size_t bytes = (size_t)kMmaQTile * row +
                 2 * (size_t)(int8 ? 1 : kMmaStages) * kKTile * row;
  if (int8)
    bytes += (size_t)kMmaStages * 2 * kKTile * (D + 16 + sizeof(float));
  return bytes + (size_t)((width + 3) / 4 * 4) * sizeof(int32_t);
}

// One block per (query tile of kMmaQTile rows, head, row).  Warp w owns
// queries q0 + 16 w .. q0 + 16 w + 15.  In an m16n8 fragment lane l holds
// rows l / 4 and l / 4 + 8, columns 2 (l % 4) and 2 (l % 4) + 1 of each
// 8-column tile.
//
// KV: bf16 (B2) or int8 (B3).  Every int8 value (|x| <= 127) is exact in
// bf16, so a staged int8 tile is converted to bf16 in shared memory and
// runs the same mma; each score column is then multiplied by its page's
// k_scale in f32, and each probability by its page's v_scale before it
// is split into bf16 for P.V (the softmax sum takes it unscaled).  In
// exact arithmetic that is the Pallas kernel's k.astype(f32) * k_scale
// (and v likewise) before the products, since a scale is constant along
// the head dim that each product sums over.
template <typename KV, int kD>
__global__ void __launch_bounds__(kMmaThreads)
paged_attention_kernel_mma(const __nv_bfloat16* __restrict__ q,
                           const KV* __restrict__ k_pages,
                           const KV* __restrict__ v_pages,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int32_t* __restrict__ page_table,
                           const int32_t* __restrict__ index,
                           __nv_bfloat16* __restrict__ out, int Lq, int H,
                           int num_pages, int page_size, int width,
                           float scale) {
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  constexpr int kStride = kD + 8;        // padded bf16 row, in elements
  constexpr int kRawStride = kD + 16;    // padded int8 row, in bytes
  constexpr int kQChunks = kD / 8;       // 16-byte chunks of a bf16 row
  constexpr int kKVElems = 16 / (int)sizeof(KV);
  constexpr int kKVChunks = kD / kKVElems;  // ... of a stored K/V row
  constexpr int kKSteps = kD / 16;       // k-steps of Q.K^T
  constexpr int kDTiles = kD / 8;        // n-tiles of P.V
  constexpr int kNTiles = kKTile / 8;    // n-tiles of Q.K^T
  constexpr int kTileElems = kKTile * kStride;
  constexpr int kBufs = kInt8 ? 1 : kMmaStages;  // bf16 K/V tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];

  // kMmaThreads wide, the block reads its width from blockDim.x, a number
  // the compiler cannot see: compiled against the constant, its strided
  // copy loops ran B3 9-15% slower on an H100 (prefill_ab.py, variant
  // constant_block), and rolling them by hand spilled at <int8, 32>
  const int threads = blockDim.x;
  const int warps = threads / 32;
  const int q_tile = warps * kMmaRows;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + q_tile * kStride;    // [kBufs][kKTile][kStride]
  __nv_bfloat16* vs = ks + kBufs * kTileElems;  // [kBufs][kKTile][kStride]
  unsigned char* rest =
      reinterpret_cast<unsigned char*>(vs + kBufs * kTileElems);
  // int8: [stage][k|v][kKTile][kRawStride] bytes, then [stage][k|v][kKTile]
  // scales
  int8_t* raw = reinterpret_cast<int8_t*>(rest);
  float* sc = reinterpret_cast<float*>(
      rest + (kInt8 ? kMmaStages * 2 * kKTile * kRawStride : 0));
  int32_t* table_s =
      reinterpret_cast<int32_t*>(sc + (kInt8 ? kMmaStages * 2 * kKTile : 0));

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int h = blockIdx.y;
  const int r = blockIdx.z;
  const int q0 = blockIdx.x * q_tile;
  const int64_t pos_stride = (int64_t)H * kD;  // one position of q or a page
  const int idx = index[r];
  // positions 0 .. n_pos - 1 are the only ones a query of this block sees
  const int n_pos = min(width * page_size, idx + min(q0 + q_tile, Lq));
  const int n_tiles = (n_pos + kKTile - 1) / kKTile;
  const int tig2 = 2 * (lane % 4);
  // a position's table entry and place in its page: a shift and a mask
  // where the page size is a power of two (the engine's 16)
  const int shift =
      (page_size & (page_size - 1)) ? -1 : __ffs(page_size) - 1;
  auto page_of = [&](int pos) {
    return shift >= 0 ? pos >> shift : pos / page_size;
  };
  auto row_in_page = [&](int pos) {
    return shift >= 0 ? pos & (page_size - 1) : pos % page_size;
  };

  // the query tile (rows past Lq zero-filled) and the row's whole table
  // are read at once, neither waiting on index[r]
  const __nv_bfloat16* q_row =
      q + (int64_t)r * Lq * pos_stride + (int64_t)h * kD;
  for (int e = tid; e < q_tile * kQChunks; e += threads) {
    const int qq = e / kQChunks, c = e % kQChunks;
    const bool ok = q0 + qq < Lq;
    cp_async16(qs + qq * kStride + c * 8,
               q_row + (int64_t)(ok ? q0 + qq : 0) * pos_stride + c * 8, ok);
  }
  const int32_t* table_row = page_table + (int64_t)r * width;
  for (int i = tid; i < width; i += threads)
    table_s[i] = min(max(table_row[i], 0), num_pages - 1);
  __syncthreads();  // the gathers below read the table
  // queue a K/V tile (and, over int8 pages, each position's scales), each
  // 16-byte chunk gathered through the row's table (positions past n_pos
  // zero-filled), then commit a group (an empty one past the last tile,
  // so every step waits the same way)
  auto load_kv = [&](int tile) {
    if (tile < n_tiles) {
      const int k0 = tile * kKTile;
      const int s = tile % kMmaStages;
      for (int e = tid; e < kKTile * kKVChunks; e += threads) {
        const int j = e / kKVChunks, c = e % kKVChunks;
        const int pos = k0 + j;
        const bool ok = pos < n_pos;
        int64_t off = 0;
        if (ok)
          off = ((int64_t)table_s[page_of(pos)] * page_size +
                 row_in_page(pos)) * pos_stride +
                (int64_t)h * kD + c * kKVElems;
        if constexpr (kInt8) {
          int8_t* kb = raw + (size_t)(2 * s) * kKTile * kRawStride;
          int8_t* vb = kb + kKTile * kRawStride;
          cp_async16(kb + j * kRawStride + c * 16, k_pages + off, ok);
          cp_async16(vb + j * kRawStride + c * 16, v_pages + off, ok);
        } else {
          __nv_bfloat16* kb = ks + s * kTileElems;
          __nv_bfloat16* vb = vs + s * kTileElems;
          cp_async16(kb + j * kStride + c * 8, k_pages + off, ok);
          cp_async16(vb + j * kStride + c * 8, v_pages + off, ok);
        }
      }
      if constexpr (kInt8) {
        float* scs = sc + s * 2 * kKTile;
        for (int j = tid; j < kKTile; j += threads) {
          const int pos = k0 + j;
          const bool ok = pos < n_pos;
          const int64_t at = ok ? (int64_t)table_s[page_of(pos)] * H + h : 0;
          cp_async4(scs + j, k_scale + at, ok);
          cp_async4(scs + kKTile + j, v_scale + at, ok);
        }
      }
    }
    cp_async_commit();
  };
  // the query tile lands with tile 0
#pragma unroll
  for (int i = 0; i < kMmaStages - 1; ++i) load_kv(i);

  uint32_t qf[kKSteps][4];              // this warp's Q, A fragments
  float o[kDTiles][4];                  // output accumulator
  float m[2] = {-INFINITY, -INFINITY};  // rows lane/4, lane/4 + 8; log2
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const float scale2 = scale * kLog2e;
  // the positions of this warp's first and last query, and of this lane's
  const int warp_first = idx + q0 + warp * kMmaRows;
  const int warp_last = warp_first + kMmaRows - 1;
  const int qpos_lo = warp_first + lane / 4;  // rows lane/4 and lane/4 + 8

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKTile;
    // tile t (and, at t = 0, the query tile) has landed ...
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();  // ... for every thread, and tile t - 1 is read
    load_kv(t + kMmaStages - 1);  // into the buffers tile t - 1 used
    const __nv_bfloat16* kb = ks;
    const __nv_bfloat16* vb = vs;
    const float* sct = sc + (t % kMmaStages) * 2 * kKTile;  // int8 scales
    if constexpr (kInt8) {
      // tile t's int8 rows to bf16 (exact)
      const int8_t* rk =
          raw + (size_t)(2 * (t % kMmaStages)) * kKTile * kRawStride;
      for (int e = tid; e < 2 * kKTile * kKVChunks; e += threads) {
        const int which = e / (kKTile * kKVChunks);
        const int j = (e / kKVChunks) % kKTile, c = e % kKVChunks;
        const uint4 w = *reinterpret_cast<const uint4*>(
            rk + ((size_t)which * kKTile + j) * kRawStride + c * 16);
        float f[16];
        unpack16(w, f, int8_t());
        uint4 lo, hi;
        lo.x = pack_bf16(f[0], f[1]);
        lo.y = pack_bf16(f[2], f[3]);
        lo.z = pack_bf16(f[4], f[5]);
        lo.w = pack_bf16(f[6], f[7]);
        hi.x = pack_bf16(f[8], f[9]);
        hi.y = pack_bf16(f[10], f[11]);
        hi.z = pack_bf16(f[12], f[13]);
        hi.w = pack_bf16(f[14], f[15]);
        uint4* dst = reinterpret_cast<uint4*>((which ? vs : ks) +
                                              j * kStride + c * 16);
        dst[0] = lo;
        dst[1] = hi;
      }
      __syncthreads();
    } else {
      kb += (t % kMmaStages) * kTileElems;
      vb += (t % kMmaStages) * kTileElems;
    }

    if (t == 0) {
      const __nv_bfloat16* qw = qs + warp * kMmaRows * kStride;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldmatrix_x4(qf[kk], qw + (lane % 16) * kStride + kk * 16 +
                                (lane / 16) * 8);
    }
    // a tile wholly past this warp's last query holds nothing it sees
    // (tile 0 never is: position 0 is visible to every query); a warp
    // whose rows all lie past Lq has nothing to compute, only to load
    if (k0 > warp_last || q0 + warp * kMmaRows >= Lq) continue;

    // S = Q . K^T over this tile's 64 positions
    float s[kNTiles][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kb +
                            (np * 16 + (lane % 8) + (lane / 16) * 8) * kStride +
                            kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // f32 scores * scale (* k_scale), in log2 units; the causal mask only
    // where the tile reaches past this warp's first query or past n_pos
    const bool masked = k0 + kKTile - 1 > warp_first || k0 + kKTile > n_pos;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + tig2 + (e % 2);
        float x = s[n][e] * scale2;
        if constexpr (kInt8) x *= sct[col];
        if (masked && (k0 + col > qpos_lo + 8 * (e / 2) || k0 + col >= n_pos))
          x = -INFINITY;
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // tile 0 holds position 0, which every query sees, so the running
      // max is finite from the first tile on
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);  // exp2(-inf) = 0 on the first tile
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e / 2]);  // exp2(-inf) = 0
        l[e / 2] += p;
        if constexpr (kInt8)
          s[n][e] = p * sct[kKTile + n * 8 + tig2 + (e % 2)];
        else
          s[n][e] = p;
      }
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P . V, V by ldmatrix.trans, P from the score registers as a
    // bf16 head and tail (two products): one bf16 rounding of P would
    // move an output by up to 2^-9 of its size, enough to round it to the
    // neighbouring bf16 value of the float32 result
#pragma unroll
    for (int kk = 0; kk < kKTile / 16; ++kk) {
      uint32_t ph[4], pt[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pt[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pt[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pt[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pt[3]);
#pragma unroll
      for (int np = 0; np < kDTiles / 2; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(
            vf, vb + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kStride +
                    np * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * np], ph, vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], ph, vf[2], vf[3]);
        mma_bf16(o[2 * np], pt, vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pt, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // acc / max(l, 1e-30) in bf16, through this warp's own query rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  __nv_bfloat16* ow = qs + warp * kMmaRows * kStride;
  const int row = lane / 4;
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    *reinterpret_cast<uint32_t*>(ow + row * kStride + n * 8 + tig2) =
        pack_bf16(o[n][0] * l[0], o[n][1] * l[0]);
    *reinterpret_cast<uint32_t*>(ow + (row + 8) * kStride + n * 8 + tig2) =
        pack_bf16(o[n][2] * l[1], o[n][3] * l[1]);
  }
  __syncwarp();
  __nv_bfloat16* o_row = out + (int64_t)r * Lq * pos_stride + (int64_t)h * kD;
  for (int e = lane; e < kMmaRows * kQChunks; e += 32) {
    const int qq = e / kQChunks, c = e % kQChunks;
    const int qi = q0 + warp * kMmaRows + qq;
    if (qi < Lq)
      *reinterpret_cast<uint4*>(o_row + (int64_t)qi * pos_stride + c * 8) =
          *reinterpret_cast<const uint4*>(ow + qq * kStride + c * 8);
  }
}

template <typename KV, int kD>
cudaError_t launch_mma_dim(const void* q, const void* k, const void* v,
                           const float* k_scale, const float* v_scale,
                           const int32_t* table, const int32_t* index,
                           void* out, int R, int Lq, int H, int num_pages,
                           int page_size, int width, float scale,
                           cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(kD, sizeof(KV), width);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel_mma<KV, kD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Lq + kMmaQTile - 1) / kMmaQTile, H, R);
  paged_attention_kernel_mma<KV, kD><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), k_scale, v_scale, table, index,
      static_cast<__nv_bfloat16*>(out), Lq, H, num_pages, page_size, width,
      scale);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const float* k_scale, const float* v_scale,
                       const int32_t* table, const int32_t* index, void* out,
                       int R, int Lq, int H, int D, int num_pages,
                       int page_size, int width, float scale,
                       cudaStream_t stream) {
  switch (D) {
#define SKY_MMA_CASE(d)                                                       \
  case d:                                                                     \
    return launch_mma_dim<KV, d>(q, k, v, k_scale, v_scale, table, index,    \
                                 out, R, Lq, H, num_pages, page_size, width,  \
                                 scale, stream);
    SKY_MMA_CASE(16)
    SKY_MMA_CASE(32)
    SKY_MMA_CASE(48)
    SKY_MMA_CASE(64)
    SKY_MMA_CASE(80)
    SKY_MMA_CASE(96)
    SKY_MMA_CASE(112)
    SKY_MMA_CASE(128)
#undef SKY_MMA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The register-tile body (Lq > 16 outside the tensor-core body): float32
// prefill and chunk waves, and any head dim or page size
// ---------------------------------------------------------------------------

constexpr int kTileWarps = 4;  // warps per (row, head, query tile) block
constexpr int kTileThreads = kTileWarps * 32;
constexpr int kTileQPL = 4;  // queries of one lane's register tile
// blocks an SM holds: float32 pages' shared memory (about 90 KB a block
// at head_dim 64) allows two, so a thread may keep up to 255 registers
// (at 168, the compiler's own cap, the float32 body at head_dim 64
// spilled)
constexpr int kTileBlocksPerSM = 2;

// the head-dim bound a block is compiled for: 32, 64 or 128
__host__ __device__ constexpr int tile_dmax(int D) {
  return D <= 32 ? 32 : (D <= 64 ? 64 : 128);
}
// queries of one block: 32, or 16 past head_dim 64, so that a lane's
// accumulator (4 queries x 16 head dims) stays at 64 registers
__host__ __device__ constexpr int tile_queries(int d_max) {
  return d_max > 64 ? 16 : 32;
}

// Shared memory of the register-tile body, in bytes: the block's scaled
// queries (rows of Dp + 4 floats, Dp the padded head dims), each warp's
// probabilities (key-major, rows of q_tile + 8 floats) and (int8) scales,
// the row's clamped table, then each warp's double buffer of raw K and V
// chunks (decode_row_bytes apart) and, over bf16 or int8 pages, each
// warp's float32 K and V chunk (rows of Dp + 4); the merge of the warps'
// states reuses those last two at the end.
__host__ __device__ inline size_t tile_staging_offset(int Dp, int q_tile,
                                                      int width) {
  return (size_t)q_tile * (Dp + 4) * sizeof(float)                  // q_s
         + (size_t)kTileWarps * kChunk * (q_tile + 8) * sizeof(float)  // p_s
         + (size_t)kTileWarps * kStages * 2 * kChunk * sizeof(float)  // scales
         + (size_t)((width + 3) / 4 * 4) * sizeof(int32_t);          // table
}
__host__ __device__ inline size_t tile_smem_bytes(int D, int kv_size,
                                                  int width) {
  const int q_tile = tile_queries(tile_dmax(D));
  const int Dp = padded_dim(D, kv_size);
  size_t walk = (size_t)kTileWarps * kStages * 2 * kChunk *
                decode_row_bytes(D, kv_size);
  if (kv_size != (int)sizeof(float))
    walk += (size_t)kTileWarps * 2 * kChunk * (Dp + 4) * sizeof(float);
  const size_t merge = (size_t)kTileWarps * q_tile * (Dp + 6) * sizeof(float);
  return tile_staging_offset(Dp, q_tile, width) + (walk > merge ? walk : merge);
}

// One block of four warps per (query tile, head, row).  The tile's
// visible positions are cut into chunks of 16; warp w walks chunks w,
// w + 4, ... through its own cp.async double buffer (each position's page
// from the row's table, copied once into shared memory), with a private
// float32 online-softmax state for all the tile's queries, and only
// __syncwarp orders the walk; the four states merge through shared memory
// at the end.  Lane (qg, kg) owns queries 4 qg .. 4 qg + 3 and, of each
// chunk, keys kg, kg + kKG, ...: S = Q.K^T is a 4 x kKPL register tile of
// float4 reads (16 FMAs per 8 floats read at kKPL = 4), the softmax
// statistics are shuffles over the kKG lanes that share a query, and in
// O += P.V the lane owns its 4 queries x the head dims of float4 columns
// kg, kg + kKG, ....  Every product is an IEEE float32 fmaf; over bf16
// or int8 pages a chunk is widened to float32
// in the warp's own rows first (int8: float(k) * k_scale, the Pallas
// order), and its raw buffer is refilled at once.  Chunks wholly past the
// tile's last query are never read; the causal mask applies only on
// chunks that reach past the tile's first query or past n_pos.
//
// kDMax bounds the head dim; with kExactD it is the head dim, a constant
// the compiler sees (every loop over it unrolled, no bound tests: 18-27%
// faster at D = 64 on an H100 than under the bound, prefill_ab.py's
// bound_d variant).  Under the bound a row is staged padded to whole
// 16-byte slots (padded_dim; zeros past D, as in the decode body), so
// the float4 reads of its last head dims read zeros, and it is copied
// `copy` bytes at a time; the output's last float4 column is stored
// element by element where D is not a multiple of 4.
template <typename T, typename KV, int kDMax, bool kExactD>
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSM)
paged_attention_kernel_tile(const T* __restrict__ q,
                            const KV* __restrict__ k_pages,
                            const KV* __restrict__ v_pages,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int32_t* __restrict__ page_table,
                            const int32_t* __restrict__ index,
                            T* __restrict__ out, int Lq, int H, int head_dim,
                            int copy, int num_pages, int page_size, int width,
                            float scale) {
  constexpr bool kFloatKV = std::is_same<KV, float>::value;
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  constexpr int kElems = 16 / (int)sizeof(KV);  // elements of a 16-byte slot
  constexpr int kQ = tile_queries(kDMax);       // queries of the block
  constexpr int kQG = kQ / kTileQPL;            // query groups: 8 or 4
  constexpr int kKG = 32 / kQG;                 // lanes sharing a query: 4, 8
  constexpr int kKPL = kChunk / kKG;            // keys of a lane: 4 or 2
  constexpr int kC4 = kDMax / 4 / kKG;          // float4 columns of a lane
  constexpr int kPStride = kQ + 8;              // p_s row, in floats
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int D = kExactD ? kDMax : head_dim;
  const int Dp = kExactD ? kDMax : padded_dim(D, sizeof(KV));
  const int QS = Dp + 4;  // a float row of q_s, K or V (16 bytes of padding)
  const int row_bytes = (int)decode_row_bytes(D, sizeof(KV));
  float* q_s = reinterpret_cast<float*>(smem_raw);         // [kQ][QS]
  float* p_all = q_s + kQ * QS;                            // [warp][16][kPStride]
  float* sc_all = p_all + kTileWarps * kChunk * kPStride;  // [warp][stage][2][16]
  int32_t* table_s =
      reinterpret_cast<int32_t*>(sc_all + kTileWarps * kStages * 2 * kChunk);
  unsigned char* staging =  // [warp][stage][2][16][row]
      smem_raw + tile_staging_offset(Dp, kQ, width);
  float* conv_all = reinterpret_cast<float*>(  // [warp][2][16][QS]
      staging + (size_t)kTileWarps * kStages * 2 * kChunk * row_bytes);
  float* merge = reinterpret_cast<float*>(staging);  // [warp][kQ][QS]
  float* merge_ml = merge + kTileWarps * kQ * QS;     // [warp][kQ][m, l]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int h = blockIdx.y;
  const int r = blockIdx.z;
  const int q0 = blockIdx.x * kQ;
  const int nq = min(kQ, Lq - q0);
  const int64_t pos_stride = (int64_t)H * D;  // one position of q or a page
  const int idx = index[r];
  // positions 0 .. n_pos - 1 are the only ones a query of this tile sees
  const int n_pos = min(width * page_size, idx + q0 + nq);
  const int n_chunks = (n_pos + kChunk - 1) / kChunk;

  // this tile's queries, scaled in float32 (the Pallas kernel's q * scale;
  // rows past Lq zero-filled): every load is issued before the first
  // store, so the tile costs one round trip, not one per element
  constexpr int kQLoads = kQ * kDMax / kTileThreads;
  const T* q_row = q + ((int64_t)r * Lq + q0) * pos_stride + (int64_t)h * D;
  float q_in[kQLoads];
#pragma unroll
  for (int a = 0; a < kQLoads; ++a) {
    const int e = tid + a * kTileThreads;
    const int qq = e / kDMax, d = e % kDMax;
    q_in[a] = qq < nq && d < D ? to_float(q_row[qq * pos_stride + d]) : 0.f;
  }
  // the row's whole table, not waiting on index[r]
  const int32_t* table_row = page_table + (int64_t)r * width;
  for (int i = tid; i < width; i += kTileThreads)
    table_s[i] = min(max(table_row[i], 0), num_pages - 1);
#pragma unroll
  for (int a = 0; a < kQLoads; ++a) {
    const int e = tid + a * kTileThreads;
    const int d = e % kDMax;
    if (d < Dp) q_s[(e / kDMax) * QS + d] = q_in[a] * scale;  // 0 past D
  }

  // a position's table entry and place in its page: a shift and a mask
  // where the page size is a power of two (the engine's 16)
  const int shift =
      (page_size & (page_size - 1)) ? -1 : __ffs(page_size) - 1;
  auto page_of = [&](int pos) {
    return shift >= 0 ? pos >> shift : pos / page_size;
  };
  auto row_in_page = [&](int pos) {
    return shift >= 0 ? pos & (page_size - 1) : pos % page_size;
  };
  // 16-byte slots of one staged position: chunks_per_row of them, laid
  // out over kRowSlots (a compile-time power of two) so that the copy
  // loops split an index with a shift and a mask
  const int data_bytes = D * (int)sizeof(KV);  // a stored K/V row
  const int chunks_per_row = Dp / kElems;
  constexpr int kRowSlots = kDMax / kElems;
  // (a head dim of 32, 64 or 128 makes whole 16-byte slots of any type)
  const int granule = kExactD ? 16 : copy;
  float* p_s = p_all + warp * kChunk * kPStride;
  float* sc_w = sc_all + warp * kStages * 2 * kChunk;
  unsigned char* st_w =
      staging + (size_t)warp * kStages * 2 * kChunk * row_bytes;
  float* conv_w = conv_all + (size_t)warp * 2 * kChunk * QS;
  // the padding of this warp's staged rows is zero for the whole walk
  if (!kExactD)
    zero_padding(st_w, kStages * 2 * kChunk, row_bytes, data_bytes,
                 Dp * (int)sizeof(KV), lane, 32);
  __syncthreads();

  // queue chunk ci's K, V (and scales) into stage s, then commit a group
  // (an empty one past the tile's last chunk, so every step waits the
  // same way); positions past n_pos are zero-filled
  auto issue = [&](int ci, int s) {
    if (ci < n_chunks) {
      unsigned char* kb = st_w + (size_t)(2 * s) * kChunk * row_bytes;
      unsigned char* vb = kb + (size_t)kChunk * row_bytes;
      with_slot_copy(data_bytes, granule, [&](auto slot) {
#pragma unroll
        for (int e = lane; e < kChunk * kRowSlots; e += 32) {
          const int j = e / kRowSlots, c = e % kRowSlots;
          if (c >= chunks_per_row) continue;
          const int pos = ci * kChunk + j;
          const bool ok = pos < n_pos;
          int64_t off = 0;
          if (ok)
            off = ((int64_t)table_s[page_of(pos)] * page_size +
                   row_in_page(pos)) * pos_stride +
                  (int64_t)h * D;
          slot(kb + j * row_bytes,
               reinterpret_cast<const unsigned char*>(k_pages + off), c, ok);
          slot(vb + j * row_bytes,
               reinterpret_cast<const unsigned char*>(v_pages + off), c, ok);
        }
      });
      if (kInt8 && lane < kChunk) {
        const int pos = ci * kChunk + lane;
        const bool ok = pos < n_pos;
        const int64_t off =
            ok ? (int64_t)table_s[page_of(pos)] * H + h : 0;
        cp_async4(sc_w + (2 * s) * kChunk + lane, k_scale + off, ok);
        cp_async4(sc_w + (2 * s + 1) * kChunk + lane, v_scale + off, ok);
      }
    }
    cp_async_commit();
  };

  const int qg = lane / kKG;
  const int kg = lane % kKG;
  float m[kTileQPL], l[kTileQPL], acc[kTileQPL][kC4][4];
#pragma unroll
  for (int i = 0; i < kTileQPL; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }
  const int tile_first = idx + q0;              // the tile's first query
  const int lane_first = tile_first + qg * kTileQPL;  // ... and this lane's
  const float* q_lane = q_s + qg * kTileQPL * QS;

#pragma unroll
  for (int s = 0; s < kStages; ++s) issue(warp + s * kTileWarps, s);
  for (int t = 0;; ++t) {
    const int ci = warp + t * kTileWarps;
    if (ci >= n_chunks) break;
    const int s = t % kStages;
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* kraw = st_w + (size_t)(2 * s) * kChunk * row_bytes;
    const unsigned char* vraw = kraw + (size_t)kChunk * row_bytes;
    const float* kb;
    const float* vb;
    if constexpr (kFloatKV) {
      kb = reinterpret_cast<const float*>(kraw);
      vb = reinterpret_cast<const float*>(vraw);
    } else {
      // the chunk in float32 (int8: float(k) * k_scale, before q meets it)
      const float* ksc = sc_w + (2 * s) * kChunk;
#pragma unroll
      for (int e = lane; e < 2 * kChunk * kRowSlots; e += 32) {
        const int which = e / (kChunk * kRowSlots);
        const int j = (e / kRowSlots) % kChunk, c = e % kRowSlots;
        if (c >= chunks_per_row) continue;
        float f[kElems];
        unpack16(*reinterpret_cast<const uint4*>(
                     (which ? vraw : kraw) + j * row_bytes + c * 16),
                 f, KV());
        if (kInt8) {
          const float sc = ksc[which * kChunk + j];
#pragma unroll
          for (int x = 0; x < kElems; ++x) f[x] *= sc;
        }
        float4* dst = reinterpret_cast<float4*>(
            conv_w + (which * kChunk + j) * QS + c * kElems);
#pragma unroll
        for (int x = 0; x < kElems / 4; ++x)
          dst[x] = make_float4(f[4 * x], f[4 * x + 1], f[4 * x + 2],
                               f[4 * x + 3]);
      }
      __syncwarp();
      issue(ci + kStages * kTileWarps, s);  // the raw stage is read: refill
      kb = conv_w;
      vb = conv_w + kChunk * QS;
    }

    // S = Q.K^T: queries 4 qg + i against keys kg + kKG j
    float sc[kTileQPL][kKPL];
#pragma unroll
    for (int i = 0; i < kTileQPL; ++i)
#pragma unroll
      for (int j = 0; j < kKPL; ++j) sc[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < kDMax / 4; ++c) {
      if (4 * c < D) {
        float4 qv[kTileQPL], kv[kKPL];
#pragma unroll
        for (int i = 0; i < kTileQPL; ++i)
          qv[i] = *reinterpret_cast<const float4*>(q_lane + i * QS + 4 * c);
#pragma unroll
        for (int j = 0; j < kKPL; ++j)
          kv[j] = *reinterpret_cast<const float4*>(kb + (kg + kKG * j) * QS +
                                                   4 * c);
#pragma unroll
        for (int i = 0; i < kTileQPL; ++i)
#pragma unroll
          for (int j = 0; j < kKPL; ++j) {
            sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
            sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
            sc[i][j] = fmaf(qv[i].z, kv[j].z, sc[i][j]);
            sc[i][j] = fmaf(qv[i].w, kv[j].w, sc[i][j]);
          }
      }
    }

    // online softmax, per query, over the kKG lanes that share it
    const int base = ci * kChunk;
    const bool masked = base + kChunk - 1 > tile_first || base + kChunk > n_pos;
    float corr[kTileQPL];
#pragma unroll
    for (int i = 0; i < kTileQPL; ++i) {
      float cm = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKPL; ++j) {
        const int pos = base + kg + kKG * j;
        if (masked && (pos > lane_first + i || pos >= n_pos))
          sc[i][j] = -INFINITY;
        cm = fmaxf(cm, sc[i][j]);
      }
#pragma unroll
      for (int o = kKG / 2; o > 0; o >>= 1)
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
      const float m_new = fmaxf(m[i], cm);
      float cs = 0.f;
#pragma unroll
      for (int j = 0; j < kKPL; ++j) {
        const float p = sc[i][j] == -INFINITY ? 0.f : expf(sc[i][j] - m_new);
        sc[i][j] = p;
        cs += p;
      }
#pragma unroll
      for (int o = kKG / 2; o > 0; o >>= 1)
        cs += __shfl_xor_sync(0xffffffffu, cs, o);
      corr[i] = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + cs;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kKPL; ++j)
      *reinterpret_cast<float4*>(p_s + (kg + kKG * j) * kPStride +
                                 qg * kTileQPL) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
#pragma unroll
    for (int i = 0; i < kTileQPL; ++i)
#pragma unroll
      for (int c = 0; c < kC4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr[i];
    __syncwarp();

    // O += P.V over the chunk's 16 positions (zero-filled past n_pos)
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const float4 p =
          *reinterpret_cast<const float4*>(p_s + j * kPStride + qg * kTileQPL);
      const float* vrow = vb + j * QS;
#pragma unroll
      for (int c = 0; c < kC4; ++c) {
        const int col = kg + kKG * c;
        if (4 * col < D) {
          const float4 v = *reinterpret_cast<const float4*>(vrow + 4 * col);
          const float pv[kTileQPL] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int i = 0; i < kTileQPL; ++i) {
            acc[i][c][0] = fmaf(pv[i], v.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pv[i], v.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pv[i], v.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pv[i], v.w, acc[i][c][3]);
          }
        }
      }
    }
    __syncwarp();  // p_s and the stage are read
    if constexpr (kFloatKV) issue(ci + kStages * kTileWarps, s);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp's buffers are read; the merge reuses them

  // merge the warps' (m, l, acc); a warp that walked nothing has m = -inf
#pragma unroll
  for (int i = 0; i < kTileQPL; ++i) {
    const int row = warp * kQ + qg * kTileQPL + i;
    if (kg == 0) {
      merge_ml[2 * row] = m[i];
      merge_ml[2 * row + 1] = l[i];
    }
#pragma unroll
    for (int c = 0; c < kC4; ++c) {
      const int col = kg + kKG * c;
      if (4 * col < D)
        *reinterpret_cast<float4*>(merge + row * QS + 4 * col) = make_float4(
            acc[i][c][0], acc[i][c][1], acc[i][c][2], acc[i][c][3]);
    }
  }
  __syncthreads();
  // each query's weights exp(m_w - max) and the sum they weight, once
  // (p_s is free now): [kQ][kTileWarps + 1]
  float* wts = p_all;
  if (tid < kQ) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w)
      mx = fmaxf(mx, merge_ml[2 * (w * kQ + tid)]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) {
      const float* st = merge_ml + 2 * (w * kQ + tid);
      const float wt = st[0] == -INFINITY ? 0.f : expf(st[0] - mx);
      wts[tid * (kTileWarps + 1) + w] = wt;
      sum = fmaf(st[1], wt, sum);
    }
    wts[tid * (kTileWarps + 1) + kTileWarps] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  // acc / max(l, 1e-30), four head dims a thread at a time
  T* o_row = out + ((int64_t)r * Lq + q0) * pos_stride + (int64_t)h * D;
  constexpr int kD4 = kDMax / 4;
#pragma unroll
  for (int a = 0; a < kQ * kD4 / kTileThreads; ++a) {
    const int e = tid + a * kTileThreads;
    const int qq = e / kD4, c4 = e % kD4;
    if (qq < nq && 4 * c4 < D) {
      const float* wq = wts + qq * (kTileWarps + 1);
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kTileWarps; ++w) {
        const float4 x = *reinterpret_cast<const float4*>(
            merge + (w * kQ + qq) * QS + 4 * c4);
        o.x = fmaf(x.x, wq[w], o.x);
        o.y = fmaf(x.y, wq[w], o.y);
        o.z = fmaf(x.z, wq[w], o.z);
        o.w = fmaf(x.w, wq[w], o.w);
      }
      const float sum = wq[kTileWarps];
      const float4 y = make_float4(o.x / sum, o.y / sum, o.z / sum, o.w / sum);
      T* dst = o_row + qq * pos_stride + 4 * c4;
      if (D % 4 == 0) {  // then every row's float4 columns are aligned
        store4(dst, y);
      } else {
        const float ys[4] = {y.x, y.y, y.z, y.w};
        for (int x = 0; x < 4 && 4 * c4 + x < D; ++x)
          dst[x] = from_float<T>(ys[x]);
      }
    }
  }
}

template <typename T, typename KV, int kDMax, bool kExactD>
cudaError_t launch_tile_dim(const void* q, const void* k, const void* v,
                            const float* k_scale, const float* v_scale,
                            const int32_t* table, const int32_t* index,
                            void* out, int R, int Lq, int H, int D, int copy,
                            int num_pages, int page_size, int width,
                            float scale, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(D, sizeof(KV), width);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel_tile<T, KV, kDMax, kExactD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  constexpr int kQ = tile_queries(kDMax);
  const dim3 grid((Lq + kQ - 1) / kQ, H, R);
  paged_attention_kernel_tile<T, KV, kDMax, kExactD>
      <<<grid, kTileThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const KV*>(k),
          static_cast<const KV*>(v), k_scale, v_scale, table, index,
          static_cast<T*>(out), Lq, H, D, copy, num_pages, page_size, width,
          scale);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t launch_register_tile(const void* q, const void* k, const void* v,
                                 const float* k_scale, const float* v_scale,
                                 const int32_t* table, const int32_t* index,
                                 void* out, int R, int Lq, int H, int D,
                                 int copy, int num_pages, int page_size,
                                 int width, float scale, cudaStream_t stream) {
#define SKY_TILE_CASE(d_max, exact)                                          \
  return launch_tile_dim<T, KV, d_max, exact>(                              \
      q, k, v, k_scale, v_scale, table, index, out, R, Lq, H, D, copy,      \
      num_pages, page_size, width, scale, stream)
  switch (D) {
    case 32:
      SKY_TILE_CASE(32, true);
    case 64:
      SKY_TILE_CASE(64, true);
    case 128:
      SKY_TILE_CASE(128, true);
  }
  switch (tile_dmax(D)) {
    case 32:
      SKY_TILE_CASE(32, false);
    case 64:
      SKY_TILE_CASE(64, false);
    default:
      SKY_TILE_CASE(128, false);
  }
#undef SKY_TILE_CASE
}

// the decode body's query bound: 1 (decode), 8 (speculative verify) or 16
int decode_max_q(int Lq) { return Lq == 1 ? 1 : (Lq <= 8 ? 8 : kMaxDecodeQ); }

// p is aligned to `bytes`
bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// body: 0 = the decode body (Lq <= 16), 1 = the tensor-core prefill body
// (T bf16, D and page_size multiples of 16), 2 = the register-tile body;
// copy: the granule of a K/V row, copy_granule(D * sizeof(KV))
template <typename T, typename KV>
cudaError_t launch(int body, const void* q, const void* k,
                   const void* v, const float* k_scale, const float* v_scale,
                   const int32_t* table, const int32_t* index, void* out,
                   int R, int Lq, int H, int D, int copy, int num_pages,
                   int page_size, int width, float scale,
                   cudaStream_t stream) {
  if (copy != copy_granule(D * (int)sizeof(KV)) || !aligned(k, copy) ||
      !aligned(v, copy))
    return cudaErrorInvalidValue;
  if (body == 2)
    return launch_register_tile<T, KV>(q, k, v, k_scale, v_scale, table,
                                       index, out, R, Lq, H, D, copy,
                                       num_pages, page_size, width, scale,
                                       stream);
  if (body == 1) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (D % 16 != 0 || page_size % 16 != 0 || !aligned(q, 16) ||
          !aligned(out, 16))
        return cudaErrorInvalidValue;
      return launch_mma<KV>(q, k, v, k_scale, v_scale, table, index, out, R,
                            Lq, H, D, num_pages, page_size, width, scale,
                            stream);
    }
    return cudaErrorInvalidValue;  // the body takes bfloat16 q only
  }
  if (body != 0 || Lq > kMaxDecodeQ) return cudaErrorInvalidValue;
  switch (decode_max_q(Lq)) {
    case 1:
      return launch_decode_q<T, KV, 1>(q, k, v, k_scale, v_scale, table,
                                       index, out, R, Lq, H, D, copy,
                                       num_pages, page_size, width, scale,
                                       stream);
    case 8:
      return launch_decode_q<T, KV, 8>(q, k, v, k_scale, v_scale, table,
                                       index, out, R, Lq, H, D, copy,
                                       num_pages, page_size, width, scale,
                                       stream);
    default:
      return launch_decode_q<T, KV, kMaxDecodeQ>(
          q, k, v, k_scale, v_scale, table, index, out, R, Lq, H, D, copy,
          num_pages, page_size, width, scale, stream);
  }
}

bool bad_shape(int R, int Lq, int H, int D, int num_pages, int page_size,
               int width) {
  return D < 1 || D > kMaxHeadDim || R < 1 || R > 65535 || H < 1 ||
         H > 65535 || Lq < 1 || width < 1 || num_pages < 1 || page_size < 1;
}

}  // namespace

extern "C" {

// body: 0 = the decode body (Lq <= 16), 1 = the tensor-core prefill body
// (bfloat16, D and page_size multiples of 16, q and out 16-byte aligned),
// 2 = the register-tile body; the Python wrapper picks it.  copy: the
// bytes a K/V row is copied in, copy_granule(D * page element size) (the
// wrapper's row plan), the pages aligned to it.  dtype: 0 = float32, 1 =
// bfloat16.  Returns a cudaError_t (0 = launched).  Shapes are checked by
// the Python wrapper; this rejects only what the chosen body cannot hold.
int sky_paged_attention(int body, int dtype, const void* q,
                        const void* k_pages, const void* v_pages,
                        const void* page_table, const void* index, void* out,
                        int R, int Lq, int H, int D, int copy, int num_pages,
                        int page_size, int width, float scale, void* stream) {
  if (bad_shape(R, Lq, H, D, num_pages, page_size, width))
    return (int)cudaErrorInvalidValue;
  const int32_t* table = static_cast<const int32_t*>(page_table);
  const int32_t* idx = static_cast<const int32_t*>(index);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float, float>(body, q, k_pages, v_pages, nullptr,
                                       nullptr, table, idx, out, R, Lq, H, D,
                                       copy, num_pages, page_size, width,
                                       scale, s);
    case 1:
      return (int)launch<__nv_bfloat16, __nv_bfloat16>(
          body, q, k_pages, v_pages, nullptr, nullptr, table, idx, out, R, Lq,
          H, D, copy, num_pages, page_size, width, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The int8 pool: k/v pages int8, k_scale/v_scale float32 [num_pages, H];
// body and dtype (of q and out) as above.
int sky_paged_attention_int8(int body, int dtype, const void* q,
                             const void* k_pages, const void* v_pages,
                             const void* k_scale, const void* v_scale,
                             const void* page_table, const void* index,
                             void* out, int R, int Lq, int H, int D,
                             int copy, int num_pages, int page_size,
                             int width, float scale, void* stream) {
  if (bad_shape(R, Lq, H, D, num_pages, page_size, width))
    return (int)cudaErrorInvalidValue;
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  const int32_t* table = static_cast<const int32_t*>(page_table);
  const int32_t* idx = static_cast<const int32_t*>(index);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float, int8_t>(body, q, k_pages, v_pages, ksc, vsc,
                                        table, idx, out, R, Lq, H, D, copy,
                                        num_pages, page_size, width, scale,
                                        s);
    case 1:
      return (int)launch<__nv_bfloat16, int8_t>(
          body, q, k_pages, v_pages, ksc, vsc, table, idx, out, R, Lq, H, D,
          copy, num_pages, page_size, width, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory, in bytes, of one block of the given body for a
// page element of kv_size bytes (4, 2 or 1).
int sky_paged_attention_smem(int body, int kv_size, int Lq, int D,
                             int width) {
  if (body == 1) return (int)mma_smem_bytes(D, kv_size, width);
  if (body == 2) return (int)tile_smem_bytes(D, kv_size, width);
  const int max_q = decode_max_q(Lq);
  const int warps = decode_warps(D, kv_size, max_q, width);
  return warps ? (int)decode_smem_bytes(D, kv_size, max_q, width, warps) : -1;
}

}  // extern "C"
