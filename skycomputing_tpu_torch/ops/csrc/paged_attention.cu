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
// q's dtype.
//
// What bounds it on an H100: the K/V bytes it reads.  A decode step
// (Lq = 1) does 4*D flops per key position against 2*D*sizeof(KV) bytes
// of K/V, far below the card's ~295 flops per byte, so it is memory
// bound; prefill tiles of 16 queries stay below that line too.  The int8
// pool halves those bytes against bf16 (plus 8 bytes of scales per page
// and head); its pages are dequantized as they are staged into shared
// memory, so no dequantized copy ever goes to device memory.
//
// What the design does about it: each K/V page tile is read from device
// memory once per (row, head, tile of 16 queries) and staged through
// shared memory, where every query of the tile reuses it; pages wholly
// past the tile's last query position are never read; the score matrix
// and the running statistics never leave the block.  On the TPU the
// page walk was a grid axis carrying its state in VMEM scratch; here
// blocks run in no order and share nothing, so the walk is a loop
// inside one block.  Loads are scalar and no wgmma or TMA is used yet.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see skycomputing_tpu_torch/ops/_build.py) and bound
// with ctypes through the plain C functions at the end of this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;     // four warps
constexpr int kQueryTile = 16;    // queries of one row and head per block
constexpr int kMaxHeadDim = 128;  // the accumulator lives in registers
constexpr int kAccPerThread = kQueryTile * kMaxHeadDim / kThreads;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared memory, in floats.  q and k rows are padded by one so that the
// score loop, where neighbouring threads read neighbouring key rows, hits
// distinct banks.
__host__ __device__ inline size_t smem_floats(int D, int page_size) {
  const int Dp = D + 1;
  return (size_t)kQueryTile * Dp       // qs
         + (size_t)page_size * Dp      // ks
         + (size_t)page_size * D       // vs
         + (size_t)kQueryTile * page_size  // scores, then probabilities
         + 3 * kQueryTile;             // running max, sum, correction
}

// T: q and output type.  KV: stored page type, T itself or int8_t; an
// int8 page is multiplied by its (page, head) scale as it is staged
// (k_scale/v_scale are read only when KV is int8_t).
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                       const KV* __restrict__ v_pages,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int32_t* __restrict__ page_table,
                       const int32_t* __restrict__ index, T* __restrict__ out,
                       int Lq, int H, int D, int num_pages, int page_size,
                       int width, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* qs = smem;
  float* ks = qs + kQueryTile * Dp;
  float* vs = ks + page_size * Dp;
  float* ps = vs + page_size * D;
  float* m_s = ps + kQueryTile * page_size;
  float* l_s = m_s + kQueryTile;
  float* c_s = l_s + kQueryTile;

  const int h = blockIdx.y;
  const int r = blockIdx.z;
  const int q0 = blockIdx.x * kQueryTile;
  const int nq = min(kQueryTile, Lq - q0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int idx = index[r];
  const int64_t pos_stride = (int64_t)H * D;  // one position of q or a page

  // this tile's queries, scaled in float32 (the Pallas kernel's q * scale)
  const T* q_row = q + ((int64_t)r * Lq + q0) * pos_stride + (int64_t)h * D;
  for (int e = tid; e < nq * D; e += kThreads) {
    const int qq = e / D, d = e % D;
    qs[qq * Dp + d] = to_float(q_row[qq * pos_stride + d]) * scale;
  }
  if (tid < kQueryTile) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) acc[a] = 0.f;

  // pages wholly past the tile's last query hold nothing it may see.  The
  // walk runs in order from page 0, whose position 0 every query sees, so
  // the running max is finite after the first page; the guards below keep
  // exp(-inf - -inf) out all the same.
  const int last_pos = idx + q0 + nq - 1;
  const int n_pages = min(width, last_pos / page_size + 1);
  const int32_t* table_row = page_table + (int64_t)r * width;
  for (int i = 0; i < n_pages; ++i) {
    const int phys = min(max(table_row[i], 0), num_pages - 1);
    const KV* k_page = k_pages + (int64_t)phys * page_size * pos_stride +
                       (int64_t)h * D;
    const KV* v_page = v_pages + (int64_t)phys * page_size * pos_stride +
                       (int64_t)h * D;
    __syncthreads();  // the previous page's tiles are no longer read
    if constexpr (std::is_same<KV, int8_t>::value) {
      // the Pallas kernel's k.astype(f32) * k_scale, in the same order
      const float k_sc = k_scale[(int64_t)phys * H + h];
      const float v_sc = v_scale[(int64_t)phys * H + h];
      for (int e = tid; e < page_size * D; e += kThreads) {
        const int j = e / D, d = e % D;
        ks[j * Dp + d] = to_float(k_page[j * pos_stride + d]) * k_sc;
        vs[j * D + d] = to_float(v_page[j * pos_stride + d]) * v_sc;
      }
    } else {
      for (int e = tid; e < page_size * D; e += kThreads) {
        const int j = e / D, d = e % D;
        ks[j * Dp + d] = to_float(k_page[j * pos_stride + d]);
        vs[j * D + d] = to_float(v_page[j * pos_stride + d]);
      }
    }
    __syncthreads();

    // scores, masked by logical position
    for (int e = tid; e < nq * page_size; e += kThreads) {
      const int qq = e / page_size, j = e % page_size;
      float s = -INFINITY;
      if (i * page_size + j <= idx + q0 + qq) {
        const float* qv = qs + qq * Dp;
        const float* kv = ks + j * Dp;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qv[d], kv[d], dot);
        s = dot;
      }
      ps[e] = s;
    }
    __syncthreads();

    // online softmax statistics, one warp per query
    for (int qq = warp; qq < nq; qq += kThreads / 32) {
      float* prow = ps + qq * page_size;
      float mx = -INFINITY;
      for (int j = lane; j < page_size; j += 32) mx = fmaxf(mx, prow[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[qq];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < page_size; j += 32) {
        const float s = prow[j];
        const float p = (s == -INFINITY) ? 0.f : expf(s - m_new);
        prow[j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr =
            (m_new == -INFINITY) ? 1.f : expf(m_prev - m_new);
        c_s[qq] = corr;
        l_s[qq] = l_s[qq] * corr + sum;
        m_s[qq] = m_new;
      }
    }
    __syncthreads();

    // accumulator: thread tid owns elements tid + a * kThreads of [nq, D]
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int e = tid + a * kThreads;
      if (e < nq * D) {
        const int qq = e / D, d = e % D;
        const float* prow = ps + qq * page_size;
        float pv = 0.f;
        for (int j = 0; j < page_size; ++j) pv = fmaf(prow[j], vs[j * D + d], pv);
        acc[a] = acc[a] * c_s[qq] + pv;
      }
    }
  }
  __syncthreads();

  T* o_row = out + ((int64_t)r * Lq + q0) * pos_stride + (int64_t)h * D;
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int e = tid + a * kThreads;
    if (e < nq * D) {
      const int qq = e / D, d = e % D;
      o_row[qq * pos_stride + d] = from_float<T>(acc[a] / fmaxf(l_s[qq], 1e-30f));
    }
  }
}

template <typename T, typename KV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const int32_t* table, const int32_t* index, void* out,
                   int R, int Lq, int H, int D, int num_pages, int page_size,
                   int width, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(D, page_size) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Lq + kQueryTile - 1) / kQueryTile, H, R);
  paged_attention_kernel<T, KV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), k_scale, v_scale, table, index,
      static_cast<T*>(out), Lq, H, D, num_pages, page_size, width, scale);
  return cudaGetLastError();
}

bool bad_shape(int R, int Lq, int H, int D, int num_pages, int page_size,
               int width) {
  return D < 1 || D > kMaxHeadDim || R < 1 || R > 65535 || H < 1 ||
         H > 65535 || Lq < 1 || width < 1 || num_pages < 1 || page_size < 1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
// Shapes are checked by the Python wrapper; this rejects only what the
// kernel itself cannot hold.
int sky_paged_attention(int dtype, const void* q, const void* k_pages,
                        const void* v_pages, const void* page_table,
                        const void* index, void* out, int R, int Lq, int H,
                        int D, int num_pages, int page_size, int width,
                        float scale, void* stream) {
  if (bad_shape(R, Lq, H, D, num_pages, page_size, width))
    return (int)cudaErrorInvalidValue;
  const int32_t* table = static_cast<const int32_t*>(page_table);
  const int32_t* idx = static_cast<const int32_t*>(index);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float, float>(q, k_pages, v_pages, nullptr, nullptr,
                                       table, idx, out, R, Lq, H, D,
                                       num_pages, page_size, width, scale, s);
    case 1:
      return (int)launch<__nv_bfloat16, __nv_bfloat16>(
          q, k_pages, v_pages, nullptr, nullptr, table, idx, out, R, Lq, H, D,
          num_pages, page_size, width, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The int8 pool: k/v pages int8, k_scale/v_scale float32 [num_pages, H];
// dtype (of q and out) as above.
int sky_paged_attention_int8(int dtype, const void* q, const void* k_pages,
                             const void* v_pages, const void* k_scale,
                             const void* v_scale, const void* page_table,
                             const void* index, void* out, int R, int Lq,
                             int H, int D, int num_pages, int page_size,
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
      return (int)launch<float, int8_t>(q, k_pages, v_pages, ksc, vsc, table,
                                        idx, out, R, Lq, H, D, num_pages,
                                        page_size, width, scale, s);
    case 1:
      return (int)launch<__nv_bfloat16, int8_t>(
          q, k_pages, v_pages, ksc, vsc, table, idx, out, R, Lq, H, D,
          num_pages, page_size, width, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
