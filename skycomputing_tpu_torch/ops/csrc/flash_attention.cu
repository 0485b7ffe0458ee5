// Non-causal softmax attention with an additive per-key bias (flash
// attention): out = softmax(q * scale . k^T + bias) . v, per (batch, head).
//
// Replaces the Pallas kernel of skycomputing_tpu/ops/flash_attention.py:
// _flash_kernel, launched by _flash_forward's pl.pallas_call.  Same
// contract: q, k, v [B, L, H, D] in float32 or bfloat16, contiguous;
// bias [B, L] float32 (the model-dtype mask row, widened exactly by the
// wrapper), added to every query's score of that key; out [B, L, H, D]
// in q's dtype.  q is scaled by `scale` in float32 before the product
// (the Pallas kernel's q.astype(f32) * scale), the bias is added in
// float32, and the running max, running sum and accumulator are float32;
// the output is acc / max(l, 1e-30) rounded to q's dtype.  The bias is
// an ordinary additive term: a key with bias -1e4 still counts, so a row
// whose every key is masked gets a uniform softmax, as on the TPU.  Keys
// past L in the last tile are excluded by their index, never by a bias.
//
// What bounds it on an H100: at BERT's shapes (L = 128, D = 64) the work
// is 4*L*L*D flops per (batch, head) against (4*L*D + L) elements of
// q, k, v, out and bias: 128 flops per element, 64 per bf16 byte, below
// the card's ~295 flops per byte, so the bound is the bytes.  This
// kernel does its products on the float32 CUDA cores, not the tensor
// cores, and reads its operands from shared memory: shared-memory loads
// and float32 FMAs bound it, well above the byte bound.
//
// What the design does about it: one thread block per (batch, head,
// tile of 32 queries) walks K/V in tiles of 64 keys, staging each tile
// once through shared memory (converted to float32 as it is staged) and
// folding it into a float32 online softmax; the [L, L] score matrix
// never reaches device memory.  Each thread owns a 4 x 4 block of scores
// and a 4 x (D/16) block of the accumulator, so every value it loads
// from shared memory feeds four FMAs.  On the TPU the K/V walk was a
// fori_loop over VMEM blocks of one grid cell; here it is a loop inside
// one block, and blocks share nothing.  No wgmma, TMA or mma.sync yet.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see skycomputing_tpu_torch/ops/_build.py) and bound
// with ctypes through the plain C function at the end of this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // four warps
constexpr int kQTile = 32;              // queries of one (batch, head) per block
constexpr int kKTile = 64;              // keys staged per step
constexpr int kMaxHeadDim = 128;
constexpr int kTx = 16;                 // threads along keys and head dims
constexpr int kTy = kThreads / kTx;     // 8 threads along queries
constexpr int kRows = kQTile / kTy;     // 4 queries per thread
constexpr int kCols = kKTile / kTx;     // 4 keys per thread
constexpr int kPs = kKTile + 1;         // padded row of the score tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// Shared memory, in floats.  q and k rows are padded by one so that
// threads reading neighbouring rows at the same head dim hit distinct
// banks; the score rows likewise.
__host__ __device__ inline size_t smem_floats(int D) {
  const int Dp = D + 1;
  return (size_t)kQTile * Dp      // qs
         + (size_t)kKTile * Dp    // ks
         + (size_t)kKTile * D     // vs
         + (size_t)kQTile * kPs   // scores, then probabilities
         + kKTile                 // bias of the key tile
         + 3 * kQTile;            // running max, sum, correction
}

// kDims: head dims per thread (D <= 16 * kDims).  Thread (tx, ty) owns
// queries ty + kTy * r (r < kRows), keys tx + kTx * c (c < kCols) of the
// score tile and head dims tx + kTx * c (c < kDims) of the accumulator.
template <typename T, int kDims>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       T* __restrict__ out, int L, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* qs = smem;
  float* ks = qs + kQTile * Dp;
  float* vs = ks + kKTile * Dp;
  float* ps = vs + kKTile * D;
  float* bs = ps + kQTile * kPs;
  float* m_s = bs + kKTile;
  float* l_s = m_s + kQTile;
  float* c_s = l_s + kQTile;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kQTile;
  const int nq = min(kQTile, L - q0);
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t pos_stride = (int64_t)H * D;  // one position of q, k, v
  const int64_t base = (int64_t)b * L * pos_stride + (int64_t)h * D;
  const float* bias_row = bias + (int64_t)b * L;

  // this tile's queries, scaled in float32; rows past L are zero
  for (int e = tid; e < kQTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    qs[r * Dp + d] =
        r < nq ? to_float(q[base + (int64_t)(q0 + r) * pos_stride + d]) * scale
               : 0.f;
  }
  if (tid < kQTile) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[kRows][kDims];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < L; k0 += kKTile) {
    const int nk = min(kKTile, L - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < kKTile * D; e += kThreads) {
      const int j = e / D, d = e % D;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const int64_t off = base + (int64_t)(k0 + j) * pos_stride + d;
        kv = to_float(k[off]);
        vv = to_float(v[off]);
      }
      ks[j * Dp + d] = kv;
      vs[j * D + d] = vv;
    }
    if (tid < kKTile) bs[tid] = tid < nk ? bias_row[k0 + tid] : 0.f;
    __syncthreads();

    // scores (q * scale) . k + bias; keys past L are -inf by index
    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = qs[(ty + kTy * r) * Dp + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = ks[(tx + kTx * c) * Dp + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = tx + kTx * c;
        ps[(ty + kTy * r) * kPs + j] = j < nk ? s[r][c] + bs[j] : -INFINITY;
      }
    __syncthreads();

    // online softmax statistics, one warp per query row
    for (int r = warp; r < kQTile; r += kThreads / 32) {
      float* prow = ps + r * kPs;
      float mx = -INFINITY;
      for (int j = lane; j < kKTile; j += 32) mx = fmaxf(mx, prow[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kKTile; j += 32) {
        const float sc = prow[j];
        const float p = (sc == -INFINITY) ? 0.f : expf(sc - m_new);
        prow[j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        // the first tile holds key 0, so m_new is finite from then on;
        // the guard keeps exp(-inf - -inf) out all the same
        const float corr = (m_new == -INFINITY) ? 1.f : expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * correction + p . v
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float corr = c_s[ty + kTy * r];
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[r][c] *= corr;
    }
    for (int j = 0; j < nk; ++j) {
      float pv[kRows], vv[kDims];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = ps[(ty + kTy * r) * kPs + j];
#pragma unroll
      for (int c = 0; c < kDims; ++c) {
        const int d = tx + kTx * c;
        vv[c] = d < D ? vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kDims; ++c)
          acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = ty + kTy * r;
    if (row < nq) {
      const float denom = fmaxf(l_s[row], 1e-30f);
      T* o_row = out + base + (int64_t)(q0 + row) * pos_stride;
#pragma unroll
      for (int c = 0; c < kDims; ++c) {
        const int d = tx + kTx * c;
        if (d < D) o_row[d] = from_float<T>(acc[r][c] / denom);
      }
    }
  }
}

template <typename T, int kDims>
cudaError_t launch_dims(const void* q, const void* k, const void* v,
                        const float* bias, void* out, int B, int L, int H,
                        int D, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, kDims>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((L + kQTile - 1) / kQTile, H, B);
  flash_attention_kernel<T, kDims><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), L, H, D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* out, int B, int L, int H, int D,
                   float scale, cudaStream_t stream) {
  // half the accumulator registers where the head is at most 64 wide
  if (D <= 4 * kTx)
    return launch_dims<T, 4>(q, k, v, bias, out, B, L, H, D, scale, stream);
  return launch_dims<T, kMaxHeadDim / kTx>(q, k, v, bias, out, B, L, H, D,
                                           scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  bias is float32
// [B, L].  Returns a cudaError_t (0 = launched).  Shapes are checked by
// the Python wrapper; this rejects only what the kernel cannot hold.
int sky_flash_attention(int dtype, const void* q, const void* k,
                        const void* v, const void* bias, void* out, int B,
                        int L, int H, int D, float scale, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || L < 1 || D < 1 ||
      D > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  const float* bias_f = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(q, k, v, bias_f, out, B, L, H, D, scale, s);
    case 1:
      return (int)launch<__nv_bfloat16>(q, k, v, bias_f, out, B, L, H, D,
                                        scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
