// Non-causal softmax attention with an additive per-key bias (flash
// attention): out = softmax(q * scale . k^T + bias) . v, per (batch, head).
//
// Replaces the Pallas kernel of skycomputing_tpu/ops/flash_attention.py:
// _flash_kernel, launched by _flash_forward's pl.pallas_call.  Same
// contract: q, k, v [B, L, H, D] in float32 or bfloat16, contiguous;
// bias [B, L] in float32 or bfloat16, read in its stored type at the
// strides it is given (no widened copy is made), added in float32 to
// every query's score of that key; out [B, L, H, D] in q's dtype.  The
// scores are scaled by `scale` in float32, the bias is added in float32,
// and the running max, running sum and accumulator are float32; the
// output is acc / max(l, 1e-30) rounded to q's dtype.  The bias is an
// ordinary additive term: a key with bias -1e4 still counts, so a row
// whose every key is masked gets a uniform softmax, as on the TPU.  Keys
// past L in the last tile are excluded by their index, never by a bias.
//
// What bounds it on an H100: at BERT's shapes (L = 128, D = 64) the work
// is 4*L*L*D flops per (batch, head) against (4*L*D + L) elements of
// q, k, v, out and bias: 128 flops per element, 64 per bf16 byte, below
// the card's ~295 flops per byte, so the bound is the bytes.
//
// Two bodies, one per dtype (the wrapper's plan,
// skycomputing_tpu_torch/ops/flash_attention.py), each for every head dim
// D from 1 to 128:
//
// * bfloat16: flash_attention_kernel_mma, an FA2-style tensor-core body.
//   One block per (batch, head, tile of 16 queries per warp; 4 warps, or
//   2 or 1 where fewer blocks than SMs would result).  Each warp keeps
//   its 16 query rows as mma A fragments in registers for the whole K/V
//   walk.  K/V tiles of 64 keys are copied into shared memory with
//   cp.async, double-buffered, so the next tile loads while this one is
//   computed, with one barrier per tile; rows are padded by 16 bytes so
//   that ldmatrix is free of bank conflicts.  A tile's bias is read one
//   key per thread, a tile ahead.  S = Q.K^T runs on mma.sync.m16n8k16
//   (bf16 in, f32 accumulate); the f32 scores are multiplied by `scale`
//   (q is never rounded after scaling), the bias is added in f32, keys
//   past L are set to -inf by index, and the online softmax runs in
//   registers with quad shuffles.  P is rounded to bf16 in registers and
//   reused as the A operand of P.V, V read with ldmatrix.trans; the f32
//   output goes through shared memory and out to device memory.
// * float32: flash_attention_kernel_tf32x3, the same skeleton on
//   mma.sync.m16n8k8 with tf32 operands, each product taken as three
//   (3xTF32: every operand split once into a big and a small tf32 part,
//   small.big + big.small + big.big into one f32 accumulator), so the
//   products keep float32's accuracy (about 2^-22 relative) at the
//   tensor cores' rate.  K/V tiles of 64 keys (32 past D = 64) in f32
//   rows padded by 4 floats; P.V takes P straight from the score
//   registers by reading each 8-key group of V in a permuted order.  The
//   tensor cores' f32 sums truncate, so each tile's P.V is summed apart
//   and added to the output with an f32 FMA; each bias row is shifted
//   by its largest value first, so that a row whose every key carries
//   -1e4 does not round its scores to a step of 2^-10.  It is bounded by
//   three TF32 products (3 x 4BHL^2D at 495 TFLOP/s), not by the FFMA
//   peak (67 TFLOP/s).
//
// A head dim that is not a multiple of the mma's k-step (16 bf16, 8
// tf32) is padded, not given a body of its own: each body is compiled
// for kD, D rounded up to the step, and stages every row at kD with
// head dims D .. kD - 1 zero.  Those are zeroed once before the walk and
// no copy ever writes them, so Q.K^T adds nothing for them and the
// output columns past D, which P.V computes from zero V columns, are
// never stored.  The caller's `scale` stays the real D's.  A row of D
// elements is copied in the widest granule that divides its bytes (16,
// 8 or 4 bytes by cp.async, 2 by an ordinary load for a bf16 row of odd
// D: copy_granule in common.cuh); D and the granule are run-time values,
// so each kD is one instantiation.  (Until this design, float32 with D %
// 8 != 0 and bfloat16 with D % 16 != 0 ran a CUDA-core body of float32
// FMAs, 1.9-4.0x slower than SDPA.)
//
// On the TPU the K/V walk was a fori_loop over VMEM blocks of one grid
// cell; here it is a loop inside one block, and blocks share nothing.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see skycomputing_tpu_torch/ops/_build.py) and bound
// with ctypes through the plain C functions at the end of this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;           // four warps at most
constexpr int kKTile = 64;              // keys staged per step
constexpr int kMaxHeadDim = 128;

// the bias row: [B, L] at strides (sb, sk) elements, float32 or bfloat16
struct Bias {
  const void* ptr;
  int is_bf16;
  int64_t sb, sk;
  __device__ __forceinline__ float at(int b, int key) const {
    const int64_t off = (int64_t)b * sb + (int64_t)key * sk;
    return is_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(ptr)[off])
                   : static_cast<const float*>(ptr)[off];
  }
};

// ---------------------------------------------------------------------------
// The tensor-core body (bfloat16)
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 16;  // query rows of one warp (the mma's M)

constexpr int kStages = 2;  // K/V tiles in the tensor-core body's ring

// the head dims a body stages a row at: D rounded up to one k-step of
// its mma (16 bf16 values, 8 tf32)
__host__ __device__ inline int padded_dim(int D, int step) {
  return (D + step - 1) / step * step;
}

// Shared memory of the tensor-core body, in bytes: the block's query
// rows (then its output rows) and kStages K and V tiles, all with rows
// of kD + 8 bf16 (16 bytes of padding), and kStages bias tiles in f32.
__host__ __device__ inline size_t mma_smem_bytes(int kD, int warps) {
  const size_t row = (size_t)(kD + 8) * sizeof(__nv_bfloat16);
  return (size_t)warps * kMmaRows * row + 2 * kStages * (size_t)kKTile * row +
         kStages * kKTile * sizeof(float);
}

// Warp w owns query rows q0 + 16 w .. q0 + 16 w + 15.  In an m16n8
// fragment lane l holds rows l / 4 and l / 4 + 8, columns 2 (l % 4) and
// 2 (l % 4) + 1 of each 8-column tile.  kD is the head dim D rounded up
// to 16; rows are staged at kD with head dims D .. kD - 1 zero (zeroed
// once, never copied to), copied and stored `copy` bytes at a time.
template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel_mma(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, Bias bias,
                           __nv_bfloat16* __restrict__ out, int L, int H,
                           int D, int copy, float scale) {
  constexpr int kStride = kD + 8;       // padded shared row, in bf16
  constexpr int kChunks = kD / 8;       // 16-byte slots of a staged row
  constexpr int kKSteps = kD / 16;      // k-steps of Q.K^T
  constexpr int kDTiles = kD / 8;       // n-tiles of P.V
  constexpr int kNTiles = kKTile / 8;   // n-tiles of Q.K^T
  constexpr int kTileElems = kKTile * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int threads = blockDim.x;
  const int warps = threads / 32;
  const int q_tile = warps * kMmaRows;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + q_tile * kStride;      // [kStages][kKTile][kStride]
  __nv_bfloat16* vs = ks + kStages * kTileElems;  // [kStages][kKTile][kStride]
  float* bs = reinterpret_cast<float*>(vs + kStages * kTileElems);  // [kStages][kKTile]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * q_tile;
  const int64_t pos_stride = (int64_t)H * D;
  const int64_t base = (int64_t)b * L * pos_stride + (int64_t)h * D;
  const int n_tiles = (L + kKTile - 1) / kKTile;
  const int tig2 = 2 * (lane % 4);
  const int row_bytes = D * (int)sizeof(__nv_bfloat16);
  auto bytes = [](const __nv_bfloat16* p) {
    return reinterpret_cast<const unsigned char*>(p);
  };

  // head dims D .. kD - 1 of every staged row (the query tile, each K and
  // V tile) are zero for the whole walk
  if (D != kD)
    zero_padding(smem_raw, q_tile + 2 * kStages * kKTile,
                 kStride * (int)sizeof(__nv_bfloat16), row_bytes,
                 kD * (int)sizeof(__nv_bfloat16), tid, threads);
  // the query tile, rows past L zero-filled
  with_slot_copy(row_bytes, copy, [&](auto slot) {
    for (int e = tid; e < q_tile * kChunks; e += threads) {
      const int r = e / kChunks, c = e % kChunks;
      const bool ok = q0 + r < L;
      slot(reinterpret_cast<unsigned char*>(qs + r * kStride),
           bytes(q + base + (int64_t)(ok ? q0 + r : 0) * pos_stride), c, ok);
    }
  });
  // queue a K/V tile (keys past L zero-filled), then commit a group (an
  // empty one past the last tile, so every step waits the same way)
  auto load_kv = [&](int tile) {
    if (tile < n_tiles) {
      const int k0 = tile * kKTile;
      __nv_bfloat16* kb = ks + (tile % kStages) * kTileElems;
      __nv_bfloat16* vb = vs + (tile % kStages) * kTileElems;
      with_slot_copy(row_bytes, copy, [&](auto slot) {
        for (int e = tid; e < kKTile * kChunks; e += threads) {
          const int j = e / kChunks, c = e % kChunks;
          const bool ok = k0 + j < L;
          const int64_t off = base + (int64_t)(ok ? k0 + j : 0) * pos_stride;
          slot(reinterpret_cast<unsigned char*>(kb + j * kStride),
               bytes(k + off), c, ok);
          slot(reinterpret_cast<unsigned char*>(vb + j * kStride),
               bytes(v + off), c, ok);
        }
      });
    }
    cp_async_commit();
  };
  // a tile's bias in log2 units, one key per thread (two where the
  // block has one warp; keys past L read nothing): read into registers
  // one tile before it is stored to shared memory, two before it is used
  float bias_next[kKTile / 32];
  auto load_bias = [&](int tile) {
#pragma unroll
    for (int i = 0; i < kKTile / 32; ++i) {
      const int j = tid + i * threads;
      const int key = tile * kKTile + j;
      bias_next[i] = j < kKTile && key < L ? bias.at(b, key) * kLog2e : 0.f;
    }
  };
  auto store_bias = [&](int tile) {
#pragma unroll
    for (int i = 0; i < kKTile / 32; ++i) {
      const int j = tid + i * threads;
      if (j < kKTile) bs[(tile % kStages) * kKTile + j] = bias_next[i];
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_kv(i);
  load_bias(0);
  store_bias(0);
  load_bias(1);

  uint32_t qf[kKSteps][4];             // this warp's Q, A fragments
  float o[kDTiles][4];                 // output accumulator
  float m[2] = {-INFINITY, -INFINITY};  // rows lane/4 and lane/4 + 8, log2 units
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const float scale2 = scale * kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t (and the query tile) has landed
    __syncthreads();  // ... for every thread, and tile t - 1 is read
    load_kv(t + kStages - 1);  // into the buffers tile t - 1 used
    store_bias(t + 1);
    load_bias(t + 2);

    if (t == 0) {
      const __nv_bfloat16* qw = qs + warp * kMmaRows * kStride;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldmatrix_x4(qf[kk], qw + (lane % 16) * kStride + kk * 16 +
                                (lane / 16) * 8);
    }

    // S = Q . K^T over this tile's 64 keys
    const __nv_bfloat16* kb = ks + (t % kStages) * kTileElems;
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
        ldmatrix_x4(kf, kb + (np * 16 + (lane % 8) + (lane / 16) * 8) * kStride +
                            kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // f32 scores * scale + bias, in log2 units; keys past L are -inf
    const int k0 = t * kKTile;
    const float* bb = bs + (t % kStages) * kKTile;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + tig2 + (e % 2);
        const float x = k0 + key < L
                            ? fmaf(s[n][e], scale2, bb[key])
                            : -INFINITY;
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key k0 < L is in every tile, so the new max is finite
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);  // exp2(-inf) = 0 on the first tile
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e / 2]);  // exp2(-inf) = 0
        s[n][e] = p;
        l[e / 2] += p;
      }
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P . V: P in bf16 from the score registers, V by ldmatrix.trans
    const __nv_bfloat16* vb = vs + (t % kStages) * kTileElems;
#pragma unroll
    for (int kk = 0; kk < kKTile / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int np = 0; np < kDTiles / 2; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(
            vf, vb + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kStride +
                    np * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * np], pf, vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pf, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // acc / max(l, 1e-30) in bf16, through this warp's own query rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
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
  for (int e = lane; e < kMmaRows * kChunks; e += 32) {
    const int r = e / kChunks, c = e % kChunks;
    const int qi = q0 + warp * kMmaRows + r;
    if (qi < L)
      store_slot(
          reinterpret_cast<unsigned char*>(out + base + (int64_t)qi * pos_stride),
          bytes(ow + r * kStride), c, row_bytes, copy);
  }
}

template <int kD>
cudaError_t launch_mma_dim(const void* q, const void* k, const void* v,
                           Bias bias, void* out, int B, int L, int H, int D,
                           int copy, int warps, float scale,
                           cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(kD, warps);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel_mma<kD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int q_tile = warps * kMmaRows;
  const dim3 grid((L + q_tile - 1) / q_tile, H, B);
  flash_attention_kernel_mma<kD><<<grid, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias,
      static_cast<__nv_bfloat16*>(out), L, H, D, copy, scale);
  return cudaGetLastError();
}

cudaError_t launch_mma(const void* q, const void* k, const void* v, Bias bias,
                       void* out, int B, int L, int H, int D, int copy,
                       int warps, float scale, cudaStream_t stream) {
  switch (padded_dim(D, 16)) {
#define SKY_MMA_CASE(d)                                                  \
  case d:                                                                \
    return launch_mma_dim<d>(q, k, v, bias, out, B, L, H, D, copy, warps, \
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
// The float32 tensor-core body (3xTF32; float32)
// ---------------------------------------------------------------------------

// keys of one K/V tile of the float32 tensor-core body: 64, or 32 past
// head_dim 64, where 64 would double the score registers and the tiles
__host__ __device__ constexpr int tf32_keys(int D) { return D > 64 ? 32 : 64; }

// Shared memory of the float32 tensor-core body, in bytes: the block's
// query rows (then its output rows) and kStages K and V tiles, float32
// rows of kD + 4 (so that a fragment's loads, rows g and columns t of a
// quad, fall in 32 distinct banks), and kStages bias tiles in f32.
__host__ __device__ inline size_t tf32_smem_bytes(int kD, int warps) {
  const size_t row = (size_t)(kD + 4) * sizeof(float);
  const size_t keys = tf32_keys(kD);
  return (size_t)warps * kMmaRows * row + 2 * kStages * keys * row +
         kStages * keys * sizeof(float);
}

// Warp w owns query rows q0 + 16 w .. q0 + 16 w + 15; lane l is row
// (or, in a B fragment, column) g = l / 4 of a fragment and column (row)
// t = l % 4.  m16n8k8 tf32 fragments: A a0 (g, t), a1 (g+8, t), a2 (g,
// t+4), a3 (g+8, t+4); B b0 (k=t, n=g), b1 (k=t+4, n=g); C c0 (g, 2t),
// c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).  Every product is three
// mmas into one f32 accumulator, a_small.b_big + a_big.b_small +
// a_big.b_big (split_tf32; the dropped small.small term is about 2^-22
// of the product, float32's own rounding).  The bound of one block per
// SM frees ptxas's register budget (without it, head_dim 112 spilled);
// shared memory allows two blocks per SM all the same.  kD is the head
// dim D rounded up to 8, staged as in the bf16 body.
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel_tf32x3(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v, Bias bias,
                              float* __restrict__ out, int L, int H, int D,
                              int copy, float scale) {
  constexpr int kStride = kD + 4;         // padded shared row, in floats
  constexpr int kChunks = kD / 4;         // 16-byte slots of a staged row
  constexpr int kKSteps = kD / 8;         // k-steps of Q.K^T, n-tiles of P.V
  constexpr int kKeys = tf32_keys(kD);    // keys of one K/V tile
  constexpr int kNTiles = kKeys / 8;      // n-tiles of Q.K^T, k-steps of P.V
  constexpr int kTileElems = kKeys * kStride;
  constexpr int kBiasPer = (kKeys + 31) / 32;  // bias keys per thread
  // up to head_dim 64 the warp holds Q's two parts; past it Q's float32
  // values, split at each use (the registers of two parts would spill)
  constexpr bool kHoldParts = kD <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int threads = blockDim.x;
  const int warps = threads / 32;
  const int q_tile = warps * kMmaRows;
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + q_tile * kStride;      // [kStages][kKeys][kStride]
  float* vs = ks + kStages * kTileElems;  // [kStages][kKeys][kStride]
  float* bs = vs + kStages * kTileElems;  // [kStages][kKeys]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * q_tile;
  const int64_t pos_stride = (int64_t)H * D;
  const int64_t base = (int64_t)b * L * pos_stride + (int64_t)h * D;
  const int n_tiles = (L + kKeys - 1) / kKeys;
  const int row_bytes = D * (int)sizeof(float);
  auto bytes = [](const float* p) {
    return reinterpret_cast<const unsigned char*>(p);
  };

  // head dims D .. kD - 1 of every staged row are zero for the whole walk
  if (D != kD)
    zero_padding(smem_raw, q_tile + 2 * kStages * kKeys,
                 kStride * (int)sizeof(float), row_bytes,
                 kD * (int)sizeof(float), tid, threads);
  // the query tile, rows past L zero-filled
  with_slot_copy(row_bytes, copy, [&](auto slot) {
    for (int e = tid; e < q_tile * kChunks; e += threads) {
      const int r = e / kChunks, c = e % kChunks;
      const bool ok = q0 + r < L;
      slot(reinterpret_cast<unsigned char*>(qs + r * kStride),
           bytes(q + base + (int64_t)(ok ? q0 + r : 0) * pos_stride), c, ok);
    }
  });
  // queue a K/V tile (keys past L zero-filled), then commit a group (an
  // empty one past the last tile, so every step waits the same way)
  auto load_kv = [&](int tile) {
    if (tile < n_tiles) {
      const int k0 = tile * kKeys;
      float* kb = ks + (tile % kStages) * kTileElems;
      float* vb = vs + (tile % kStages) * kTileElems;
      with_slot_copy(row_bytes, copy, [&](auto slot) {
        for (int e = tid; e < kKeys * kChunks; e += threads) {
          const int j = e / kChunks, c = e % kChunks;
          const bool ok = k0 + j < L;
          const int64_t off = base + (int64_t)(ok ? k0 + j : 0) * pos_stride;
          slot(reinterpret_cast<unsigned char*>(kb + j * kStride),
               bytes(k + off), c, ok);
          slot(reinterpret_cast<unsigned char*>(vb + j * kStride),
               bytes(v + off), c, ok);
        }
      });
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_kv(i);

  // the bias row's largest value: softmax is unchanged by a shift of a
  // row, and bias - max loses nothing where the two are close
  // (Sterbenz), so a row whose every key carries -1e4 keeps float32's
  // accuracy, where s * scale - 1e4 would round to a step of 2^-10 (up
  // to 5e-4 of each p); a row with a live key has max 0 and is unchanged
  __shared__ float warp_max[kThreads / 32];
  float bmax = -INFINITY;
  for (int key = tid; key < L; key += threads)
    bmax = fmaxf(bmax, bias.at(b, key));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
  if (lane == 0) warp_max[warp] = bmax;
  __syncthreads();
  for (int w = 0; w < warps; ++w) bmax = fmaxf(bmax, warp_max[w]);

  // a tile's bias, shifted, in log2 units: read into registers one tile
  // before it is stored to shared memory, two before it is used
  float bias_next[kBiasPer];
  auto load_bias = [&](int tile) {
#pragma unroll
    for (int i = 0; i < kBiasPer; ++i) {
      const int j = tid + i * threads;
      const int key = tile * kKeys + j;
      bias_next[i] =
          j < kKeys && key < L ? (bias.at(b, key) - bmax) * kLog2e : 0.f;
    }
  };
  auto store_bias = [&](int tile) {
#pragma unroll
    for (int i = 0; i < kBiasPer; ++i) {
      const int j = tid + i * threads;
      if (j < kKeys) bs[(tile % kStages) * kKeys + j] = bias_next[i];
    }
  };
  load_bias(0);
  store_bias(0);
  load_bias(1);

  // this warp's Q as A fragments: big parts (or, past head_dim 64, the
  // float32 bits) and small parts
  uint32_t qa[kKSteps][4];
  uint32_t qb[kHoldParts ? kKSteps : 1][4];
  float o[kKSteps][4];                   // output accumulator
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
#pragma unroll
  for (int n = 0; n < kKSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const float scale2 = scale * kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t (and the query tile) has landed
    __syncthreads();  // ... for every thread, and tile t - 1 is read
    load_kv(t + kStages - 1);  // into the buffers tile t - 1 used
    store_bias(t + 1);
    load_bias(t + 2);

    if (t == 0) {
      const float* qw = qs + warp * kMmaRows * kStride;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x =
              qw[(g + (e % 2) * 8) * kStride + kk * 8 + tq + (e / 2) * 4];
          if constexpr (kHoldParts)
            split_tf32(x, qa[kk][e], qb[kk][e]);
          else
            qa[kk][e] = __float_as_uint(x);
        }
    }

    // S = Q . K^T over this tile's keys, 3xTF32
    const float* kb = ks + (t % kStages) * kTileElems;
    float s[kNTiles][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t a_big[4], a_small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kHoldParts) {
          a_big[e] = qa[kk][e];
          a_small[e] = qb[kk][e];
        } else {
          split_tf32(__uint_as_float(qa[kk][e]), a_big[e], a_small[e]);
        }
      }
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        const float* kr = kb + (n * 8 + g) * kStride + kk * 8 + tq;
        uint32_t b0, b0_small, b1, b1_small;
        split_tf32(kr[0], b0, b0_small);
        split_tf32(kr[4], b1, b1_small);
        mma_tf32(s[n], a_small, b0, b1);
        mma_tf32(s[n], a_big, b0_small, b1_small);
        mma_tf32(s[n], a_big, b0, b1);
      }
    }

    // f32 scores * scale + bias, in log2 units; keys past L are -inf
    const int k0 = t * kKeys;
    const float* bb = bs + (t % kStages) * kKeys;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * tq + (e % 2);
        const float x =
            k0 + key < L ? fmaf(s[n][e], scale2, bb[key]) : -INFINITY;
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key k0 < L is in every tile, so the new max is finite
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);  // exp2(-inf) = 0 on the first tile
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e / 2]);  // exp2(-inf) = 0
        s[n][e] = p;
        l[e / 2] += p;
      }
    // this tile's P.V, added to the rescaled output in f32 after the
    // tile: the tensor cores' f32 sums truncate, which over thousands of
    // keys in one accumulator would cost 1e-5 at L = 4,096
    float pv[kKSteps][4];
#pragma unroll
    for (int n = 0; n < kKSteps; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;

    // O += P . V, 3xTF32, P from the score registers.  P.V sums over the
    // keys in any order, so k-step kk reads its 8 keys permuted: k = t is
    // key 2t and k = t + 4 key 2t + 1, where c0..c3 already stand as
    // a0 = c0 (g, 2t), a1 = c2 (g+8, 2t), a2 = c1 (g, 2t+1), a3 = c3
    // (g+8, 2t+1); V's rows are read in the same order
    const float* vb = vs + (t % kStages) * kTileElems;
#pragma unroll
    for (int kk = 0; kk < kNTiles; ++kk) {
      uint32_t p_big[4], p_small[4];
      split_tf32(s[kk][0], p_big[0], p_small[0]);
      split_tf32(s[kk][2], p_big[1], p_small[1]);
      split_tf32(s[kk][1], p_big[2], p_small[2]);
      split_tf32(s[kk][3], p_big[3], p_small[3]);
      const float* vr = vb + (kk * 8 + 2 * tq) * kStride + g;
#pragma unroll
      for (int n = 0; n < kKSteps; ++n) {
        uint32_t b0, b0_small, b1, b1_small;
        split_tf32(vr[n * 8], b0, b0_small);
        split_tf32(vr[kStride + n * 8], b1, b1_small);
        mma_tf32(pv[n], p_small, b0, b1);
        mma_tf32(pv[n], p_big, b0_small, b1_small);
        mma_tf32(pv[n], p_big, b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < kKSteps; ++n) {
      o[n][0] = fmaf(o[n][0], corr[0], pv[n][0]);
      o[n][1] = fmaf(o[n][1], corr[0], pv[n][1]);
      o[n][2] = fmaf(o[n][2], corr[1], pv[n][2]);
      o[n][3] = fmaf(o[n][3], corr[1], pv[n][3]);
    }
  }
  cp_async_wait<0>();

  // acc / max(l, 1e-30) in f32, through this warp's own query rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  float* ow = qs + warp * kMmaRows * kStride;
#pragma unroll
  for (int n = 0; n < kKSteps; ++n) {
    *reinterpret_cast<float2*>(ow + g * kStride + n * 8 + 2 * tq) =
        make_float2(o[n][0] / l[0], o[n][1] / l[0]);
    *reinterpret_cast<float2*>(ow + (g + 8) * kStride + n * 8 + 2 * tq) =
        make_float2(o[n][2] / l[1], o[n][3] / l[1]);
  }
  __syncwarp();
  for (int e = lane; e < kMmaRows * kChunks; e += 32) {
    const int r = e / kChunks, c = e % kChunks;
    const int qi = q0 + warp * kMmaRows + r;
    if (qi < L)
      store_slot(
          reinterpret_cast<unsigned char*>(out + base + (int64_t)qi * pos_stride),
          bytes(ow + r * kStride), c, row_bytes, copy);
  }
}

template <int kD>
cudaError_t launch_tf32_dim(const void* q, const void* k, const void* v,
                            Bias bias, void* out, int B, int L, int H, int D,
                            int copy, int warps, float scale,
                            cudaStream_t stream) {
  const size_t smem = tf32_smem_bytes(kD, warps);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel_tf32x3<kD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int q_tile = warps * kMmaRows;
  const dim3 grid((L + q_tile - 1) / q_tile, H, B);
  flash_attention_kernel_tf32x3<kD><<<grid, warps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(out), L, H, D,
      copy, scale);
  return cudaGetLastError();
}

cudaError_t launch_tf32(const void* q, const void* k, const void* v,
                        Bias bias, void* out, int B, int L, int H, int D,
                        int copy, int warps, float scale, cudaStream_t stream) {
  switch (padded_dim(D, 8)) {
#define SKY_TF32_CASE(d)                                                    \
  case d:                                                                   \
    return launch_tf32_dim<d>(q, k, v, bias, out, B, L, H, D, copy, warps, \
                              scale, stream);
    SKY_TF32_CASE(8)
    SKY_TF32_CASE(16)
    SKY_TF32_CASE(24)
    SKY_TF32_CASE(32)
    SKY_TF32_CASE(40)
    SKY_TF32_CASE(48)
    SKY_TF32_CASE(56)
    SKY_TF32_CASE(64)
    SKY_TF32_CASE(72)
    SKY_TF32_CASE(80)
    SKY_TF32_CASE(88)
    SKY_TF32_CASE(96)
    SKY_TF32_CASE(104)
    SKY_TF32_CASE(112)
    SKY_TF32_CASE(120)
    SKY_TF32_CASE(128)
#undef SKY_TF32_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// p is aligned to `bytes`
bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

extern "C" {

// body: 0 = the tensor-core body (bfloat16), 1 = the float32 tensor-core
// body (3xTF32); each stages a row of D <= 128 head dims padded to its
// mma's k-step (16 bf16, 8 tf32).  copy: the bytes each row is copied in,
// copy_granule(D * element size), the wrapper's plan's `copy_bytes`;
// q, k, v and out aligned to it.  warps: 1, 2 or 4 per block, 16
// queries each.  dtype: 0 = float32, 1 = bfloat16 (q, k, v and out);
// bias_dtype likewise, the bias read at bias[b * bias_sb + key * bias_sk].
// Returns a cudaError_t (0 = launched).  Shapes are checked by the Python
// wrapper, which also picks the body; this rejects only what the chosen
// body cannot hold.
int sky_flash_attention(int body, int warps, int dtype, const void* q,
                        const void* k, const void* v, const void* bias,
                        int bias_dtype, long long bias_sb, long long bias_sk,
                        void* out, int B, int L, int H, int D, int copy,
                        float scale, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || L < 1 || D < 1 ||
      D > kMaxHeadDim || (bias_dtype != 0 && bias_dtype != 1) ||
      (warps != 1 && warps != 2 && warps != 4) || (dtype != 0 && dtype != 1)
      || body != 1 - dtype)
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == 1 ? (int)sizeof(__nv_bfloat16) : (int)sizeof(float);
  if (copy != copy_granule(D * elem) || !aligned(q, copy) ||
      !aligned(k, copy) || !aligned(v, copy) || !aligned(out, copy))
    return (int)cudaErrorInvalidValue;
  const Bias b{bias, bias_dtype, (int64_t)bias_sb, (int64_t)bias_sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 0)
    return (int)launch_mma(q, k, v, b, out, B, L, H, D, copy, warps, scale, s);
  return (int)launch_tf32(q, k, v, b, out, B, L, H, D, copy, warps, scale, s);
}

// Dynamic shared memory, in bytes, of one block of the given body.
int sky_flash_attention_smem(int body, int D, int warps) {
  if (body == 0) return (int)mma_smem_bytes(padded_dim(D, 16), warps);
  return (int)tf32_smem_bytes(padded_dim(D, 8), warps);
}

}  // extern "C"
