// Device helpers shared by the port's CUDA sources: float conversions of
// the element types, the PTX the Hopper bodies are built from (cp.async,
// ldmatrix, mma.sync on bf16 and on tf32, the tf32 split), and the copies
// that stage rows of any length padded to whole 16-byte slots.  Included
// by each csrc/*.cu;
// skycomputing_tpu_torch/ops/_build.py hashes it with each source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, asynchronously; with
// `valid` false the 16 bytes are zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 8 or 4 bytes likewise (cp.async.cg takes 16 bytes only, .ca 4, 8 or 16)
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows of any length.  A kernel stages a row of `row_bytes` bytes in
// shared memory padded to whole 16-byte slots; the padding is zeroed once
// (zero_padding) and no copy writes it, so the products read zeros past
// the row's last element.  Every row of a [.., D] tensor whose base is
// 16-byte aligned starts at a multiple of `row_bytes`, so it is copied in
// the widest granule that divides `row_bytes` (copy_granule; the
// wrappers' plans name the same): 16, 8 or 4 bytes by cp.async, 2 or 1
// byte by an ordinary load, which cp.async does not take.
__host__ __device__ inline int copy_granule(int row_bytes) {
  int g = 16;
  while (row_bytes % g != 0) g /= 2;
  return g;
}

// copy_slot's ordinary loads (a granule of 2 or 1 byte), all issued
// before their stores; kept out of line, off the hot paths
__device__ __noinline__ void copy_slot_narrow(unsigned char* dst_row,
                                              const unsigned char* src_row,
                                              int begin, int end, int granule,
                                              bool valid) {
  if (granule == 2) {
    uint16_t v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = valid && begin + 2 * i < end
                 ? *reinterpret_cast<const uint16_t*>(src_row + begin + 2 * i)
                 : 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (begin + 2 * i < end)
        *reinterpret_cast<uint16_t*>(dst_row + begin + 2 * i) = v[i];
    return;
  }
  unsigned char v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    v[i] = valid && begin + i < end ? src_row[begin + i] : 0;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (begin + i < end) dst_row[begin + i] = v[i];
}

// slot c (bytes 16 c .. 16 c + 15) of a staged row: the bytes of it that
// lie in the row's `row_bytes` (the rest is padding, never written), from
// device into shared memory in `granule`s of 8 or 4 (cp.async,
// asynchronous), 2 or 1 byte; with `valid` false zeros, and nothing is
// read.  (A granule of 16 is with_slot_copy's own.)
__device__ __forceinline__ void copy_slot(unsigned char* dst_row,
                                          const unsigned char* src_row, int c,
                                          int row_bytes, int granule,
                                          bool valid) {
  const int begin = 16 * c;
  const int end = min(begin + 16, row_bytes);
  if (granule < 4) {
    copy_slot_narrow(dst_row, src_row, begin, end, granule, valid);
    return;
  }
  for (int b = begin; b < end; b += granule) {
    if (granule == 8)
      cp_async8(dst_row + b, src_row + b, valid);
    else
      cp_async4(dst_row + b, src_row + b, valid);
  }
}

// Run `copies(slot)`, a copy loop whose `slot(dst_row, src_row, c,
// valid)` copies slot c of a staged row: copy_slot, or for a granule of
// 16 (every slot all data or all padding: the main paths' head dims) its
// one cp.async.  The choice is made here, once, so that the loop compiled
// for the granule of 16 holds nothing else: with copy_slot's other
// granules inline in it, B1 at head_dim 64 ran 4-6% slower than before
// padding on an H100 (padded_ab.py).
template <typename Copies>
__device__ __forceinline__ void with_slot_copy(int row_bytes, int granule,
                                               Copies copies) {
  if (granule == 16)
    copies([=](unsigned char* dst_row, const unsigned char* src_row, int c,
               bool valid) {
      if (16 * c < row_bytes)
        cp_async16(dst_row + 16 * c, src_row + 16 * c, valid);
    });
  else
    copies([=](unsigned char* dst_row, const unsigned char* src_row, int c,
               bool valid) {
      copy_slot(dst_row, src_row, c, row_bytes, granule, valid);
    });
}

// slot c of a row in shared memory out to device memory, its padding not
// written
__device__ __noinline__ void store_slot_narrow(unsigned char* dst_row,
                                               const unsigned char* src_row,
                                               int begin, int end,
                                               int granule) {
  for (int b = begin; b < end; b += granule) {
    switch (granule) {
      case 8:
        *reinterpret_cast<uint2*>(dst_row + b) =
            *reinterpret_cast<const uint2*>(src_row + b);
        break;
      case 4:
        *reinterpret_cast<uint32_t*>(dst_row + b) =
            *reinterpret_cast<const uint32_t*>(src_row + b);
        break;
      case 2:
        *reinterpret_cast<uint16_t*>(dst_row + b) =
            *reinterpret_cast<const uint16_t*>(src_row + b);
        break;
      default:
        dst_row[b] = src_row[b];
    }
  }
}
__device__ __forceinline__ void store_slot(unsigned char* dst_row,
                                           const unsigned char* src_row,
                                           int c, int row_bytes, int granule) {
  const int begin = 16 * c;
  if (granule == 16) {
    if (begin < row_bytes)
      *reinterpret_cast<uint4*>(dst_row + begin) =
          *reinterpret_cast<const uint4*>(src_row + begin);
    return;
  }
  store_slot_narrow(dst_row, src_row, begin, min(begin + 16, row_bytes),
                    granule);
}

// Zero the padding of `rows` staged rows `stride` bytes apart (16-byte
// aligned), bytes `row_bytes` up to `padded_bytes` (a multiple of 16) of
// each, one row a thread of the block's (or warp's) `threads` from `t`
// on.  No copy writes those bytes, so this needs no barrier before the
// copies into the rows; the walk's own barrier before their first read
// orders it.
__device__ __forceinline__ void zero_padding(unsigned char* base, int rows,
                                             int stride, int row_bytes,
                                             int padded_bytes, int t,
                                             int threads) {
  const int whole = (row_bytes + 15) / 16 * 16;
  for (int r = t; r < rows; r += threads) {
    unsigned char* row = base + (size_t)r * stride;
    for (int b = row_bytes; b < whole; ++b) row[b] = 0;
    for (int b = whole; b < padded_bytes; b += 16)
      *reinterpret_cast<uint4*>(row + b) = make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[16 x 8] += a[16 x 8] . b[8 x 8], tf32 in (the low 13 bits of each
// operand are not read), f32 accumulate
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits; to nearest, ties away from zero),
// as the bits of a float whose low 13 bits are zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = big + small + (about 2^-22 |x|): big = tf32(x), small = tf32(x - big)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// two floats as a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace
