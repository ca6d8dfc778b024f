// K5: the packed device->host decision blob.
//
// Replaces the pack_outputs block of the TPU program's
// pheniqs_tpu/device/step.py:make_decode_step (685-745): per read, the
// int16 (int32 for panels of 32000 barcodes or more) decoded index of each
// pamld/mdd decoder, the raw f32 confidence of each pamld decoder, the
// chained per-decoder qcfail bits and the hybrid uncertain byte
// (uncertain_any | forced, step.py:658-665), in d2h_layout order. The
// TPU's flat-reshape workaround (step.py:733-739) has no counterpart: the
// (N * total,) output is the contiguous layout itself.
//
// Bound on the H100: memory, ~30 B read and 14 B written per read on the
// flagship (2.4 MB written per 131072-read batch), a few microseconds of
// HBM time; the arithmetic is a few shifts a byte.
//
// What held the first version back: one thread per read wrote its row one
// byte at a time at a stride of `total` bytes (14 on the flagship), so a
// warp store scattered 32 bytes over 14 sectors and a warp issued `total`
// such stores: ~200 partial sector writes where 14 whole ones do.
//
// Design: a block owns R consecutive reads, one thread each (R a multiple
// of 32, 256 unless R * total bytes pass the 48 KB of static shared
// memory; kernels/pack.py:pack_plan, cached on the instrument). Thread t
// loads read r0 + t's elements of the (decoders, N) rows (lane-contiguous,
// so a 4-byte row's loads fill whole sectors) and assembles the read's row
// in shared memory at t * total. The stores into shared memory are as wide
// as the row stride allows: a field of size z at row offset o goes out as
// z / e stores of e bytes, e the largest of 4, 2, 1 that divides z, o and
// total (2-byte stores on the flagship's and MDD flagship's 14 and 10,
// bytes on the whitelist's 17). A warp's 32 stores at stride `total` then
// put at most 2 words in a bank at totals 10, 14 and 18, and 3 at 17 and 35
// (the fast whitelist, 9 decoders). Spacing the warp's half-warps 4 read
// groups apart takes those to 2; timed at 17 B it made no difference
// (PERF.md), so the kernel keeps t = threadIdx.x.
// After a barrier the block's span of R * total bytes (16-byte aligned,
// as R is a multiple of 16) is copied out with 16-byte loads and stores,
// neighbouring threads on neighbouring words; the ending bytes of the last
// block's span one by one. So every global store fills whole sectors.
// ptxas (sm_90a): 32 registers, no spills, no static shared memory; at
// R = 256 and 3,584 shared bytes (the flagship) 8 blocks fit an SM, so a
// 131072-read batch's 512 blocks are half a wave of the card's 1,056.
// Any number of decoders: which decoders send an index, a confidence and
// an uncertain row that counts are bit masks of ceil(D / 32) words in a
// device array (kernels/pack.py:PackPlan.masks), and rows too wide
// for 32 of them to fit the 48 KB (past ~1,500 bytes, some 250 decoders)
// are assembled in place in the output, one thread a row (`staged` 0).
#include "common.cuh"

#define PHQ_PACK_MAX_READS 256

// `size` bytes of `value` (little-endian) at row + offset, in stores as
// wide as `align` (the widest power of two <= 4 dividing the row stride),
// the size and the offset allow.
__device__ __forceinline__ void phq_pack_put(uint8_t* row, int offset, unsigned value, int size, int align) {
  int e = min(size, align);
  while (offset & (e - 1)) e >>= 1;
  uint8_t* p = row + offset;
  if (e == 4) {
    *(uint32_t*)p = value;
  } else if (e == 2) {
    for (int b = 0; b < size; b += 2) *(uint16_t*)(p + b) = (uint16_t)(value >> (8 * b));
  } else {
    for (int b = 0; b < size; ++b) p[b] = (uint8_t)(value >> (8 * b));
  }
}

// bit d of a decoder mask of `masks` words
__device__ __forceinline__ bool phq_pack_bit(const unsigned* __restrict__ masks, int d) {
  return (masks[d >> 5] >> (d & 31)) & 1u;
}

__global__ void __launch_bounds__(PHQ_PACK_MAX_READS) phq_pack_kernel(
    int n, int n_decoders, const unsigned* __restrict__ decoded_mask,
    const unsigned* __restrict__ confidence_mask, int index_size, int qcfail_bytes, int want_uncertain,
    const unsigned* __restrict__ uncertain_mask, int total, int staged, const int* __restrict__ decoded,
    const float* __restrict__ confidence, const uint8_t* __restrict__ qcfail,
    const uint8_t* __restrict__ uncertain, const uint8_t* __restrict__ forced,
    uint8_t* __restrict__ out) {
  PHQ_DYNAMIC_SMEM(smem);
  const int reads = blockDim.x;
  const int r0 = blockIdx.x * reads;
  const int rows = min(reads, n - r0);
  const int t = threadIdx.x;
  const int align = (total & 3) == 0 ? 4 : (total & 1) == 0 ? 2 : 1;
  if (t < rows) {
    const size_t i = (size_t)r0 + t;
    // rows [r0, r0 + R) are one 16-byte aligned span of the output, so a
    // row in place has the alignment of its staged copy
    uint8_t* row = staged ? smem + t * total : out + i * total;
    int offset = 0;
    for (int d = 0; d < n_decoders; ++d) {
      if (phq_pack_bit(decoded_mask, d)) {
        phq_pack_put(row, offset, (unsigned)decoded[(size_t)d * n + i], index_size, align);
        offset += index_size;
      }
    }
    for (int d = 0; d < n_decoders; ++d) {
      if (phq_pack_bit(confidence_mask, d)) {
        phq_pack_put(row, offset, __float_as_uint(confidence[(size_t)d * n + i]), 4, align);
        offset += 4;
      }
    }
    for (int byte = 0; byte < qcfail_bytes; ++byte) {
      unsigned bits = 0;
      for (int bit = 0; bit < 8 && byte * 8 + bit < n_decoders; ++bit) {
        bits |= (qcfail[(size_t)(byte * 8 + bit) * n + i] ? 1u : 0u) << bit;
      }
      row[offset++] = (uint8_t)bits;
    }
    if (want_uncertain) {
      bool unsure = forced != nullptr && forced[i] != 0;
      for (int d = 0; d < n_decoders; ++d) {
        if (phq_pack_bit(uncertain_mask, d)) unsure = unsure || uncertain[(size_t)d * n + i] != 0;
      }
      row[offset] = unsure ? 1 : 0;
    }
  }
  if (!staged) return;
  __syncthreads();

  // the block's rows are one span of the output, 16-byte aligned
  uint8_t* dst = out + (size_t)r0 * total;
  const int span = rows * total;
  const int words = span >> 4;
  for (int c = threadIdx.x; c < words; c += reads) ((uint4*)dst)[c] = ((const uint4*)smem)[c];
  for (int b = 16 * words + threadIdx.x; b < span; b += reads) dst[b] = smem[b];
}

// `reads` (a multiple of 32, at most PHQ_PACK_MAX_READS) and `staged`
// come from kernels/pack.py:pack_plan; `masks` holds its decoded,
// confidence and uncertain masks of `mask_words` words each; `out` is
// 16-byte aligned.
PHQ_EXPORT int phq_pack(
    int n, int n_decoders, const void* masks, int mask_words,
    int index_size, int qcfail_bytes, int want_uncertain,
    int total, int reads, int staged, const void* decoded,
    const void* confidence, const void* qcfail, const void* uncertain,
    const void* forced, void* out, void* stream) {
  if (reads < 32 || reads > PHQ_PACK_MAX_READS || reads % 32 != 0 || mask_words < (n_decoders + 31) / 32) {
    return (int)cudaErrorInvalidValue;
  }
  const int shared_bytes = staged ? (reads * total + 15) / 16 * 16 : 0;
  if (shared_bytes > 48 * 1024 || ((uintptr_t)out & 15) != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    PHQ_LAUNCH(phq_pack_kernel, (n + reads - 1) / reads, reads, shared_bytes, (cudaStream_t)stream)(
        n, n_decoders, (const unsigned*)masks, (const unsigned*)masks + mask_words, index_size, qcfail_bytes,
        want_uncertain, (const unsigned*)masks + 2 * mask_words, total, staged, (const int*)decoded,
        (const float*)confidence, (const uint8_t*)qcfail,
        (const uint8_t*)uncertain, (const uint8_t*)forced, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}
