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
// Bound on the H100: memory, ~36 B read and 14 B written per read on the
// flagship (a few microseconds of HBM time), 347 B read and 183 B written
// at 64 decoders; the arithmetic is a few shifts a byte.
//
// Design: a block owns R consecutive reads (R a multiple of 32, 256
// unless R * total bytes pass 48 KB; kernels/pack.py:pack_plan, cached on
// the instrument). The plan lists the fields of the output row (an index
// or a confidence stored, a qcfail byte packed from up to 8 decoders'
// rows, the uncertain byte ORed from the counted rows and forced) and the
// input rows each reads (its sources).
//  - The block's warps take the fields in turn, the table read once a
//    field and warp; a warp's lanes take the block's reads, R / 32 each:
//    their elements of the field's rows loaded together (lane-contiguous:
//    a warp's 4-byte loads fill whole sectors), then put into the rows.
//    The first design had a thread a read walk every decoder's fields in
//    turn, one load and its stores at a time (0.075 ms at 64 decoders,
//    3.6x its bound): every read paid the walk of the table. Measured on
//    the way (PERF.md PR 16): each row's span staged in shared memory by
//    cp.async, then assembled, 0.068-0.163 ms; a thread a read building
//    its fields in batches of loads, 0.071.
//  - The rows sit in shared memory at r * total; a field of size z at row
//    offset o goes out as z / e stores of e bytes, e the largest of 4, 2, 1
//    that divides z, o and total (2-byte stores on the flagship's and MDD
//    flagship's 14 and 10, bytes on the whitelist's 17).
//  - After a barrier the block's span of R * total bytes (16-byte aligned,
//    as R is a multiple of 16) is copied out with 16-byte loads and stores,
//    neighbouring threads on neighbouring words; the ending bytes of the
//    last block's span one by one. So every global store fills whole
//    sectors.
// Rows too wide for 32 of them to fit 48 KB (past ~1,500 bytes, some 250
// decoders) are assembled in place in the output, the same way
// (`staged` 0).
#include "common.cuh"

#define PHQ_PACK_MAX_READS 256
// the most dynamic shared memory a block may take on the H100
#define PHQ_PACK_SHARED_MAX (227 * 1024)

// The plan's table (kernels/pack.py:PackPlan.ints): int4 rows
//   a source:  (array, input row (0 for forced), 0, 0)
//   a field:   (kind | bytes << 4, first source, sources, byte of the row)
#define PHQ_PACK_DECODED 0     // int32 rows
#define PHQ_PACK_CONFIDENCE 1  // f32 rows
#define PHQ_PACK_QCFAIL 2      // byte rows
#define PHQ_PACK_UNCERTAIN 3   // byte rows
#define PHQ_PACK_FORCED 4      // one byte row
#define PHQ_PACK_STORE 0       // the source's low `bytes` bytes
#define PHQ_PACK_BITS 1        // bit j: the j-th source's value != 0
#define PHQ_PACK_ANY 2         // 1 where any source's value != 0
// the blocks of PHQ_PACK_MAX_READS threads an SM holds (the launch
// bound: 64 registers a thread), 4 of 50 KB at 64 decoders
#define PHQ_PACK_BLOCKS_PER_SM 4
// the most reads a lane takes: PHQ_PACK_MAX_READS over a warp
#define PHQ_PACK_LANE_READS (PHQ_PACK_MAX_READS / 32)
// a packed byte's rows loaded together
#define PHQ_PACK_ROWS 8

// 1 in each byte of w that is not 0, else 0
__device__ __forceinline__ unsigned phq_nonzero(unsigned w) {
  return ((((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) >> 7) & 0x01010101u;
}

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

// The input row of `source`, from its first read
__device__ __forceinline__ const uint8_t* phq_pack_row(int4 source, int n, const int* decoded,
                                                      const float* confidence, const uint8_t* qcfail,
                                                      const uint8_t* uncertain, const uint8_t* forced) {
  switch (source.x) {
    case PHQ_PACK_DECODED: return (const uint8_t*)(decoded + (size_t)source.y * n);
    case PHQ_PACK_CONFIDENCE: return (const uint8_t*)(confidence + (size_t)source.y * n);
    case PHQ_PACK_QCFAIL: return qcfail + (size_t)source.y * n;
    case PHQ_PACK_UNCERTAIN: return uncertain + (size_t)source.y * n;
    default: return forced;
  }
}

// One field of the block's `rows` rows (from read r0) into `base` (the
// rows, `total` bytes each), the lanes of one warp together: lane l takes
// reads l, l + 32, ...; their elements of each source row loaded together,
// then put. A packed byte where every byte row holds whole 4-byte words
// (`words`) takes 4 reads a word, PHQ_PACK_ROWS rows at a time.
__device__ __forceinline__ void phq_pack_field(int4 field, const int4* sources, uint8_t* base, int total, int r0,
                                               int rows, int lane, int n, int align, bool words, const int* decoded,
                                               const float* confidence, const uint8_t* qcfail,
                                               const uint8_t* uncertain, const uint8_t* forced) {
  const int kind = field.x & 15;
  if (kind != PHQ_PACK_STORE && words) {
    // a packed byte from 4-byte words of 4 reads: lane l takes reads 4l +
    // 128p + q, PHQ_PACK_ROWS rows' words in flight together
    unsigned bytes[PHQ_PACK_LANE_READS / 4];
#pragma unroll
    for (int p = 0; p < PHQ_PACK_LANE_READS / 4; ++p) bytes[p] = 0u;
    for (int j0 = 0; j0 < field.z; j0 += PHQ_PACK_ROWS) {
      unsigned w[PHQ_PACK_ROWS][PHQ_PACK_LANE_READS / 4];
#pragma unroll
      for (int j = 0; j < PHQ_PACK_ROWS; ++j) {
        const uint8_t* from = j0 + j < field.z ? phq_pack_row(sources[field.y + j0 + j], n, decoded, confidence, qcfail,
                                                              uncertain, forced) + r0
                                               : nullptr;
#pragma unroll
        for (int p = 0; p < PHQ_PACK_LANE_READS / 4; ++p) {
          const int r = 4 * lane + 128 * p;
          w[j][p] = from != nullptr && r < rows ? *reinterpret_cast<const unsigned*>(from + r) : 0u;
        }
      }
#pragma unroll
      for (int j = 0; j < PHQ_PACK_ROWS; ++j) {
#pragma unroll
        for (int p = 0; p < PHQ_PACK_LANE_READS / 4; ++p) {
          bytes[p] |= phq_nonzero(w[j][p]) << (kind == PHQ_PACK_BITS ? j0 + j : 0);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < PHQ_PACK_LANE_READS / 4; ++p) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 4 * lane + 128 * p + q;
        if (r < rows) base[(size_t)r * total + field.w] = (uint8_t)(bytes[p] >> (8 * q));
      }
    }
    return;
  }
  unsigned value[PHQ_PACK_LANE_READS];
  if (kind == PHQ_PACK_STORE) {
    const unsigned* from =
        reinterpret_cast<const unsigned*>(phq_pack_row(sources[field.y], n, decoded, confidence, qcfail, uncertain,
                                                       forced)) + r0;
#pragma unroll
    for (int k = 0; k < PHQ_PACK_LANE_READS; ++k) value[k] = lane + 32 * k < rows ? from[lane + 32 * k] : 0u;
  } else {
#pragma unroll
    for (int k = 0; k < PHQ_PACK_LANE_READS; ++k) value[k] = 0u;
#pragma unroll 4
    for (int j = 0; j < field.z; ++j) {
      const uint8_t* from = phq_pack_row(sources[field.y + j], n, decoded, confidence, qcfail, uncertain, forced) + r0;
      const int bit = kind == PHQ_PACK_BITS ? j : 0;
#pragma unroll
      for (int k = 0; k < PHQ_PACK_LANE_READS; ++k) {
        if (lane + 32 * k < rows) value[k] |= (from[lane + 32 * k] != 0 ? 1u : 0u) << bit;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PHQ_PACK_LANE_READS; ++k) {
    const int r = lane + 32 * k;
    if (r < rows) phq_pack_put(base + (size_t)r * total, field.w, value[k], field.x >> 4, align);
  }
}

__global__ void __launch_bounds__(PHQ_PACK_MAX_READS, PHQ_PACK_BLOCKS_PER_SM) phq_pack_kernel(
    int n, int total, int staged, int n_sources, int n_fields, const int4* __restrict__ table,
    const int* __restrict__ decoded, const float* __restrict__ confidence, const uint8_t* __restrict__ qcfail,
    const uint8_t* __restrict__ uncertain, const uint8_t* __restrict__ forced, uint8_t* __restrict__ out) {
  PHQ_DYNAMIC_SMEM(smem);
  const int reads = blockDim.x;
  const int r0 = blockIdx.x * reads;
  const int rows = min(reads, n - r0);
  const int t = threadIdx.x, lane = t & 31, warps = reads / 32;
  const int align = (total & 3) == 0 ? 4 : (total & 1) == 0 ? 2 : 1;
  // every byte row holds whole 4-byte words from each block's first read
  const bool whole_words =
      (n & 3) == 0 && (((uintptr_t)qcfail | (uintptr_t)uncertain | (uintptr_t)forced) & 3) == 0;
  if (!staged) {
    // rows [r0, r0 + R) are one 16-byte aligned span of the output, so a
    // row in place has the alignment of its staged copy
    for (int f = t / 32; f < n_fields; f += warps) {
      phq_pack_field(table[n_sources + f], table, out + (size_t)r0 * total, total, r0, rows, lane, n, align,
                     whole_words, decoded, confidence, qcfail, uncertain, forced);
    }
    return;
  }
  // the block's rows in shared memory; with more fields than warps, a
  // copy of the table after them (a warp walks several fields, each a
  // chain of table reads: 0.0377 against 0.0428 ms read from device
  // memory at 64 decoders), else the table read where it is (no copy and
  // barrier: 0.0046 against 0.0054-0.0057 on the fast whitelist's 5
  // fields; PERF.md PR 16)
  if (n_fields > warps) {
    int4* copy = reinterpret_cast<int4*>(smem + (reads * total + 15) / 16 * 16);
    for (int s = t; s < n_sources + n_fields; s += reads) copy[s] = table[s];
    __syncthreads();
    for (int f = t / 32; f < n_fields; f += warps) {
      phq_pack_field(copy[n_sources + f], copy, smem, total, r0, rows, lane, n, align, whole_words, decoded,
                     confidence, qcfail, uncertain, forced);
    }
  } else {
    for (int f = t / 32; f < n_fields; f += warps) {
      phq_pack_field(table[n_sources + f], table, smem, total, r0, rows, lane, n, align, whole_words, decoded,
                     confidence, qcfail, uncertain, forced);
    }
  }
  __syncthreads();

  // the block's rows are one span of the output, 16-byte aligned
  uint8_t* dst = out + (size_t)r0 * total;
  const int span = rows * total;
  const int words = span >> 4;
  for (int c = threadIdx.x; c < words; c += reads) ((uint4*)dst)[c] = ((const uint4*)smem)[c];
  for (int b = 16 * words + threadIdx.x; b < span; b += reads) dst[b] = smem[b];
}

// `reads` (a multiple of 32, at most PHQ_PACK_MAX_READS), `staged` and
// `table` (n_sources sources and n_fields fields, int4 rows) come from
// kernels/pack.py:pack_plan; `out` is 16-byte aligned.
PHQ_EXPORT int phq_pack(
    int n, int total, int reads, int staged, int n_sources, int n_fields, const void* table, const void* decoded,
    const void* confidence, const void* qcfail, const void* uncertain, const void* forced, void* out,
    void* stream) {
  if (reads < 32 || reads > PHQ_PACK_MAX_READS || reads % 32 != 0 || ((uintptr_t)table & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  // the rows, and a copy of the table where there are more fields than warps
  const int shared_bytes =
      staged ? (reads * total + 15) / 16 * 16 + (n_fields > reads / 32 ? 16 * (n_sources + n_fields) : 0) : 0;
  if (shared_bytes > PHQ_PACK_SHARED_MAX || ((uintptr_t)out & 15) != 0) return (int)cudaErrorInvalidValue;
  if (shared_bytes > 48 * 1024) {
    const cudaError_t status =
        cudaFuncSetAttribute(phq_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (status != cudaSuccess) return (int)status;
  }
  if (n > 0) {
    PHQ_LAUNCH(phq_pack_kernel, (n + reads - 1) / reads, reads, shared_bytes, (cudaStream_t)stream)(
        n, total, staged, n_sources, n_fields, (const int4*)table, (const int*)decoded, (const float*)confidence,
        (const uint8_t*)qcfail, (const uint8_t*)uncertain, (const uint8_t*)forced, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}
