// K3: wire unpack + decoder token extraction.
//
// Replaces the TPU program's pheniqs_tpu/device/step.py:_unpack_h2d_blob
// (434-514) with _codebook_select (423-431), followed by
// pheniqs_tpu/device/classify.py:apply_plans (111-202), for every PAMLD
// and MDD decoder of the instrument at once (an MDD decoder's observation
// segments side by side, each with its own length column).
//
// Bound on the H100: memory. Per read it reads one wire row (26 B on the
// flagship j4 wire) and writes each PAMLD or MDD decoder's (code, quality)
// token bytes, its token lengths and one short flag, plus three flag
// bytes: about 110 B per read on the flagship (with either sample
// decoder), 14 MB per 131072-read batch, a few microseconds of HBM time.
// Arithmetic is a handful of shifts per base.
// Design: a block owns R consecutive reads (R a multiple of 16, one thread
// each; kernels/unpack.py:block_plan picks R and the shared layout). Its
// wire rows are one contiguous span, loaded into shared memory with
// 16-byte loads, neighbouring threads on neighbouring addresses, whatever
// the blob's alignment. Each thread walks a small int32 program (the wire
// layout and every token plan, kernels/unpack.py:token_layout), held in
// shared memory with the codebooks, over its own row and writes its
// tokens, lengths (summed there), short flags and flags into staging rows
// in shared memory. After a barrier the block writes each output's span
// (its R rows are contiguous in every output) with 16-byte stores, so a
// warp's stores fill whole sectors. The staging rows of codes and
// qualities have an odd number of words, so the 32 threads of a warp
// writing one column hit 32 banks. One launch covers every wire layout
// (6-bit, 2-bit and 4-bit codebook, j4, and the raw byte rows through
// which apply_plans reaches this kernel on its own) and both gathers of
// apply_plans (the static forward window and the general clipped gather
// with negative starts and reverse complement). Where a layout's rows are
// too wide to stage at R = 32, the plan reads the wire, or writes codes and
// qualities, then lengths and short flags, in place in device memory
// instead; the three flags are always staged. A program that does not fit beside the staged rows (past
// ~50,000 ints at the flagship's rows) is read from device memory through
// the read-only path: every thread walks the same program, so its loads
// are broadcasts that stay in L1.
#include "common.cuh"

#define PHQ_UNPACK_HEADER 24
#define PHQ_UNPACK_MAX_READS 128
#define PHQ_SEG_INTS 5
#define PHQ_PLAN_INTS 9
#define PHQ_ENTRY_INTS 3

// The block plan (kernels/unpack.py:BlockPlan.ints, in this order): reads
// a block, whether the wire, the codes and qualities, the program and the
// lengths and short flags are staged, the pitch of a staged token row (bytes) and length row (ints),
// the byte offset of each staging area in dynamic shared memory, and its
// size.
struct PhqUnpackPlan {
  int reads, stage_wire, stage_tokens, stage_program, stage_lengths, token_pitch, length_pitch;
  int wire_at, codes_at, quals_at, lengths_at, short_at, flags_at, shared_bytes;
};
#define PHQ_UNPACK_PLAN_INTS 14

// (code, quality) of wire position `pos` of one segment.
__device__ __forceinline__ void phq_decode_base(
    const uint8_t* row, const int* seg, int mode, int pos, const int* ccb,
    const int* qcb, int& code, int& qual) {
  const int code_off = seg[1];
  const int qual_off = seg[2];
  if (mode == PHQ_WIRE_J4) {
    const int byte = row[qual_off + (pos >> 1)];
    const int idx = (pos & 1) ? (byte >> 4) : (byte & 15);
    code = ccb[idx];
    qual = qcb[idx];
    return;
  }
  if (mode == PHQ_WIRE_RAW) {
    code = row[code_off + pos];
    qual = row[qual_off + pos];
    return;
  }
  const int cbyte = row[code_off + (pos >> 1)];
  code = (pos & 1) ? (cbyte >> 4) : (cbyte & 15);
  if (mode == PHQ_WIRE_6) {
    const uint8_t* g = row + qual_off + 3 * (pos >> 2);
    switch (pos & 3) {
      case 0: qual = g[0] & 63; break;
      case 1: qual = (g[0] >> 6) | ((g[1] & 15) << 2); break;
      case 2: qual = (g[1] >> 4) | ((g[2] & 3) << 4); break;
      default: qual = g[2] >> 2; break;
    }
  } else if (mode == PHQ_WIRE_2) {
    const int byte = row[qual_off + (pos >> 2)];
    qual = qcb[(byte >> (2 * (pos & 3))) & 3];
  } else {
    const int byte = row[qual_off + (pos >> 1)];
    qual = qcb[(pos & 1) ? (byte >> 4) : (byte & 15)];
  }
}

// Copies `bytes` bytes from `src` (any alignment) into shared memory at
// dst + (src % 16), dst 16-byte aligned: whole 16-byte words with one load
// each, neighbouring threads on neighbouring words; the partial words at
// either end byte by byte, so nothing outside the span is read. Returns
// src % 16.
__device__ __forceinline__ int phq_load_span(uint8_t* dst, const uint8_t* src, int bytes) {
  const int lead = (int)((uintptr_t)src & 15);
  const uint8_t* base = src - lead;
  const int end = lead + bytes;
  for (int c = threadIdx.x; 16 * c < end; c += blockDim.x) {
    const int b0 = 16 * c;
    if (b0 >= lead && b0 + 16 <= end) {
      *(uint4*)(dst + b0) = *(const uint4*)(base + b0);
    } else {
      for (int b = max(b0, lead); b < min(b0 + 16, end); ++b) dst[b] = base[b];
    }
  }
  return lead;
}

// Writes the first `cols` bytes of `rows` staged rows (row r at
// src + r * pitch) to the contiguous span dst (rows * cols bytes, dst
// 16-byte aligned): each thread gathers 16 bytes of the span, as
// elements of T (4-byte words where cols and pitch allow), and stores
// them at once; the span's last partial 16 bytes element by element.
template <typename T>
__device__ __forceinline__ void phq_store_rows_as(uint8_t* dst, const uint8_t* src, int rows, int cols,
                                                  int pitch) {
  constexpr int per = 16 / sizeof(T);
  const int ecols = cols / (int)sizeof(T);
  const int epitch = pitch / (int)sizeof(T);
  const T* s = (const T*)src;
  T* d = (T*)dst;
  const int total = rows * ecols;
  for (int c = threadIdx.x; per * c < total; c += blockDim.x) {
    const int e0 = per * c;
    int r = e0 / ecols;
    int col = e0 - r * ecols;
    if (e0 + per <= total) {
      union {
        uint4 v;
        T e[per];
      } u;
#pragma unroll
      for (int q = 0; q < per; ++q) {
        u.e[q] = s[r * epitch + col];
        if (++col == ecols) {
          col = 0;
          ++r;
        }
      }
      *(uint4*)(d + e0) = u.v;
    } else {
      for (int e = e0; e < total; ++e) {
        d[e] = s[r * epitch + col];
        if (++col == ecols) {
          col = 0;
          ++r;
        }
      }
    }
  }
}

__device__ __forceinline__ void phq_store_rows(uint8_t* dst, const uint8_t* src, int rows, int cols, int pitch) {
  if (cols == 0) return;
  if ((cols & 3) == 0 && (pitch & 3) == 0) {
    phq_store_rows_as<uint32_t>(dst, src, rows, cols, pitch);
  } else {
    phq_store_rows_as<uint8_t>(dst, src, rows, cols, pitch);
  }
}

// spec layout (kernels/unpack.py:token_layout):
//   [0] wire mode  [1] segments  [2] flags offset  [3] plans  [4] entries
//   [5] decoder slots  [6] token columns  [7] length columns
//   [8..23] BAM reverse-complement table
//   then per segment  [width, code offset, quality offset, length offset, length bytes]
//   then per plan     [input segment, start, end, end terminated, reverse complement,
//                      token column, width, length column, 0]
//   then per entry    [decoder slot, length column, observation segment width]
__global__ void __launch_bounds__(PHQ_UNPACK_MAX_READS) phq_unpack_kernel(
    const uint8_t* __restrict__ blob, int n, int row_bytes,
    const int* __restrict__ spec, int spec_len, const int* __restrict__ ccb,
    const int* __restrict__ qcb, PhqUnpackPlan plan, uint8_t* __restrict__ codes,
    uint8_t* __restrict__ quals, int* __restrict__ lens,
    uint8_t* __restrict__ short_flags, uint8_t* __restrict__ qcfail,
    uint8_t* __restrict__ pad, uint8_t* __restrict__ forced) {
  PHQ_DYNAMIC_SMEM(smem);
  // the program in shared memory, or read in place (read-only loads)
  const int* s_spec = plan.stage_program ? (const int*)smem : spec;
  __shared__ int s_ccb[16];
  __shared__ int s_qcb[16];
  if (plan.stage_program) {
    for (int t = threadIdx.x; t < spec_len; t += blockDim.x) ((int*)smem)[t] = spec[t];
  }
  if (threadIdx.x < 16) {
    // codebooks hold 16 entries, 4 on the 2-bit wire; ccb exists on j4
    // only; the 6-bit and raw layouts carry none
    const int entries = spec[0] == PHQ_WIRE_2 ? 4 : 16;
    const int t = threadIdx.x;
    s_ccb[t] = ccb != nullptr ? ccb[t] : 0;
    s_qcb[t] = (qcb != nullptr && t < entries) ? qcb[t] : 0;
  }
  const int r0 = blockIdx.x * plan.reads;
  const int rows = min(plan.reads, n - r0);
  const uint8_t* wire = blob + (size_t)r0 * row_bytes;
  int lead = 0;
  if (plan.stage_wire) lead = phq_load_span(smem + plan.wire_at, wire, rows * row_bytes);
  __syncthreads();

  const int mode = s_spec[0];
  const int n_segments = s_spec[1];
  const int flags_offset = s_spec[2];
  const int n_plans = s_spec[3];
  const int n_entries = s_spec[4];
  const int n_slots = s_spec[5];
  const int token_cols = s_spec[6];
  const int length_cols = s_spec[7];
  uint8_t* s_flags = smem + plan.flags_at;
  const int t = threadIdx.x;
  if (t < rows) {
    const int* revcomp = s_spec + 8;
    const int* segments = s_spec + PHQ_UNPACK_HEADER;
    const int* plans = segments + PHQ_SEG_INTS * n_segments;
    const int* entries = plans + PHQ_PLAN_INTS * n_plans;

    const uint8_t* row = plan.stage_wire ? smem + plan.wire_at + lead + t * row_bytes
                                         : wire + (size_t)t * row_bytes;
    const size_t i = (size_t)r0 + t;
    uint8_t* my_codes = plan.stage_tokens ? smem + plan.codes_at + t * plan.token_pitch
                                          : codes + i * token_cols;
    uint8_t* my_quals = plan.stage_tokens ? smem + plan.quals_at + t * plan.token_pitch
                                          : quals + i * token_cols;
    int* my_lens = plan.stage_lengths ? (int*)(smem + plan.lengths_at) + t * plan.length_pitch
                                      : lens + i * length_cols;
    uint8_t* my_short = plan.stage_lengths ? smem + plan.short_at + t * n_slots : short_flags + i * n_slots;
    for (int s = 0; s < length_cols; ++s) my_lens[s] = 0;

    for (int p = 0; p < n_plans; ++p) {
      const int* plan_ints = plans + PHQ_PLAN_INTS * p;
      const int* seg = segments + PHQ_SEG_INTS * plan_ints[0];
      const int plan_start = plan_ints[1];
      const int plan_end = plan_ints[2];
      const bool end_terminated = plan_ints[3] != 0;
      const bool reverse = plan_ints[4] != 0;
      const int column = plan_ints[5];
      const int width = plan_ints[6];
      const int w_in = seg[0];
      const int length =
          seg[4] == 1 ? row[seg[3]] : (row[seg[3]] | (row[seg[3] + 1] << 8));
      // python-slice coordinate resolution (reference transform.h:73-88)
      int start;
      if (plan_start < 0) {
        start = max(length + plan_start, 0);
      } else {
        start = plan_start > length ? 0 : plan_start;
      }
      int end;
      if (!end_terminated) {
        end = length;
      } else if (plan_end < 0) {
        end = max(length + plan_end, 0);
      } else {
        end = min(plan_end, length);
      }
      const int size = max(end - start, 0);
      for (int j = 0; j < width; ++j) {
        int code = 0;
        int qual = 0;
        if (j < size && w_in > 0) {
          if (!reverse && plan_start >= 0) {
            // static forward window: columns past the segment read as zero
            const int pos = start + j;
            if (pos < w_in) phq_decode_base(row, seg, mode, pos, s_ccb, s_qcb, code, qual);
          } else {
            int pos = reverse ? end - 1 - j : start + j;
            pos = min(max(pos, 0), w_in - 1);
            phq_decode_base(row, seg, mode, pos, s_ccb, s_qcb, code, qual);
            if (reverse) code = revcomp[code];
          }
        }
        my_codes[column + j] = (uint8_t)code;
        my_quals[column + j] = (uint8_t)qual;
      }
      my_lens[plan_ints[7]] += size;
    }

    // observations shorter than their segment width: the hybrid host always
    // re-resolves them (pheniqs_tpu/device/step.py:135-142)
    for (int d = 0; d < n_slots; ++d) my_short[d] = 0;
    for (int e = 0; e < n_entries; ++e) {
      const int* entry = entries + PHQ_ENTRY_INTS * e;
      if (my_lens[entry[1]] < entry[2]) my_short[entry[0]] = 1;
    }

    const int flags = row[flags_offset];
    s_flags[t] = (flags & 1) ? 1 : 0;
    s_flags[plan.reads + t] = (flags & 2) ? 1 : 0;
    s_flags[2 * plan.reads + t] = (flags & 4) ? 1 : 0;
  }
  __syncthreads();

  // every output's rows [r0, r0 + rows) are one span; R is a multiple of
  // 16, so each span starts 16-byte aligned in the wrapper's outputs
#ifndef PHQ_UNPACK_NO_TOKEN_STORES  // defined only by chip_smoke.py --times' diagnostic copy
  if (plan.stage_tokens) {
    phq_store_rows(codes + (size_t)r0 * token_cols, smem + plan.codes_at, rows, token_cols, plan.token_pitch);
    phq_store_rows(quals + (size_t)r0 * token_cols, smem + plan.quals_at, rows, token_cols, plan.token_pitch);
  }
#endif
  if (plan.stage_lengths) {
    phq_store_rows((uint8_t*)(lens + (size_t)r0 * length_cols), smem + plan.lengths_at, rows, 4 * length_cols,
                   4 * plan.length_pitch);
    phq_store_rows(short_flags + (size_t)r0 * n_slots, smem + plan.short_at, rows, n_slots, n_slots);
  }
  phq_store_rows(qcfail + r0, s_flags, rows, 1, 1);
  phq_store_rows(pad + r0, s_flags + plan.reads, rows, 1, 1);
  phq_store_rows(forced + r0, s_flags + 2 * plan.reads, rows, 1, 1);
}

// `plan_ints` (host memory) is kernels/unpack.py:BlockPlan.ints(): the
// reads a block and the shared layout for this program and row size.
PHQ_EXPORT int phq_unpack_tokens(
    const void* blob, int n, int row_bytes, const void* spec, int spec_len,
    const void* ccb, const void* qcb, const int* plan_ints, void* codes, void* quals,
    void* lens, void* short_flags, void* qcfail, void* pad, void* forced, void* stream) {
  PhqUnpackPlan plan;
  int* fields = (int*)&plan;
  for (int k = 0; k < PHQ_UNPACK_PLAN_INTS; ++k) fields[k] = plan_ints[k];
  if (plan.reads < 16 || plan.reads > PHQ_UNPACK_MAX_READS || plan.reads % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    if (plan.shared_bytes > 48 * 1024) {
      const cudaError_t status = cudaFuncSetAttribute(
          phq_unpack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.shared_bytes);
      if (status != cudaSuccess) return (int)status;
    }
    const int blocks = (n + plan.reads - 1) / plan.reads;
    PHQ_LAUNCH(phq_unpack_kernel, blocks, plan.reads, plan.shared_bytes, (cudaStream_t)stream)(
        (const uint8_t*)blob, n, row_bytes, (const int*)spec, spec_len,
        (const int*)ccb, (const int*)qcb, plan, (uint8_t*)codes, (uint8_t*)quals,
        (int*)lens, (uint8_t*)short_flags, (uint8_t*)qcfail, (uint8_t*)pad,
        (uint8_t*)forced);
  }
  return (int)cudaGetLastError();
}
