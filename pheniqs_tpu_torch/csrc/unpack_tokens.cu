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
// Arithmetic is a handful of shifts per base; a layout of thousands of
// token plans adds a plan's slice arithmetic per read and plan, which the
// column plan does once.
//
// Two plans (kernels/unpack.py:unpack_plan), one launch each.
//
// The block plan (phq_unpack_kernel), where a block of R = 128 reads
// stages everything in shared memory, two blocks an SM
// (kernels/unpack.py:block_plan; the flagship, MDD flagship and whitelist
// layouts): a block owns 128
// consecutive reads, one thread each. Its wire rows are one contiguous
// span, loaded into shared memory with 16-byte loads, neighbouring
// threads on neighbouring addresses, whatever the blob's alignment. Each
// thread walks a small int32 program (the wire layout and every token
// plan, kernels/unpack.py:token_layout), held in shared memory with the
// codebooks, over its own row and writes its tokens, lengths (summed
// there), short flags and flags into staging rows in shared memory. After
// a barrier the block writes each output's span (its R rows are
// contiguous in every output) with 16-byte stores, so a warp's stores
// fill whole sectors. The staging rows of codes and qualities have an odd
// number of words, so the 32 threads of a warp writing one column hit 32
// banks. One launch covers every wire layout (6-bit, 2-bit and 4-bit
// codebook, j4, and the raw byte rows through which apply_plans reaches
// this kernel on its own) and both gathers of apply_plans (the static
// forward window and the general clipped gather with negative starts and
// reverse complement).
//
// The column plan (phq_unpack_columns_kernel), for every other layout: a
// long program, token rows or length rows too wide to stage for 128 reads
// (or to stage twice in an SM). Walking the program serially a thread per
// read is what made those layouts slow (one or four warps an SM where the
// program is staged, 32 sectors a warp store where rows are written in
// place), so the work of a read is split instead. A table built once per layout on the host
// (kernels/unpack.py:column_table) lists the plans by length column, each
// with its start, end, first token column, width and flags; cuts each
// length column's plans into items of at most 16 plans; and groups the
// decoder slots into chunks whose columns 32 reads stage in a block's
// shared memory. A block owns 32 reads and one chunk, a lane a read: its
// warps take the chunk's items in turn, so every lane of a warp walks the
// same plans (table loads are broadcasts, no lane diverges), resolves
// each plan's extent in its own read once, writes the code and quality
// bytes into the read's staged row and adds the sizes to the staged
// length (an integer atomic add in shared memory: nothing is
// read-modify-written in device memory). After a barrier each staged
// length below its segment's width sets its read's short flag for the
// slot; after another the block writes the chunk's columns of each row,
// 4-byte words where the row allows (32 lanes a 128-byte line). The wire
// rows are staged where they fit. A slot whose columns 32 reads cannot
// stage is its own chunk, run in place: a warp walks a length column's
// items at a time and writes bytes, length and short flag to device
// memory (uncoalesced, and only for layouts no instrument has).
#include "common.cuh"

#define PHQ_UNPACK_HEADER 24
#define PHQ_UNPACK_MAX_READS 128
#define PHQ_SEG_INTS 5
#define PHQ_PLAN_INTS 9
#define PHQ_ENTRY_INTS 3

// The block plan (kernels/unpack.py:BlockPlan.ints, in this order): reads
// a block (R = 128), the pitch of a staged token row (bytes) and length
// row (ints), the byte offset of each staging area in dynamic shared
// memory (the program, the wire rows, codes, qualities, lengths, short
// flags and flags, all staged), and its size.
struct PhqUnpackPlan {
  int reads, token_pitch, length_pitch;
  int wire_at, codes_at, quals_at, lengths_at, short_at, flags_at, shared_bytes;
};
#define PHQ_UNPACK_PLAN_INTS 10

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

// The python-slice coordinates of a token plan (reference
// transform.h:73-88) in the read of wire row `row`: its resolved
// [start, end) in segment `seg`, and its size.
__device__ __forceinline__ int phq_plan_extent(const uint8_t* row, const int* seg, int plan_start, int plan_end,
                                               bool end_terminated, int& start, int& end) {
  const int length = seg[4] == 1 ? row[seg[3]] : (row[seg[3]] | (row[seg[3] + 1] << 8));
  if (plan_start < 0) {
    start = max(length + plan_start, 0);
  } else {
    start = plan_start > length ? 0 : plan_start;
  }
  if (!end_terminated) {
    end = length;
  } else if (plan_end < 0) {
    end = max(length + plan_end, 0);
  } else {
    end = min(plan_end, length);
  }
  return max(end - start, 0);
}

// (code, quality) of offset j < size of a plan over segment `seg` (width
// > 0): the static forward window (`forward`: a start >= 0, no reverse
// complement; columns past the segment read as zero) or the general
// clipped gather.
__device__ __forceinline__ void phq_token_base(const uint8_t* row, const int* seg, int mode, int start, int end,
                                               int j, bool forward, bool reverse, const int* ccb, const int* qcb,
                                               const int* revcomp, int& code, int& qual) {
  const int w_in = seg[0];
  if (!reverse && forward) {
    const int pos = start + j;
    if (pos < w_in) phq_decode_base(row, seg, mode, pos, ccb, qcb, code, qual);
    return;
  }
  int pos = reverse ? end - 1 - j : start + j;
  pos = min(max(pos, 0), w_in - 1);
  phq_decode_base(row, seg, mode, pos, ccb, qcb, code, qual);
  if (reverse) code = revcomp[code];
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
  const int* s_spec = (const int*)smem;
  __shared__ int s_ccb[16];
  __shared__ int s_qcb[16];
  for (int t = threadIdx.x; t < spec_len; t += blockDim.x) ((int*)smem)[t] = spec[t];
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
  const int lead = phq_load_span(smem + plan.wire_at, blob + (size_t)r0 * row_bytes, rows * row_bytes);
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

    const uint8_t* row = smem + plan.wire_at + lead + t * row_bytes;
    uint8_t* my_codes = smem + plan.codes_at + t * plan.token_pitch;
    uint8_t* my_quals = smem + plan.quals_at + t * plan.token_pitch;
    int* my_lens = (int*)(smem + plan.lengths_at) + t * plan.length_pitch;
    uint8_t* my_short = smem + plan.short_at + t * n_slots;
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
      int start, end;
      const int size = phq_plan_extent(row, seg, plan_start, plan_end, end_terminated, start, end);
      for (int j = 0; j < width; ++j) {
        int code = 0;
        int qual = 0;
        if (j < size && w_in > 0) phq_token_base(row, seg, mode, start, end, j, plan_start >= 0, reverse, s_ccb,
                                                 s_qcb, revcomp, code, qual);
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
  phq_store_rows(codes + (size_t)r0 * token_cols, smem + plan.codes_at, rows, token_cols, plan.token_pitch);
  phq_store_rows(quals + (size_t)r0 * token_cols, smem + plan.quals_at, rows, token_cols, plan.token_pitch);
#endif
  phq_store_rows((uint8_t*)(lens + (size_t)r0 * length_cols), smem + plan.lengths_at, rows, 4 * length_cols,
                 4 * plan.length_pitch);
  phq_store_rows(short_flags + (size_t)r0 * n_slots, smem + plan.short_at, rows, n_slots, n_slots);
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
  if (plan.reads != PHQ_UNPACK_MAX_READS) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    // past 48 KB of shared memory with the codebooks, by opt-in
    if (plan.shared_bytes + 128 > 48 * 1024) {
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

// --- the column plan ------------------------------------------------------

#define PHQ_COLUMN_THREADS 256
#define PHQ_COLUMN_WARPS (PHQ_COLUMN_THREADS / 32)
// reads a block of the column plan owns: a lane each
#define PHQ_COLUMN_READS 32
// the program's header and segment table are staged in shared memory when
// they take at most this many ints (else read in place: a warp's lanes
// read the same few segments, broadcasts that stay in L1)
#define PHQ_COLUMN_SPEC_SHARED 1024
// column table header (kernels/unpack.py:column_table): token columns,
// length columns, slots, items, chunks, then the int offsets of the
// items, the plans, the length columns and the chunks, 0 to 16 ints
#define PHQ_COLUMN_HEADER 16

// The elements of one phase of a block: f(k, c) for k < rows and c <
// per_read, consecutive threads on consecutive c.
template <typename F>
__device__ __forceinline__ void phq_elements(int rows, int per_read, F f) {
  if (per_read <= 0) return;
  int k = threadIdx.x / per_read;
  int c = threadIdx.x - k * per_read;
  const int dk = blockDim.x / per_read;
  const int dc = blockDim.x - dk * per_read;
  for (int e = threadIdx.x; e < rows * per_read; e += blockDim.x) {
    f(k, c);
    c += dc;
    k += dk;
    if (c >= per_read) {
      c -= per_read;
      ++k;
    }
  }
}

// Writes `cols` bytes of `rows` staged rows (row k at src + k * pitch) to
// dst + k * stride: 4-byte words where every destination row is 4-byte
// aligned, bytes where not; consecutive threads on consecutive words.
__device__ __forceinline__ void phq_store_tile(uint8_t* dst, size_t stride, const uint8_t* src, int pitch, int rows,
                                               int cols) {
  if (((uintptr_t)dst & 3) == 0 && (stride & 3) == 0 && (cols & 3) == 0 && (pitch & 3) == 0) {
    phq_elements(rows, cols >> 2, [&](int k, int w) {
      ((uint32_t*)(dst + k * stride))[w] = ((const uint32_t*)(src + k * pitch))[w];
    });
  } else {
    phq_elements(rows, cols, [&](int k, int c) { dst[k * stride + c] = src[k * pitch + c]; });
  }
}

// Bytes of a row of `count` columns staged an odd number of words apart
// (a warp's 32 rows at one column fall in 32 banks).
__device__ __forceinline__ int phq_odd_pitch(int count) { return count ? 4 * (((count + 3) / 4) | 1) : 0; }

// `table` the layout's column table; the blocks are (read groups of 32) x
// (chunks); `stage_wire`: the 32 wire rows in shared memory.
__global__ void __launch_bounds__(PHQ_COLUMN_THREADS) phq_unpack_columns_kernel(
    const uint8_t* __restrict__ blob, int n, int row_bytes, const int* __restrict__ spec,
    const int* __restrict__ ccb, const int* __restrict__ qcb, const int* __restrict__ table, int stage_wire,
    uint8_t* __restrict__ codes, uint8_t* __restrict__ quals, int* __restrict__ lens,
    uint8_t* __restrict__ short_flags, uint8_t* __restrict__ qcfail, uint8_t* __restrict__ pad,
    uint8_t* __restrict__ forced) {
  PHQ_DYNAMIC_SMEM(smem);
  __shared__ int s_spec[PHQ_COLUMN_SPEC_SHARED];
  __shared__ int s_ccb[16];
  __shared__ int s_qcb[16];
  const int spec_ints = PHQ_UNPACK_HEADER + PHQ_SEG_INTS * spec[1];
  const bool spec_staged = spec_ints <= PHQ_COLUMN_SPEC_SHARED;
  if (spec_staged) {
    for (int t = threadIdx.x; t < spec_ints; t += blockDim.x) s_spec[t] = spec[t];
  }
  if (threadIdx.x < 16) {
    const int entries = spec[0] == PHQ_WIRE_2 ? 4 : 16;
    const int t = threadIdx.x;
    s_ccb[t] = ccb != nullptr ? ccb[t] : 0;
    s_qcb[t] = (qcb != nullptr && t < entries) ? qcb[t] : 0;
  }
  const int token_cols = table[0];
  const int length_cols = table[1];
  const int n_slots = table[2];
  const int4* items = (const int4*)(table + table[5]);  // {first plan, end plan, length column, 0}
  const int4* plans = (const int4*)(table + table[6]);  // {start, end, column, flags}, {width, 0, 0, 0}
  const int4* lcols = (const int4*)(table + table[7]);  // {first item, end item, width, slot}
  // the chunk: {first, end token column, first, end length column},
  // {first, end item, first, end slot}, {staged, 0, 0, 0}
  const int4* chunk = (const int4*)(table + table[8]) + 3 * blockIdx.y;
  const int4 span = __ldg(chunk);
  const int4 walk_span = __ldg(chunk + 1);
  const bool staged = __ldg(&chunk[2].x) != 0;
  const int c0 = span.x, l0 = span.z, d0 = walk_span.z;
  const int ncols = span.y - span.x, nl = span.w - span.z, nd = walk_span.w - walk_span.z;
  const int cpitch = phq_odd_pitch(ncols);
  const int lpitch = nl | 1;
  const int r0 = blockIdx.x * PHQ_COLUMN_READS;
  const int rows = min(PHQ_COLUMN_READS, n - r0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // shared memory: the wire rows, then the chunk's codes, qualities,
  // lengths and short flags of the 32 reads
  const uint8_t* wire = blob + (size_t)r0 * row_bytes;
  int at = 0;
  int lead = 0;
  if (stage_wire) {
    lead = phq_load_span(smem, wire, rows * row_bytes);
    at = (PHQ_COLUMN_READS * row_bytes + 16 + 15) / 16 * 16;
  }
  uint8_t* s_codes = smem + at;
  uint8_t* s_quals = s_codes + PHQ_COLUMN_READS * cpitch;
  int* s_lens = (int*)(s_quals + PHQ_COLUMN_READS * cpitch);
  uint8_t* s_short = (uint8_t*)(s_lens + PHQ_COLUMN_READS * lpitch);
  if (staged) {
    const int bytes = (int)(s_short - s_codes) + PHQ_COLUMN_READS * nd;
    for (int t = threadIdx.x; 16 * t < bytes; t += blockDim.x) ((uint4*)s_codes)[t] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  const int* head = spec_staged ? s_spec : spec;
  const int mode = head[0];
  const int flags_offset = head[2];
  const int* revcomp = head + 8;
  const int* segments = head + PHQ_UNPACK_HEADER;
  // a lane's read (past the batch's end, the last read, its results never
  // stored)
  const int k = min(lane, rows - 1);
  const uint8_t* row = stage_wire ? smem + lead + k * row_bytes : wire + (size_t)k * row_bytes;
  // the plans of `item` in the lane's read: their bytes into
  // my_codes[column - c0] (a row), the sum of their sizes returned; each
  // plan's record loaded one plan ahead
  auto walk = [&](int4 item, uint8_t* my_codes, uint8_t* my_quals) {
    int sum = 0;
    int4 next = item.x < item.y ? __ldg(plans + 2 * item.x) : make_int4(0, 0, 0, 0);
    int next_width = item.x < item.y ? __ldg(&plans[2 * item.x + 1].x) : 0;
    for (int p = item.x; p < item.y; ++p) {
      const int4 a = next;
      const int width = next_width;
      if (p + 1 < item.y) {
        next = __ldg(plans + 2 * (p + 1));
        next_width = __ldg(&plans[2 * (p + 1) + 1].x);
      }
      const int* seg = segments + PHQ_SEG_INTS * (a.w >> 8);
      int start, end;
      const int size = phq_plan_extent(row, seg, a.x, a.y, (a.w & 2) != 0, start, end);
      for (int j = 0; j < width; ++j) {
        int code = 0;
        int qual = 0;
        if (j < size && seg[0] > 0) {
          phq_token_base(row, seg, mode, start, end, j, a.x >= 0, (a.w & 4) != 0, s_ccb, s_qcb, revcomp, code, qual);
        }
        my_codes[a.z - c0 + j] = (uint8_t)code;
        my_quals[a.z - c0 + j] = (uint8_t)qual;
      }
      sum += size;
    }
    return sum;
  };

  if (staged) {
    uint8_t* my_codes = s_codes + lane * cpitch;
    uint8_t* my_quals = s_quals + lane * cpitch;
    // a warp's items in turn, each item's record loaded one item ahead
    int it = walk_span.x + warp;
    int4 item = it < walk_span.y ? __ldg(items + it) : make_int4(0, 0, 0, 0);
    while (it < walk_span.y) {
      const int after = it + PHQ_COLUMN_WARPS;
      const int4 next = after < walk_span.y ? __ldg(items + after) : make_int4(0, 0, 0, 0);
      const int sum = walk(item, my_codes, my_quals);
      atomicAdd(s_lens + lane * lpitch + item.z - l0, sum);
      item = next;
      it = after;
    }
    __syncthreads();
    // observations shorter than their segment width: the hybrid host
    // always re-resolves them (pheniqs_tpu/device/step.py:135-142)
    phq_elements(rows, nl, [&](int r, int l) {
      const int4 lc = __ldg(lcols + l0 + l);
      if (s_lens[r * lpitch + l] < lc.z) s_short[r * nd + lc.w - d0] = 1;
    });
    __syncthreads();
    phq_store_tile(codes + (size_t)r0 * token_cols + c0, token_cols, s_codes, cpitch, rows, ncols);
    phq_store_tile(quals + (size_t)r0 * token_cols + c0, token_cols, s_quals, cpitch, rows, ncols);
    phq_store_tile((uint8_t*)(lens + (size_t)r0 * length_cols + l0), 4 * (size_t)length_cols, (uint8_t*)s_lens,
                   4 * lpitch, rows, 4 * nl);
    phq_store_tile(short_flags + (size_t)r0 * n_slots + d0, n_slots, s_short, nd, rows, nd);
  } else {
    // in place: a warp a length column at a time, the entry zeroed the
    // token bytes and short flags
    const size_t i = (size_t)r0 + lane;
    for (int l = l0 + warp; l < span.w; l += PHQ_COLUMN_WARPS) {
      const int4 lc = __ldg(lcols + l);
      int sum = 0;
      for (int it = lc.x; it < lc.y; ++it) {
        if (lane < rows) sum += walk(__ldg(items + it), codes + i * token_cols + c0, quals + i * token_cols + c0);
      }
      if (lane < rows) {
        lens[i * length_cols + l] = sum;
        if (sum < lc.z) short_flags[i * n_slots + lc.w] = 1;
      }
    }
  }
  if (blockIdx.y == 0 && threadIdx.x < rows) {
    const uint8_t* mine = stage_wire ? smem + lead + threadIdx.x * row_bytes : wire + (size_t)threadIdx.x * row_bytes;
    const int flags = mine[flags_offset];
    qcfail[r0 + threadIdx.x] = (flags & 1) ? 1 : 0;
    pad[r0 + threadIdx.x] = (flags & 2) ? 1 : 0;
    forced[r0 + threadIdx.x] = (flags & 4) ? 1 : 0;
  }
}

// `table` (device memory, 16-byte aligned) is the layout's column table
// (kernels/unpack.py:column_table) and `head` its header in host memory;
// `shared_bytes` the most a chunk stages (kernels/unpack.py:ColumnPlan),
// the wire rows' too where `stage_wire`. A chunk run in place (`in_place`)
// needs the token bytes and short flags zeroed first.
PHQ_EXPORT int phq_unpack_columns(
    const void* blob, int n, int row_bytes, const void* spec, const void* ccb, const void* qcb,
    const void* table, const int* head, int stage_wire, int shared_bytes, int in_place, void* codes, void* quals,
    void* lens, void* short_flags, void* qcfail, void* pad, void* forced, void* stream) {
  const int chunks = head[4];
  if (chunks < 1 || ((uintptr_t)table & 15) != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (in_place) {
      cudaError_t status = cudaMemsetAsync(codes, 0, (size_t)n * head[0], s);
      if (status == cudaSuccess) status = cudaMemsetAsync(quals, 0, (size_t)n * head[0], s);
      if (status == cudaSuccess) status = cudaMemsetAsync(short_flags, 0, (size_t)n * head[2], s);
      if (status != cudaSuccess) return (int)status;
    }
    // past 48 KB of shared memory with the static arrays, by opt-in
    if (shared_bytes + (int)sizeof(int) * (PHQ_COLUMN_SPEC_SHARED + 32) > 48 * 1024) {
      const cudaError_t status = cudaFuncSetAttribute(phq_unpack_columns_kernel,
                                                      cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
      if (status != cudaSuccess) return (int)status;
    }
    const dim3 grid((n + PHQ_COLUMN_READS - 1) / PHQ_COLUMN_READS, chunks);
    PHQ_LAUNCH(phq_unpack_columns_kernel, grid, PHQ_COLUMN_THREADS, shared_bytes, s)(
        (const uint8_t*)blob, n, row_bytes, (const int*)spec, (const int*)ccb, (const int*)qcb, (const int*)table,
        stage_wire, (uint8_t*)codes, (uint8_t*)quals, (int*)lens, (uint8_t*)short_flags, (uint8_t*)qcfail,
        (uint8_t*)pad, (uint8_t*)forced);
  }
  return (int)cudaGetLastError();
}
