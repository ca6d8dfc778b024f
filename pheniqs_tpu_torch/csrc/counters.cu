// K4: per-barcode statistics counters of every decoder of a batch, in
// integers, deterministic.
//
// Replaces the TPU program's pheniqs_tpu/device/step.py:_counters (48-94)
// and _segment_sum (39-45): per decoder, (B+1) sums keyed by the decoded
// index (count, pf count, distance, pf distance, confidence, pf confidence)
// and (B+1, 2) sums keyed by the argmax (low confidence, noise), over the
// rows valid = !pad && !uncertain_any (step.py:667-678), written as one
// flat f32 vector in device/wire.py:counter_layout order.
//
// Bound on the H100: bytes (~20 B a read and decoder in, 4 B a counter
// out; ~0.002 ms on the flagship, ~0.008 ms over the whitelist's 737,281
// bins, ~0.025 ms at 64 decoders), and below that, latency. The TPU's
// one-hot contraction would need an (N, B+1) one-hot; float atomics would
// make the sums depend on scheduling.
// Arithmetic: every column is summed in integers, so the order of the adds
// does not matter and any schedule gives the same bytes.
//  - Six columns hold integers (count, pf count, distance, pf distance, low
//    confidence, noise): 32-bit integer atomics, converted to f32 once
//    (exact while a bin stays below 2^24; kernels/counters.py:slice_rows).
//  - The two confidence columns sum q = rint(c * 2^40) in 64-bit integers
//    (c * 2^40 is exact in f32), converted once as float(sum) * 2^-40: the
//    exact sum of the quantised terms, rounded once, within N * 2^-41 + 1/2
//    ulp of the true sum (N * 2^40 < 2^63: slice_rows). In shared memory
//    each is three 32-bit pieces of 14 bits (no 64-bit shared atomic add
//    but a compare-and-swap loop), put together at the flush.
// Two instances (kernels/counters.py:counter_plan, cached on the
// instrument): where every histogram is shared and all take at most
// PER_DECODER_BYTES together (the flagship paths; up to 33 small
// decoders), phq_counters_decoder, PR 5's grid (below); else
// the grouped kernel: a block owns one tile of reads and one group of
// decoders, blockIdx.x the group, so the groups of a tile run side by
// side.
//  - Each read's valid flag is built once a block, not once a decoder: the
//    block ORs pad, forced and the uncertain rows that count over its tile
//    (4-byte words of 4 reads where the rows allow) into a byte per read in
//    shared memory. So the uncertain rows are read once a group, where the
//    first design read them once a decoder (D x P byte loads a read). A
//    tile with no read to add ends there, and a warp whose chunk holds
//    none skips its adds (a hybrid whitelist batch's cellular decisions
//    are ~all uncertain).
//  - A group is decoders whose shared histograms fit GROUP_BYTES together
//    (2 groups at 33 decoders, 3 at 64). Its warps take the group's
//    (decoder, chunk) items in turn, a chunk two items of 32 lanes x 4
//    consecutive reads (int4, float4 and 4-byte loads where N % 4 == 0),
//    all loaded before the first read is added; the lane then adds its 8
//    reads one at a time from a shifting register window, so the kernel
//    holds one copy of the add a path. A decoder whose histogram fits
//    SHARED_LIMIT adds into shared memory with shared atomics (red.shared:
//    the first design's pointer, shared or global, compiled to generic
//    atomics), a larger panel (the whitelist) straight into global atomics.
//    Either way the lanes on bin 0 (unclassified, or a naive decoder's one
//    bin: the one key many lanes share, whose atomics serialise) are summed
//    first by whole-warp reductions and added by one lane. (A reduction
//    over each key's lanes, __match_any_sync's groups, replays once a
//    group: 10x slower, measured.)
//  - Then the block adds its nonzero bins into the global sums. The tile is
//    as long as a grid of about WAVES blocks an SM allows (the walk is
//    bound by latency: every resident warp counts), so each block sums
//    its tile's reads over the group's decoders several times over the
//    bins it flushes; the first design's blocks (512 reads, one decoder
//    each) flushed their decoder's whole histogram for every 512 reads.
//  - The integer sums live in the output buffer itself, which the finalize
//    launch converts to f32 in place; the fixed-point sums, 16 B a bin of
//    a PAMLD decoder, sit in front of it. One memset zeroes both.
#include "common.cuh"

#define PHQ_COUNTER_THREADS 256
// the grouped kernel's resident blocks an SM (its launch bound: 85
// registers a thread at 3; at 4, 64 and spills)
#define PHQ_COUNTER_BLOCKS_PER_SM 3
// The most dynamic shared memory a block may take on the H100: a group's
// histograms (at most kernels/counters.py:SHARED_LIMIT for one decoder,
// 64 KiB; chip_smoke.py:k4_threshold_sweep measures where shared loses
// to global atomics) and the tile's valid flags.
#define PHQ_COUNTER_SHARED_MAX (227 * 1024)

// One row of the decoder table (kernels/counters.py:CounterPlan.ints).
#define PHQ_COUNTER_FIELDS 7
#define PHQ_T_OFFSET 0  // the decoder's first counter in the flat layout
#define PHQ_T_B1 1      // bins: barcodes + 1 (bin 0 = unclassified)
#define PHQ_T_KIND 2    // 0 count + pf count, 1 + distances, 2 + confidences and filters
#define PHQ_T_COLS 3    // its columns in the layout (2, 4 or 8)
#define PHQ_T_WIDE 4    // its first fixed-point confidence sum, -1 unless kind 2
#define PHQ_T_SHARED 5  // bytes of its shared-memory histogram, 0 = global atomics
#define PHQ_T_SMEM 6    // where that histogram starts in its group's shared memory
// One row of the group table, after the decoder rows: the group's first
// decoder, the one after its last, and its histograms' shared bytes.
#define PHQ_GROUP_FIELDS 3

#define PHQ_CONF_SCALE 1099511627776.0f  // 2^40
#define PHQ_CONF_UNSCALE (1.0f / 1099511627776.0f)

// The sum over the lanes of the warp of v where `mine`, a whole-warp
// reduction (one mask: a reduction over lanes of several masks replays)
__device__ __forceinline__ unsigned phq_warp_sum(bool mine, unsigned v) {
  return __reduce_add_sync(0xffffffffu, mine ? v : 0u);
}

// The same for 64-bit values below 2^63: three pieces of 22 bits, each
// summed over at most 32 lanes without overflow.
__device__ __forceinline__ unsigned long long phq_warp_sum64(bool mine, unsigned long long v) {
  const unsigned lo = phq_warp_sum(mine, (unsigned)(v & 0x3fffffull));
  const unsigned mid = phq_warp_sum(mine, (unsigned)((v >> 22) & 0x3fffffull));
  const unsigned hi = phq_warp_sum(mine, (unsigned)(v >> 44));
  return (unsigned long long)lo + ((unsigned long long)mid << 22) + ((unsigned long long)hi << 44);
}

// A shared-memory add, as the shared atomic it is (a pointer that may be
// global compiles to the slower generic atomic)
__device__ __forceinline__ void phq_shared_add(unsigned* p, unsigned v) {
  asm volatile("red.shared.add.u32 [%0], %1;\n" ::"r"((unsigned)__cvta_generic_to_shared(p)), "r"(v) : "memory");
}

// A fixed-point confidence q <= 2^40 in a shared histogram: three 32-bit
// pieces of 14 bits each (a 64-bit shared atomic add is a compare-and-swap
// loop), each summing at most MAX_TILE = 2^14 reads below 2^28; the flush
// puts them together into the 64-bit global sum.
#define PHQ_PIECE_BITS 14
#define PHQ_PIECE_MASK 0x3fffu

// A window of 2 * VEC reads of one decoder's rows, VEC from each of two
// items (VEC == 4: each item's first read a multiple of 4 and every row
// 16-byte aligned for 4-byte fields, 4-byte for byte fields). The reads
// are added one at a time from the front, the window shifted after each:
// one copy of the add a template instance, not one a read, keeps the
// kernel small enough for the instruction cache.
template <int VEC>
struct PhqCounterWindow {
  static constexpr int R = 2 * VEC;
  int decoded[R], argmax[R], distance[R];
  float confidence[R];
  // a byte a read, the front read's in the low byte: branch (as stored),
  // qcfail, and nonzero where padding or uncertain (not counted)
  unsigned long long branch, qcfail, bad;

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int r = 0; r < R; ++r) decoded[r] = argmax[r] = distance[r] = 0, confidence[r] = 0.0f;
    branch = qcfail = 0ull;
    bad = ~0ull;
  }

  // item h (0 or 1) from read i of the decoder's rows at `row`
  __device__ __forceinline__ void load(int h, int kind, size_t row, size_t i,
                                       const int* __restrict__ decoded_rows, const int* __restrict__ argmax_rows,
                                       const int* __restrict__ distance_rows, const int8_t* __restrict__ branch_rows,
                                       const float* __restrict__ confidence_rows,
                                       const uint8_t* __restrict__ qcfail_rows) {
    const int at = h * VEC, bits = 8 * at;
    if constexpr (VEC == 4) {
      qcfail |= (unsigned long long)*reinterpret_cast<const unsigned*>(qcfail_rows + row + i) << bits;
      if (kind >= 1) {
        const int4 d = *reinterpret_cast<const int4*>(decoded_rows + row + i);
        const int4 s = *reinterpret_cast<const int4*>(distance_rows + row + i);
        decoded[at] = d.x, decoded[at + 1] = d.y, decoded[at + 2] = d.z, decoded[at + 3] = d.w;
        distance[at] = s.x, distance[at + 1] = s.y, distance[at + 2] = s.z, distance[at + 3] = s.w;
      }
      if (kind == 2) {
        const int4 a = *reinterpret_cast<const int4*>(argmax_rows + row + i);
        const float4 c = *reinterpret_cast<const float4*>(confidence_rows + row + i);
        branch |= (unsigned long long)*reinterpret_cast<const unsigned*>(branch_rows + row + i) << bits;
        argmax[at] = a.x, argmax[at + 1] = a.y, argmax[at + 2] = a.z, argmax[at + 3] = a.w;
        confidence[at] = c.x, confidence[at + 1] = c.y, confidence[at + 2] = c.z, confidence[at + 3] = c.w;
      }
    } else {
      qcfail |= (unsigned long long)qcfail_rows[row + i] << bits;
      if (kind >= 1) {
        decoded[at] = decoded_rows[row + i];
        distance[at] = distance_rows[row + i];
      }
      if (kind == 2) {
        argmax[at] = argmax_rows[row + i];
        confidence[at] = confidence_rows[row + i];
        branch |= (unsigned long long)(uint8_t)branch_rows[row + i] << bits;
      }
    }
  }

  // item h's valid flags (the tile's, in shared memory, once built)
  __device__ __forceinline__ void flag(int h, const uint8_t* flags) {
    const int bits = 8 * h * VEC;
    const unsigned long long keep = ~(((1ull << (8 * VEC)) - 1) << bits);
    if constexpr (VEC == 4) {
      bad = (bad & keep) | (unsigned long long)*reinterpret_cast<const unsigned*>(flags) << bits;
    } else {
      bad = (bad & keep) | (unsigned long long)flags[0] << bits;
    }
  }

  // whether item h has a read to add (a zero flag byte)
  __device__ __forceinline__ bool counts(int h) const {
    const unsigned bytes = (unsigned)(bad >> (8 * h * VEC));
    if constexpr (VEC == 4) {
      return ((bytes - 0x01010101u) & ~bytes & 0x80808080u) != 0u;
    } else {
      return (bytes & 0xffu) == 0u;
    }
  }

  // the next read to the front
  __device__ __forceinline__ void shift() {
#pragma unroll
    for (int r = 0; r + 1 < R; ++r) {
      decoded[r] = decoded[r + 1], argmax[r] = argmax[r + 1], distance[r] = distance[r + 1];
      confidence[r] = confidence[r + 1];
    }
    branch >>= 8, qcfail >>= 8, bad >>= 8;
  }
};

// The front read of `window` into the decoder's histogram: in shared
// memory (`hist` its integer columns, `pieces` its fixed-point sums in
// 14-bit pieces) or in the global sums (`hist`, `hist_wide`). The lanes
// on bin 0 (unclassified, or a naive decoder's one bin: the one key many
// lanes of a warp share, whose atomics would serialise) are summed over
// the warp first and added by one lane; every other lane adds its own.
// Every lane of the warp calls it.
template <int VEC, bool SHARED>
__device__ __forceinline__ void phq_counters_add(const PhqCounterWindow<VEC>& window, int kind, int b1,
                                                 unsigned* hist, unsigned* pieces, unsigned long long* hist_wide) {
  const int lane = threadIdx.x & 31;
  int key = -1;   // decoded index, -1 = adds nothing
  int key2 = -1;  // argmax, -1 = adds nothing
  unsigned pf_count = 0, dist = 0, pf_dist = 0, low = 0, noise = 0;
  unsigned long long conf = 0ull, pf_conf = 0ull;
  if ((window.bad & 0xff) == 0) {
    const unsigned pf = (window.qcfail & 0xff) ? 0u : 1u;
    // a naive or passthrough row decides nothing: its one bin is 0
    const int decoded_i = window.decoded[0];
    const int distance_i = window.distance[0];
    const int branch_i = kind == 2 ? (int)(int8_t)(window.branch & 0xff) : -1;
    const float c = window.confidence[0];
    key = decoded_i;
    pf_count = pf;
    if (decoded_i > 0 && distance_i > 0) {
      dist = (unsigned)distance_i;
      pf_dist = dist * pf;
    }
    if (branch_i == 0 && c != 0.0f) {
      conf = __float2ull_rn(c * PHQ_CONF_SCALE);
      pf_conf = pf ? conf : 0ull;
    } else if (branch_i == 1 || branch_i == 2) {
      key2 = window.argmax[0];
      low = branch_i == 1 ? 1u : 0u;
      noise = branch_i == 2 ? 1u : 0u;
    }
  }
  // bin 0: count and pf count summed over the warp (its distances are 0);
  // its confidences only where one of its lanes has one
  const bool zero = key == 0;
  const unsigned zeros = __ballot_sync(0xffffffffu, zero);
  unsigned count = 1, pf_sum = pf_count;
  unsigned long long conf_sum = conf, pf_conf_sum = pf_conf;
  bool adds = key > 0;
  if (zeros) {
    const unsigned zero_pf = phq_warp_sum(zero, pf_count);
    unsigned long long zero_conf = 0ull, zero_pf_conf = 0ull;
    if (kind == 2 && __any_sync(0xffffffffu, zero && conf != 0ull)) {
      zero_conf = phq_warp_sum64(zero, conf);
      zero_pf_conf = phq_warp_sum64(zero, pf_conf);
    }
    if (zero && lane == __ffs(zeros) - 1) {
      adds = true;
      count = __popc(zeros), pf_sum = zero_pf, conf_sum = zero_conf, pf_conf_sum = zero_pf_conf;
    }
  }
  if (adds) {
    if constexpr (SHARED) {
      phq_shared_add(hist + key, count);
      if (pf_sum) phq_shared_add(hist + b1 + key, pf_sum);
      if (dist) phq_shared_add(hist + 2 * b1 + key, dist);
      if (pf_dist) phq_shared_add(hist + 3 * b1 + key, pf_dist);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const unsigned mask = p < 2 ? PHQ_PIECE_MASK : ~0u;
        const unsigned c = (unsigned)(conf_sum >> (PHQ_PIECE_BITS * p)) & mask;
        const unsigned pc = (unsigned)(pf_conf_sum >> (PHQ_PIECE_BITS * p)) & mask;
        if (c) phq_shared_add(pieces + p * b1 + key, c);
        if (pc) phq_shared_add(pieces + (3 + p) * b1 + key, pc);
      }
    } else {
      atomicAdd(hist + key, count);
      if (pf_sum) atomicAdd(hist + b1 + key, pf_sum);
      if (dist) atomicAdd(hist + 2 * b1 + key, dist);
      if (pf_dist) atomicAdd(hist + 3 * b1 + key, pf_dist);
      if (conf_sum) atomicAdd(hist_wide + key, conf_sum);
      if (pf_conf_sum) atomicAdd(hist_wide + b1 + key, pf_conf_sum);
    }
  }
  // the filters keyed by the argmax, a barcode (bin 0 holds none)
  if (key2 >= 0) {
    if constexpr (SHARED) {
      if (low) phq_shared_add(hist + 6 * b1 + key2, low);
      if (noise) phq_shared_add(hist + 7 * b1 + key2, noise);
    } else {
      if (low) atomicAdd(hist + 6 * b1 + key2, low);
      if (noise) atomicAdd(hist + 7 * b1 + key2, noise);
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(PHQ_COUNTER_THREADS, PHQ_COUNTER_BLOCKS_PER_SM) phq_counters_accumulate(
    int n, int tile, int n_decoders, int n_groups, int n_uncertain, int flags_at,
    const int* __restrict__ table, const int* __restrict__ decoded, const int* __restrict__ argmax,
    const int* __restrict__ distance, const int8_t* __restrict__ branch, const float* __restrict__ confidence,
    const uint8_t* __restrict__ qcfail, const uint8_t* __restrict__ pad, const uint8_t* __restrict__ forced,
    const uint8_t* __restrict__ uncertain, unsigned* __restrict__ acc, unsigned long long* __restrict__ wide) {
  PHQ_DYNAMIC_SMEM(smem);
  const int* group = table + n_decoders * PHQ_COUNTER_FIELDS + blockIdx.x * PHQ_GROUP_FIELDS;
  const int* unsure_rows = table + n_decoders * PHQ_COUNTER_FIELDS + n_groups * PHQ_GROUP_FIELDS;
  const int first = group[0], stop = group[1], group_bytes = group[2];
  const size_t t0 = (size_t)blockIdx.y * tile;
  const int reads = min(tile, n - (int)t0);
  const int t = threadIdx.x;

  // the group's histograms zeroed (16-byte multiples), and the tile's
  // flags: nonzero where the read is padding or uncertain
  for (int j = t; j < group_bytes / 16; j += PHQ_COUNTER_THREADS) {
    reinterpret_cast<uint4*>(smem)[j] = make_uint4(0u, 0u, 0u, 0u);
  }
  uint8_t* flags = smem + flags_at;
  bool counts = false;  // a read of the thread's to add
  for (int j = t * VEC; j < reads; j += PHQ_COUNTER_THREADS * VEC) {
    const size_t i = t0 + j;
    if constexpr (VEC == 4) {
      unsigned bad = *reinterpret_cast<const unsigned*>(pad + i);
      if (forced != nullptr) bad |= *reinterpret_cast<const unsigned*>(forced + i);
#pragma unroll 4
      for (int q = 0; q < n_uncertain; ++q) {
        bad |= *reinterpret_cast<const unsigned*>(uncertain + (size_t)unsure_rows[q] * n + i);
      }
      *reinterpret_cast<unsigned*>(flags + j) = bad;
      counts |= ((bad - 0x01010101u) & ~bad & 0x80808080u) != 0u;
    } else {
      unsigned bad = pad[i];
      if (forced != nullptr) bad |= forced[i];
      for (int q = 0; q < n_uncertain; ++q) bad |= uncertain[(size_t)unsure_rows[q] * n + i];
      flags[j] = (uint8_t)bad;
      counts |= bad == 0u;
    }
  }

  // a tile with no read to add (padding, or uncertain: most of a hybrid
  // whitelist batch's tiles) adds nothing and flushes nothing
  if (__syncthreads_count(counts) == 0) return;

  // the warps take the group's (decoder, chunk) items in turn, a chunk
  // two items of VEC reads a lane: every warp busy whatever the tile's
  // length, the decoder the same across the warp. (Loading a warp's next
  // chunk while it adds the one before took 122 registers where this
  // takes 78, and was no faster: PERF.md PR 16.)
  const int lane = t & 31;
  const int item = 32 * VEC;
  const int chunks = (reads + 2 * item - 1) / (2 * item);
  for (int c = t / 32; c < (stop - first) * chunks; c += PHQ_COUNTER_THREADS / 32) {
    const int d = first + c / chunks;
    const int base = (c % chunks) * 2 * item;
    const int* entry = table + d * PHQ_COUNTER_FIELDS;
    const int b1 = entry[PHQ_T_B1];
    const int kind = entry[PHQ_T_KIND];
    const size_t row = (size_t)d * n;
    const int j0 = base + lane * VEC, j1 = j0 + item;
    PhqCounterWindow<VEC> window;
    window.clear();
    if (j0 < reads) {
      window.load(0, kind, row, t0 + j0, decoded, argmax, distance, branch, confidence, qcfail);
      window.flag(0, flags + j0);
    }
    if (j1 < reads) {
      window.load(1, kind, row, t0 + j1, decoded, argmax, distance, branch, confidence, qcfail);
      window.flag(1, flags + j1);
    }
    // a warp whose chunk holds no read to add (padding, or uncertain: most
    // of a hybrid whitelist batch's) skips its adds
    if (!__any_sync(0xffffffffu, window.counts(0) || window.counts(1))) continue;
    const int count = base + item < reads ? 2 * VEC : VEC;
    if (entry[PHQ_T_SHARED] > 0) {
      // the fixed-point pieces first, then the integer columns in the
      // layout's order (the confidence slots unused)
      unsigned* pieces = reinterpret_cast<unsigned*>(smem + entry[PHQ_T_SMEM]);
      unsigned* hist = pieces + (kind == 2 ? 6 * b1 : 0);
#pragma unroll 1
      for (int r = 0; r < count; ++r, window.shift()) phq_counters_add<VEC, true>(window, kind, b1, hist, pieces, nullptr);
    } else {
      unsigned* hist = acc + entry[PHQ_T_OFFSET];
      unsigned long long* hist_wide = wide + (kind == 2 ? entry[PHQ_T_WIDE] : 0);
#pragma unroll 1
      for (int r = 0; r < count; ++r, window.shift()) {
        phq_counters_add<VEC, false>(window, kind, b1, hist, nullptr, hist_wide);
      }
    }
  }
  __syncthreads();

  // the block's nonzero bins into the global sums
  for (int d = first; d < stop; ++d) {
    const int* entry = table + d * PHQ_COUNTER_FIELDS;
    if (entry[PHQ_T_SHARED] == 0) continue;
    const int b1 = entry[PHQ_T_B1];
    const bool confidences = entry[PHQ_T_KIND] == 2;
    const unsigned* pieces = reinterpret_cast<const unsigned*>(smem + entry[PHQ_T_SMEM]);
    const unsigned* s_acc = pieces + (confidences ? 6 * b1 : 0);
    unsigned* out = acc + entry[PHQ_T_OFFSET];
    for (int j = t; j < entry[PHQ_T_COLS] * b1; j += PHQ_COUNTER_THREADS) {
      const unsigned v = s_acc[j];
      if (v) atomicAdd(out + j, v);
    }
    if (confidences) {
      unsigned long long* out_wide = wide + entry[PHQ_T_WIDE];
      for (int j = t; j < 2 * b1; j += PHQ_COUNTER_THREADS) {
        const unsigned* p = pieces + (j / b1) * 3 * b1 + j % b1;
        const unsigned long long v = (unsigned long long)p[0] + ((unsigned long long)p[b1] << PHQ_PIECE_BITS) +
                                     ((unsigned long long)p[2 * b1] << (2 * PHQ_PIECE_BITS));
        if (v) atomicAdd(out_wide + j, v);
      }
    }
  }
}

// The per-decoder instance (PR 5's grid), for an instrument whose
// histograms are all shared and small together
// (kernels/counters.py:CounterPlan.per_decoder): blockIdx.y the decoder, a
// grid-stride share of the reads a block, each read's valid flag built
// from its P uncertain rows where the read is summed (D x P byte loads a
// read), the block's histogram in shared memory (b1 x (4 x cols + 16)
// bytes: 64-bit fixed-point sums), flushed once. Where the histograms are
// small its one pass a block beats the grouped kernel's flag pass and
// barrier, up to 33 decoders measured; larger ones flush too much
// (PERF.md PR 16).
#define PHQ_COUNTER_DECODER_READS 512
#define PHQ_COUNTER_DECODER_BLOCKS 4096

__global__ void __launch_bounds__(PHQ_COUNTER_THREADS) phq_counters_decoder(
    int n, int n_decoders, int n_groups, int n_uncertain, const int* __restrict__ table,
    const int* __restrict__ decoded, const int* __restrict__ argmax, const int* __restrict__ distance,
    const int8_t* __restrict__ branch, const float* __restrict__ confidence, const uint8_t* __restrict__ qcfail,
    const uint8_t* __restrict__ pad, const uint8_t* __restrict__ forced, const uint8_t* __restrict__ uncertain,
    unsigned* __restrict__ acc, unsigned long long* __restrict__ wide) {
  PHQ_DYNAMIC_SMEM(smem);
  const int d = blockIdx.y;
  const int* entry = table + d * PHQ_COUNTER_FIELDS;
  const int* unsure_rows = table + n_decoders * PHQ_COUNTER_FIELDS + n_groups * PHQ_GROUP_FIELDS;
  const int b1 = entry[PHQ_T_B1];
  const int kind = entry[PHQ_T_KIND];
  const int cols = entry[PHQ_T_COLS];
  const int wide_bins = kind == 2 ? 2 * b1 : 0;
  // the fixed-point sums first (8-byte aligned), then the integer columns
  // in the layout's order (the confidence slots unused)
  unsigned long long* s_wide = reinterpret_cast<unsigned long long*>(smem);
  unsigned* s_acc = reinterpret_cast<unsigned*>(smem + (size_t)wide_bins * 8);
  for (int j = threadIdx.x; j < wide_bins; j += blockDim.x) s_wide[j] = 0ull;
  for (int j = threadIdx.x; j < cols * b1; j += blockDim.x) s_acc[j] = 0u;
  __syncthreads();

  const size_t row = (size_t)d * n;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < (size_t)n; i += (size_t)gridDim.x * blockDim.x) {
    // every load first, none behind another's value: one latency a row
    unsigned unsure = forced != nullptr ? forced[i] : 0u;
    for (int q = 0; q < n_uncertain; ++q) unsure |= uncertain[(size_t)unsure_rows[q] * n + i];
    const unsigned padded = pad[i];
    const unsigned pf = qcfail[row + i] ? 0u : 1u;
    // a naive or passthrough row decides nothing: its one bin is 0
    const int decoded_i = kind >= 1 ? decoded[row + i] : 0;
    const int distance_i = kind >= 1 ? distance[row + i] : 0;
    const int branch_i = kind == 2 ? (int)branch[row + i] : -1;
    const float c = kind == 2 ? confidence[row + i] : 0.0f;
    const int argmax_i = kind == 2 ? argmax[row + i] : -1;
    if (padded != 0 || unsure != 0) continue;
    atomicAdd(s_acc + decoded_i, 1u);
    if (pf) atomicAdd(s_acc + b1 + decoded_i, 1u);
    if (decoded_i > 0 && distance_i > 0) {
      atomicAdd(s_acc + 2 * b1 + decoded_i, (unsigned)distance_i);
      if (pf) atomicAdd(s_acc + 3 * b1 + decoded_i, (unsigned)distance_i);
    }
    if (branch_i == 0 && c != 0.0f) {
      const unsigned long long q = __float2ull_rn(c * PHQ_CONF_SCALE);
      atomicAdd(s_wide + decoded_i, q);
      if (pf) atomicAdd(s_wide + b1 + decoded_i, q);
    } else if (branch_i == 1) {
      atomicAdd(s_acc + 6 * b1 + argmax_i, 1u);
    } else if (branch_i == 2) {
      atomicAdd(s_acc + 7 * b1 + argmax_i, 1u);
    }
  }
  __syncthreads();
  unsigned* out = acc + entry[PHQ_T_OFFSET];
  for (int j = threadIdx.x; j < cols * b1; j += blockDim.x) {
    const unsigned v = s_acc[j];
    if (v) atomicAdd(out + j, v);
  }
  unsigned long long* out_wide = wide + (kind == 2 ? entry[PHQ_T_WIDE] : 0);
  for (int j = threadIdx.x; j < wide_bins; j += blockDim.x) {
    const unsigned long long v = s_wide[j];
    if (v) atomicAdd(out_wide + j, v);
  }
}

// In place: counter t of the flat layout, an integer in acc[t] (the same
// 4 bytes as out[t]) or, in a confidence column, a fixed-point sum in wide.
__global__ void phq_counters_finalize(int total, int n_decoders, const int* __restrict__ table,
                                      const unsigned* acc,
                                      const unsigned long long* __restrict__ wide, float* out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  // the last decoder whose first counter is at or before t
  int lo = 0, hi = n_decoders - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table[mid * PHQ_COUNTER_FIELDS + PHQ_T_OFFSET] <= t) lo = mid; else hi = mid - 1;
  }
  const int* entry = table + lo * PHQ_COUNTER_FIELDS;
  const int local = t - entry[PHQ_T_OFFSET];
  const int b1 = entry[PHQ_T_B1];
  const int col = local / b1;
  float value;
  if (entry[PHQ_T_KIND] == 2 && (col == 4 || col == 5)) {
    value = __ull2float_rn(wide[entry[PHQ_T_WIDE] + local - 4 * b1]) * PHQ_CONF_UNSCALE;
  } else {
    value = __uint2float_rn(acc[t]);
  }
  out[t] = value;
}

// Writes the `total` counters of every decoder of the batch, in
// counter_layout order, as f32 to scratch + 8 * wide_total; `scratch`
// holds wide_total fixed-point sums and then those `total` 4-byte slots.
// `table` (kernels/counters.py:CounterPlan.ints, on the device) holds
// n_decoders decoder rows, n_groups group rows and the n_uncertain rows
// whose uncertain flag counts (0 of them in a fast run, where `forced` is
// null too); a block owns `tile` reads of one group, `shared_bytes` of
// dynamic shared memory with the flags at `flags_at`; `vec` 4 takes 4
// reads a lane (n % 4 == 0, rows aligned), else 1; with `per_decoder`
// the per-decoder instance runs instead, its largest histogram
// `shared_bytes`.
PHQ_EXPORT int phq_counters(
    int n, int n_decoders, int n_groups, int n_uncertain, int total, int wide_total, int tile, int shared_bytes,
    int flags_at, int vec, int per_decoder, const void* table, const void* decoded, const void* argmax,
    const void* distance, const void* branch, const void* confidence, const void* qcfail, const void* pad,
    const void* forced, const void* uncertain, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (shared_bytes > PHQ_COUNTER_SHARED_MAX ||
      (!per_decoder && (tile <= 0 || tile % 4 != 0 || (vec != 1 && vec != 4) || flags_at % 16 != 0 ||
                        flags_at + tile > shared_bytes))) {
    return (int)cudaErrorInvalidValue;
  }
  unsigned long long* wide = (unsigned long long*)scratch;
  unsigned* acc = (unsigned*)(wide + wide_total);
  cudaError_t status = cudaMemsetAsync(scratch, 0, (size_t)wide_total * 8 + (size_t)total * 4, s);
  if (status != cudaSuccess) return (int)status;
  const int tiles = (n + tile - 1) / tile;
  if (per_decoder && n > 0 && n_decoders > 0) {
    int blocks = (n + PHQ_COUNTER_DECODER_READS - 1) / PHQ_COUNTER_DECODER_READS;
    if (blocks > PHQ_COUNTER_DECODER_BLOCKS) blocks = PHQ_COUNTER_DECODER_BLOCKS;
    if (shared_bytes > 48 * 1024) {
      status = cudaFuncSetAttribute(phq_counters_decoder, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
      if (status != cudaSuccess) return (int)status;
    }
    PHQ_LAUNCH(phq_counters_decoder, dim3(blocks, n_decoders), PHQ_COUNTER_THREADS, shared_bytes, s)(
        n, n_decoders, n_groups, n_uncertain, (const int*)table, (const int*)decoded, (const int*)argmax,
        (const int*)distance, (const int8_t*)branch, (const float*)confidence, (const uint8_t*)qcfail,
        (const uint8_t*)pad, (const uint8_t*)forced, (const uint8_t*)uncertain, acc, wide);
    status = cudaGetLastError();
    if (status != cudaSuccess) return (int)status;
  } else if (tiles > 0 && n_groups > 0) {
    auto kernel = vec == 4 ? &phq_counters_accumulate<4> : &phq_counters_accumulate<1>;
    if (shared_bytes > 48 * 1024) {
      status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
      if (status != cudaSuccess) return (int)status;
    }
    PHQ_LAUNCH(kernel, dim3(n_groups, tiles), PHQ_COUNTER_THREADS, shared_bytes, s)(
        n, tile, n_decoders, n_groups, n_uncertain, flags_at, (const int*)table, (const int*)decoded,
        (const int*)argmax, (const int*)distance, (const int8_t*)branch, (const float*)confidence,
        (const uint8_t*)qcfail, (const uint8_t*)pad, (const uint8_t*)forced, (const uint8_t*)uncertain, acc, wide);
    status = cudaGetLastError();
    if (status != cudaSuccess) return (int)status;
  }
  const int threads = 256;
  if (total > 0) {
    PHQ_LAUNCH(phq_counters_finalize, (total + threads - 1) / threads, threads, 0, s)(
        total, n_decoders, (const int*)table, acc, wide, (float*)acc);
  }
  return (int)cudaGetLastError();
}
