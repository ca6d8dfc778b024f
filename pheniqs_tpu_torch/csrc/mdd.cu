// K6: the MDD classify of one decoder (minimum distance decoding), per read.
//
// Replaces the TPU program's pheniqs_tpu/device/classify.py:mdd_classify_device
// (667-745; reference mdd.cpp:37-102): per observation segment, the
// in-range mismatches against every barcode, the quality-masked errors
// (a position below the quality masking threshold counts as an error), the
// per-segment tolerance test and the exact test (full length, no
// mismatch); the first exact match wins, else the first barcode in codec
// order within tolerance, with that barcode's total error as the distance.
//
// Bound on the H100: memory, 2W + 4S + ~20 bytes a read, once the work is
// counted as the inputs need it: a read with an exact match needs its W
// positions compared once, a read without one all B barcodes (chip_smoke's
// classify_work).
// Design: two phases, so that a read with an exact match costs one lookup
// and only the others scan the panel, a warp at a time.
//  1. A thread per read loads its codes with word loads and packs them 4 to
//     a 32-bit word, as the key table packs the panel (kernels/mdd.py
//     key_table, built once per decoder: the panel's words in codec order,
//     the same keys sorted by (key, barcode index), and each key's index).
//     A read at full length looks its key up by a lower-bound binary
//     search; a hit is the first exact match (with duplicated barcodes the
//     lowest index sorts first), distance 0.
//  2. The warp takes its other reads one at a time (a ballot of the
//     misses): the read's words and its in-range and quality-masked
//     position masks are broadcast by shuffles, lanes cover barcodes
//     lane, lane + 32, ..., and a ballot of "within every segment's
//     tolerance" over each round of 32 gives the first barcode in codec
//     order (the lowest set lane of the first round with one); that lane's
//     total error is the distance.
// Errors are counted on position masks, one bit a position: a byte of
// read ^ barcode is nonzero where its low seven bits carry into the eighth
// or it has the eighth set, and a multiply gathers the four eighth bits of
// a word into a nibble; a segment's errors are the popcount of its
// position bits. The table sits in shared memory when it fits in
// PHQ_MDD_SHARED_TABLE bytes and is read from device memory (L2) when it
// does not. Integer-only: the result is byte-identical to the plain
// version and to the f64 oracle.
//
// Any number of segments and positions: the segment table (start, width,
// tolerance and, up to 64 positions, the segment's position mask) is a
// device array the wrapper builds once per decoder
// (kernels/mdd.py:segment_table), copied into shared memory when it fits
// PHQ_MDD_SHARED_SEGMENTS and read from device memory when it does not.
// The instances of NW = 4, 8 and 16 key words (up to 16, 32 and 64
// positions) keep a read's words and its position masks (one word) in
// registers, as above. Past 64 positions the wide instance
// (phq_mdd_wide_kernel) takes over; its lookup compares key words with
// the read's row as it goes, and its scan counts errors on bit planes:
//  - the decoder's key table carries the panel as bit planes
//    (kernels/mdd.py:key_table): per group of 32 positions, plane q of
//    barcode b holds bit q of its 32 codes, [group][barcode][plane], so a
//    lane loads a barcode's planes of a group, and a staged read's, with
//    16-byte loads;
//    4 planes where every panel code is below 16 (a read's codes of 16 or
//    more then all mismatch: one more plane, their OR), else 8;
//  - a warp stages its pending reads K at a time (K from the shared
//    budget, at most 32), each with the whole warp: lanes take positions
//    lane, lane + 32, ... (coalesced byte loads), and one ballot builds
//    each plane of 32 positions, and the low-quality mask, in one
//    instruction; lanes over the segments OR the in-range bits in;
//  - the warp then walks (read, barcode) pairs of its batch in order, 32
//    a round, so a panel of 40 barcodes keeps every lane busy; a ballot
//    of "within every segment's tolerance" gives each read its first
//    barcode in codec order (the lowest set lane of its pairs), and a read
//    whose hit is found skips the rest of its pairs;
//  - a pair's errors: per group the OR of its planes' XORs, masked to the
//    in-range bits, OR the low-quality bits; a segment's errors the
//    popcount between its two boundaries, the segments walked in position
//    order and given up at the first one past its tolerance.
#include <type_traits>

#include "common.cuh"

#define PHQ_MDD_THREADS 256
#define PHQ_MDD_WARPS (PHQ_MDD_THREADS / 32)
#define PHQ_MDD_SHARED_TABLE (40 * 1024)
#define PHQ_MDD_SHARED_SEGMENTS (8 * 1024)
#define PHQ_MDD_SMEM_MAX (227 * 1024)
// ints of a segment-table row before its mask words: start, width,
// tolerance, 0
#define PHQ_MDD_SEG_INTS 4
// the wide instance: reads a warp stages at once, at most, and the (read,
// group of 32 positions) pairs whose bytes a warp loads at once
#define PHQ_MDD_BATCH_MAX 32
#define PHQ_MDD_STAGE_GROUPS 8

// ints (host memory, kernels/mdd.py:_ints): n, B, W, S, ld_obs, ld_len,
// quality masking threshold, key words NW, and for the wide instance the
// panel's bit planes (4 or 8) and the reads a warp stages at once (K)
struct PhqMddParams {
  int n, B, W, S, ld_obs, ld_len, qmt, NW, planes, batch;
};
#define PHQ_MDD_INTS 10

// `count` bits from bit `start` (count <= the mask's bits)
template <typename Mask>
__device__ __forceinline__ Mask phq_bits(int start, int count) {
  if (count <= 0) return 0;
  const Mask ones = count >= (int)(8 * sizeof(Mask)) ? ~(Mask)0 : (((Mask)1 << count) - 1);
  return ones << start;
}

// One bit for each nonzero byte of x, in byte order.
__device__ __forceinline__ uint32_t phq_nonzero_nibble(uint32_t x) {
  const uint32_t high = (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
  return (((high >> 7) * 0x00204081u) >> 21) & 15u;
}

template <typename Mask>
__device__ __forceinline__ int phq_popc(Mask m) {
  if constexpr (sizeof(Mask) == 8) {
    return __popcll(m);
  } else {
    return __popc(m);
  }
}

// word k of a row of `count` bytes from p (any alignment; zero past count)
__device__ __forceinline__ uint32_t phq_mdd_word(const uint8_t* p, int count, int k) {
  if (((uintptr_t)p & 3) == 0 && 4 * k + 4 <= count) return ((const uint32_t*)p)[k];
  uint32_t word = 0;
  for (int j = 0; j < 4; ++j) {
    if (4 * k + j < count) word |= (uint32_t)p[4 * k + j] << (8 * j);
  }
  return word;
}

// `count` bytes of a row from p as little-endian words (any alignment;
// nothing past p + count is read)
template <int NW>
__device__ __forceinline__ void phq_load_words(const uint8_t* p, int count, uint32_t (&out)[NW]) {
  const bool aligned = ((uintptr_t)p & 3) == 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    uint32_t word = 0;
    if (aligned && 4 * k + 4 <= count) {
      word = ((const uint32_t*)p)[k];
    } else {
      for (int j = 0; j < 4; ++j) {
        if (4 * k + j < count) word |= (uint32_t)p[4 * k + j] << (8 * j);
      }
    }
    out[k] = word;
  }
}

// -1, 0 or 1 as the key (16-byte aligned) sorts before, equal to or
// after the read's words, word 0 first (kernels/mdd.py:key_table's order)
template <int NW>
__device__ __forceinline__ int phq_key_order(const uint32_t* key, const uint32_t (&ow)[NW]) {
  int order = 0;
#pragma unroll
  for (int q = NW / 4 - 1; q >= 0; --q) {
    const uint4 v = ((const uint4*)key)[q];
    const uint32_t k4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 3; j >= 0; --j) {
      // the last difference seen, the first in word order, decides
      if (k4[j] != ow[4 * q + j]) order = k4[j] < ow[4 * q + j] ? -1 : 1;
    }
  }
  return order;
}

// the wide instance's: the read's words taken from its row as they are
// compared, the first difference in word order deciding
__device__ __forceinline__ int phq_key_order_row(const uint32_t* key, int nw, const uint8_t* row, int W) {
  for (int k = 0; k < nw; ++k) {
    const uint32_t o = phq_mdd_word(row, W, k);
    if (key[k] != o) return key[k] < o ? -1 : 1;
  }
  return 0;
}

// Copies `ints` ints of `src` (16-byte aligned, a multiple of 4) to
// shared memory at `dst` with 16-byte loads.
__device__ __forceinline__ void phq_mdd_stage(uint32_t* dst, const uint32_t* src, size_t ints) {
  for (size_t t = threadIdx.x; 4 * t < ints; t += blockDim.x) ((uint4*)dst)[t] = ((const uint4*)src)[t];
}

// Writes read i's results.
__device__ __forceinline__ void phq_mdd_write(int i, int result, int dist, const uint8_t* qcfail_in,
                                              int* decoded, int* argmax, int* distance, int8_t* branch,
                                              float* confidence, uint8_t* qcfail_out) {
  const int decoded_index = result + 1;
  decoded[i] = decoded_index;
  argmax[i] = decoded_index;
  distance[i] = result >= 0 ? dist : 0;
  branch[i] = 0;
  confidence[i] = 0.0f;
  qcfail_out[i] = (qcfail_in[i] != 0 || decoded_index == 0) ? 1 : 0;
}

// The register instances (W <= 64: NW = 4, 8 or 16 key words, one mask
// word a read). The table: B * NW panel words in codec order, B * NW keys
// sorted, B indices (padded to whole 16-byte words), in shared memory
// when `table_in_shared`; the segment table (rows of start, width,
// tolerance, 0 and a 64-bit position mask) when `segments_in_shared`.
template <int NW>
__global__ void __launch_bounds__(PHQ_MDD_THREADS) phq_mdd_kernel(
    PhqMddParams p, int table_in_shared, int segments_in_shared, const uint8_t* __restrict__ obs_code,
    const uint8_t* __restrict__ obs_qual, const int* __restrict__ lengths,
    const uint8_t* __restrict__ qcfail_in, const uint32_t* __restrict__ table,
    const int* __restrict__ segments, int* __restrict__ decoded, int* __restrict__ argmax,
    int* __restrict__ distance, int8_t* __restrict__ branch,
    float* __restrict__ confidence, uint8_t* __restrict__ qcfail_out) {
  using Mask = typename std::conditional<(NW <= 8), uint32_t, unsigned long long>::type;
  constexpr int SEG = PHQ_MDD_SEG_INTS + 2;  // ints of a segment-table row
  PHQ_DYNAMIC_SMEM(smem);
  const size_t table_ints = 2 * (size_t)p.B * NW + ((p.B + 3) & ~3);
  const uint32_t* words = table;
  const int* segs = segments;
  int at = 0;
  if (table_in_shared) {
    phq_mdd_stage((uint32_t*)smem, table, table_ints);
    words = (const uint32_t*)smem;
    at = 4 * (int)table_ints;
  }
  if (segments_in_shared) {
    int* s_segs = (int*)(smem + at);
    for (int t = threadIdx.x; t < p.S * SEG; t += blockDim.x) s_segs[t] = segments[t];
    segs = s_segs;
  }
  __syncthreads();
  const uint32_t* keys = words + p.B * NW;
  const int* index = (const int*)(keys + p.B * NW);

  // phase 1: a thread per read (a thread past the last read takes part in
  // the warp's ballots and writes nothing)
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < p.n;
  const int row = active ? i : p.n - 1;
  const uint8_t* oc = obs_code + (size_t)row * p.ld_obs;
  const int* len = lengths + (size_t)row * p.ld_len;
  uint32_t ow[NW];
  phq_load_words<NW>(oc, p.W, ow);
  bool full = true;
  Mask inr = 0;
  for (int s = 0; s < p.S; ++s) {
    const int* seg = segs + s * SEG;
    const int l = len[s];
    full = full && l == seg[1];
    inr |= phq_bits<Mask>(seg[0], min(max(l, 0), seg[1]));
  }
  int result = -1;  // 0-based barcode, -1 for none
  int dist = 0;
  if (active && full) {
    // lower bound of the read's key: the first (key, index) not before it
    int lo = 0;
    int hi = p.B;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (phq_key_order<NW>(keys + mid * NW, ow) < 0) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo < p.B && phq_key_order<NW>(keys + lo * NW, ow) == 0) result = index[lo];
  }
  const bool pending = active && result < 0;
  Mask lowq = 0;
  if (pending && p.qmt > 0) {
    const uint8_t* oq = obs_qual + (size_t)row * p.ld_obs;
    uint32_t qw[NW];
    phq_load_words<NW>(oq, p.W, qw);
#pragma unroll
    for (int k = 0; k < NW; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((int)((qw[k] >> (8 * j)) & 255u) < p.qmt) lowq |= (Mask)1 << (4 * k + j);
      }
    }
    lowq &= inr;
  }

  // phase 2: the warp scans the panel for each of its pending reads
  const int lane = threadIdx.x & 31;
  unsigned todo = __ballot_sync(0xFFFFFFFFu, pending);
#ifdef PHQ_MDD_NO_SCAN  // defined only by chip_smoke.py --times' diagnostic copy
  todo = 0;
#endif
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    uint32_t w[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) w[k] = __shfl_sync(0xFFFFFFFFu, ow[k], src);
    const Mask in = __shfl_sync(0xFFFFFFFFu, inr, src);
    const Mask lq = __shfl_sync(0xFFFFFFFFu, lowq, src);
    int found = -1;
    int found_error = 0;
    for (int b0 = 0; b0 < p.B; b0 += 32) {
      const int b = b0 + lane;
      bool within = false;
      int total = 0;
      if (b < p.B) {
        const uint4* e = (const uint4*)(words + b * NW);
        Mask mismatch = 0;
#pragma unroll
        for (int q = 0; q < NW / 4; ++q) {
          const uint4 v = e[q];
          const int at = 16 * q;
          mismatch |= (Mask)phq_nonzero_nibble(w[4 * q] ^ v.x) << at;
          mismatch |= (Mask)phq_nonzero_nibble(w[4 * q + 1] ^ v.y) << (at + 4);
          mismatch |= (Mask)phq_nonzero_nibble(w[4 * q + 2] ^ v.z) << (at + 8);
          mismatch |= (Mask)phq_nonzero_nibble(w[4 * q + 3] ^ v.w) << (at + 12);
        }
        const Mask err = (mismatch & in) | lq;
        within = true;
        for (int s = 0; s < p.S; ++s) {
          const int* seg = segs + s * SEG;
          const int errors = phq_popc<Mask>(err & (Mask)(*(const unsigned long long*)(seg + PHQ_MDD_SEG_INTS)));
          within = within && errors <= seg[2];
          total += errors;
        }
      }
      const unsigned hits = __ballot_sync(0xFFFFFFFFu, within);
      if (hits) {
        const int first = __ffs(hits) - 1;
        found = b0 + first;
        found_error = __shfl_sync(0xFFFFFFFFu, total, first);
        break;
      }
    }
    if (lane == src) {
      result = found;
      dist = found_error;
    }
  }

  if (!active) return;
  phq_mdd_write(i, result, dist, qcfail_in, decoded, argmax, distance, branch, confidence, qcfail_out);
}

// A staged read's words of a group of 32 positions, 16-byte records:
// with 4 planes {plane 0-3}, {the OR of its codes' high bits, in-range,
// low-quality, 0}; with 8 {plane 0-3}, {plane 4-7}, {in-range,
// low-quality, 0, 0}.
template <int PLANES>
struct PhqWideRead {
  static constexpr int WORDS = PLANES == 4 ? 8 : 12;
  static constexpr int IN_RANGE = PLANES == 4 ? 5 : 8;
  static constexpr int LOW = IN_RANGE + 1;
};

// The error bits of one group of 32 positions of a (read, barcode) pair:
// `rg` the read's words of the group, `pg` the barcode's planes of the
// group (kernels/mdd.py:key_table, [group][barcode][plane]), each 16-byte
// loads.
template <int PLANES>
__device__ __forceinline__ uint32_t phq_wide_errors(const uint32_t* rg, const uint32_t* pg) {
  const uint4 r = *(const uint4*)rg;
  const uint4 e = *(const uint4*)pg;
  uint32_t mismatch = (r.x ^ e.x) | (r.y ^ e.y) | (r.z ^ e.z) | (r.w ^ e.w);
  if constexpr (PLANES == 4) {
    const uint4 m = *(const uint4*)(rg + 4);
    return ((mismatch | m.x) & m.y) | m.z;
  } else {
    const uint4 r1 = *(const uint4*)(rg + 4);
    const uint4 e1 = *(const uint4*)(pg + 4);
    const uint4 m = *(const uint4*)(rg + 8);
    mismatch |= (r1.x ^ e1.x) | (r1.y ^ e1.y) | (r1.z ^ e1.z) | (r1.w ^ e1.w);
    return (mismatch & m.x) | m.y;
  }
}

// The wide instance (W > 64). Shared memory: the key table's sorted keys,
// indices and bit planes (kernels/mdd.py:key_table, past its panel words)
// when `table_in_shared`; the segment table (rows of start, width,
// tolerance, 0) when `segments_in_shared`; from `buffer_at`, each warp's
// batch of K staged reads (per read G groups of RW words, PhqWideRead,
// then each read's result, distance and row, and a pad word).
template <int PLANES>
__global__ void __launch_bounds__(PHQ_MDD_THREADS) phq_mdd_wide_kernel(
    PhqMddParams p, int table_in_shared, int segments_in_shared, int buffer_at,
    const uint8_t* __restrict__ obs_code, const uint8_t* __restrict__ obs_qual,
    const int* __restrict__ lengths, const uint8_t* __restrict__ qcfail_in,
    const uint32_t* __restrict__ table, const int* __restrict__ segments, int* __restrict__ decoded,
    int* __restrict__ argmax, int* __restrict__ distance, int8_t* __restrict__ branch,
    float* __restrict__ confidence, uint8_t* __restrict__ qcfail_out) {
  constexpr int SEG = PHQ_MDD_SEG_INTS;
  constexpr int RW = PhqWideRead<PLANES>::WORDS;  // words of a staged read's group
  constexpr int INR = PhqWideRead<PLANES>::IN_RANGE;
  constexpr int LOW = PhqWideRead<PLANES>::LOW;
  constexpr unsigned FULL = 0xFFFFFFFFu;
  PHQ_DYNAMIC_SMEM(smem);
  const int NW = p.NW;
  const int B = p.B;
  const int G = (p.W + 31) / 32;
  const size_t part_ints = (size_t)B * NW + ((B + 3) & ~3) + (size_t)G * PLANES * B;
  const uint32_t* keys = table + (size_t)B * NW;
  const int* segs = segments;
  int at = 0;
  if (table_in_shared) {
    phq_mdd_stage((uint32_t*)smem, keys, part_ints);
    keys = (const uint32_t*)smem;
    at = 4 * (int)part_ints;
  }
  if (segments_in_shared) {
    int* s_segs = (int*)(smem + at);
    for (int t = threadIdx.x; t < p.S * SEG; t += blockDim.x) s_segs[t] = segments[t];
    segs = s_segs;
  }
  __syncthreads();
  const int* index = (const int*)(keys + (size_t)B * NW);
  const uint32_t* planes = keys + (size_t)B * NW + ((B + 3) & ~3);
  const int lane = threadIdx.x & 31;
  const int read_ints = G * RW + 4;
  uint32_t* buffer = (uint32_t*)(smem + buffer_at) + (threadIdx.x / 32) * p.batch * read_ints;
  int* res = (int*)(buffer + p.batch * G * RW);
  int* dst = res + p.batch;
  int* batch_rows = dst + p.batch;

  // phase 1: a thread per read looks a full-length read's key up
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < p.n;
  const int row = active ? i : p.n - 1;
  const uint8_t* oc = obs_code + (size_t)row * p.ld_obs;
  const int* len = lengths + (size_t)row * p.ld_len;
  bool full = true;
  for (int s = 0; s < p.S; ++s) full = full && len[s] == segs[s * SEG + 1];
  int result = -1;
  int dist = 0;
  if (active && full) {
    int lo = 0;
    int hi = B;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (phq_key_order_row(keys + (size_t)mid * NW, NW, oc, p.W) < 0) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo < B && phq_key_order_row(keys + (size_t)lo * NW, NW, oc, p.W) == 0) result = index[lo];
  }
  const bool pending = active && result < 0;

  // phase 2: the warp's pending reads, a batch of up to K at a time
  unsigned todo = __ballot_sync(FULL, pending);
#ifdef PHQ_MDD_NO_SCAN
  todo = 0;
#endif
  while (todo) {
    // the batch: the first K pending lanes, in lane order, their rows
    // noted for the whole warp
    const int rank = __popc(todo & phq_bits<uint32_t>(0, lane));
    const bool mine = ((todo >> lane) & 1) && rank < p.batch;
    const unsigned batch = __ballot_sync(FULL, mine);
    const int kb = __popc(batch);
    if (mine) batch_rows[rank] = row;
    for (int t = lane; t < kb * G; t += 32) buffer[t * RW + INR] = 0u;
    __syncwarp();
    // each (read, segment)'s in-range positions, a lane a pair
    for (int t = lane; t < kb * p.S; t += 32) {
      const int k = t / p.S;
      const int* seg = segs + (t - k * p.S) * SEG;
      const int end = seg[0] + min(max(lengths[(size_t)batch_rows[k] * p.ld_len + t - k * p.S], 0), seg[1]);
      for (int pos = seg[0]; pos < end;) {
        const int g = pos >> 5;
        const int stop = min(end, 32 * (g + 1));
        atomicOr(buffer + (k * G + g) * RW + INR, phq_bits<uint32_t>(pos & 31, stop - pos));
        pos = stop;
      }
    }
    __syncwarp();
    // the batch's (read, group) pairs, PHQ_MDD_STAGE_GROUPS at a time: their
    // bytes loaded together (lanes on positions, coalesced), then one
    // ballot a plane
    for (int t0 = 0; t0 < kb * G; t0 += PHQ_MDD_STAGE_GROUPS) {
      int codes[PHQ_MDD_STAGE_GROUPS];
      int quals[PHQ_MDD_STAGE_GROUPS];
#pragma unroll
      for (int u = 0; u < PHQ_MDD_STAGE_GROUPS; ++u) {
        const int t = min(t0 + u, kb * G - 1);
        const int k = t / G;
        const int pos = 32 * (t - k * G) + lane;
        const size_t at = (size_t)batch_rows[k] * p.ld_obs + pos;
        codes[u] = pos < p.W ? obs_code[at] : 0;
        quals[u] = p.qmt > 0 && pos < p.W ? obs_qual[at] : 255;
      }
#pragma unroll
      for (int u = 0; u < PHQ_MDD_STAGE_GROUPS; ++u) {
        if (t0 + u >= kb * G) break;
        uint32_t* rg = buffer + (t0 + u) * RW;  // read k's group g: (k * G + g) * RW
        uint32_t v[PLANES];
#pragma unroll
        for (int q = 0; q < PLANES; ++q) v[q] = __ballot_sync(FULL, (codes[u] >> q) & 1);
        const uint32_t high = PLANES == 4 ? __ballot_sync(FULL, codes[u] >= 16) : 0u;
        const uint32_t low = p.qmt > 0 ? __ballot_sync(FULL, quals[u] < p.qmt) & rg[INR] : 0u;
        if (lane == 0) {
#pragma unroll
          for (int q = 0; q < PLANES; ++q) rg[q] = v[q];
          if (PLANES == 4) rg[4] = high;
          rg[LOW] = low;
        }
      }
    }
    for (int k = lane; k < kb; k += 32) {
      res[k] = -1;
      dst[k] = 0;
    }
    __syncwarp();

    // the batch's (read, barcode) pairs in order, 32 a round
    const int pairs = kb * B;
    for (int pos = 0; pos < pairs;) {
      const int k0 = pos / B;
      int k = k0;
      int b = pos - k0 * B + lane;
      while (b >= B) {
        b -= B;
        ++k;
      }
      bool within = false;
      int total = 0;
      if (pos + lane < pairs) {
        const uint32_t* rw = buffer + k * G * RW;
        const uint32_t* pb = planes + (size_t)b * PLANES;
        within = true;
        int g = 0;
        int below = 0;  // error bits in the groups before g
        int prev = 0;   // error bits before the segment's start
        uint32_t err = phq_wide_errors<PLANES>(rw, pb);
        for (int s = 0; s < p.S && within; ++s) {
          const int4 seg = *(const int4*)(segs + s * SEG);  // start, width, tolerance, 0
          const int end = seg.x + seg.y;
          while (g < G && 32 * (g + 1) <= end) {
            below += __popc(err);
            ++g;
            err = g < G ? phq_wide_errors<PLANES>(rw + g * RW, pb + (size_t)g * B * PLANES) : 0u;
          }
          const int upto = below + __popc(err & phq_bits<uint32_t>(0, end & 31));
          const int errors = upto - prev;
          prev = upto;
          within = errors <= seg.z;
          total += errors;
        }
      }
      const unsigned hits = __ballot_sync(FULL, within);
      // a lane holding its read's first hit of the round (none of the
      // read's lower lanes hit) records it
      const int first_lane = max(k * B - pos, 0);
      if (within && (hits & ~phq_bits<uint32_t>(0, first_lane) & phq_bits<uint32_t>(0, lane)) == 0) {
        res[k] = b;
        dst[k] = total;
      }
      // the round's last read continues into the next round unless it hit
      const int k_last = (min(pos + 31, pairs - 1)) / B;
      if (hits & ~phq_bits<uint32_t>(0, max(k_last * B - pos, 0))) {
        pos = (k_last + 1) * B;
      } else {
        pos += 32;
      }
    }
    __syncwarp();
    if (batch & (1u << lane)) {
      const int k = __popc(batch & phq_bits<uint32_t>(0, lane));
      result = res[k];
      dist = dst[k];
    }
    todo &= ~batch;
    __syncwarp();  // the buffer is free for the next batch
  }

  if (!active) return;
  phq_mdd_write(i, result, dist, qcfail_in, decoded, argmax, distance, branch, confidence, qcfail_out);
}

// `ints` (host memory): PhqMddParams in order (kernels/mdd.py:_ints).
// Codes and qualities are (N, W) uint8 rows of stride ld_obs, lengths
// (N, S) int32 rows of stride ld_len; `table` is the decoder's key table
// (kernels/mdd.py:key_table, 16-byte aligned) and `segments` its segment
// table (kernels/mdd.py:segment_table: per segment start, width,
// tolerance, 0, and up to 64 positions its position mask as a 64-bit
// word); the results go to the decode step's (N,) rows.
PHQ_EXPORT int phq_mdd(const int* ints, const void* obs_code,
                       const void* obs_qual, const void* lengths,
                       const void* qcfail_in, const void* table, const void* segments, void* decoded,
                       void* argmax, void* distance, void* branch,
                       void* confidence, void* qcfail_out, void* stream) {
  PhqMddParams p;
  int* fields = (int*)&p;
  for (int k = 0; k < PHQ_MDD_INTS; ++k) fields[k] = ints[k];
  const bool wide = p.W > 64;
  const int nw = p.W <= 16 ? 4 : p.W <= 32 ? 8 : p.W <= 64 ? 16 : 4 * ((p.W + 15) / 16);
  if (p.S < 1 || p.W < 1 || p.B < 1 || p.NW != nw || ((uintptr_t)table & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (wide && ((p.planes != 4 && p.planes != 8) || p.batch < 1 || p.batch > PHQ_MDD_BATCH_MAX)) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.n <= 0) return (int)cudaGetLastError();
  const int G = (p.W + 31) / 32;
  // the part of the table the instance reads: all of it, or past the
  // panel words (the wide instance scans the bit planes)
  const size_t table_bytes = wide ? 4 * ((size_t)p.B * p.NW + ((p.B + 3) & ~3) + (size_t)G * p.planes * p.B)
                                  : 4 * ((size_t)2 * p.B * p.NW + ((p.B + 3) & ~3));
  const size_t segment_bytes = (size_t)4 * p.S * (PHQ_MDD_SEG_INTS + (wide ? 0 : 2));
  // the wide instance's batches of staged reads come first: the tables
  // take their shares of shared memory only beside them
  const int rw = p.planes == 4 ? PhqWideRead<4>::WORDS : PhqWideRead<8>::WORDS;
  const size_t buffers = wide ? (size_t)PHQ_MDD_WARPS * 4 * p.batch * (G * rw + 4) : 0;
  const bool table_in_shared =
      table_bytes <= PHQ_MDD_SHARED_TABLE && table_bytes + buffers <= PHQ_MDD_SMEM_MAX;
  const size_t table_smem = table_in_shared ? table_bytes : 0;
  const bool segments_in_shared = segment_bytes <= PHQ_MDD_SHARED_SEGMENTS &&
                                  table_smem + (segment_bytes + 15) / 16 * 16 + buffers <= PHQ_MDD_SMEM_MAX;
  size_t smem = table_smem + (segments_in_shared ? (segment_bytes + 15) / 16 * 16 : 0);
  const int blocks = (p.n + PHQ_MDD_THREADS - 1) / PHQ_MDD_THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* oc = (const uint8_t*)obs_code;
  const uint8_t* oq = (const uint8_t*)obs_qual;
  const int* ln = (const int*)lengths;
  const uint8_t* qc = (const uint8_t*)qcfail_in;
  const uint32_t* tb = (const uint32_t*)table;
  const int* sg = (const int*)segments;
  if (wide) {
    const int buffer_at = (int)smem;
    smem += buffers;
    if (smem > PHQ_MDD_SMEM_MAX) return (int)cudaErrorInvalidValue;
    void (*kernel)(PhqMddParams, int, int, int, const uint8_t*, const uint8_t*, const int*, const uint8_t*,
                   const uint32_t*, const int*, int*, int*, int*, int8_t*, float*, uint8_t*) =
        p.planes == 4 ? phq_mdd_wide_kernel<4> : phq_mdd_wide_kernel<8>;
    if (smem > 48 * 1024) {
      const cudaError_t status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (status != cudaSuccess) return (int)status;
    }
    PHQ_LAUNCH(kernel, blocks, PHQ_MDD_THREADS, smem, s)(
        p, table_in_shared ? 1 : 0, segments_in_shared ? 1 : 0, buffer_at, oc, oq, ln, qc, tb, sg,
        (int*)decoded, (int*)argmax, (int*)distance, (int8_t*)branch, (float*)confidence, (uint8_t*)qcfail_out);
    return (int)cudaGetLastError();
  }
  // one name for the instance: a template argument list's comma would
  // split the launch macro's arguments
  void (*kernel)(PhqMddParams, int, int, const uint8_t*, const uint8_t*, const int*, const uint8_t*,
                 const uint32_t*, const int*, int*, int*, int*, int8_t*, float*, uint8_t*) =
      p.NW == 4 ? phq_mdd_kernel<4> : p.NW == 8 ? phq_mdd_kernel<8> : phq_mdd_kernel<16>;
  PHQ_LAUNCH(kernel, blocks, PHQ_MDD_THREADS, smem, s)(
      p, table_in_shared ? 1 : 0, segments_in_shared ? 1 : 0, oc, oq, ln, qc, tb, sg, (int*)decoded,
      (int*)argmax, (int*)distance, (int8_t*)branch, (float*)confidence, (uint8_t*)qcfail_out);
  return (int)cudaGetLastError();
}
