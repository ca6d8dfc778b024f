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
// tolerance and the segment's position mask) is a device array the
// wrapper builds once per decoder (kernels/mdd.py:segment_table), copied
// into shared memory when it fits PHQ_MDD_SHARED_SEGMENTS and read from
// device memory when it does not. A read's position masks are MW 64-bit
// words (32-bit ones up to 32 positions): the instances of NW = 4, 8, 16
// and 32 key words (up to 16, 32, 64 and 128 positions) keep the read's
// words and masks in registers; wider observations run the looped
// instance (NW = 0), which keeps nothing of a width in registers: its
// lookup compares key words with the read's row as it goes, and the warp
// stages each pending read's words and masks in shared memory
// (PHQ_MDD_WARPS buffers) before it scans the panel, counting each
// segment's errors as it walks the mask words in position order.
#include <type_traits>

#include "common.cuh"

#define PHQ_MDD_THREADS 256
#define PHQ_MDD_WARPS (PHQ_MDD_THREADS / 32)
#define PHQ_MDD_SHARED_TABLE (40 * 1024)
#define PHQ_MDD_SHARED_SEGMENTS (8 * 1024)
#define PHQ_MDD_SMEM_MAX (227 * 1024)
// the looped instance's NW
#define PHQ_MDD_LOOPED 0
// ints of a segment-table row before its mask words: start, width,
// tolerance, 0
#define PHQ_MDD_SEG_INTS 4

struct PhqMddParams {
  int n, B, W, S, ld_obs, ld_len, qmt, NW;
};

// 64-bit mask words of a segment-table row (kernels/mdd.py:mask_words):
// one for NW <= 16, two for NW = 32, none for the looped instance
__host__ __device__ __forceinline__ int phq_mdd_mask_words(int nw) {
  return nw == PHQ_MDD_LOOPED ? 0 : nw <= 16 ? 1 : nw / 16;
}

__host__ __device__ __forceinline__ int phq_mdd_segment_ints(int nw) {
  return PHQ_MDD_SEG_INTS + 2 * phq_mdd_mask_words(nw);
}

// `count` bits from bit `start` (count <= 64)
template <typename Mask>
__device__ __forceinline__ Mask phq_bits(int start, int count) {
  if (count <= 0) return 0;
  const Mask ones = count >= (int)(8 * sizeof(Mask)) ? ~(Mask)0 : (((Mask)1 << count) - 1);
  return ones << start;
}

// the bits of positions [lo, hi) that fall in 64-bit mask word m
__device__ __forceinline__ unsigned long long phq_range_word(int lo, int hi, int m) {
  const int a = max(lo - 64 * m, 0);
  const int b = min(hi - 64 * m, 64);
  return b > a ? phq_bits<unsigned long long>(a, b - a) : 0ull;
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

// the looped instance's: the read's words taken from its row as they are
// compared, the first difference in word order deciding
__device__ __forceinline__ int phq_key_order_row(const uint32_t* key, int nw, const uint8_t* row, int W) {
  for (int k = 0; k < nw; ++k) {
    const uint32_t o = phq_mdd_word(row, W, k);
    if (key[k] != o) return key[k] < o ? -1 : 1;
  }
  return 0;
}

// The key table (into shared memory when `table_in_shared`) and the
// segment table (when `segments_in_shared`) of one block; returns the
// table's base and sets `segs` to the segment table's.
__device__ __forceinline__ const uint32_t* phq_mdd_tables(const PhqMddParams& p, int table_in_shared,
                                                          int segments_in_shared, const uint32_t* table,
                                                          const int* segments, uint8_t* smem,
                                                          const int** segs) {
  const int table_ints = 2 * p.B * p.NW + ((p.B + 3) & ~3);
  const uint32_t* words = table;
  int at = 0;
  if (table_in_shared) {
    uint32_t* s_table = (uint32_t*)smem;
    for (int t = threadIdx.x; 4 * t < table_ints; t += blockDim.x) {
      ((uint4*)s_table)[t] = ((const uint4*)table)[t];
    }
    words = s_table;
    at = 4 * table_ints;
  }
  *segs = segments;
  if (segments_in_shared) {
    int* s_segs = (int*)(smem + at);
    const int seg_ints = p.S * phq_mdd_segment_ints(p.NW);
    for (int t = threadIdx.x; t < seg_ints; t += blockDim.x) s_segs[t] = segments[t];
    *segs = s_segs;
  }
  return words;
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

template <int NW>
__global__ void __launch_bounds__(PHQ_MDD_THREADS) phq_mdd_kernel(
    PhqMddParams p, int table_in_shared, int segments_in_shared, const uint8_t* __restrict__ obs_code,
    const uint8_t* __restrict__ obs_qual, const int* __restrict__ lengths,
    const uint8_t* __restrict__ qcfail_in, const uint32_t* __restrict__ table,
    const int* __restrict__ segments, int* __restrict__ decoded, int* __restrict__ argmax,
    int* __restrict__ distance, int8_t* __restrict__ branch,
    float* __restrict__ confidence, uint8_t* __restrict__ qcfail_out) {
  using Mask = typename std::conditional<(NW <= 8), uint32_t, unsigned long long>::type;
  constexpr int MW = NW <= 16 ? 1 : NW / 16;  // mask words of a read
  constexpr int SEG = PHQ_MDD_SEG_INTS + 2 * MW;  // ints of a segment-table row
  PHQ_DYNAMIC_SMEM(smem);
  // the table: B * NW panel words in codec order, B * NW keys sorted, B
  // indices (padded to whole 16-byte words)
  const int* segs = nullptr;
  const uint32_t* words = phq_mdd_tables(p, table_in_shared, segments_in_shared, table, segments, smem, &segs);
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
  Mask inr[MW];
#pragma unroll
  for (int m = 0; m < MW; ++m) inr[m] = 0;
  for (int s = 0; s < p.S; ++s) {
    const int* seg = segs + s * SEG;
    const int l = len[s];
    full = full && l == seg[1];
    const int in_range = min(max(l, 0), seg[1]);
    if constexpr (MW == 1) {
      inr[0] |= phq_bits<Mask>(seg[0], in_range);
    } else {
#pragma unroll
      for (int m = 0; m < MW; ++m) inr[m] |= phq_range_word(seg[0], seg[0] + in_range, m);
    }
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
  Mask lowq[MW];
#pragma unroll
  for (int m = 0; m < MW; ++m) lowq[m] = 0;
  if (pending && p.qmt > 0) {
    const uint8_t* oq = obs_qual + (size_t)row * p.ld_obs;
    uint32_t qw[NW];
    phq_load_words<NW>(oq, p.W, qw);
#pragma unroll
    for (int k = 0; k < NW; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int w = 4 * k + j;
        if ((int)((qw[k] >> (8 * j)) & 255u) < p.qmt) lowq[w / 64] |= (Mask)1 << (w % 64);
      }
    }
#pragma unroll
    for (int m = 0; m < MW; ++m) lowq[m] &= inr[m];
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
    Mask in[MW], lq[MW];
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      in[m] = __shfl_sync(0xFFFFFFFFu, inr[m], src);
      lq[m] = __shfl_sync(0xFFFFFFFFu, lowq[m], src);
    }
    int found = -1;
    int found_error = 0;
    for (int b0 = 0; b0 < p.B; b0 += 32) {
      const int b = b0 + lane;
      bool within = false;
      int total = 0;
      if (b < p.B) {
        const uint4* e = (const uint4*)(words + b * NW);
        Mask err[MW];
#pragma unroll
        for (int m = 0; m < MW; ++m) err[m] = 0;
#pragma unroll
        for (int q = 0; q < NW / 4; ++q) {
          const uint4 v = e[q];
          Mask& mismatch = err[q / 4];
          const int at = 16 * (q % 4);
          mismatch |= (Mask)phq_nonzero_nibble(w[4 * q] ^ v.x) << at;
          mismatch |= (Mask)phq_nonzero_nibble(w[4 * q + 1] ^ v.y) << (at + 4);
          mismatch |= (Mask)phq_nonzero_nibble(w[4 * q + 2] ^ v.z) << (at + 8);
          mismatch |= (Mask)phq_nonzero_nibble(w[4 * q + 3] ^ v.w) << (at + 12);
        }
#pragma unroll
        for (int m = 0; m < MW; ++m) err[m] = (err[m] & in[m]) | lq[m];
        within = true;
        for (int s = 0; s < p.S; ++s) {
          const int* seg = segs + s * SEG;
          const unsigned long long* mask = (const unsigned long long*)(seg + PHQ_MDD_SEG_INTS);
          int errors = 0;
#pragma unroll
          for (int m = 0; m < MW; ++m) errors += phq_popc<Mask>(err[m] & (Mask)mask[m]);
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

// The looped instance (W > 128, p.NW key words of 16 positions' multiples):
// each warp stages its pending reads one at a time in its buffer of
// shared memory (`buffer` ints a warp: NW read words, then MW in-range and
// MW low-quality 64-bit mask words).
__global__ void __launch_bounds__(PHQ_MDD_THREADS) phq_mdd_looped_kernel(
    PhqMddParams p, int table_in_shared, int segments_in_shared, int buffer_at,
    const uint8_t* __restrict__ obs_code, const uint8_t* __restrict__ obs_qual,
    const int* __restrict__ lengths, const uint8_t* __restrict__ qcfail_in,
    const uint32_t* __restrict__ table, const int* __restrict__ segments, int* __restrict__ decoded,
    int* __restrict__ argmax, int* __restrict__ distance, int8_t* __restrict__ branch,
    float* __restrict__ confidence, uint8_t* __restrict__ qcfail_out) {
  constexpr int SEG = PHQ_MDD_SEG_INTS;
  PHQ_DYNAMIC_SMEM(smem);
  const int NW = p.NW;
  const int MW = (4 * NW + 63) / 64;
  const int* segs = nullptr;
  const uint32_t* words = phq_mdd_tables(p, table_in_shared, segments_in_shared, table, segments, smem, &segs);
  __syncthreads();
  const uint32_t* keys = words + (size_t)p.B * NW;
  const int* index = (const int*)(keys + (size_t)p.B * NW);
  const int lane = threadIdx.x & 31;
  uint32_t* buffer = (uint32_t*)(smem + buffer_at) + (threadIdx.x / 32) * (NW + 4 * MW);
  unsigned long long* b_in = (unsigned long long*)(buffer + NW);
  unsigned long long* b_lq = b_in + MW;

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
    int hi = p.B;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (phq_key_order_row(keys + (size_t)mid * NW, NW, oc, p.W) < 0) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo < p.B && phq_key_order_row(keys + (size_t)lo * NW, NW, oc, p.W) == 0) result = index[lo];
  }
  const bool pending = active && result < 0;

  unsigned todo = __ballot_sync(0xFFFFFFFFu, pending);
#ifdef PHQ_MDD_NO_SCAN
  todo = 0;
#endif
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    // the warp stages read `src`: its words, in-range and low-quality masks
    const int r = __shfl_sync(0xFFFFFFFFu, row, src);
    const uint8_t* rc = obs_code + (size_t)r * p.ld_obs;
    const uint8_t* rq = obs_qual + (size_t)r * p.ld_obs;
    const int* rl = lengths + (size_t)r * p.ld_len;
    for (int k = lane; k < NW; k += 32) buffer[k] = phq_mdd_word(rc, p.W, k);
    for (int m = lane; m < MW; m += 32) {
      unsigned long long in = 0ull;
      for (int s = 0; s < p.S; ++s) {
        const int* seg = segs + s * SEG;
        in |= phq_range_word(seg[0], seg[0] + min(max(rl[s], 0), seg[1]), m);
      }
      unsigned long long lq = 0ull;
      if (p.qmt > 0) {
        for (int j = 0; j < 64 && 64 * m + j < p.W; ++j) {
          if ((int)rq[64 * m + j] < p.qmt) lq |= 1ull << j;
        }
      }
      b_in[m] = in;
      b_lq[m] = lq & in;
    }
    __syncwarp();
    int found = -1;
    int found_error = 0;
    for (int b0 = 0; b0 < p.B; b0 += 32) {
      const int b = b0 + lane;
      bool within = false;
      int total = 0;
      if (b < p.B) {
        const uint32_t* e = words + (size_t)b * NW;
        within = true;
        int s = 0;
        int errors = 0;  // of segment s so far
        for (int m = 0; m < MW && s < p.S; ++m) {
          unsigned long long mismatch = 0ull;
          for (int k = 0; k < 16 && 16 * m + k < NW; ++k) {
            mismatch |= (unsigned long long)phq_nonzero_nibble(buffer[16 * m + k] ^ e[16 * m + k]) << (4 * k);
          }
          const unsigned long long err = (mismatch & b_in[m]) | b_lq[m];
          // the segments in position order, each counted word by word
          while (s < p.S) {
            const int* seg = segs + s * SEG;
            const int end = seg[0] + seg[1];
            errors += __popcll(err & phq_range_word(seg[0], end, m));
            if (end > 64 * (m + 1)) break;  // continues in the next word
            within = within && errors <= seg[2];
            total += errors;
            errors = 0;
            ++s;
          }
        }
        // segments of no position (width 0) after the last word
        for (; s < p.S; ++s) {
          within = within && errors <= segs[s * SEG + 2];
          total += errors;
          errors = 0;
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
    __syncwarp();  // the buffer is free for the next read
  }

  if (!active) return;
  phq_mdd_write(i, result, dist, qcfail_in, decoded, argmax, distance, branch, confidence, qcfail_out);
}

// ints: n, B, W, S, ld_obs, ld_len, quality masking threshold, words a key
// (NW: 4, 8, 16 or 32, or 4 * ceil(W / 16) past 128 positions, the looped
// instance). Codes and qualities are (N, W) uint8 rows of stride ld_obs,
// lengths (N, S) int32 rows of stride ld_len; `table` is the decoder's key
// table (kernels/mdd.py:key_table, 16-byte aligned) and `segments` its
// segment table (kernels/mdd.py:segment_table: per segment start, width,
// tolerance, 0 and its position mask as MW 64-bit words); the results go
// to the decode step's (N,) rows.
PHQ_EXPORT int phq_mdd(const int* ints, const void* obs_code,
                       const void* obs_qual, const void* lengths,
                       const void* qcfail_in, const void* table, const void* segments, void* decoded,
                       void* argmax, void* distance, void* branch,
                       void* confidence, void* qcfail_out, void* stream) {
  PhqMddParams p;
  p.n = ints[0];
  p.B = ints[1];
  p.W = ints[2];
  p.S = ints[3];
  p.ld_obs = ints[4];
  p.ld_len = ints[5];
  p.qmt = ints[6];
  p.NW = ints[7];
  const int nw = p.W <= 16 ? 4 : p.W <= 32 ? 8 : p.W <= 64 ? 16 : p.W <= 128 ? 32 : 4 * ((p.W + 15) / 16);
  if (p.S < 1 || p.W < 1 || p.B < 1 || p.NW != nw || ((uintptr_t)table & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.n <= 0) return (int)cudaGetLastError();
  const bool looped = p.W > 128;
  const size_t table_bytes = 4 * ((size_t)2 * p.B * p.NW + ((p.B + 3) & ~3));
  const bool table_in_shared = table_bytes <= PHQ_MDD_SHARED_TABLE;
  const size_t segment_bytes = (size_t)4 * p.S * phq_mdd_segment_ints(looped ? PHQ_MDD_LOOPED : p.NW);
  const bool segments_in_shared = segment_bytes <= PHQ_MDD_SHARED_SEGMENTS;
  size_t smem = (table_in_shared ? table_bytes : 0) + (segments_in_shared ? (segment_bytes + 15) / 16 * 16 : 0);
  const int blocks = (p.n + PHQ_MDD_THREADS - 1) / PHQ_MDD_THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* oc = (const uint8_t*)obs_code;
  const uint8_t* oq = (const uint8_t*)obs_qual;
  const int* ln = (const int*)lengths;
  const uint8_t* qc = (const uint8_t*)qcfail_in;
  const uint32_t* tb = (const uint32_t*)table;
  const int* sg = (const int*)segments;
  if (looped) {
    const int buffer_at = (int)smem;
    const int mw = (4 * p.NW + 63) / 64;
    smem += (size_t)PHQ_MDD_WARPS * 4 * (p.NW + 4 * mw);
    if (smem > PHQ_MDD_SMEM_MAX) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t status =
          cudaFuncSetAttribute(phq_mdd_looped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (status != cudaSuccess) return (int)status;
    }
    PHQ_LAUNCH(phq_mdd_looped_kernel, blocks, PHQ_MDD_THREADS, smem, s)(
        p, table_in_shared ? 1 : 0, segments_in_shared ? 1 : 0, buffer_at, oc, oq, ln, qc, tb, sg,
        (int*)decoded, (int*)argmax, (int*)distance, (int8_t*)branch, (float*)confidence, (uint8_t*)qcfail_out);
    return (int)cudaGetLastError();
  }
  // one name for the instance: a template argument list's comma would
  // split the launch macro's arguments
  void (*kernel)(PhqMddParams, int, int, const uint8_t*, const uint8_t*, const int*, const uint8_t*,
                 const uint32_t*, const int*, int*, int*, int*, int8_t*, float*, uint8_t*) =
      p.NW == 4 ? phq_mdd_kernel<4> : p.NW == 8 ? phq_mdd_kernel<8> : p.NW == 16 ? phq_mdd_kernel<16>
                                                                                  : phq_mdd_kernel<32>;
  PHQ_LAUNCH(kernel, blocks, PHQ_MDD_THREADS, smem, s)(
      p, table_in_shared ? 1 : 0, segments_in_shared ? 1 : 0, oc, oq, ln, qc, tb, sg, (int*)decoded,
      (int*)argmax, (int*)distance, (int8_t*)branch, (float*)confidence, (uint8_t*)qcfail_out);
  return (int)cudaGetLastError();
}
