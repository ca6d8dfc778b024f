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
#include <type_traits>

#include "common.cuh"

#define PHQ_MDD_THREADS 256
#define PHQ_MDD_MAXS 8
#define PHQ_MDD_MAXW 64
#define PHQ_MDD_SHARED_TABLE (40 * 1024)

struct PhqMddParams {
  int n, B, W, S, ld_obs, ld_len, qmt;
  int start[PHQ_MDD_MAXS];
  int width[PHQ_MDD_MAXS];
  int tolerance[PHQ_MDD_MAXS];
};

// `count` bits from bit `start` (count <= 64)
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

template <int NW>
__global__ void __launch_bounds__(PHQ_MDD_THREADS) phq_mdd_kernel(
    PhqMddParams p, int table_in_shared, const uint8_t* __restrict__ obs_code,
    const uint8_t* __restrict__ obs_qual, const int* __restrict__ lengths,
    const uint8_t* __restrict__ qcfail_in, const uint32_t* __restrict__ table,
    int* __restrict__ decoded, int* __restrict__ argmax,
    int* __restrict__ distance, int8_t* __restrict__ branch,
    float* __restrict__ confidence, uint8_t* __restrict__ qcfail_out) {
  using Mask = typename std::conditional<(NW <= 8), uint32_t, unsigned long long>::type;
  PHQ_DYNAMIC_SMEM(smem);
  __shared__ Mask s_segmask[PHQ_MDD_MAXS];
  __shared__ int s_start[PHQ_MDD_MAXS];
  __shared__ int s_width[PHQ_MDD_MAXS];
  __shared__ int s_tolerance[PHQ_MDD_MAXS];
  // the table: B * NW panel words in codec order, B * NW keys sorted, B
  // indices (padded to whole 16-byte words)
  const int table_ints = 2 * p.B * NW + ((p.B + 3) & ~3);
  const uint32_t* words = table;
  if (table_in_shared) {
    uint32_t* s_table = (uint32_t*)smem;
    for (int t = threadIdx.x; 4 * t < table_ints; t += blockDim.x) {
      ((uint4*)s_table)[t] = ((const uint4*)table)[t];
    }
    words = s_table;
  }
  if (threadIdx.x < PHQ_MDD_MAXS) {
    const int s = threadIdx.x;
    s_segmask[s] = s < p.S ? phq_bits<Mask>(p.start[s], p.width[s]) : (Mask)0;
    s_start[s] = p.start[s];
    s_width[s] = p.width[s];
    s_tolerance[s] = p.tolerance[s];
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
    const int l = len[s];
    full = full && l == s_width[s];
    inr |= phq_bits<Mask>(s_start[s], min(max(l, 0), s_width[s]));
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
          mismatch |= (Mask)phq_nonzero_nibble(w[4 * q] ^ v.x) << (16 * q);
          mismatch |= (Mask)phq_nonzero_nibble(w[4 * q + 1] ^ v.y) << (16 * q + 4);
          mismatch |= (Mask)phq_nonzero_nibble(w[4 * q + 2] ^ v.z) << (16 * q + 8);
          mismatch |= (Mask)phq_nonzero_nibble(w[4 * q + 3] ^ v.w) << (16 * q + 12);
        }
        const Mask err = (mismatch & in) | lq;
        within = true;
        for (int s = 0; s < p.S; ++s) {
          const int errors = phq_popc<Mask>(err & s_segmask[s]);
          within = within && errors <= s_tolerance[s];
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
  const int decoded_index = result + 1;
  decoded[i] = decoded_index;
  argmax[i] = decoded_index;
  distance[i] = result >= 0 ? dist : 0;
  branch[i] = 0;
  confidence[i] = 0.0f;
  qcfail_out[i] = (qcfail_in[i] != 0 || decoded_index == 0) ? 1 : 0;
}

template <int NW>
static int phq_mdd_launch(const PhqMddParams& p, const void* obs_code,
                          const void* obs_qual, const void* lengths,
                          const void* qcfail_in, const void* table,
                          void* decoded, void* argmax, void* distance,
                          void* branch, void* confidence, void* qcfail_out,
                          cudaStream_t stream) {
  const size_t table_bytes = 4 * ((size_t)2 * p.B * NW + ((p.B + 3) & ~3));
  const bool in_shared = table_bytes <= PHQ_MDD_SHARED_TABLE;
  const int blocks = (p.n + PHQ_MDD_THREADS - 1) / PHQ_MDD_THREADS;
  PHQ_LAUNCH(phq_mdd_kernel<NW>, blocks, PHQ_MDD_THREADS, in_shared ? table_bytes : 0, stream)(
      p, in_shared ? 1 : 0, (const uint8_t*)obs_code, (const uint8_t*)obs_qual,
      (const int*)lengths, (const uint8_t*)qcfail_in, (const uint32_t*)table,
      (int*)decoded, (int*)argmax, (int*)distance, (int8_t*)branch,
      (float*)confidence, (uint8_t*)qcfail_out);
  return (int)cudaGetLastError();
}

// ints: n, B, W, S, ld_obs, ld_len, quality masking threshold, words a key
// (NW: 4, 8 or 16), then per segment (start, width, tolerance). Codes and
// qualities are (N, W) uint8 rows of stride ld_obs, lengths (N, S) int32
// rows of stride ld_len; `table` is the decoder's key table
// (kernels/mdd.py:key_table, 16-byte aligned); the results go to the
// decode step's (N,) rows.
PHQ_EXPORT int phq_mdd(const int* ints, const void* obs_code,
                       const void* obs_qual, const void* lengths,
                       const void* qcfail_in, const void* table, void* decoded,
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
  const int nw = ints[7];
  if (p.S < 1 || p.S > PHQ_MDD_MAXS || p.W < 1 || p.W > PHQ_MDD_MAXW || p.B < 1 ||
      nw != (p.W <= 16 ? 4 : p.W <= 32 ? 8 : 16) || ((uintptr_t)table & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < PHQ_MDD_MAXS; ++s) {
    const bool used = s < p.S;
    p.start[s] = used ? ints[8 + 3 * s] : 0;
    p.width[s] = used ? ints[9 + 3 * s] : 0;
    p.tolerance[s] = used ? ints[10 + 3 * s] : 0;
  }
  if (p.n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (nw == 4) {
    return phq_mdd_launch<4>(p, obs_code, obs_qual, lengths, qcfail_in, table,
                             decoded, argmax, distance, branch, confidence,
                             qcfail_out, s);
  }
  if (nw == 8) {
    return phq_mdd_launch<8>(p, obs_code, obs_qual, lengths, qcfail_in, table,
                             decoded, argmax, distance, branch, confidence,
                             qcfail_out, s);
  }
  return phq_mdd_launch<16>(p, obs_code, obs_qual, lengths, qcfail_in, table,
                            decoded, argmax, distance, branch, confidence,
                            qcfail_out, s);
}
