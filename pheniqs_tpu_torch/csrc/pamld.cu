// K1 with K2 fused: the PAMLD classify of one decoder, per read, for a
// panel of any size; K7, the same tile loop past 1024 barcodes with the
// panel split into slices across blocks; and K8, the same slices over one
// shard of a panel split across ranks.
//
// Replaces the TPU program's pheniqs_tpu/device/classify.py:
// pamld_classify_device (402-664: the likelihood contraction at 465-473,
// the monolithic posterior at 478-510, the decoded-barcode distance (K2)
// at 512-586, the branches and qcfail chain at 588-615 and the hybrid
// uncertain mask at 625-663) and, for panels past LARGE_PANEL_B = 1024,
// its _posterior_chunked (240-332, reached at 444-451) with the row-gather
// distance (575-582); observation_features (205-235) and
// device/instrument.py:analytic_tpq (61-94) are folded into its prologue.
// K8 replaces classify.py:_posterior_panel_sharded (335-399) with
// device/tp.py:_local_posterior and tp_posterior (48-177).
//
// Bound on the H100: arithmetic on the CUDA cores. Per read it evaluates
// sigma for all B barcodes twice (once for the row minimum, once for the
// posterior): 4*N*B*(W+1) useful operations, 6.3 T for a 737,280-barcode
// 16 nt whitelist per 131072-read batch, 98 ms at 67 TFLOP/s of f32. The
// hybrid bound forbids the tensor cores here: sigma must be an exact f32
// sum (no TF32, no bf16 split), so the contraction F.G of the reference is
// evaluated as the plain per-position sum it stands for. The panel is no
// limit: 11.8 MB at the whitelist, resident in the 50 MB L2, and a tile of
// it costs ~10^3 cycles to copy against ~10^6 of arithmetic, so the tiles
// are copied by the block's threads (no cp.async or TMA).
//
// What the design does about the arithmetic:
//  - Slices. The grid is (read blocks x S slices); slice s takes a
//    contiguous run of the panel's columns cut at multiples of `cut`
//    barcodes (cuts [s*C/S, (s+1)*C/S) of C = ceil(B/cut)). The cut is a
//    whole tile (PhqPamldShape::tile_b) where whole tiles give the waves,
//    as at a whitelist; else PHQ_PAMLD_SLICE_UNIT, so that a panel of one
//    tile, K1's, is sliced too. S and the cut come from the shapes and the
//    card (kernels/pamld.py slice_plan: the smallest S giving >= 4 waves of
//    the resident block slots phq_pamld_info reports, each slice at least
//    one cut; one slice for a panel of one tile whose batch already fills
//    3/4 of the one-launch instance's last wave, where slices would only
//    add their prologues and the merge), so a batch of any size fills the
//    132 SMs. Inside a slice
//    the tiles are still loaded tile_b barcodes at a time (a slice narrower
//    than a tile is one load, one __syncthreads). Stage A
//    (PHQ_MODE_SLICE_MIN) writes each slice's row minimum, stage B
//    (PHQ_MODE_SLICE_POSTERIOR) takes the minimum over the slices in its
//    prologue (exact in any order) and writes each slice's five partials in
//    that frame, and the merge kernel (stage C) combines the slices in
//    slice order by the rules of device/tp.py:reduce_partials (totals
//    summed in slice order, MAX of the best, the first global index among
//    its holders, MIN of sigma on the holder, MAX of the runner-up) and
//    runs phq_pamld_finish. No atomics: two launches give the same bytes.
//    The merge gives the one-pass loop's best, index, runner-up and sigma
//    of the best bit for bit (maxima and minima are exact in any order);
//    only the posterior's total is summed in another tree, per slice and
//    then over the slices, which the hybrid bound's gamma_b term covers:
//    2*gamma_{B+2} bounds any summation tree of the B positive terms. K8
//    runs stages A and B on its shard with the same slices and the merge
//    without the finish, before the merges across ranks. A panel of one
//    slice runs both passes in one launch (PHQ_MODE_CLASSIFY), loading its
//    tile once; its prologue fetches the reads' bytes as words before the
//    TPQ table's barriers and K2 compares four positions a step, which
//    keep it at 4 blocks/SM on the H100 (W <= 16).
//  - Packed compares. A read keeps its codes as 32-bit words, four
//    positions each, holding a position's code only where it is A, C, G or
//    T with q > 0 (elsewhere both feature terms are 0); a barcode row is
//    read from shared memory in 16-byte broadcast loads, and one AND per
//    word finds the matching positions of an all-strict barcode (a strict
//    code has one bit). Only the matching positions' features are added.
//  - Strictness folded per barcode. A tile load marks each barcode whose
//    positions are all A, C, G or T. For such a barcode the strictness
//    terms are the same W terms whatever the barcode, so the read sums them
//    once with qpos*U: C = (sum of fs) + qpos*U, and sigma = M + C, M the
//    match terms added in position order. A barcode with other codes takes
//    the interleaved loop (per position the match, then the strictness
//    term, then qpos*U). Either order sums the same at most 2W + 1 nonzero
//    terms, and the hybrid bound (pheniqs_tpu/device/classify.py:57-84,
//    gamma_{2W+2} * S_read) holds for any order of those terms: every
//    summation tree of K terms errs by at most gamma_{K-1} times the sum of
//    their magnitudes. Both passes call the same functions, and the row
//    minimum of stage A is min(M) + C: rounding is monotone, so that is
//    bit-equal to the least sigma of pass B.
//  - Independent chains. Each thread takes PhqPamldShape::reads reads (2 at
//    W <= 16) and each step of the barcode loop PHQ_PAMLD_UNROLL barcodes, so
//    one shared-memory load feeds every read and each thread keeps several
//    sigma sums in flight.
//  - Any width. An observation of up to 64 positions keeps its W match
//    features in registers (instances MAXW 16, 32, 64). Past 64 they would
//    pass the 255-register cap, and a read fetched position by position
//    leaves each add waiting on a load: the looped instance (MAXW 0) first
//    writes each read's strict codes and quality bytes to device memory
//    (one launch, 16-byte vectors of 16 positions, vector v of read i at
//    [v * N + i]) with C beside them, and its tile loop is blocked, as the
//    arithmetic binds it: a thread keeps 1 read x 16 barcodes of sums and
//    walks the positions in blocks of 16. Per block it loads the read's
//    two vectors one block ahead of their use and its 16 features from the
//    block's 256-entry table fm[q] = tpq(q) - q (the same two f32
//    operations, so the same bits) once, then per barcode one 16-byte
//    broadcast load of the row, and per word one AND and four predicated
//    adds: about two instructions a (read, barcode, position), no load on
//    an add chain. Each sum adds its terms in position order, so
//    pamld_classify_tile_order stays its twin; its tile is sized to the
//    row, in whole groups of 16 barcodes.
// Kept from K1: an exact f32 sigma (products by 0 or 1 only, -fmad=false),
// CUDA's expf, first-maximum ties (strict p > best), a runner-up that keeps
// duplicated maxima (classify.py:_second_max), and padding columns never
// visited.
#include <type_traits>

#include "common.cuh"
#include <math.h>

#define PHQ_PAMLD_THREADS 128
#define PHQ_PAMLD_TILE_BYTES 32768
// barcodes a step of the barcode loop takes
#define PHQ_PAMLD_UNROLL 2
// the least barcodes of a slice cut below a tile (a multiple of the
// unroll): every slice repeats a block's prologue (the TPQ table, the
// reads' loads and features, the tile load) in stages A and B, which on an
// H100 costs about as much as a few dozen barcodes of arithmetic: 96
// barcodes run fastest in 2 slices (chip_smoke.py's slice_cut_sweep;
// PERF.md)
#define PHQ_PAMLD_SLICE_UNIT 48

// The wide tile loop (the looped instance, observations past 64
// positions): a thread keeps PHQ_PAMLD_WIDE_READS reads x
// PHQ_PAMLD_WIDE_UNROLL barcodes of sigma sums and walks the positions in
// blocks of 16 (phq_wide_block); its kernels ask the compiler for
// PHQ_PAMLD_WIDE_BLOCKS resident blocks. On an H100 (PERF.md's sweep of
// chip_smoke.py --times): 1 x 16 takes 128 registers, no spills,
// 4 blocks/SM; 1 x 8 (96 registers, 5 blocks/SM) ran 4-8 % slower from 96
// positions on; 2 x 8, 2 x 16 and 4 x 4 spill at that cap and ran slower.
#define PHQ_PAMLD_WIDE_READS 1
#define PHQ_PAMLD_WIDE_UNROLL 16
#define PHQ_PAMLD_WIDE_BLOCKS 4

// The looped instance (MAXW 0, observations wider than 64 positions): its
// read state lives in device memory (phq_pamld_state_kernel), and its tile
// and row size are set at run time.
#define PHQ_PAMLD_LOOPED 0

template <int MAXW>
struct PhqPamldShape {
  static constexpr bool looped = MAXW == PHQ_PAMLD_LOOPED;
  // reads a thread takes: two while the register arrays stay small
  static constexpr int reads = looped ? PHQ_PAMLD_WIDE_READS : MAXW <= 16 ? 2 : 1;
  // 32-bit words of a read or a barcode row (the looped instance's are
  // counted at run time: phq_pamld_row_bytes)
  static constexpr int words = looped ? 4 : MAXW / 4;
  static constexpr int tile_b = looped ? 0 : PHQ_PAMLD_TILE_BYTES / MAXW;
  // barcodes a step of the barcode loop takes
  static constexpr int unroll = looped ? PHQ_PAMLD_WIDE_UNROLL : PHQ_PAMLD_UNROLL;
};

// bytes of a barcode row in the tile: whole 16-byte vectors
__host__ __device__ __forceinline__ int phq_pamld_row_bytes(int W) { return 16 * ((W + 15) / 16); }

struct PhqPamldParams {
  int n, B, W, ld_obs, short_stride;
  int has_noise, has_rbp, has_ct, hq_threshold, hqd_threshold, want_uncertain;
  float U, lam, log_noise, nst, ct;
  float gamma_w, term_w, eps_w, four_lam, gamma_b, gamma_chunks, eight_u;
  float safety, sigma_floor, four_u;
};

// ints:   n, B, W, ld_obs, short_stride, has_noise, has_rbp, has_ct,
//         hq_threshold, hqd_threshold, want_uncertain
// floats: U, lam, log_noise, nst, ct, gamma_w, term_w, eps_w, four_lam,
//         gamma_b, gamma_chunks, eight_u, safety, sigma_floor, four_u
static inline PhqPamldParams phq_pamld_params(const int* ints, const float* floats) {
  PhqPamldParams p;
  p.n = ints[0];
  p.B = ints[1];
  p.W = ints[2];
  p.ld_obs = ints[3];
  p.short_stride = ints[4];
  p.has_noise = ints[5];
  p.has_rbp = ints[6];
  p.has_ct = ints[7];
  p.hq_threshold = ints[8];
  p.hqd_threshold = ints[9];
  p.want_uncertain = ints[10];
  p.U = floats[0];
  p.lam = floats[1];
  p.log_noise = floats[2];
  p.nst = floats[3];
  p.ct = floats[4];
  p.gamma_w = floats[5];
  p.term_w = floats[6];
  p.eps_w = floats[7];
  p.four_lam = floats[8];
  p.gamma_b = floats[9];
  p.gamma_chunks = floats[10];
  p.eight_u = floats[11];
  p.safety = floats[12];
  p.sigma_floor = floats[13];
  p.four_u = floats[14];
  return p;
}

__device__ __forceinline__ bool phq_strict(uint32_t c) {
  return c == 1u || c == 2u || c == 4u || c == 8u;
}

// The 256-entry TPQ table in shared memory (needs a
// __syncthreads() before it is read); with FM the match features
// tpq(q) - q instead, the same two f32 operations as PhqRead::load's.
template <bool FM>
__device__ __forceinline__ void phq_tpq_table(float* s_tpq, float* s_consts,
                                              const float* tpq_consts) {
  if (threadIdx.x < 24) s_consts[threadIdx.x] = tpq_consts[threadIdx.x];
  __syncthreads();
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    const float tpq = phq_analytic_tpq(t, s_consts);
    s_tpq[t] = FM ? tpq - (float)t : tpq;
  }
}

// The tensors of one launch. `panel`/`conc` are the columns the launch
// walks (K8: its shard's, `base` their first global column); `shift` holds
// S rows of row minima (stage A writes them; stage B and the merge read
// `shift_rows` rows and take their minimum); `partials` holds S blocks of
// the five partial rows (total, best p, global best index, runner-up and
// sigma of the best, each (N,), f32 but the int32 index), which stage B
// writes and the merge reads; the merge writes its five rows to `merged`
// or, with the finish, the decisions.
struct PhqPamldArgs {
  const uint8_t* obs_code;
  const uint8_t* obs_qual;
  const uint8_t* qcfail_in;
  const uint8_t* short_flags;
  const uint8_t* panel;
  const float* conc;
  const float* tpq_consts;
  float* shift;
  int* partials;
  int* merged;
  int* decoded;
  int* argmax;
  int* distance;
  int8_t* branch;
  float* confidence;
  uint8_t* qcfail_out;
  uint8_t* uncertain;
  // the looped instance's read state (phq_pamld_state_kernel)
  const uint32_t* state;
  int base;
};

// Whether the observation rows and the panel can be read as 32-bit words:
// W a multiple of 4 and every row 4-byte aligned, as the token layout's are.
__host__ __device__ __forceinline__ bool phq_words(const PhqPamldParams& p, const PhqPamldArgs& a) {
  return (p.W & 3) == 0 && (p.ld_obs & 3) == 0 && ((uintptr_t)a.obs_code & 3) == 0 &&
         ((uintptr_t)a.obs_qual & 3) == 0 && ((uintptr_t)a.panel & 3) == 0;
}

// Four bytes of a row from position 4k on (zero past W): one 32-bit load
// with `words`, else byte by byte.
__device__ __forceinline__ uint32_t phq_row_word(const uint8_t* row, int k, int W, bool words) {
  if (words) return *(const uint32_t*)(row + 4 * k);
  uint32_t v = 0u;
  for (int j = 0; j < 4 && 4 * k + j < W; ++j) v |= (uint32_t)row[4 * k + j] << (8 * j);
  return v;
}

// A read's code and quality bytes as words, fetched before the block's
// TPQ table is built so that their loads are in flight across its
// barriers: a slice's prologue waits on them once per slice and stage.
template <int MAXW>
struct PhqRaw {
  uint32_t codes[PhqPamldShape<MAXW>::words];
  uint32_t quals[PhqPamldShape<MAXW>::words];

  __device__ __forceinline__ void fetch(const PhqPamldParams& p, const uint8_t* oc, const uint8_t* oq,
                                        bool words) {
#pragma unroll
    for (int k = 0; k < PhqPamldShape<MAXW>::words; ++k) {
      codes[k] = 4 * k < p.W ? phq_row_word(oc, k, p.W, words) : 0u;
      quals[k] = 4 * k < p.W ? phq_row_word(oq, k, p.W, words) : 0u;
    }
  }
};

// The state a thread keeps for one read: its strict codes packed four to a
// word (0 where the code is not A, C, G or T or q == 0), the match features
// fm = tpq - q of those positions (observation_features; 0 elsewhere),
// C = (sum of the strictness features fs = q - U, position order) + qpos*U,
// and qpos*U alone for the interleaved loop.
template <int MAXW>
struct PhqRead {
  static constexpr int maxw = MAXW;
  uint32_t code[PhqPamldShape<MAXW>::words];
  float fm[MAXW];
  float c;
  float qpos_u;

  // fm of position w (w a constant once the loops are unrolled)
  __device__ __forceinline__ float fm_of(int w) const { return fm[w]; }

  __device__ __forceinline__ void load(const PhqPamldParams& p, const PhqRaw<MAXW>& raw,
                                       const float* s_tpq) {
    int qpos = 0;
    float fs_sum = 0.0f;
#pragma unroll
    for (int k = 0; k < PhqPamldShape<MAXW>::words; ++k) {
      code[k] = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int w = 4 * k + j;
        fm[w] = 0.0f;
        if (w < p.W) {
          const uint32_t cw = (raw.codes[k] >> (8 * j)) & 0xFFu;
          const int q = (int)((raw.quals[k] >> (8 * j)) & 0xFFu);
          if (phq_strict(cw) && q > 0) {
            const float qf = (float)q;
            code[k] |= cw << (8 * j);
            fm[w] = s_tpq[q] - qf;
            fs_sum = fs_sum + (qf - p.U);
          }
          qpos += q > 0 ? 1 : 0;
        }
      }
    }
    qpos_u = (float)qpos * p.U;
    c = fs_sum + qpos_u;
  }
};

// The looped instance's read (W > 64, where W match features would pass
// the 255-register cap): its strict codes and quality bytes in device
// memory as 16-byte vectors of 16 positions, vector v of read i at
// [v * n + i] (a warp reads one vector of 32 reads in one 512-byte run),
// C and qpos*U beside them, all written once per batch by
// phq_pamld_state_kernel. A matching position's fm is read from the
// block's table s_fm[q] = tpq(q) - q, the same f32 value PhqRead keeps, so
// sigma is the same bit for bit.
struct PhqReadLooped {
  const uint4* code;  // vector v at code[v * n]
  const uint4* qual;
  size_t n;
  float c;
  float qpos_u;
};

// The looped instance's state: per read, its strict codes, its quality
// bytes, C and qpos*U (PhqReadLooped), computed as PhqRead::load does.
// `state` holds V = ceil(W/16) vectors of codes per read, then V of
// qualities (zero past W), then n floats of C, then n of qpos*U.
__global__ void __launch_bounds__(PHQ_PAMLD_THREADS) phq_pamld_state_kernel(
    PhqPamldParams p, const uint8_t* __restrict__ obs_code, const uint8_t* __restrict__ obs_qual,
    int words_ok, uint4* __restrict__ state) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const size_t n = (size_t)p.n;
  const int V = phq_pamld_row_bytes(p.W) / 16;
  const uint8_t* oc = obs_code + (size_t)i * p.ld_obs;
  const uint8_t* oq = obs_qual + (size_t)i * p.ld_obs;
  int qpos = 0;
  float fs_sum = 0.0f;
  for (int v = 0; v < V; ++v) {
    uint32_t kept[4], quals[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int k = 4 * v + t;
      const uint32_t cw = 4 * k < p.W ? phq_row_word(oc, k, p.W, words_ok != 0) : 0u;
      const uint32_t qw = 4 * k < p.W ? phq_row_word(oq, k, p.W, words_ok != 0) : 0u;
      kept[t] = 0u;
      quals[t] = qw;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t code = (cw >> (8 * j)) & 0xFFu;
        const int q = (int)((qw >> (8 * j)) & 0xFFu);
        if (phq_strict(code) && q > 0) {
          kept[t] |= code << (8 * j);
          fs_sum = fs_sum + ((float)q - p.U);
        }
        qpos += q > 0 ? 1 : 0;
      }
    }
    state[v * n + i] = make_uint4(kept[0], kept[1], kept[2], kept[3]);
    state[(V + v) * n + i] = make_uint4(quals[0], quals[1], quals[2], quals[3]);
  }
  float* tail = (float*)(state + 2 * V * n);
  const float qpos_u = (float)qpos * p.U;
  tail[i] = fs_sum + qpos_u;
  tail[n + i] = qpos_u;
}

// word k of a barcode row held as 16-byte vectors
template <int K>
__device__ __forceinline__ uint32_t phq_word(const uint4* e) {
  const uint4 v = e[K >> 2];
  return (K & 3) == 0 ? v.x : (K & 3) == 1 ? v.y : (K & 3) == 2 ? v.z : v.w;
}

// M: the match terms of an all-strict barcode row `e`, added in position
// order (each a feature times 0 or 1: only the matching ones are added).
template <typename Read, int K>
__device__ __forceinline__ float phq_match_from(const Read& r, const uint4* e, int W, float acc) {
  constexpr int MAXW = Read::maxw;
  if constexpr (K < PhqPamldShape<MAXW>::words) {
    if (MAXW == 16 || 4 * K < W) {
      const uint32_t x = phq_word<K>(e) & r.code[K];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (x & (0xFu << (8 * j))) acc = acc + r.fm_of(4 * K + j);
      }
    }
    return phq_match_from<Read, K + 1>(r, e, W, acc);
  } else {
    return acc;
  }
}

template <typename Read>
__device__ __forceinline__ float phq_match(const Read& r, const uint4* e, int W) {
  return phq_match_from<Read, 0>(r, e, W, 0.0f);
}

// word j of a 16-byte vector (j a constant once the loops are unrolled)
__device__ __forceinline__ uint32_t phq_lane(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// One block of 16 positions of the wide tile loop, NW of its four words
// inside the observation: the R reads' kept codes `code` and quality bytes
// `qual` of the block, whose 4*NW match features each read takes from the
// table s_fm once, before any add; then, for each of the U barcode rows
// (row u's vector at e[u * V]), one 16-byte broadcast load and, per read
// and word, one AND and four predicated adds of fm in position order
// (strict codes are one-hot: a position matches if and only if its byte of
// the AND is not 0). Each of the R x U sums in `m` adds its terms in
// position order, so a skipped term is the +0.0 of sigma_tile_order.
template <int R, int U, int NW>
__device__ __forceinline__ void phq_wide_block(const uint4 (&code)[R], const uint4 (&qual)[R], const float* s_fm,
                                               const uint4* e, int V, float (&m)[R][U]) {
  float fm[R][4 * NW];
#pragma unroll
  for (int k = 0; k < R; ++k) {
#pragma unroll
    for (int w = 0; w < 4 * NW; ++w) fm[k][w] = s_fm[(phq_lane(qual[k], w >> 2) >> (8 * (w & 3))) & 0xFFu];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const uint4 row = e[u * V];
#pragma unroll
    for (int k = 0; k < R; ++k) {
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const uint32_t x = phq_lane(row, j) & phq_lane(code[k], j);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (x & (0xFu << (8 * t))) m[k][u] = m[k][u] + fm[k][4 * j + t];
        }
      }
    }
  }
}

// The last block of an observation whose words are not a multiple of four
// (W = 65, 97, 300): its `rest` words.
template <int R, int U>
__device__ __forceinline__ void phq_wide_rest(int rest, const uint4 (&code)[R], const uint4 (&qual)[R],
                                              const float* s_fm, const uint4* e, int V, float (&m)[R][U]) {
  if (rest == 1) phq_wide_block<R, U, 1>(code, qual, s_fm, e, V, m);
  if (rest == 2) phq_wide_block<R, U, 2>(code, qual, s_fm, e, V, m);
  if (rest == 3) phq_wide_block<R, U, 3>(code, qual, s_fm, e, V, m);
}

// M of R reads against U all-strict barcode rows (row u at e[u * V] of the
// tile): the reads' state read from device memory one block of 16
// positions ahead of its use, once per block for all U barcodes; the last
// block cut to the observation's words (W = 65, 97, 300).
template <int R, int U>
__device__ __forceinline__ void phq_wide_match(const PhqReadLooped (&r)[R], const float* s_fm, const uint4* e,
                                               int V, int W, float (&m)[R][U]) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
#pragma unroll
    for (int u = 0; u < U; ++u) m[k][u] = 0.0f;
  }
  const int words = (W + 3) / 4;
  uint4 code[R], qual[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    code[k] = r[k].code[0];
    qual[k] = r[k].qual[0];
  }
#pragma unroll 1
  for (int v = 0; v < words / 4; ++v) {
    uint4 c[R], q[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      c[k] = code[k];
      q[k] = qual[k];
      if (v + 1 < V) {
        code[k] = r[k].code[(size_t)(v + 1) * r[k].n];
        qual[k] = r[k].qual[(size_t)(v + 1) * r[k].n];
      }
    }
    phq_wide_block<R, U, 4>(c, q, s_fm, e + v, V, m);
  }
  phq_wide_rest<R, U>(words & 3, code, qual, s_fm, e + words / 4, V, m);
}

// sigma of a barcode with codes other than A, C, G and T: per position the
// match term, then its strictness term (q - U, from the read's quality
// byte `oq`), then qpos*U, as the (5W, B) contraction orders them. A
// position the read does not keep adds fm = 0 (PhqRead) or nothing (the
// table instances), which leaves the sum as it is.
template <int MAXW>
__device__ __forceinline__ float phq_sigma_mixed(const PhqRead<MAXW>& r, const uint8_t* e,
                                                 const uint8_t* oq, const PhqPamldParams& p) {
  float acc = 0.0f;
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    if (w < p.W) {
      const uint32_t ew = e[w];
      const uint32_t ow = (r.code[w >> 2] >> (8 * (w & 3))) & 0xFFu;
      if (ew == ow) acc = acc + r.fm_of(w);
      if (ow != 0u && phq_strict(ew)) acc = acc + ((float)oq[w] - p.U);
    }
  }
  return acc + r.qpos_u;
}

// The looped instance's: the same sum, its positions looped over the
// read's state; a barcode with other codes is rare.
__device__ __forceinline__ float phq_sigma_mixed(const PhqReadLooped& r, const float* s_fm, const uint8_t* e,
                                                 const uint8_t* oq, const PhqPamldParams& p) {
  float acc = 0.0f;
#pragma unroll 1
  for (int k = 0; 4 * k < p.W; ++k) {
    const uint32_t code = ((const uint32_t*)(r.code + (size_t)(k >> 2) * r.n))[k & 3];
    const uint32_t qual = ((const uint32_t*)(r.qual + (size_t)(k >> 2) * r.n))[k & 3];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * k + j < p.W) {
        const uint32_t ew = e[4 * k + j];
        const uint32_t ow = (code >> (8 * j)) & 0xFFu;
        const uint32_t q = (qual >> (8 * j)) & 0xFFu;
        if (ew == ow && ow != 0u) acc = acc + s_fm[q];
        if (ow != 0u && phq_strict(ew)) acc = acc + ((float)q - p.U);
      }
    }
  }
  return acc + r.qpos_u;
}

// Running posterior of the second pass: prior-adjusted conditionals, their
// sum, the first-max argmax (strict p > best) and the runner-up, which
// keeps duplicated maxima at other columns (classify.py:_second_max).
struct PhqPosterior {
  float total = 0.0f;
  float best = -1.0f;
  float second = 0.0f;
  float sigma_best = 0.0f;
  int best0 = 0;

  __device__ __forceinline__ void add(float c, float s, int b) {
    total = total + c;
    if (c > best) {
      second = fmaxf(second, best);
      best = c;
      best0 = b;
      sigma_best = s;
    } else {
      second = fmaxf(second, c);
    }
  }
};

// Everything after the posterior, for read i: the shifted noise term, the
// decoded index, K2's Hamming and high-quality distance to the decoded
// barcode `e` (a row of the panel) from the read's code and quality rows,
// the noise and confidence branches, the chained qcfail and, with
// want_uncertain, the derived per-read margins of classify.py:625-663 in
// its f32 evaluation order (the port-measured TPQ epsilon is in eps_w, the
// rescale term of the chunked posterior in gamma_chunks).
__device__ __forceinline__ void phq_pamld_finish(
    const PhqPamldParams& p, int i, const PhqPosterior& post, float shift, const uint8_t* e,
    const uint8_t* oc, const uint8_t* oq, bool words, const uint8_t* qcfail_in,
    const uint8_t* short_flags, int* decoded, int* argmax, int* distance,
    int8_t* branch, float* confidence, uint8_t* qcfail_out, uint8_t* uncertain) {
  const float noise_shifted = p.has_noise ? expf(p.log_noise - p.lam * shift) : 0.0f;
  const float sigma_p = post.total + noise_shifted;

  const bool decoded_any = post.sigma_best < 3233.0f;
  const int best_index = decoded_any ? post.best0 + 1 : 0;
  const float conf = post.best / sigma_p;

  // four positions a step, as words where the rows allow (phq_words)
  int raw_distance = 0;
  int raw_hq = 0;
  int qsum = 0;
#pragma unroll 4
  for (int k = 0; 4 * k < p.W; ++k) {
    const uint32_t differ = phq_row_word(e, k, p.W, words) ^ phq_row_word(oc, k, p.W, words);
    const uint32_t quals = phq_row_word(oq, k, p.W, words);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = (int)((quals >> (8 * j)) & 0xFFu);
      const int mismatch = 4 * k + j < p.W && ((differ >> (8 * j)) & 0xFFu) != 0u ? 1 : 0;
      raw_distance += mismatch;
      raw_hq += (mismatch && q >= p.hq_threshold) ? 1 : 0;
      qsum += q;
    }
  }
  const int dist = decoded_any ? raw_distance : 0;
  const int hq_distance = decoded_any ? raw_hq : 0;

  const bool passed_noise = p.has_rbp ? (decoded_any && post.sigma_best < p.nst) : decoded_any;
  const bool passed_conf = conf > p.ct;
  branch[i] = (int8_t)(passed_noise ? (passed_conf ? 0 : 1) : 2);
  decoded[i] = passed_noise ? best_index : 0;
  confidence[i] = passed_noise ? conf : 0.0f;
  distance[i] = passed_noise ? dist : 0;
  argmax[i] = best_index;
  bool qc = qcfail_in[i] != 0 || !passed_noise || (passed_noise && !passed_conf);
  if (p.hqd_threshold > 0) {
    qc = qc || (passed_noise && passed_conf && hq_distance >= p.hqd_threshold);
  }
  qcfail_out[i] = qc ? 1 : 0;

  if (p.want_uncertain) {
    const float d_sigma = p.gamma_w * (2.0f * (float)qsum + p.term_w) + p.eps_w;
    const float rel_eps =
        p.safety * (((p.four_lam * d_sigma + p.gamma_b) + p.gamma_chunks) + p.eight_u);
    const float sigma_eps = p.safety * d_sigma + p.sigma_floor;
    bool u = post.second > post.best * (1.0f - rel_eps);
    if (p.has_ct) u = u || fabsf(conf - p.ct) < rel_eps * fmaxf(conf, p.ct) + p.four_u;
    if (p.has_rbp) u = u || fabsf(post.sigma_best - p.nst) < sigma_eps;
    u = u || fabsf(post.sigma_best - 3233.0f) < 1.0f;
    if (short_flags != nullptr) u = u || short_flags[(size_t)i * p.short_stride] != 0;
    uncertain[i] = u ? 1 : 0;
  }
}

// What a launch of the tile loop does: the whole classify over a panel of
// one slice (K1, and K7 where S = 1), or one of the two passes over S
// slices of the columns (K7, K8's shards), split at the pass boundary so
// that the slices' row minima, and in K8 the shards', are merged between
// them (pheniqs_tpu/device/classify.py:335-399).
#define PHQ_MODE_CLASSIFY 0
#define PHQ_MODE_SLICE_MIN 1
#define PHQ_MODE_SLICE_POSTERIOR 2

// sigma of a padding column in the reference's sharded posterior: an empty
// shard's row minimum
#define PHQ_BIG_SIGMA 3.0e38f
// the candidate index of a slice that does not hold the maximum
#define PHQ_BIG_INDEX 0x40000000

// Loads `count` barcode rows of W codes from `src` (global) into the tile:
// each row as MAXW / 4 words (the looped instance: phq_pamld_row_bytes(W)
// / 4; zero past W), the barcode's concentration when `conc` is given, and
// whether all its codes are A, C, G or T. Returns (to every thread)
// whether every barcode of the tile is.
template <int MAXW>
__device__ __forceinline__ bool phq_load_tile(const PhqPamldParams& p, const uint8_t* src,
                                              const float* conc, int count, uint4* s_rows,
                                              float* s_conc, uint8_t* s_strict) {
  constexpr int WORDS = PhqPamldShape<MAXW>::words;
  __syncthreads();  // every thread is done with the previous tile
  const bool aligned = (p.W & 3) == 0;
  bool all_strict = true;
  if constexpr (MAXW == PHQ_PAMLD_LOOPED) {
    const int row_words = phq_pamld_row_bytes(p.W) / 4;
    uint32_t* s_words = (uint32_t*)s_rows;
    for (int b = threadIdx.x; b < count; b += blockDim.x) {
      const uint8_t* row = src + (size_t)b * p.W;
      bool strict = true;
      for (int k = 0; k < row_words; ++k) {
        const uint32_t v = 4 * k < p.W ? phq_row_word(row, k, p.W, aligned) : 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * k + j < p.W) strict = strict && phq_strict((v >> (8 * j)) & 0xFFu);
        }
        s_words[(size_t)b * row_words + k] = v;
      }
      s_strict[b] = strict ? 1 : 0;
      all_strict = all_strict && strict;
      if (conc != nullptr) s_conc[b] = conc[b];
    }
    return __syncthreads_and(all_strict ? 1 : 0) != 0;
  }
  for (int b = threadIdx.x; b < count; b += blockDim.x) {
    const uint8_t* row = src + (size_t)b * p.W;
    uint32_t words[WORDS];
    bool strict = true;
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      uint32_t v = 0u;
      if (4 * k < p.W) {
        if (aligned) {
          v = *(const uint32_t*)(row + 4 * k);
        } else {
          for (int j = 0; j < 4 && 4 * k + j < p.W; ++j) v |= (uint32_t)row[4 * k + j] << (8 * j);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * k + j < p.W) strict = strict && phq_strict((v >> (8 * j)) & 0xFFu);
        }
      }
      words[k] = v;
    }
#pragma unroll
    for (int k = 0; k < WORDS / 4; ++k) {
      s_rows[b * (WORDS / 4) + k] =
          make_uint4(words[4 * k], words[4 * k + 1], words[4 * k + 2], words[4 * k + 3]);
    }
    s_strict[b] = strict ? 1 : 0;
    all_strict = all_strict && strict;
    if (conc != nullptr) s_conc[b] = conc[b];
  }
  return __syncthreads_and(all_strict ? 1 : 0) != 0;
}

// sigma of barcode b of the tile (rows of V 16-byte vectors) for read r
template <typename Read>
__device__ __forceinline__ float phq_sigma(const Read& r, const uint4* s_rows, int V,
                                           const uint8_t* s_strict, int b, const uint8_t* oq,
                                           const PhqPamldParams& p) {
  const uint4* e = s_rows + b * V;
  if (s_strict[b]) return phq_match(r, e, p.W) + r.c;
  return phq_sigma_mixed(r, (const uint8_t*)e, oq, p);
}

// What a launch of the tile loop writes for read i (nothing past the last
// read): stage A its slice's row minimum, stage B its slice's partials, the
// one-launch classify its decisions (phq_pamld_finish).
template <int MODE>
__device__ __forceinline__ void phq_pamld_store(const PhqPamldParams& p, const PhqPamldArgs& a, int i, float shift,
                                                const PhqPosterior& post, bool words) {
  if (i >= p.n) return;
  const size_t n = (size_t)p.n;
  if (MODE == PHQ_MODE_SLICE_MIN) {
    a.shift[blockIdx.y * n + i] = fminf(shift, PHQ_BIG_SIGMA);
  } else if (MODE == PHQ_MODE_SLICE_POSTERIOR) {
    int* out = a.partials + blockIdx.y * 5 * n;
    float* rows = (float*)out;
    rows[i] = post.total;
    rows[n + i] = post.best;
    out[2 * n + i] = a.base + post.best0;
    rows[3 * n + i] = post.second;
    rows[4 * n + i] = post.sigma_best;
  } else {
    // K2 reads the decoded barcode's row from device memory
    phq_pamld_finish(p, i, post, shift, a.panel + (size_t)post.best0 * p.W, a.obs_code + (size_t)i * p.ld_obs,
                     a.obs_qual + (size_t)i * p.ld_obs, words, a.qcfail_in, a.short_flags, a.decoded, a.argmax,
                     a.distance, a.branch, a.confidence, a.qcfail_out, a.uncertain);
  }
}

// One group of G barcodes of the wide tile loop, tile rows [b, b + G),
// global columns from `col`: their match terms for the R reads
// (phq_wide_match), then barcode by barcode in column order pass A's row
// minimum (PASS 0) or pass B's posterior (PASS 1). A barcode with codes
// other than A, C, G and T takes the interleaved sum.
template <int PASS, int R, int G>
__device__ __forceinline__ void phq_wide_group(const PhqReadLooped (&r)[R], const PhqPamldParams& p, const float* s_fm,
                                               const uint4* s_rows, int V, const uint8_t* s_strict,
                                               const float* s_conc, bool all_strict, int b, int col,
                                               const uint8_t* const (&oq)[R], const float (&shift)[R],
                                               float (&mmin)[R], float (&smin)[R], PhqPosterior (&post)[R]) {
  float m[R][G];
  phq_wide_match<R, G>(r, s_fm, s_rows + b * V, V, p.W, m);
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const bool strict = all_strict || s_strict[b + u] != 0;
    const uint8_t* e = (const uint8_t*)(s_rows + (b + u) * V);
    if (PASS == 0) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (strict) {
          mmin[k] = fminf(mmin[k], m[k][u]);
        } else {
          smin[k] = fminf(smin[k], phq_sigma_mixed(r[k], s_fm, e, oq[k], p));
        }
      }
    } else {
      const float conc = s_conc[b + u];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float s = strict ? m[k][u] + r[k].c : phq_sigma_mixed(r[k], s_fm, e, oq[k], p);
        post[k].add(expf(p.lam * (s - shift[k])) * conc, s, col + u);
      }
    }
  }
}

// One pass over `count` barcodes of the tile: groups of U, then the rest
// one at a time.
template <int PASS, int R, int U>
__device__ __forceinline__ void phq_wide_tile(const PhqReadLooped (&r)[R], const PhqPamldParams& p, const float* s_fm,
                                              const uint4* s_rows, int V, const uint8_t* s_strict,
                                              const float* s_conc, bool all_strict, int count, int t0,
                                              const uint8_t* const (&oq)[R], const float (&shift)[R],
                                              float (&mmin)[R], float (&smin)[R], PhqPosterior (&post)[R]) {
  int b = 0;
  for (; b + U <= count; b += U) {
    phq_wide_group<PASS, R, U>(r, p, s_fm, s_rows, V, s_strict, s_conc, all_strict, b, t0 + b, oq, shift, mmin,
                               smin, post);
  }
  for (; b < count; ++b) {
    phq_wide_group<PASS, R, 1>(r, p, s_fm, s_rows, V, s_strict, s_conc, all_strict, b, t0 + b, oq, shift, mmin,
                               smin, post);
  }
}

template <int MAXW, int MODE>
__device__ __forceinline__ void phq_pamld_body(PhqPamldParams p, PhqPamldArgs a, int tile_b, int cut,
                                               int shift_rows) {
  using Shape = PhqPamldShape<MAXW>;
  constexpr int R = Shape::reads;
  constexpr int U = Shape::unroll;
  // 16-byte vectors of a barcode row (and of the looped instance's read
  // state)
  const int V = Shape::looped ? phq_pamld_row_bytes(p.W) / 16 : Shape::words / 4;
  PHQ_DYNAMIC_SMEM(smem);
  float* s_tpq = (float*)smem;                                // 256 (fm with Shape::looped)
  float* s_conc = s_tpq + 256;                                // tile_b, rounded up to 4
  uint4* s_rows = (uint4*)(s_conc + ((tile_b + 3) & ~3));     // tile_b * V
  uint8_t* s_strict = (uint8_t*)(s_rows + (size_t)tile_b * V);  // tile_b
  __shared__ float s_consts[24];
  // every thread takes part in the tile loads; a read past the last one is
  // computed on the last read and writes nothing. Its bytes are fetched
  // first, in flight while the TPQ table is built.
  const size_t n = (size_t)p.n;
  const bool words = phq_words(p, a);
  int row[R];
  const uint8_t* row_qual[R];
  PhqRaw<MAXW> raw[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = (blockIdx.x * R + k) * PHQ_PAMLD_THREADS + threadIdx.x;
    row[k] = i < p.n ? i : p.n - 1;
    row_qual[k] = a.obs_qual + (size_t)row[k] * p.ld_obs;
    if constexpr (!Shape::looped) raw[k].fetch(p, a.obs_code + (size_t)row[k] * p.ld_obs, row_qual[k], words);
  }
  phq_tpq_table<Shape::looped>(s_tpq, s_consts, a.tpq_consts);
  __syncthreads();

  // this block's slice of the columns: cuts [s*C/S, (s+1)*C/S) of the
  // C = ceil(B/cut) runs of `cut` barcodes
  const int units = (p.B + cut - 1) / cut;
  const int col0 = (int)((long long)blockIdx.y * units / gridDim.y) * cut;
  const int col1 = min((int)((long long)(blockIdx.y + 1) * units / gridDim.y) * cut, p.B);

  typename std::conditional<Shape::looped, PhqReadLooped, PhqRead<MAXW>>::type r[R];
  float mmin[R], smin[R], shift[R];
  PhqPosterior post[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if constexpr (Shape::looped) {
      const uint4* state = (const uint4*)a.state;
      const float* tail = (const float*)(state + 2 * V * n);
      r[k].code = state + row[k];
      r[k].qual = state + V * n + row[k];
      r[k].n = n;
      r[k].c = tail[row[k]];
      r[k].qpos_u = tail[n + row[k]];
    } else {
      r[k].load(p, raw[k], s_tpq);
    }
    mmin[k] = INFINITY;
    smin[k] = INFINITY;
    shift[k] = INFINITY;
    if (MODE == PHQ_MODE_SLICE_POSTERIOR) {
      // the minimum over the slices' rows, exact in any order: loads kept
      // in flight together
#pragma unroll 4
      for (int s = 0; s < shift_rows; ++s) shift[k] = fminf(shift[k], a.shift[s * n + row[k]]);
    }
  }

  // a slice of one tile is loaded once, for both passes
  const bool resident = col1 - col0 <= tile_b;
  const int first_pass = MODE == PHQ_MODE_SLICE_POSTERIOR ? 1 : 0;
  const int last_pass = MODE == PHQ_MODE_SLICE_MIN ? 0 : 1;
  bool all_strict = false;
  for (int pass = first_pass; pass <= last_pass; ++pass) {
    for (int t0 = col0; t0 < col1; t0 += tile_b) {
      const int count = min(tile_b, col1 - t0);
      if (pass == first_pass || !resident) {
        const bool conc = pass == 1 || (resident && MODE == PHQ_MODE_CLASSIFY);
        all_strict = phq_load_tile<MAXW>(p, a.panel + (size_t)t0 * p.W,
                                         conc ? a.conc + t0 : nullptr, count, s_rows, s_conc,
                                         s_strict);
      }
      if constexpr (Shape::looped) {
        if (MODE != PHQ_MODE_SLICE_POSTERIOR && pass == 0) {
          phq_wide_tile<0, R, U>(r, p, s_tpq, s_rows, V, s_strict, s_conc, all_strict, count, t0, row_qual, shift,
                                 mmin, smin, post);
        } else if (MODE != PHQ_MODE_SLICE_MIN) {
          phq_wide_tile<1, R, U>(r, p, s_tpq, s_rows, V, s_strict, s_conc, all_strict, count, t0, row_qual, shift,
                                 mmin, smin, post);
        }
      } else {
        if (pass == 0) {
          if (all_strict) {
            int b = 0;
            for (; b + U <= count; b += U) {
#pragma unroll
              for (int u = 0; u < U; ++u) {
#pragma unroll
                for (int k = 0; k < R; ++k) {
                  mmin[k] = fminf(mmin[k], phq_match(r[k], s_rows + (b + u) * V, p.W));
                }
              }
            }
            for (; b < count; ++b) {
#pragma unroll
              for (int k = 0; k < R; ++k) {
                mmin[k] = fminf(mmin[k], phq_match(r[k], s_rows + b * V, p.W));
              }
            }
          } else {
            for (int b = 0; b < count; ++b) {
              const uint4* e = s_rows + b * V;
              if (s_strict[b]) {
#pragma unroll
                for (int k = 0; k < R; ++k) mmin[k] = fminf(mmin[k], phq_match(r[k], e, p.W));
              } else {
#pragma unroll
                for (int k = 0; k < R; ++k) {
                  const uint8_t* oq = a.obs_qual + (size_t)row[k] * p.ld_obs;
                  smin[k] = fminf(smin[k], phq_sigma_mixed(r[k], (const uint8_t*)e, oq, p));
                }
              }
            }
          }
        } else {
          int b = 0;
          if (all_strict) {
            for (; b + U <= count; b += U) {
#pragma unroll
              for (int u = 0; u < U; ++u) {
                const float conc = s_conc[b + u];
#pragma unroll
                for (int k = 0; k < R; ++k) {
                  const float s = phq_match(r[k], s_rows + (b + u) * V, p.W) + r[k].c;
                  post[k].add(expf(p.lam * (s - shift[k])) * conc, s, t0 + b + u);
                }
              }
            }
          }
          for (; b < count; ++b) {
            const float conc = s_conc[b];
#pragma unroll
            for (int k = 0; k < R; ++k) {
              const uint8_t* oq = a.obs_qual + (size_t)row[k] * p.ld_obs;
              const float s = phq_sigma(r[k], s_rows, V, s_strict, b, oq, p);
              post[k].add(expf(p.lam * (s - shift[k])) * conc, s, t0 + b);
            }
          }
        }
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int k = 0; k < R; ++k) shift[k] = fminf(mmin[k] + r[k].c, smin[k]);
    }
  }

#pragma unroll
  for (int k = 0; k < R; ++k) {
    phq_pamld_store<MODE>(p, a, (blockIdx.x * R + k) * PHQ_PAMLD_THREADS + threadIdx.x, shift[k], post[k], words);
  }
}

template <int MAXW, int MODE>
__global__ void __launch_bounds__(PHQ_PAMLD_THREADS) phq_pamld_kernel(
    PhqPamldParams p, PhqPamldArgs a, int tile_b, int cut, int shift_rows) {
  phq_pamld_body<MAXW, MODE>(p, a, tile_b, cut, shift_rows);
}

// The looped instance, with the resident blocks asked of the compiler (a
// second bound on the register instances would move their register
// allocation: 125 -> 136 at MAXW 16).
template <int MODE>
__global__ void __launch_bounds__(PHQ_PAMLD_THREADS, PHQ_PAMLD_WIDE_BLOCKS) phq_pamld_wide_kernel(
    PhqPamldParams p, PhqPamldArgs a, int tile_b, int cut, int shift_rows) {
  phq_pamld_body<PHQ_PAMLD_LOOPED, MODE>(p, a, tile_b, cut, shift_rows);
}

// the kernel of an instance
typedef void (*PhqPamldKernel)(PhqPamldParams, PhqPamldArgs, int, int, int);

template <int MAXW, int MODE>
static PhqPamldKernel phq_pamld_kernel_of() {
  if constexpr (MAXW == PHQ_PAMLD_LOOPED) {
    return phq_pamld_wide_kernel<MODE>;
  } else {
    return phq_pamld_kernel<MAXW, MODE>;
  }
}

// Stage C: per read, the `slices` blocks of partials merged in slice order
// (device/tp.py:reduce_partials), in the frame of the minimum over the
// `shift_rows` rows of `shift`; then, with `finish`, everything after the
// posterior (phq_pamld_finish, `a.panel` the whole panel for K2's row),
// else the merged five rows to `merged` (K8's shard, before the merge
// across ranks).
__global__ void __launch_bounds__(PHQ_PAMLD_THREADS) phq_pamld_merge_kernel(
    PhqPamldParams p, PhqPamldArgs a, int slices, int shift_rows, int finish) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const size_t n = (size_t)p.n;
  const float* rows = (const float*)a.partials;
  const size_t block = 5 * n;
  PhqPosterior post;
  post.best = rows[n + i];
  for (int s = 1; s < slices; ++s) post.best = fmaxf(post.best, rows[s * block + n + i]);
  post.best0 = PHQ_BIG_INDEX;
  for (int s = 0; s < slices; ++s) {
    if (rows[s * block + n + i] >= post.best) post.best0 = min(post.best0, a.partials[s * block + 2 * n + i]);
  }
  post.total = rows[i];
  post.sigma_best = PHQ_BIG_SIGMA;
  post.second = -INFINITY;
  for (int s = 0; s < slices; ++s) {
    if (s > 0) post.total = post.total + rows[s * block + i];
    const bool holder = a.partials[s * block + 2 * n + i] == post.best0;
    if (holder) post.sigma_best = fminf(post.sigma_best, rows[s * block + 4 * n + i]);
    post.second = fmaxf(post.second, holder ? rows[s * block + 3 * n + i] : rows[s * block + n + i]);
  }
  if (!finish) {
    float* out = (float*)a.merged;
    out[i] = post.total;
    out[n + i] = post.best;
    a.merged[2 * n + i] = post.best0;
    out[3 * n + i] = post.second;
    out[4 * n + i] = post.sigma_best;
    return;
  }
  float shift = INFINITY;
  for (int s = 0; s < shift_rows; ++s) shift = fminf(shift, a.shift[s * n + i]);
  phq_pamld_finish(p, i, post, shift, a.panel + (size_t)post.best0 * p.W,
                   a.obs_code + (size_t)i * p.ld_obs, a.obs_qual + (size_t)i * p.ld_obs, phq_words(p, a),
                   a.qcfail_in, a.short_flags, a.decoded, a.argmax, a.distance, a.branch,
                   a.confidence, a.qcfail_out, a.uncertain);
}

// dynamic shared memory of a tile of `tile_b` barcode rows of `row_bytes`
static size_t phq_pamld_smem(int row_bytes, int tile_b) {
  return 256 * sizeof(float) + (size_t)((tile_b + 3) & ~3) * sizeof(float) +
         (size_t)tile_b * row_bytes + (size_t)tile_b;
}

// the most dynamic shared memory a block may take on the H100 (by opt-in)
#define PHQ_PAMLD_SMEM_MAX (227 * 1024)

// bytes of a barcode row in the tile, and barcodes a whole tile holds, of
// the instance at observation width W
template <int MAXW>
static int phq_pamld_tile_row(int W) {
  return MAXW != PHQ_PAMLD_LOOPED ? MAXW : phq_pamld_row_bytes(W);
}

template <int MAXW>
static int phq_pamld_tile_b(int W) {
  if (MAXW != PHQ_PAMLD_LOOPED) return PhqPamldShape<MAXW>::tile_b;
  // whole groups of the barcode loop where the tile holds one
  constexpr int unroll = PhqPamldShape<MAXW>::unroll;
  const int tile_b = PHQ_PAMLD_TILE_BYTES / phq_pamld_tile_row<MAXW>(W);
  return tile_b >= unroll ? tile_b - tile_b % unroll : tile_b > 0 ? tile_b : 1;
}

template <int MAXW, int MODE>
static int phq_pamld_launch(const PhqPamldParams& p, const PhqPamldArgs& a, int slices, int cut,
                            int shift_rows, cudaStream_t stream) {
  using Shape = PhqPamldShape<MAXW>;
  // the tile holds at most the widest slice: a panel of one tile, or a
  // slice of it, is loaded once
  const int units = (p.B + cut - 1) / cut;
  const long long widest = (long long)((units + slices - 1) / slices) * cut;
  int tile_b = phq_pamld_tile_b<MAXW>(p.W);
  if (widest < tile_b) tile_b = widest > 0 ? (int)widest : 1;
  const size_t smem = phq_pamld_smem(phq_pamld_tile_row<MAXW>(p.W), tile_b);
  // one name for the instance: a template argument list's comma would
  // split the launch macro's arguments
  const PhqPamldKernel kernel = phq_pamld_kernel_of<MAXW, MODE>();
  if (MAXW == PHQ_PAMLD_LOOPED && a.state == nullptr) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    // only the looped instance's tile of one row past ~47,000 positions
    if (MAXW != PHQ_PAMLD_LOOPED || smem > PHQ_PAMLD_SMEM_MAX) return (int)cudaErrorInvalidValue;
    const cudaError_t status =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (status != cudaSuccess) return (int)status;
  }
  const int per_block = PHQ_PAMLD_THREADS * Shape::reads;
  const dim3 grid((p.n + per_block - 1) / per_block, slices);
  PHQ_LAUNCH(kernel, grid, PHQ_PAMLD_THREADS, smem, stream)(p, a, tile_b, cut, shift_rows);
  return (int)cudaGetLastError();
}

template <int MODE>
static int phq_pamld_dispatch(const PhqPamldParams& p, const PhqPamldArgs& a, int slices, int cut,
                              int shift_rows, cudaStream_t s) {
  if (p.n <= 0) return (int)cudaGetLastError();
  if (slices < 1 || cut < 1 || (MODE == PHQ_MODE_CLASSIFY && slices != 1)) return (int)cudaErrorInvalidValue;
  // every slice holds at least one cut: an empty slice's partials would
  // name a column it does not hold
  if (p.B > 0 && slices > (p.B + cut - 1) / cut) return (int)cudaErrorInvalidValue;
  if (p.W <= 16) return phq_pamld_launch<16, MODE>(p, a, slices, cut, shift_rows, s);
  if (p.W <= 32) return phq_pamld_launch<32, MODE>(p, a, slices, cut, shift_rows, s);
  if (p.W <= 64) return phq_pamld_launch<64, MODE>(p, a, slices, cut, shift_rows, s);
  return phq_pamld_launch<PHQ_PAMLD_LOOPED, MODE>(p, a, slices, cut, shift_rows, s);
}

// The looped instance's read state of a batch (W > 64), written once
// before its launches (PhqReadLooped): `state` holds (8 * ceil(W/16) + 2) * n
// 32-bit words, 16-byte aligned.
PHQ_EXPORT int phq_pamld_state(const int* ints, const float* floats, const void* obs_code,
                               const void* obs_qual, void* state, void* stream) {
  const PhqPamldParams p = phq_pamld_params(ints, floats);
  if (p.n <= 0) return (int)cudaGetLastError();
  if (p.W <= 64 || ((uintptr_t)state & 15) != 0) return (int)cudaErrorInvalidValue;
  PhqPamldArgs a = {};
  a.obs_code = (const uint8_t*)obs_code;
  a.obs_qual = (const uint8_t*)obs_qual;
  const int blocks = (p.n + PHQ_PAMLD_THREADS - 1) / PHQ_PAMLD_THREADS;
  PHQ_LAUNCH(phq_pamld_state_kernel, blocks, PHQ_PAMLD_THREADS, 0, (cudaStream_t)stream)(
      p, a.obs_code, a.obs_qual, phq_words(p, a) ? 1 : 0, (uint4*)state);
  return (int)cudaGetLastError();
}

// K1, and K7 over one slice: ints and floats as phq_pamld_params reads them;
// `state` the looped instance's (phq_pamld_state), else null
PHQ_EXPORT int phq_pamld(
    const int* ints, const float* floats, const void* obs_code,
    const void* obs_qual, const void* qcfail_in, const void* short_flags,
    const void* panel, const void* conc, const void* tpq_consts, const void* state, void* decoded,
    void* argmax, void* distance, void* branch, void* confidence,
    void* qcfail_out, void* uncertain, void* stream) {
  const PhqPamldParams p = phq_pamld_params(ints, floats);
  PhqPamldArgs a = {};
  a.state = (const uint32_t*)state;
  a.obs_code = (const uint8_t*)obs_code;
  a.obs_qual = (const uint8_t*)obs_qual;
  a.qcfail_in = (const uint8_t*)qcfail_in;
  a.short_flags = (const uint8_t*)short_flags;
  a.panel = (const uint8_t*)panel;
  a.conc = (const float*)conc;
  a.tpq_consts = (const float*)tpq_consts;
  a.decoded = (int*)decoded;
  a.argmax = (int*)argmax;
  a.distance = (int*)distance;
  a.branch = (int8_t*)branch;
  a.confidence = (float*)confidence;
  a.qcfail_out = (uint8_t*)qcfail_out;
  a.uncertain = (uint8_t*)uncertain;
  return phq_pamld_dispatch<PHQ_MODE_CLASSIFY>(p, a, 1, p.B > 0 ? p.B : 1, 0, (cudaStream_t)stream);
}

// Stages A (mode PHQ_MODE_SLICE_MIN: writes `slices` rows of `shift`) and B
// (PHQ_MODE_SLICE_POSTERIOR: reads `shift_rows` rows of `shift`, writes
// `slices` blocks of `partials`) over the columns of `panel` and `conc`:
// ints[1] is their count, `base` the global index of the first (K8's shard),
// the slices cut at multiples of `cut` barcodes; `state` as phq_pamld's.
PHQ_EXPORT int phq_pamld_slices(
    const int* ints, const float* floats, int mode, int base, int slices, int cut, int shift_rows,
    const void* obs_code, const void* obs_qual, const void* panel,
    const void* conc, const void* tpq_consts, const void* state, void* shift, void* partials,
    void* stream) {
  const PhqPamldParams p = phq_pamld_params(ints, floats);
  PhqPamldArgs a = {};
  a.state = (const uint32_t*)state;
  a.obs_code = (const uint8_t*)obs_code;
  a.obs_qual = (const uint8_t*)obs_qual;
  a.panel = (const uint8_t*)panel;
  a.conc = (const float*)conc;
  a.tpq_consts = (const float*)tpq_consts;
  a.shift = (float*)shift;
  a.partials = (int*)partials;
  a.base = base;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == PHQ_MODE_SLICE_MIN) return phq_pamld_dispatch<PHQ_MODE_SLICE_MIN>(p, a, slices, cut, 0, s);
  if (mode == PHQ_MODE_SLICE_POSTERIOR) {
    return phq_pamld_dispatch<PHQ_MODE_SLICE_POSTERIOR>(p, a, slices, cut, shift_rows, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Stage C: `slices` blocks of `partials` merged in slice order in the frame
// of the minimum of `shift_rows` rows of `shift`; with `finish` the
// decisions (`panel` the whole (B, W) panel), else the five merged rows to
// `merged`.
PHQ_EXPORT int phq_pamld_merge(
    const int* ints, const float* floats, int slices, int shift_rows, int finish,
    const void* obs_code, const void* obs_qual, const void* qcfail_in, const void* short_flags,
    const void* panel, const void* shift, const void* partials, void* merged,
    void* decoded, void* argmax, void* distance, void* branch, void* confidence,
    void* qcfail_out, void* uncertain, void* stream) {
  const PhqPamldParams p = phq_pamld_params(ints, floats);
  if (p.n <= 0) return (int)cudaGetLastError();
  if (slices < 1 || (finish && shift_rows < 1)) return (int)cudaErrorInvalidValue;
  PhqPamldArgs a = {};
  a.obs_code = (const uint8_t*)obs_code;
  a.obs_qual = (const uint8_t*)obs_qual;
  a.qcfail_in = (const uint8_t*)qcfail_in;
  a.short_flags = (const uint8_t*)short_flags;
  a.panel = (const uint8_t*)panel;
  a.shift = (float*)shift;
  a.partials = (int*)partials;
  a.merged = (int*)merged;
  a.decoded = (int*)decoded;
  a.argmax = (int*)argmax;
  a.distance = (int*)distance;
  a.branch = (int8_t*)branch;
  a.confidence = (float*)confidence;
  a.qcfail_out = (uint8_t*)qcfail_out;
  a.uncertain = (uint8_t*)uncertain;
  const int blocks = (p.n + PHQ_PAMLD_THREADS - 1) / PHQ_PAMLD_THREADS;
  PHQ_LAUNCH(phq_pamld_merge_kernel, blocks, PHQ_PAMLD_THREADS, 0, (cudaStream_t)stream)(
      p, a, slices, shift_rows, finish);
  return (int)cudaGetLastError();
}

// registers, local (spill) bytes and resident blocks per SM of one
// instance at observation width W
template <int MAXW, int MODE>
static int phq_pamld_instance(int W, int* out) {
  const PhqPamldKernel kernel = phq_pamld_kernel_of<MAXW, MODE>();
  cudaFuncAttributes attributes;
  cudaError_t status = cudaFuncGetAttributes(&attributes, kernel);
  if (status != cudaSuccess) return (int)status;
  const size_t smem = phq_pamld_smem(phq_pamld_tile_row<MAXW>(W), phq_pamld_tile_b<MAXW>(W));
  if (smem > 48 * 1024) {
    status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (status != cudaSuccess) return (int)status;
  }
  int blocks = 0;
  status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, PHQ_PAMLD_THREADS, smem);
  if (status != cudaSuccess) return (int)status;
  out[0] = blocks;
  out[1] = attributes.numRegs;
  out[2] = (int)attributes.localSizeBytes;
  return 0;
}

template <int MAXW>
static int phq_pamld_info_for(int W, int* out) {
  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status == cudaSuccess) {
    status = cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, device);
  }
  if (status != cudaSuccess) return (int)status;
  out[0] = phq_pamld_tile_b<MAXW>(W);
  out[1] = PHQ_PAMLD_THREADS;
  out[2] = PHQ_PAMLD_THREADS * PhqPamldShape<MAXW>::reads;
  out[4] = MAXW;
  out[14] = PhqPamldShape<MAXW>::unroll;
  out[15] = PHQ_PAMLD_SLICE_UNIT;
  int rc = phq_pamld_instance<MAXW, PHQ_MODE_CLASSIFY>(W, out + 5);
  if (rc == 0) rc = phq_pamld_instance<MAXW, PHQ_MODE_SLICE_MIN>(W, out + 8);
  if (rc == 0) rc = phq_pamld_instance<MAXW, PHQ_MODE_SLICE_POSTERIOR>(W, out + 11);
  return rc;
}

// What the slice plan needs to know of the tile loop at observation width
// W, in `out` (16 ints): barcodes a tile holds, threads and reads a block,
// the card's SM count, the instance's MAXW (0: the looped instance, W >
// 128), then for the classify, stage A and stage B instances each
// (resident blocks per SM, registers, local bytes a thread), the barcodes
// a step of the barcode loop takes, and the least barcodes of a slice cut
// below a tile.
PHQ_EXPORT int phq_pamld_info(int W, void* out) {
  int* o = (int*)out;
  if (W <= 16) return phq_pamld_info_for<16>(W, o);
  if (W <= 32) return phq_pamld_info_for<32>(W, o);
  if (W <= 64) return phq_pamld_info_for<64>(W, o);
  return phq_pamld_info_for<PHQ_PAMLD_LOOPED>(W, o);
}

// K1's read features, written out: F (N, 5W) f32 with, per position, the
// match channels onehot4(o) * (tpq - q) for A, C, G, T and the strictness
// channel strict(o) * (q - U), gated on q > 0 — the same f32 operations as
// kernels/pamld.py:observation_features_plain (a product by 0 or 1, so even
// the sign of a zero agrees). K1 keeps these terms in registers and never
// writes them; this entry serves classify.observation_features on CUDA.
// One thread per (read, position); memory bound, 20 B written per position.
__global__ void phq_features_kernel(const uint8_t* __restrict__ obs_code,
                                    const uint8_t* __restrict__ obs_qual,
                                    int n, int W, int ld_obs, float U,
                                    const float* __restrict__ tpq_consts,
                                    float* __restrict__ out) {
  __shared__ float s_consts[24];
  if (threadIdx.x < 24) s_consts[threadIdx.x] = tpq_consts[threadIdx.x];
  __syncthreads();
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * W) return;
  const int i = (int)(t / W);
  const int w = (int)(t - (long long)i * W);
  const int c = obs_code[(size_t)i * ld_obs + w];
  const int q = obs_qual[(size_t)i * ld_obs + w];
  const bool positive = q > 0;
  const float qf = (float)q;
  const float match = phq_analytic_tpq(q, s_consts) - qf;
  float* f = out + (size_t)t * 5;
  f[0] = ((c == 1 && positive) ? 1.0f : 0.0f) * match;
  f[1] = ((c == 2 && positive) ? 1.0f : 0.0f) * match;
  f[2] = ((c == 4 && positive) ? 1.0f : 0.0f) * match;
  f[3] = ((c == 8 && positive) ? 1.0f : 0.0f) * match;
  const bool strict = (c == 1 || c == 2 || c == 4 || c == 8) && positive;
  f[4] = (strict ? 1.0f : 0.0f) * (qf - U);
}

PHQ_EXPORT int phq_features(const void* obs_code, const void* obs_qual, int n,
                            int W, int ld_obs, float U, const void* tpq_consts,
                            void* out, void* stream) {
  const long long total = (long long)n * W;
  if (total > 0) {
    const int threads = 256;
    PHQ_LAUNCH(phq_features_kernel, (int)((total + threads - 1) / threads),
               threads, 0, (cudaStream_t)stream)(
        (const uint8_t*)obs_code, (const uint8_t*)obs_qual, n, W, ld_obs, U,
        (const float*)tpq_consts, (float*)out);
  }
  return (int)cudaGetLastError();
}

__global__ void phq_tpq_kernel(const int* __restrict__ q, int n,
                               const float* __restrict__ tpq_consts,
                               float* __restrict__ out) {
  __shared__ float s_consts[24];
  if (threadIdx.x < 24) s_consts[threadIdx.x] = tpq_consts[threadIdx.x];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = phq_analytic_tpq(q[i], s_consts);
}

// The analytic TPQ of K1 on `n` quality values: the port measures its
// hybrid-bound epsilon through this entry (instrument.analytic_tpq_epsilon).
PHQ_EXPORT int phq_tpq_eval(const void* q, int n, const void* tpq_consts,
                            void* out, void* stream) {
  if (n > 0) {
    const int threads = 128;
    PHQ_LAUNCH(phq_tpq_kernel, (n + threads - 1) / threads, threads, 0,
               (cudaStream_t)stream)((const int*)q, n, (const float*)tpq_consts,
                                     (float*)out);
  }
  return (int)cudaGetLastError();
}
