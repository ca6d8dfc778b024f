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
// Bound on the H100: bytes (~20 B a read in, 4 B a counter out; ~0.002 ms
// on the flagship, ~0.008 ms over the whitelist's 737,281 bins), and below
// that, latency. The TPU's one-hot contraction would need an (N, B+1)
// one-hot; float atomics would make the sums depend on scheduling.
// Design: every column is summed in integers, so the order of the adds
// does not matter and any schedule gives the same bytes.
//  - Six columns hold integers (count, pf count, distance, pf distance, low
//    confidence, noise): 32-bit integer atomics, converted to f32 once
//    (exact while a bin stays below 2^24; kernels/counters.py:check_limits).
//  - The two confidence columns sum q = rint(c * 2^40) in 64-bit integers
//    (c * 2^40 is exact in f32), converted once as float(sum) * 2^-40: the
//    exact sum of the quantised terms, rounded once, within N * 2^-41 + 1/2
//    ulp of the true sum (N * 2^40 < 2^63: check_limits).
//  - One accumulate launch for every decoder (grid.y = decoder, a row of
//    the decoder table each) over a grid-stride share of the reads. A
//    decoder whose histogram fits the table's limit adds into shared
//    memory with shared atomics, which take clashing keys cheaply (a naive
//    decoder's single bin gets every row), then adds the block's nonzero
//    bins into the global sums. A larger panel adds straight into global
//    atomics; there the lanes of a warp with the same key are summed first
//    (__match_any_sync + __reduce_add_sync), one atomic per key a warp, as
//    a global atomic on a clashing key (bin 0, unclassified) serialises.
//  - The integer sums live in the output buffer itself, which the finalize
//    launch converts to f32 in place; the fixed-point sums, 16 B a bin of
//    a PAMLD decoder, sit in front of it. One memset zeroes both.
#include "common.cuh"

#define PHQ_COUNTER_THREADS 256
#define PHQ_COUNTER_READS_PER_BLOCK 512
#define PHQ_COUNTER_MAX_BLOCKS 4096
// The most dynamic shared memory a block may take on the H100. Which
// decoders use a shared histogram is the table's (kernels/counters.py:
// SHARED_LIMIT, 192 KiB: one PAMLD decoder of B barcodes at N = 131072,
// shared against global atomics, chip_smoke.py:k4_threshold_sweep on an
// H100 80GB HBM3 at 700 W: B = 3072 0.0325 / 0.0400 ms, B = 4096 0.0399 /
// 0.0399 ms, B = 4800 0.0448 / 0.0402 ms; the histogram's zeroing and
// flush in every block outgrow the atomics they save).
#define PHQ_COUNTER_SHARED_MAX (227 * 1024)

// One row of the decoder table (kernels/counters.py:decoder_table).
#define PHQ_COUNTER_FIELDS 6
#define PHQ_T_OFFSET 0  // the decoder's first counter in the flat layout
#define PHQ_T_B1 1      // bins: barcodes + 1 (bin 0 = unclassified)
#define PHQ_T_KIND 2    // 0 count + pf count, 1 + distances, 2 + confidences and filters
#define PHQ_T_COLS 3    // its columns in the layout (2, 4 or 8)
#define PHQ_T_WIDE 4    // its first fixed-point confidence sum, -1 unless kind 2
#define PHQ_T_SHARED 5  // bytes of its shared-memory histogram, 0 = global atomics

#define PHQ_CONF_SCALE 1099511627776.0f  // 2^40
#define PHQ_CONF_UNSCALE (1.0f / 1099511627776.0f)

// With `aggregate` (the same in every lane of the warp): the lanes of this
// warp whose key equals this lane's; else this lane alone.
__device__ __forceinline__ unsigned phq_peers(bool aggregate, int key) {
  return aggregate ? __match_any_sync(0xffffffffu, key) : 1u << (threadIdx.x & 31);
}

__device__ __forceinline__ unsigned phq_group_sum(bool aggregate, unsigned peers, unsigned v) {
  return aggregate ? __reduce_add_sync(peers, v) : v;
}

// Exact sum over the lanes of `peers` of 64-bit values below 2^63: three
// pieces of 22 bits, each summed over at most 32 lanes without overflow.
__device__ __forceinline__ unsigned long long phq_group_sum64(bool aggregate, unsigned peers,
                                                              unsigned long long v) {
  if (!aggregate) return v;
  const unsigned lo = __reduce_add_sync(peers, (unsigned)(v & 0x3fffffull));
  const unsigned mid = __reduce_add_sync(peers, (unsigned)((v >> 22) & 0x3fffffull));
  const unsigned hi = __reduce_add_sync(peers, (unsigned)(v >> 44));
  return (unsigned long long)lo + ((unsigned long long)mid << 22) + ((unsigned long long)hi << 44);
}

__global__ void __launch_bounds__(PHQ_COUNTER_THREADS) phq_counters_accumulate(
    int n, const int* __restrict__ table, const int* __restrict__ decoded,
    const int* __restrict__ argmax, const int* __restrict__ distance,
    const int8_t* __restrict__ branch, const float* __restrict__ confidence,
    const uint8_t* __restrict__ qcfail, const uint8_t* __restrict__ pad,
    const uint8_t* __restrict__ forced, const uint8_t* __restrict__ uncertain,
    const unsigned* __restrict__ uncertain_mask, int n_decoders, unsigned* __restrict__ acc,
    unsigned long long* __restrict__ wide) {
  PHQ_DYNAMIC_SMEM(smem);
  const int d = blockIdx.y;
  const int* entry = table + d * PHQ_COUNTER_FIELDS;
  const int b1 = entry[PHQ_T_B1];
  const int kind = entry[PHQ_T_KIND];
  const int cols = entry[PHQ_T_COLS];
  const bool shared = entry[PHQ_T_SHARED] > 0;
  // shared atomics take clashing keys cheaply (every row in one bin
  // included); global ones are summed over the warp's equal keys first
  const bool aggregate = !shared;
  const int wide_bins = kind == 2 ? 2 * b1 : 0;
  // shared histogram: the fixed-point sums first (8-byte aligned), then
  // the integer columns in the layout's order (the confidence slots unused)
  unsigned long long* s_wide = reinterpret_cast<unsigned long long*>(smem);
  unsigned* s_acc = reinterpret_cast<unsigned*>(smem + (size_t)wide_bins * 8);
  if (shared) {
    for (int j = threadIdx.x; j < wide_bins; j += blockDim.x) s_wide[j] = 0ull;
    for (int j = threadIdx.x; j < cols * b1; j += blockDim.x) s_acc[j] = 0u;
    __syncthreads();
  }
  unsigned* hist = shared ? s_acc : acc + entry[PHQ_T_OFFSET];
  unsigned long long* hist_wide = shared ? s_wide : wide + (kind == 2 ? entry[PHQ_T_WIDE] : 0);

  const size_t row = (size_t)d * n;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x / 32;
  const int stride = gridDim.x * warps * 32;
  // warp-uniform loop: every lane of a warp runs every iteration, so the
  // full-warp match and reductions below are legal
  for (int base = (blockIdx.x * warps + threadIdx.x / 32) * 32; base < n; base += stride) {
    const int i = base + lane;
    int key = -1;   // decoded index, -1 = adds nothing
    int key2 = -1;  // argmax, -1 = adds nothing
    unsigned pf_count = 0, dist = 0, pf_dist = 0, low = 0, noise = 0;
    unsigned long long conf = 0ull, pf_conf = 0ull;
    if (i < n) {
      // every load first, none behind another's value: one latency a row
      unsigned unsure = forced != nullptr ? forced[i] : 0u;
      if (uncertain_mask != nullptr) {
        for (int k = 0; k < n_decoders; ++k) {
          if ((uncertain_mask[k >> 5] >> (k & 31)) & 1u) unsure |= uncertain[(size_t)k * n + i];
        }
      }
      const unsigned padded = pad[i];
      const unsigned pf = qcfail[row + i] ? 0u : 1u;
      // a naive or passthrough row decides nothing: its one bin is 0
      const int decoded_i = kind >= 1 ? decoded[row + i] : 0;
      const int distance_i = kind >= 1 ? distance[row + i] : 0;
      const int branch_i = kind == 2 ? (int)branch[row + i] : -1;
      const float c = kind == 2 ? confidence[row + i] : 0.0f;
      const int argmax_i = kind == 2 ? argmax[row + i] : -1;
      if (padded == 0 && unsure == 0) {
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
          key2 = argmax_i;
          low = branch_i == 1 ? 1u : 0u;
          noise = branch_i == 2 ? 1u : 0u;
        }
      }
    }
    const unsigned peers = phq_peers(aggregate, key);
    const bool leader = lane == __ffs(peers) - 1;
    const unsigned g_pf = phq_group_sum(aggregate, peers, pf_count);
    unsigned g_dist = 0, g_pf_dist = 0;
    if (kind >= 1) {
      g_dist = phq_group_sum(aggregate, peers, dist);
      g_pf_dist = phq_group_sum(aggregate, peers, pf_dist);
    }
    unsigned long long g_conf = 0ull, g_pf_conf = 0ull;
    if (kind == 2) {
      g_conf = phq_group_sum64(aggregate, peers, conf);
      g_pf_conf = phq_group_sum64(aggregate, peers, pf_conf);
    }
    if (leader && key >= 0) {
      atomicAdd(hist + key, (unsigned)__popc(peers));
      if (g_pf) atomicAdd(hist + b1 + key, g_pf);
      if (g_dist) atomicAdd(hist + 2 * b1 + key, g_dist);
      if (g_pf_dist) atomicAdd(hist + 3 * b1 + key, g_pf_dist);
      if (g_conf) atomicAdd(hist_wide + key, g_conf);
      if (g_pf_conf) atomicAdd(hist_wide + b1 + key, g_pf_conf);
    }
    if (kind == 2) {
      const unsigned peers2 = phq_peers(aggregate, key2);
      const unsigned g_low = phq_group_sum(aggregate, peers2, low);
      const unsigned g_noise = phq_group_sum(aggregate, peers2, noise);
      if (key2 >= 0 && lane == __ffs(peers2) - 1) {
        if (g_low) atomicAdd(hist + 6 * b1 + key2, g_low);
        if (g_noise) atomicAdd(hist + 7 * b1 + key2, g_noise);
      }
    }
  }
  if (shared) {
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
}

// In place: counter t of the flat layout, an integer in acc[t] (the same
// 4 bytes as out[t]) or, in a confidence column, a fixed-point sum in wide.
__global__ void phq_counters_finalize(int total, int n_decoders, const int* __restrict__ table,
                                      const unsigned* acc,
                                      const unsigned long long* __restrict__ wide, float* out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  int d = 0;
  while (d + 1 < n_decoders && table[(d + 1) * PHQ_COUNTER_FIELDS + PHQ_T_OFFSET] <= t) ++d;
  const int* entry = table + d * PHQ_COUNTER_FIELDS;
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
// `table` is n_decoders rows of PHQ_COUNTER_FIELDS ints on the device;
// `shared_bytes` is the largest shared histogram among them;
// `uncertain_mask` the decoders whose uncertain row counts, bit k & 31 of
// word k >> 5 of a device array (null for none: a fast run).
PHQ_EXPORT int phq_counters(
    int n, int n_decoders, int total, int wide_total, int shared_bytes, const void* table,
    const void* decoded, const void* argmax, const void* distance, const void* branch,
    const void* confidence, const void* qcfail, const void* pad, const void* forced,
    const void* uncertain, const void* uncertain_mask, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (shared_bytes > PHQ_COUNTER_SHARED_MAX) return (int)cudaErrorInvalidValue;
  unsigned long long* wide = (unsigned long long*)scratch;
  unsigned* acc = (unsigned*)(wide + wide_total);
  cudaError_t status = cudaMemsetAsync(scratch, 0, (size_t)wide_total * 8 + (size_t)total * 4, s);
  if (status != cudaSuccess) return (int)status;
  int blocks = (n + PHQ_COUNTER_READS_PER_BLOCK - 1) / PHQ_COUNTER_READS_PER_BLOCK;
  if (blocks > PHQ_COUNTER_MAX_BLOCKS) blocks = PHQ_COUNTER_MAX_BLOCKS;
  if (blocks > 0) {
    if (shared_bytes > 48 * 1024) {
      status = cudaFuncSetAttribute(phq_counters_accumulate,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
      if (status != cudaSuccess) return (int)status;
    }
    PHQ_LAUNCH(phq_counters_accumulate, dim3(blocks, n_decoders), PHQ_COUNTER_THREADS, shared_bytes, s)(
        n, (const int*)table, (const int*)decoded, (const int*)argmax, (const int*)distance,
        (const int8_t*)branch, (const float*)confidence, (const uint8_t*)qcfail,
        (const uint8_t*)pad, (const uint8_t*)forced, (const uint8_t*)uncertain,
        (const unsigned*)uncertain_mask, n_decoders, acc, wide);
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
