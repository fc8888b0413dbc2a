// K22 radix_sort — a stable LSD radix sort of int64 keys in signed order,
// alone or with a payload: an int32 value a key, or the key's index (0..n-1,
// or idx[i], below 2**31) as int64. The keys come from an int64 array, or in
// the first pass straight from (N, W) u32 rows: the row's top 64 bits, words
// W-1 and W-2 (word 0 alone at W = 1), sign-flipped (ops/count.py
// _top_keys), so that no elementwise pass builds them.
//
// Replaces the sorts in the bodies of the reference's count programs:
// lax.sort in leon_tpu/ops/count.py _sort_count_device / _fused_sort_count
// (60, 64, 194-207) and in _merge_sorted_runs (233, the counts as its
// payload), which the port first ran as torch.sort: DeviceCounter's slab,
// the WordCounter's top sorts (sort_slab; sort_rows, which no counter calls
// since K23 below merges the runs), count_batch's top_sort and _tie_rounds
// (ops/count.py).
//
// Bound on the H100: device-memory bytes. A pass reads each key (and
// payload) once and writes it once; the sort runs one pass for each 8-bit
// digit of the low bits in which the caller says the keys may differ (the
// k-mers' 2k bits, the top keys' bits at k; ops/count.py radix_passes), so
// keys that use fewer bits cost fewer passes; the histogram reads the keys
// once more. Design (Onesweep, Adinets and Merrill 2022): one read of the
// keys counts every digit's histogram (shared-memory counters a block,
// summed into one global histogram: a count, order-free) and a one-block
// scan gives each digit's bucket offsets on the card (no host read); the
// wrapper runs the passes, ping-ponging two buffers. A pass is one kernel of
// tiles of RS_TILE keys: a block takes the next tile index from a counter
// (the order tiles start in, not where a key lands), loads the tile (warp w,
// item j, lane l: tile row w 32 RS_ITEMS + 32 j + l, so a warp's load is 256
// contiguous bytes), counts its digits and publishes the counts at once (so
// that the tiles after it seldom wait), ranks each key among the tile's keys
// of its digit, stably, in shared memory (a warp's lanes of one digit found
// by eight ballots; the last of them reads and bumps the warp's counter of
// the digit and shuffles the count to the others; then the warps' counts
// scanned), looks back over the tiles before it for their sum (decoupled
// look-back: a thread a digit, a 64-bit status word a tile and digit holding
// a flag and a count, so one store publishes both; RS_LB words read at
// once), and writes its keys, staged in shared memory in digit order, to
// bucket offset + the tiles' sum + rank: consecutive threads write
// consecutive keys of a digit. The payload is loaded after the keys' ranks
// are known and staged at the same places; an index payload travels as int32
// between a sort's first and last passes (on the H100 a sort with its index
// took 7-11% longer carried as int64: 4 more bytes a key a pass, 64 KB of
// staging a block). The pass is latency-bound (each block waits on its
// loads, then ranks), so registers are capped for RS_MINB blocks an SM, and
// the look-back reads RS_LB words at a time (on the H100, 2 blocks an SM, or
// 1, 16 or 32 words, took longer). Positions depend only on the keys and
// their order: no atomic decides where a key lands.

#include "common.cuh"

#define LT_TRY(x)                              \
  do {                                         \
    cudaError_t e_ = (x);                      \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

#define RS_THREADS 256
#define RS_WARPS (RS_THREADS / 32)
#define RS_ITEMS 16                       // keys a thread holds in a pass
#define RS_MINB 3                         // resident blocks an SM a pass asks of ptxas
#define RS_LB 8                           // tiles a look-back step reads at once
#define RS_TILE (RS_THREADS * RS_ITEMS)   // 4096 keys a tile (ops/count.py RADIX_TILE)
#define RS_BITS 8
#define RS_RADIX (1 << RS_BITS)           // 256 buckets, one a thread of a block
#define RS_DIGITS (64 / RS_BITS)          // 8 digits of an int64 key
#define RS_SIGN 0x8000000000000000ull
#define RS_FULL 0xffffffffu
#define RS_AGG (1ull << 62)               // a tile's own count of a digit
#define RS_PRE (2ull << 62)               // the count of the tiles up to it
#define RS_CNT ((1ull << 62) - 1)

// payload kinds (ops/count.py _PAY_*)
#define RS_PAY_NONE 0
#define RS_PAY_I32 1
#define RS_PAY_IDX 2    // idx[i], or i, written as int64 (a one-pass index sort)
#define RS_PAY_IDX32 3  // the same written as int32 (the first of several passes)
#define RS_PAY_I32W 4   // int32 read, int64 written (an index sort's last pass)

static_assert(RS_THREADS == RS_RADIX, "a thread a digit in the scan and the look-back");

// where a pass reads its keys: an int64 array, or the top 64 bits of (N, W)
// u32 rows (rows[idx[i]], or rows[i])
struct RsSrc {
  const long long* keys;
  const uint32_t* rows;
  const long long* idx;
  long long W;
};

// key i as the unsigned value whose order is the key's signed order
template <bool ROWS>
static __device__ __forceinline__ unsigned long long rs_ukey(const RsSrc& s, long long i) {
  if (ROWS) {
    const long long r = s.idx ? __ldg(s.idx + i) : i;
    const uint32_t* p = s.rows + r * s.W;
    if (s.W == 1) return (unsigned long long)__ldg(p);
    return ((unsigned long long)__ldg(p + s.W - 1) << 32) | __ldg(p + s.W - 2);
  }
  return (unsigned long long)__ldg(s.keys + i) ^ RS_SIGN;
}

// every digit's histogram in one read of the keys (a grid of resident blocks)
template <bool ROWS>
__global__ void __launch_bounds__(RS_THREADS)
    rs_hist_kernel(const RsSrc src, long long n, unsigned long long* __restrict__ hist) {
  __shared__ unsigned s_h[RS_DIGITS * RS_RADIX];
  for (int t = threadIdx.x; t < RS_DIGITS * RS_RADIX; t += RS_THREADS) s_h[t] = 0;
  __syncthreads();
  for (long long i = (long long)blockIdx.x * RS_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * RS_THREADS) {
    const unsigned long long u = rs_ukey<ROWS>(src, i);
#pragma unroll
    for (int d = 0; d < RS_DIGITS; ++d)
      atomicAdd(&s_h[d * RS_RADIX + (unsigned)((u >> (RS_BITS * d)) & (RS_RADIX - 1))], 1u);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < RS_DIGITS * RS_RADIX; t += RS_THREADS)
    if (s_h[t]) atomicAdd(hist + t, (unsigned long long)s_h[t]);
}

// one block: each digit's bucket offsets (exclusive scan of its histogram)
__global__ void __launch_bounds__(RS_THREADS)
    rs_scan_kernel(const unsigned long long* __restrict__ hist, long long* __restrict__ offsets) {
  __shared__ unsigned long long s_warp[RS_WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int d = 0; d < RS_DIGITS; ++d) {
    const unsigned long long c = hist[d * RS_RADIX + t];
    unsigned long long x = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long y = __shfl_up_sync(RS_FULL, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    unsigned long long before = 0;
    for (int w = 0; w < warp; ++w) before += s_warp[w];
    offsets[d * RS_RADIX + t] = (long long)(before + x - c);
    __syncthreads();
  }
}

static __device__ __forceinline__ unsigned long long rs_ld_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

static __device__ __forceinline__ void rs_st_status(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// a payload kind's value as read (In) and as written (Out)
template <int PAY>
struct RsPayT {
  using In = long long;  // RS_PAY_NONE, RS_PAY_IDX
  using Out = long long;
};
template <>
struct RsPayT<RS_PAY_I32> {
  using In = int32_t;
  using Out = int32_t;
};
template <>
struct RsPayT<RS_PAY_IDX32> {
  using In = long long;
  using Out = int32_t;
};
template <>
struct RsPayT<RS_PAY_I32W> {
  using In = int32_t;
  using Out = long long;
};

// One pass over the digit at bit `shift` (see the header). Dynamic shared
// memory: RS_TILE keys, then RS_TILE payload values.
template <bool ROWS, int PAY>
__global__ void __launch_bounds__(RS_THREADS, RS_MINB)
    rs_pass_kernel(const RsSrc src, const void* __restrict__ pay_in, long long n, int shift,
                   const long long* __restrict__ offsets, long long* __restrict__ keys_out,
                   void* __restrict__ pay_out, unsigned long long* status,
                   unsigned* __restrict__ tile_counter) {
  using PI = typename RsPayT<PAY>::In;
  using PO = typename RsPayT<PAY>::Out;
  extern __shared__ __align__(16) unsigned char rs_smem[];
  long long* s_keys = reinterpret_cast<long long*>(rs_smem);
  PO* s_pay = reinterpret_cast<PO*>(rs_smem + RS_TILE * sizeof(long long));
  __shared__ unsigned s_wc[RS_WARPS][RS_RADIX];  // a warp's count of a digit, then its offset
  __shared__ unsigned s_tstart[RS_RADIX];        // a digit's first place in the tile
  __shared__ long long s_gbase[RS_RADIX];        // keys_out index of the tile's place 0 of a digit
  __shared__ unsigned s_count[RS_RADIX];         // the tile's count of a digit
  __shared__ unsigned s_warp[RS_WARPS];
  __shared__ unsigned s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = threadIdx.x; t < RS_WARPS * RS_RADIX; t += RS_THREADS) (&s_wc[0][0])[t] = 0;
  if (threadIdx.x == 0) s_tile = atomicAdd(tile_counter, 1u);
  __syncthreads();
  const long long tile = s_tile, base = tile * RS_TILE;
  const int tn = (int)(n - base < RS_TILE ? n - base : RS_TILE);
  const int wbase = warp * 32 * RS_ITEMS;
  unsigned long long u[RS_ITEMS];
#pragma unroll
  for (int j = 0; j < RS_ITEMS; ++j) {
    const int t = wbase + 32 * j + lane;
    u[j] = t < tn ? rs_ukey<ROWS>(src, base + t) : 0ull;
  }
  // the tile's count of each digit (shared-memory atomics: a count, order-free),
  // published before the ranks, so that the tiles after it find it early
  s_count[threadIdx.x] = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < RS_ITEMS; ++j)
    if (wbase + 32 * j + lane < tn)
      atomicAdd(&s_count[(unsigned)(u[j] >> shift) & (RS_RADIX - 1)], 1u);
  __syncthreads();
  unsigned long long* st = status + tile * RS_RADIX + threadIdx.x;
  rs_st_status(st, (tile ? RS_AGG : RS_PRE) | s_count[threadIdx.x]);
  // each key's rank among the warp's keys of its digit before it (items in
  // order, lanes in order within an item: the tile's order)
  unsigned rank[RS_ITEMS];
#pragma unroll
  for (int j = 0; j < RS_ITEMS; ++j) {
    const bool ok = wbase + 32 * j + lane < tn;
    const unsigned d = (unsigned)(u[j] >> shift) & (RS_RADIX - 1);
    unsigned peers = __ballot_sync(RS_FULL, ok);
#pragma unroll
    for (int b = 0; b < RS_BITS; ++b) {
      const unsigned bal = __ballot_sync(RS_FULL, (d >> b) & 1u);
      peers &= (d >> b) & 1u ? bal : ~bal;
    }
    const unsigned below = __popc(peers & ((1u << lane) - 1u));
    const int leader = 31 - __clz(peers | 1u);  // the last lane of the digit: it counts them
    unsigned seen = 0;
    if (ok && lane == leader) {
      seen = s_wc[warp][d];
      s_wc[warp][d] = seen + below + 1;
    }
    __syncwarp();
    seen = __shfl_sync(RS_FULL, seen, leader);
    rank[j] = seen + below;
  }
  __syncthreads();
  {
    const int d = threadIdx.x;
    const unsigned tot = s_count[d];
    unsigned c = 0;
    for (int w = 0; w < RS_WARPS; ++w) {
      const unsigned cw = s_wc[w][d];
      s_wc[w][d] = c;
      c += cw;
    }
    unsigned x = tot;  // the tile's exclusive scan of the digits' counts
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(RS_FULL, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    unsigned before = 0;
    for (int w = 0; w < warp; ++w) before += s_warp[w];
    s_tstart[d] = before + x - tot;
    unsigned long long excl = 0;  // the digit's keys in the tiles before this one
    if (tile) {
      // RS_LB tiles' words at once, summed from the nearest to the first
      // PRE; a word not yet written starts the next step
      for (long long t = tile - 1;;) {
        unsigned long long v[RS_LB];
#pragma unroll
        for (int q = 0; q < RS_LB; ++q)
          v[q] = t - q >= 0 ? rs_ld_status(status + (t - q) * RS_RADIX + d) : RS_PRE;
        int q = 0;
        bool pre = false;
#pragma unroll
        for (; q < RS_LB && (v[q] >> 62); ++q) {
          excl += v[q] & RS_CNT;
          if (v[q] & RS_PRE) {
            pre = true;
            break;
          }
        }
        if (pre) break;
        t -= q;
      }
      rs_st_status(st, RS_PRE | (excl + tot));
    }
    s_gbase[d] = offsets[d] + (long long)excl - (long long)(before + x - tot);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < RS_ITEMS; ++j) {
    if (wbase + 32 * j + lane < tn) {
      const unsigned d = (unsigned)(u[j] >> shift) & (RS_RADIX - 1);
      rank[j] += s_tstart[d] + s_wc[warp][d];
      s_keys[rank[j]] = (long long)(u[j] ^ RS_SIGN);
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < tn; p += RS_THREADS) {
    const long long k = s_keys[p];
    const unsigned d = (unsigned)(((unsigned long long)k ^ RS_SIGN) >> shift) & (RS_RADIX - 1);
    keys_out[s_gbase[d] + p] = k;
  }
  if constexpr (PAY != RS_PAY_NONE) {
#pragma unroll
    for (int j = 0; j < RS_ITEMS; ++j) {
      const long long i = base + wbase + 32 * j + lane;
      if (wbase + 32 * j + lane < tn) {
        if constexpr (PAY == RS_PAY_IDX || PAY == RS_PAY_IDX32)
          s_pay[rank[j]] = (PO)(src.idx ? __ldg(src.idx + i) : i);
        else
          s_pay[rank[j]] = (PO)__ldg(reinterpret_cast<const PI*>(pay_in) + i);
      }
    }
    __syncthreads();
    PO* out = reinterpret_cast<PO*>(pay_out);
    for (int p = threadIdx.x; p < tn; p += RS_THREADS) {
      const unsigned d =
          (unsigned)(((unsigned long long)s_keys[p] ^ RS_SIGN) >> shift) & (RS_RADIX - 1);
      out[s_gbase[d] + p] = s_pay[p];
    }
  }
}

static RsSrc rs_src(const void* keys, const void* rows, int W, const void* idx) {
  return RsSrc{(const long long*)keys, (const uint32_t*)rows, (const long long*)idx,
               (long long)W};
}

static bool rs_src_ok(const void* keys, const void* rows, int W, long long n) {
  if (n < 0) return false;
  if (rows) return W >= 1 && W <= 16;
  return keys != nullptr || n == 0;
}

// Every digit's histogram of the n keys (keys, or the top 64 bits of
// rows[idx[i]] / rows[i] when rows is not null), then each digit's bucket
// offsets: hist 2048 u64 scratch, offsets 2048 int64 (digit d's at 256 d).
extern "C" int lt_radix_hist(const void* keys, const void* rows, int W, const void* idx,
                             long long n, void* hist, void* offsets, void* stream) {
  if (!rs_src_ok(keys, rows, W, n) || !hist || !offsets)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* h = (unsigned long long*)hist;
  LT_TRY(cudaMemsetAsync(h, 0, RS_DIGITS * RS_RADIX * sizeof(unsigned long long), st));
  const RsSrc src = rs_src(keys, rows, W, idx);
  if (n > 0) {
    int blocks = 0;
    const long long need = (n + RS_THREADS - 1) / RS_THREADS;
    if (rows) {
      LT_TRY(resident_blocks(rs_hist_kernel<true>, RS_THREADS, &blocks));
      rs_hist_kernel<true><<<(unsigned)(need < blocks ? need : blocks), RS_THREADS, 0, st>>>(
          src, n, h);
    } else {
      LT_TRY(resident_blocks(rs_hist_kernel<false>, RS_THREADS, &blocks));
      rs_hist_kernel<false><<<(unsigned)(need < blocks ? need : blocks), RS_THREADS, 0, st>>>(
          src, n, h);
    }
    LT_TRY(cudaGetLastError());
  }
  rs_scan_kernel<<<1, RS_THREADS, 0, st>>>(h, (long long*)offsets);
  return (int)cudaGetLastError();
}

template <bool ROWS, int PAY>
static int rs_launch(const RsSrc& src, const void* pay_in, long long n, int digit,
                     const long long* offsets, long long* keys_out, void* pay_out,
                     unsigned long long* status, long long tiles, cudaStream_t st) {
  constexpr size_t smem =
      RS_TILE * (sizeof(long long) + (PAY == RS_PAY_NONE ? 0 : sizeof(typename RsPayT<PAY>::Out)));
  LT_TRY(cudaFuncSetAttribute(rs_pass_kernel<ROWS, PAY>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  rs_pass_kernel<ROWS, PAY><<<(unsigned)tiles, RS_THREADS, smem, st>>>(
      src, pay_in, n, RS_BITS * digit, offsets + RS_RADIX * digit, keys_out, pay_out, status,
      (unsigned*)(status + tiles * RS_RADIX));
  return (int)cudaGetLastError();
}

// One pass over digit `digit` (0..7): the n keys (keys, or in a first pass
// the rows' top 64 bits, as lt_radix_hist) and their payload (pay_kind: 0
// none, 1 int32 pay_in, 2 the index idx[i] or i written as int64, 3 the
// same written as int32, 4 int32 pay_in written as int64; rows take 0, 2
// or 3) in the order of that digit, stably, into keys_out and pay_out.
// offsets: lt_radix_hist's. status: scratch of status_bytes >= 8 (256
// ceil(n / 4096) + 1), zeroed here.
extern "C" int lt_radix_pass(const void* keys, const void* rows, int W, const void* idx,
                             const void* pay_in, int pay_kind, long long n, int digit,
                             const void* offsets, void* keys_out, void* pay_out, void* status,
                             long long status_bytes, void* stream) {
  const bool reads_pay = pay_kind == RS_PAY_I32 || pay_kind == RS_PAY_I32W;
  if (!rs_src_ok(keys, rows, W, n) || digit < 0 || digit >= RS_DIGITS || pay_kind < 0 ||
      pay_kind > RS_PAY_I32W || (rows && reads_pay))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  if (!offsets || !keys_out || !status || (pay_kind != RS_PAY_NONE && !pay_out) ||
      (reads_pay && !pay_in))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n + RS_TILE - 1) / RS_TILE;
  const long long need = (tiles * RS_RADIX + 1) * (long long)sizeof(unsigned long long);
  if (status_bytes < need) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* s = (unsigned long long*)status;
  LT_TRY(cudaMemsetAsync(s, 0, (size_t)need, st));
  const RsSrc src = rs_src(keys, rows, W, idx);
  const long long* off = (const long long*)offsets;
  long long* ko = (long long*)keys_out;
  if (rows) {
    if (pay_kind == RS_PAY_IDX)
      return rs_launch<true, RS_PAY_IDX>(src, pay_in, n, digit, off, ko, pay_out, s, tiles, st);
    if (pay_kind == RS_PAY_IDX32)
      return rs_launch<true, RS_PAY_IDX32>(src, pay_in, n, digit, off, ko, pay_out, s, tiles, st);
    return rs_launch<true, RS_PAY_NONE>(src, pay_in, n, digit, off, ko, pay_out, s, tiles, st);
  }
  switch (pay_kind) {
    case RS_PAY_NONE:
      return rs_launch<false, RS_PAY_NONE>(src, pay_in, n, digit, off, ko, pay_out, s, tiles, st);
    case RS_PAY_I32:
      return rs_launch<false, RS_PAY_I32>(src, pay_in, n, digit, off, ko, pay_out, s, tiles, st);
    case RS_PAY_IDX:
      return rs_launch<false, RS_PAY_IDX>(src, pay_in, n, digit, off, ko, pay_out, s, tiles, st);
    case RS_PAY_IDX32:
      return rs_launch<false, RS_PAY_IDX32>(src, pay_in, n, digit, off, ko, pay_out, s, tiles, st);
    default:
      return rs_launch<false, RS_PAY_I32W>(src, pay_in, n, digit, off, ko, pay_out, s, tiles, st);
  }
}

// A redesign of the pass was measured on the H100 (NVIDIA H100 80GB HBM3,
// 700 W) and not kept: a persistent grid of the resident blocks taking tile
// after tile from the pass's counter, each streaming its next tile's keys
// into shared memory with cp.async while it ranks and scatters the current
// one (publishing the current tile's inclusive counts before it starts the
// next, so no look-back waits on a block that waits on it), and status
// words tagged with their pass (digit + 1 beside the flag, a word of another
// pass read as unwritten) so that one memset a sort replaced one a pass.
// At 4,096 keys a tile its shared memory (staging, payload, prefetch) left 2
// blocks an SM (116-128 registers); at 3,072 keys 3 blocks, but a third more
// tiles to look back over. Every shape was 3-15% slower than this pass
// (scripts/ab_kernels.py --only sort, parent and variants in turns): the
// k = 31 slab (37.0M keys) 3.206-3.210 and 3.271-3.287 ms against
// 2.848-2.850, the k = 127 slab's top keys 3.313-3.326 / 3.508-3.512 against
// 3.074-3.087, a W = 4 chunk's top keys 0.474-0.476 / 0.474-0.481 against
// 0.457-0.466. Hiding the loads did not pay for the warps it cost the
// look-back and the scatter, which it does not touch (PERF.md §6).

// ---------------------------------------------------------------------------
// K23 merge_path — a stable merge of sorted runs with their int32 counts: the
// count's merges (ops/count.py merge_path, merge_path_rows). It takes the
// place of the sort inside the reference's _merge_sorted_runs
// (leon_tpu/ops/count.py:233, lax.sort of the concatenated runs with the
// counts carried along) wherever the runs are already sorted: DeviceCounter's
// and the WordCounter's merges, which the port first ran as torch.cat and a
// K22 sort (and, at W >= 3, K20 carrying the counts). A stable merge of the
// runs in order (on equal elements the earlier run's first) gives the order
// of a stable sort of their concatenation.
//
// An element is W u32 words, least significant first: an int64 key is W = 2
// with its top word signed (SIGNED), a (M, W) row of k-mer words compares as
// unsigned words, most significant first. The top 64 bits (words W-1, W-2)
// compare first, the lower words only on a tie (equal k-mers across runs are
// exactly what a merge sums).
//
// Bound on the H100: device-memory bytes, one read and one write of the rows
// and counts for each pairwise round (R runs merge in ceil(log2 R) rounds of
// adjacent pairs, in order, so that the merge stays stable; an odd run waits
// for the next round untouched; one launch merges every pair of a round, up to
// MP_MAX_PAIRS, from a table passed by value). Design (merge path: Odeh,
// Green, Mwassi, Shmueli and Birk 2012; Green, McColl and Bader 2012): a
// block owns MP_THREADS * mp_items(W) outputs of one pair; two warps find
// where its first and last outputs' cross-diagonals cut the two inputs (a
// 32-ary search: each step a warp probes 32 places at once, so about five
// dependent round trips to device memory); the block copies both input
// stretches, which are contiguous, and their counts into shared memory with
// cp.async (16 bytes at a time; each stretch placed at its source's phase in
// a 16-byte chunk, the unaligned head and tail 4 bytes at a time); each
// thread finds its own sub-diagonal by a binary search in shared memory and
// merges its items serially (the two current tops kept in registers), writing
// only where each output comes from (a 16-bit index); then the block writes
// its rows and counts in 16-byte stores. About 54-58 KB of shared memory a
// block at every W (mp_items), so 3-4 blocks an SM.

#define MP_THREADS 256
#define MP_MAX_PAIRS 8  // pairs a launch merges (a round with more launches again)

// elements a thread merges at width W: about 56 KB of shared memory a block
// (ops/count.py merge_tile)
static __host__ __device__ constexpr int mp_items(int W) {
  return 60 / (W + 2) < 16 ? 60 / (W + 2) : 16;
}
static __host__ __device__ constexpr int mp_tile(int W) { return MP_THREADS * mp_items(W); }
// shared-memory words of a block: rows and counts of its tile, four phase
// gaps, the 16-bit source index of each output
static __host__ __device__ constexpr int mp_smem_words(int W) {
  return mp_tile(W) * (W + 1) + mp_tile(W) / 2 + 32;
}

struct MpPair {
  const uint32_t* a;  // run A: na elements of W words
  const int32_t* ca;  // its counts
  const uint32_t* b;  // run B, after A
  const int32_t* cb;
  uint32_t* out;      // na + nb elements, 16-byte aligned
  int32_t* cout;      // 16-byte aligned
  long long na, nb;
  long long first;    // the pair's first block in its launch
};

struct MpTable {
  MpPair p[MP_MAX_PAIRS];
  int n;
};

// an element's top 64 bits as an unsigned whose order is the element's
template <int W, bool SIGNED, bool GLOBAL>
static __device__ __forceinline__ unsigned long long mp_top(const uint32_t* p) {
  const unsigned long long t =
      GLOBAL ? ((unsigned long long)__ldg(p + W - 1) << 32) | __ldg(p + W - 2)
             : ((unsigned long long)p[W - 1] << 32) | p[W - 2];
  return SIGNED ? t ^ RS_SIGN : t;
}

// a <= b for elements with equal tops: words W-3 .. 0 as unsigned
template <int W, bool GLOBAL>
static __device__ __forceinline__ bool mp_low_le(const uint32_t* a, const uint32_t* b) {
#pragma unroll
  for (int q = W - 3; q >= 0; --q) {
    const uint32_t x = GLOBAL ? __ldg(a + q) : a[q], y = GLOBAL ? __ldg(b + q) : b[q];
    if (x != y) return x < y;
  }
  return true;
}

// a <= b: in a stable merge, A's element a goes before B's element b
template <int W, bool SIGNED, bool GLOBAL>
static __device__ __forceinline__ bool mp_le(const uint32_t* a, const uint32_t* b) {
  const unsigned long long ta = mp_top<W, SIGNED, GLOBAL>(a), tb = mp_top<W, SIGNED, GLOBAL>(b);
  return ta < tb || (ta == tb && mp_low_le<W, GLOBAL>(a, b));
}

// A's elements among the first d outputs of the pair's merge: the least i
// with A[i] > B[d - 1 - i] (d - nb <= i <= min(d, na)), found by one warp
// probing 32 places a step (the predicate is true, then false, along i)
template <int W, bool SIGNED>
static __device__ long long mp_search(const MpPair& P, long long d) {
  const int lane = threadIdx.x & 31;
  long long lo = d - P.nb > 0 ? d - P.nb : 0, hi = d < P.na ? d : P.na;
  while (lo < hi) {
    const long long span = hi - lo;
    const long long m = span <= 32 ? lo + lane : lo + span * lane / 32;
    const bool pred = m < hi && mp_le<W, SIGNED, true>(P.a + m * W, P.b + (d - 1 - m) * W);
    const int t = __popc(__ballot_sync(RS_FULL, pred));  // the lanes below t hold true
    if (span <= 32) {
      lo += t;
      hi = lo;
    } else {
      const long long nlo = t ? lo + span * (t - 1) / 32 + 1 : lo;
      hi = t < 32 ? lo + span * t / 32 : hi;
      lo = nlo;
    }
  }
  return lo;
}

// a pointer's 4-byte word within its 16-byte chunk
static __device__ __forceinline__ int mp_phase(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3u);
}

static __device__ __forceinline__ int mp_up4(int x) { return (x + 3) & ~3; }

static __device__ __forceinline__ void mp_cp16(uint32_t* s, const uint32_t* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(g) : "memory");
}

static __device__ __forceinline__ void mp_cp4(uint32_t* s, const uint32_t* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa), "l"(g) : "memory");
}

// the block copies n words from g to s (the same phase in a 16-byte chunk):
// the head and tail a word at a time, the chunks between 16 bytes at a time
static __device__ __forceinline__ void mp_copy(uint32_t* s, const uint32_t* g, int n) {
  const int head = min((4 - mp_phase(g)) & 3, n);
  const int body = (n - head) >> 2, tail = head + 4 * body;
  for (int t = threadIdx.x; t < head; t += MP_THREADS) mp_cp4(s + t, g + t);
  for (int t = threadIdx.x; t < body; t += MP_THREADS) mp_cp16(s + head + 4 * t, g + head + 4 * t);
  for (int t = tail + threadIdx.x; t < n; t += MP_THREADS) mp_cp4(s + t, g + t);
}

// One block: outputs [d0, d0 + tile) of its pair (see the K23 header).
template <int W, bool SIGNED>
__global__ void __launch_bounds__(MP_THREADS, 3) mp_merge_kernel(const MpTable T) {
  constexpr int ITEMS = mp_items(W), NV = mp_tile(W);
  extern __shared__ __align__(16) uint32_t mp_smem[];
  __shared__ long long s_a[2];
  int pi = 0;
#pragma unroll
  for (int q = 1; q < MP_MAX_PAIRS; ++q)
    if (q < T.n && T.p[q].first <= (long long)blockIdx.x) pi = q;
  MpPair P = T.p[0];
#pragma unroll
  for (int q = 1; q < MP_MAX_PAIRS; ++q)
    if (q == pi) P = T.p[q];  // selects, not a local copy of the table
  const long long d0 = ((long long)blockIdx.x - P.first) * NV;
  const long long d1 = d0 + NV < P.na + P.nb ? d0 + NV : P.na + P.nb;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long a = mp_search<W, SIGNED>(P, warp ? d1 : d0);
    if ((threadIdx.x & 31) == 0) s_a[warp] = a;
  }
  __syncthreads();
  const long long a0 = s_a[0], b0 = d0 - a0;
  const int na = (int)(s_a[1] - a0), nb = (int)(d1 - s_a[1] - b0), tn = na + nb;
  // words: A's rows, B's rows, A's counts, B's counts, each at its source's
  // phase in a 16-byte chunk; then the outputs' 16-bit sources
  const int offA = mp_phase(P.a + a0 * W);
  const int offB = mp_up4(offA + na * W) + mp_phase(P.b + b0 * W);
  const int offCA = mp_up4(offB + nb * W) + mp_phase(P.ca + a0);
  const int offCB = mp_up4(offCA + na) + mp_phase(P.cb + b0);
  unsigned short* s_src = reinterpret_cast<unsigned short*>(mp_smem + mp_up4(offCB + nb));
  mp_copy(mp_smem + offA, P.a + a0 * W, na * W);
  mp_copy(mp_smem + offB, P.b + b0 * W, nb * W);
  mp_copy(mp_smem + offCA, reinterpret_cast<const uint32_t*>(P.ca + a0), na);
  mp_copy(mp_smem + offCB, reinterpret_cast<const uint32_t*>(P.cb + b0), nb);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const uint32_t* sA = mp_smem + offA;
  const uint32_t* sB = mp_smem + offB;
  {
    // the thread's ITEMS outputs from its sub-diagonal
    const int diag = min((int)threadIdx.x * ITEMS, tn), end = min(diag + ITEMS, tn);
    int lo = max(0, diag - nb), hi = min(diag, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (mp_le<W, SIGNED, false>(sA + mid * W, sB + (diag - 1 - mid) * W))
        lo = mid + 1;
      else
        hi = mid;
    }
    int i = lo, j = diag - lo;
    unsigned long long ta = i < na ? mp_top<W, SIGNED, false>(sA + i * W) : 0ull;
    unsigned long long tb = j < nb ? mp_top<W, SIGNED, false>(sB + j * W) : 0ull;
    for (int p = diag; p < end; ++p) {
      const bool take_a = j >= nb || (i < na && (ta < tb || (ta == tb && mp_low_le<W, false>(
                                                                 sA + i * W, sB + j * W))));
      if (take_a) {
        s_src[p] = (unsigned short)i;
        if (++i < na) ta = mp_top<W, SIGNED, false>(sA + i * W);
      } else {
        s_src[p] = (unsigned short)(na + j);
        if (++j < nb) tb = mp_top<W, SIGNED, false>(sB + j * W);
      }
    }
  }
  __syncthreads();
  // the tile's rows, then its counts, in 16-byte stores (the outputs start
  // 16-byte aligned: d0 is a multiple of NV), a last part word by word
  uint32_t* out = P.out + d0 * W;
  const int nw = tn * W;
  for (int c = threadIdx.x; c < nw >> 2; c += MP_THREADS) {
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = 4 * c + q, r = p / W, w = p - r * W, e = s_src[r];
      v[q] = e < na ? sA[e * W + w] : sB[(e - na) * W + w];
    }
    reinterpret_cast<uint4*>(out)[c] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  for (int p = (nw & ~3) + threadIdx.x; p < nw; p += MP_THREADS) {
    const int r = p / W, w = p - r * W, e = s_src[r];
    out[p] = e < na ? sA[e * W + w] : sB[(e - na) * W + w];
  }
  const uint32_t* sCA = mp_smem + offCA;
  const uint32_t* sCB = mp_smem + offCB;
  uint32_t* cout = reinterpret_cast<uint32_t*>(P.cout + d0);
  for (int c = threadIdx.x; c < tn >> 2; c += MP_THREADS) {
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = s_src[4 * c + q];
      v[q] = e < na ? sCA[e] : sCB[e - na];
    }
    reinterpret_cast<uint4*>(cout)[c] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  for (int p = (tn & ~3) + threadIdx.x; p < tn; p += MP_THREADS) {
    const int e = s_src[p];
    cout[p] = e < na ? sCA[e] : sCB[e - na];
  }
}

template <int W, bool SIGNED>
static int mp_launch(const long long* table, int n_pairs, cudaStream_t st) {
  constexpr int NV = mp_tile(W);
  constexpr size_t smem = (size_t)mp_smem_words(W) * sizeof(uint32_t);
  LT_TRY(cudaFuncSetAttribute(mp_merge_kernel<W, SIGNED>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  for (int p0 = 0; p0 < n_pairs; p0 += MP_MAX_PAIRS) {
    MpTable T;
    memset(&T, 0, sizeof(T));
    T.n = n_pairs - p0 < MP_MAX_PAIRS ? n_pairs - p0 : MP_MAX_PAIRS;
    long long blocks = 0;
    for (int q = 0; q < T.n; ++q) {
      const long long* e = table + 8 * (p0 + q);
      MpPair& P = T.p[q];
      P.a = (const uint32_t*)e[0];
      P.ca = (const int32_t*)e[1];
      P.b = (const uint32_t*)e[2];
      P.cb = (const int32_t*)e[3];
      P.out = (uint32_t*)e[4];
      P.cout = (int32_t*)e[5];
      P.na = e[6];
      P.nb = e[7];
      P.first = blocks;
      blocks += (P.na + P.nb + NV - 1) / NV;
    }
    if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    mp_merge_kernel<W, SIGNED><<<(unsigned)blocks, MP_THREADS, smem, st>>>(T);
    LT_TRY(cudaGetLastError());
  }
  return (int)cudaSuccess;
}

// One round of K23: n_pairs merges, each a row of 8 int64 in `table` (host
// memory): run A's rows and counts, run B's rows and counts, the output's
// rows and counts (16-byte aligned), na, nb (both >= 1). Elements are W u32
// words (2 <= W <= 16; sign: int64 keys, W = 2, the top word signed).
extern "C" int lt_merge_path(const long long* table, int n_pairs, int W, int sign, void* stream) {
  if (!table || n_pairs < 0 || W < 2 || W > 16 || (sign && W != 2))
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < n_pairs; ++q) {
    const long long* e = table + 8 * q;
    if (e[6] < 1 || e[7] < 1 || e[6] + e[7] >= (1ll << 40)) return (int)cudaErrorInvalidValue;
    for (int f = 0; f < 4; ++f)
      if (!e[f] || (e[f] & 3)) return (int)cudaErrorInvalidValue;
    if (!e[4] || !e[5] || (e[4] & 15) || (e[5] & 15)) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (sign) return mp_launch<2, true>(table, n_pairs, st);
  switch (W) {
    case 2: return mp_launch<2, false>(table, n_pairs, st);
    case 3: return mp_launch<3, false>(table, n_pairs, st);
    case 4: return mp_launch<4, false>(table, n_pairs, st);
    case 5: return mp_launch<5, false>(table, n_pairs, st);
    case 6: return mp_launch<6, false>(table, n_pairs, st);
    case 7: return mp_launch<7, false>(table, n_pairs, st);
    case 8: return mp_launch<8, false>(table, n_pairs, st);
    case 9: return mp_launch<9, false>(table, n_pairs, st);
    case 10: return mp_launch<10, false>(table, n_pairs, st);
    case 11: return mp_launch<11, false>(table, n_pairs, st);
    case 12: return mp_launch<12, false>(table, n_pairs, st);
    case 13: return mp_launch<13, false>(table, n_pairs, st);
    case 14: return mp_launch<14, false>(table, n_pairs, st);
    case 15: return mp_launch<15, false>(table, n_pairs, st);
    default: return mp_launch<16, false>(table, n_pairs, st);
  }
}
