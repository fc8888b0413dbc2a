// K22 radix_sort — a stable radix sort of int64 keys in signed order, alone
// or with a payload: an int32 value a key, or the key's index (0..n-1, or
// idx[i], below 2**31) as int64. The keys come from an int64 array, or in
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
// Bound on the H100: device-memory bytes. The host picks one of three routes
// from n and the low `bits` bits in which the caller says the keys may
// differ (ops/count.py radix_route):
//
// * passes (bits <= 16; past BS_CAP keys bits <= 40, ops/count.py
//   BUCKET_MIN_BITS, or 64; or n >= 2**31): an LSD sort, a pass for each 8-bit
//   digit of those bits, after one read of the keys that counts every
//   digit's histogram (shared-memory counters a block, summed into one
//   global histogram: a count, order-free; a warp of equal keys adds once)
//   and a one-block scan that gives each digit's bucket offsets on the card
//   (no host read); the wrapper runs the passes, ping-ponging two buffers.
// * bucket (41 <= bits <= 63, BS_CAP < n < 2**31): the top B of the used
//   bits, [bits - B, bits) of the sign-flipped key, are a key's bucket
//   (B = 16, or 24 past 2**19 keys, so that a bucket holds a few keys). The
//   histogram of the bucket's bytes and a pass for each
//   (its low byte first) leave the keys grouped by bucket, stably; then K24
//   radix_bucket sorts each bucket in shared memory (one read and one write),
//   and K25 radix_oversize sorts the buckets of more than BS_CAP keys through
//   device memory, a pass for each digit of their low bits in which they
//   differ (below).
// * block (bits > 16, n <= BS_CAP): K24 alone, one block reading the keys
//   (or rows) and their payload straight from the source.
//
// A pass is one kernel of tiles of RS_TILE keys (Onesweep, Adinets and
// Merrill 2022): a block takes the next tile index from a counter (the order
// tiles start in, not where a key lands), loads the tile (warp w, item j,
// lane l: tile row w 32 RS_ITEMS + 32 j + l, so a warp's load is 256
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
// are known and staged (as int32) at the same places; an index payload
// travels as int32 between a sort's first and last passes (on the H100 a
// sort with its index took 7-11% longer carried as int64: 4 more bytes a key
// a pass, 64 KB of staging a block). The pass is latency-bound (each block
// waits on its loads, then ranks), so registers are capped for RS_MINB
// blocks an SM, and the look-back reads RS_LB words at a time (on the H100,
// 2 blocks an SM, or 1, 16 or 32 words, took longer). Positions depend only
// on the keys and their order: no atomic decides where a key lands.

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

// payload kinds of lt_radix_pass (ops/count.py _PAY_*)
#define RS_PAY_NONE 0
#define RS_PAY_I32 1
#define RS_PAY_IDX 2    // idx[i], or i, written as int64 (a one-pass index sort)
#define RS_PAY_IDX32 3  // the same written as int32 (the first of several passes)
#define RS_PAY_I32W 4   // int32 read, int64 written (an index sort's last pass)

// the payload a tile reads (a kind is one of these, written as int32 or,
// `wide`, as int64)
#define RS_IN_NONE 0
#define RS_IN_I32 1
#define RS_IN_IDX 2

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

// The warp's keys u (the lanes with ok; lane 0 has one) counted into the
// `digits` histograms s_h (shared-memory atomics): a warp of equal keys (a
// SENTINEL run, a repeated k-mer) adds its count once a digit.
static __device__ __forceinline__ void rs_count_keys(unsigned* s_h, unsigned long long u, bool ok,
                                                     int digits) {
  const int lane = threadIdx.x & 31;
  const unsigned long long u0 = __shfl_sync(RS_FULL, u, 0);
  const unsigned live = __ballot_sync(RS_FULL, ok);
  if (__all_sync(RS_FULL, !ok || u == u0)) {
    if (lane < digits)
      atomicAdd(&s_h[lane * RS_RADIX + (unsigned)((u0 >> (RS_BITS * lane)) & (RS_RADIX - 1))],
                (unsigned)__popc(live));
  } else if (ok) {
    for (int d = 0; d < digits; ++d)
      atomicAdd(&s_h[d * RS_RADIX + (unsigned)((u >> (RS_BITS * d)) & (RS_RADIX - 1))], 1u);
  }
}

// the histograms of digits 0..digits-1 of the keys >> base in one read (a
// grid of resident blocks)
template <bool ROWS>
__global__ void __launch_bounds__(RS_THREADS)
    rs_hist_kernel(const RsSrc src, long long n, int base, int digits,
                   unsigned long long* __restrict__ hist) {
  __shared__ unsigned s_h[RS_DIGITS * RS_RADIX];
  for (int t = threadIdx.x; t < RS_DIGITS * RS_RADIX; t += RS_THREADS) s_h[t] = 0;
  __syncthreads();
  for (long long i0 = (long long)blockIdx.x * RS_THREADS + (threadIdx.x & ~31); i0 < n;
       i0 += (long long)gridDim.x * RS_THREADS) {
    const long long i = i0 + (threadIdx.x & 31);
    rs_count_keys(s_h, i < n ? rs_ukey<ROWS>(src, i) >> base : 0ull, i < n, digits);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < digits * RS_RADIX; t += RS_THREADS)
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

// A status word: its flag (RS_AGG or RS_PRE) and count; a TAGGED word (K25's
// passes, whose status is zeroed once a sort) also holds its pass's tag in
// bits 32-61, so that a word another pass wrote reads as not yet written.
template <bool TAGGED>
static __device__ __forceinline__ unsigned long long rs_word(unsigned long long flag,
                                                             unsigned long long count,
                                                             unsigned tag) {
  return TAGGED ? flag | ((unsigned long long)tag << 32) | count : flag | count;
}

template <bool TAGGED>
static __device__ __forceinline__ bool rs_ready(unsigned long long v, unsigned tag) {
  return (v >> 62) && (!TAGGED || (unsigned)((v >> 32) & 0x3fffffffu) == tag);
}

template <bool TAGGED>
static __device__ __forceinline__ unsigned long long rs_count(unsigned long long v) {
  return TAGGED ? v & 0xffffffffull : v & RS_CNT;
}

// One tile of a pass over the digit at bit `shift` (see the header): keys
// [base, base + tn) of src and their payload (IN) placed, stably, at
// offsets[digit] + the digit's keys in tiles first_tile .. tile - 1 + their
// rank in this tile. smem: RS_TILE keys, then RS_TILE int32 payload values.
template <bool ROWS, int IN, bool TAGGED>
static __device__ __forceinline__ void rs_tile(
    const RsSrc& src, const int32_t* __restrict__ pay_in, long long tile, long long first_tile,
    long long base, int tn, int shift, const long long* offsets,
    long long* __restrict__ keys_out, void* __restrict__ pay_out, bool wide,
    unsigned long long* status, unsigned tag, unsigned char* smem) {
  long long* s_keys = reinterpret_cast<long long*>(smem);
  int32_t* s_pay = reinterpret_cast<int32_t*>(smem + RS_TILE * sizeof(long long));
  __shared__ unsigned s_wc[RS_WARPS][RS_RADIX];  // a warp's count of a digit, then its offset
  __shared__ unsigned s_tstart[RS_RADIX];        // a digit's first place in the tile
  __shared__ long long s_gbase[RS_RADIX];        // keys_out index of the tile's place 0 of a digit
  __shared__ unsigned s_count[RS_RADIX];         // the tile's count of a digit
  __shared__ unsigned s_warp[RS_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = threadIdx.x; t < RS_WARPS * RS_RADIX; t += RS_THREADS) (&s_wc[0][0])[t] = 0;
  s_count[threadIdx.x] = 0;
  const int wbase = warp * 32 * RS_ITEMS;
  unsigned long long u[RS_ITEMS];
#pragma unroll
  for (int j = 0; j < RS_ITEMS; ++j) {
    const int t = wbase + 32 * j + lane;
    u[j] = t < tn ? rs_ukey<ROWS>(src, base + t) : 0ull;
  }
  // the tile's count of each digit (shared-memory atomics: a count, order-free),
  // published before the ranks, so that the tiles after it find it early
  __syncthreads();
#pragma unroll
  for (int j = 0; j < RS_ITEMS; ++j)
    if (wbase + 32 * j + lane < tn)
      atomicAdd(&s_count[(unsigned)(u[j] >> shift) & (RS_RADIX - 1)], 1u);
  __syncthreads();
  unsigned long long* st = status + tile * RS_RADIX + threadIdx.x;
  rs_st_status(st, rs_word<TAGGED>(tile > first_tile ? RS_AGG : RS_PRE, s_count[threadIdx.x], tag));
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
    if (tile > first_tile) {
      // RS_LB tiles' words at once, summed from the nearest to the first
      // PRE; a word not yet written starts the next step
      for (long long t = tile - 1;;) {
        unsigned long long v[RS_LB];
#pragma unroll
        for (int q = 0; q < RS_LB; ++q)
          v[q] = t - q >= first_tile ? rs_ld_status(status + (t - q) * RS_RADIX + d)
                                     : rs_word<TAGGED>(RS_PRE, 0, tag);
        int q = 0;
        bool pre = false;
#pragma unroll
        for (; q < RS_LB && rs_ready<TAGGED>(v[q], tag); ++q) {
          excl += rs_count<TAGGED>(v[q]);
          if (v[q] & RS_PRE) {
            pre = true;
            break;
          }
        }
        if (pre) break;
        t -= q;
      }
      rs_st_status(st, rs_word<TAGGED>(RS_PRE, excl + tot, tag));
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
  if constexpr (IN != RS_IN_NONE) {
#pragma unroll
    for (int j = 0; j < RS_ITEMS; ++j) {
      const long long i = base + wbase + 32 * j + lane;
      if (wbase + 32 * j + lane < tn) {
        if constexpr (IN == RS_IN_IDX)
          s_pay[rank[j]] = (int32_t)(src.idx ? __ldg(src.idx + i) : i);
        else
          s_pay[rank[j]] = __ldg(pay_in + i);
      }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < tn; p += RS_THREADS) {
      const unsigned d =
          (unsigned)(((unsigned long long)s_keys[p] ^ RS_SIGN) >> shift) & (RS_RADIX - 1);
      if (wide)
        reinterpret_cast<long long*>(pay_out)[s_gbase[d] + p] = s_pay[p];
      else
        reinterpret_cast<int32_t*>(pay_out)[s_gbase[d] + p] = s_pay[p];
    }
  }
}

// One pass over the digit at bit `shift` of the whole array: a tile a block.
// Dynamic shared memory: RS_TILE keys, then RS_TILE int32 payload values.
template <bool ROWS, int IN>
__global__ void __launch_bounds__(RS_THREADS, RS_MINB)
    rs_pass_kernel(const RsSrc src, const int32_t* __restrict__ pay_in, long long n, int shift,
                   const long long* __restrict__ offsets, long long* __restrict__ keys_out,
                   void* __restrict__ pay_out, int wide, unsigned long long* status,
                   unsigned* __restrict__ tile_counter) {
  extern __shared__ __align__(16) unsigned char rs_smem[];
  __shared__ unsigned s_tile;
  if (threadIdx.x == 0) s_tile = atomicAdd(tile_counter, 1u);
  __syncthreads();
  const long long tile = s_tile, base = tile * RS_TILE;
  const int tn = (int)(n - base < RS_TILE ? n - base : RS_TILE);
  rs_tile<ROWS, IN, false>(src, pay_in, tile, 0, base, tn, shift, offsets, keys_out, pay_out,
                           wide != 0, status, 0, rs_smem);
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

// The histograms of digits 0..digits-1 of the n keys >> base (keys, or the
// top 64 bits of rows[idx[i]] / rows[i] when rows is not null), then each
// digit's bucket offsets: hist 2048 u64 scratch, offsets 2048 int64 (digit
// d's at 256 d).
extern "C" int lt_radix_hist(const void* keys, const void* rows, int W, const void* idx,
                             long long n, int base, int digits, void* hist, void* offsets,
                             void* stream) {
  if (!rs_src_ok(keys, rows, W, n) || !hist || !offsets || base < 0 ||
      base + RS_BITS * (digits - 1) >= 64 || digits < 1 || digits > RS_DIGITS)
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
          src, n, base, digits, h);
    } else {
      LT_TRY(resident_blocks(rs_hist_kernel<false>, RS_THREADS, &blocks));
      rs_hist_kernel<false><<<(unsigned)(need < blocks ? need : blocks), RS_THREADS, 0, st>>>(
          src, n, base, digits, h);
    }
    LT_TRY(cudaGetLastError());
  }
  rs_scan_kernel<<<1, RS_THREADS, 0, st>>>(h, (long long*)offsets);
  return (int)cudaGetLastError();
}

template <bool ROWS, int IN>
static int rs_launch(const RsSrc& src, const void* pay_in, long long n, int shift,
                     const long long* offsets, long long* keys_out, void* pay_out, bool wide,
                     unsigned long long* status, long long tiles, cudaStream_t st) {
  constexpr size_t smem = RS_TILE * (sizeof(long long) + (IN == RS_IN_NONE ? 0 : sizeof(int32_t)));
  LT_TRY(cudaFuncSetAttribute(rs_pass_kernel<ROWS, IN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  rs_pass_kernel<ROWS, IN><<<(unsigned)tiles, RS_THREADS, smem, st>>>(
      src, (const int32_t*)pay_in, n, shift, offsets, keys_out, pay_out, (int)wide, status,
      (unsigned*)(status + tiles * RS_RADIX));
  return (int)cudaGetLastError();
}

// One pass over digit `digit` of the keys >> base (its bits base + 8 digit
// ..): the n keys (keys, or in a first pass the rows' top 64 bits, as
// lt_radix_hist) and their payload (pay_kind: 0 none, 1 int32 pay_in, 2 the
// index idx[i] or i written as int64, 3 the same written as int32, 4 int32
// pay_in written as int64; rows take 0, 2 or 3) in the order of that digit,
// stably, into keys_out and pay_out. offsets: lt_radix_hist's (at the same
// base). status: scratch of status_bytes >= 8 (256 ceil(n / 4096) + 1),
// zeroed here.
extern "C" int lt_radix_pass(const void* keys, const void* rows, int W, const void* idx,
                             const void* pay_in, int pay_kind, long long n, int digit, int base,
                             const void* offsets, void* keys_out, void* pay_out, void* status,
                             long long status_bytes, void* stream) {
  const bool reads_pay = pay_kind == RS_PAY_I32 || pay_kind == RS_PAY_I32W;
  if (!rs_src_ok(keys, rows, W, n) || digit < 0 || digit >= RS_DIGITS || base < 0 ||
      base + RS_BITS * digit >= 64 || pay_kind < 0 || pay_kind > RS_PAY_I32W ||
      (rows && reads_pay))
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
  const long long* off = (const long long*)offsets + RS_RADIX * digit;
  long long* ko = (long long*)keys_out;
  const int shift = base + RS_BITS * digit;
  const bool wide = pay_kind == RS_PAY_IDX || pay_kind == RS_PAY_I32W;
  if (pay_kind == RS_PAY_NONE)
    return rows ? rs_launch<true, RS_IN_NONE>(src, pay_in, n, shift, off, ko, pay_out, wide, s,
                                              tiles, st)
                : rs_launch<false, RS_IN_NONE>(src, pay_in, n, shift, off, ko, pay_out, wide, s,
                                               tiles, st);
  if (pay_kind == RS_PAY_IDX || pay_kind == RS_PAY_IDX32)
    return rows ? rs_launch<true, RS_IN_IDX>(src, pay_in, n, shift, off, ko, pay_out, wide, s,
                                             tiles, st)
                : rs_launch<false, RS_IN_IDX>(src, pay_in, n, shift, off, ko, pay_out, wide, s,
                                              tiles, st);
  return rs_launch<false, RS_IN_I32>(src, pay_in, n, shift, off, ko, pay_out, wide, s, tiles, st);
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
// K24 radix_bucket and K25 radix_oversize — K22's bucket route (see the K22
// header): what the passes over the bucket's bytes leave grouped by bucket
// (the top B of the used bits, ascending along the array), sorted within
// each bucket by its remaining bits, into the sort's one output buffer.
//
// K24: the array is cut into shares of BS_SHARE keys; block b takes the
// buckets that start in its share (bs_edge_kernel finds each share's first
// bucket start, a warp a share by a 32-ary search of the ascending buckets,
// as K23's mp_search). Its keys are under BS_SHARE plus its last bucket, so
// it sorts them in one round of up to BS_CAP keys, or in two (the buckets
// before the last, then the last), or hands a last bucket of more than
// BS_CAP keys to K25. A round sorts its keys by the whole key, which sorts
// each of its buckets (it holds whole buckets, in bucket order): the keys
// (as their unsigned order) and an int32 payload loaded coalesced into
// shared memory (a pad word every 16 keys, so that a thread's run of BS_IPT
// keys spreads over the banks). Where no bucket of the round holds more than
// BS_RANK keys and they hold BS_DENSE keys or fewer on average (the k = 127
// slab's top keys in buckets of B = 24 bits: a k-mer's copies and a few
// others), each key's place is its bucket's first place plus its rank there:
// the keys of its bucket that are smaller, or equal and before it (a thread a
// key, the bucket's keys read in turn, most of a warp reading the same one),
// written back to shared memory at that place after a barrier. A rank costs
// a pass over the key's bucket: on the k = 31 slab, whose 24-bit buckets
// hold 26 keys a key on average, the ranks took longer than the merges
// (PERF.md §6). Else each thread sorts its BS_IPT keys in
// registers (odd-even transposition: only a greater key moves up, so
// stably); then merge levels of runs of R = BS_IPT, 2 BS_IPT, ...: a pair
// already in order (its first run's last key <= its second's first: whole
// buckets, or keys sorted already) is left as it is, else each thread
// merges its BS_IPT outputs into registers (on equal keys the first run's)
// from where a binary search of the pair's merge path puts its first (the
// rounds wait on shared-memory latency: blocks of 512 and 256 threads took
// longer than 1,024, and so did two or four interleaved searches and merges
// a thread), and writes them back after a barrier (the warp's while a pair
// lies within a warp's outputs: a block's barrier at every level was
// slower);
// then the round is written out coalesced (the key sign-flipped back, the
// payload as int32 or, wide, int64). The block route is one such round over
// the source's n <= BS_CAP keys. A round as an LSD radix sort in shared
// memory instead (a ballot-ranked pass for each byte in which its keys
// differ, 7 at the k = 31 slab) was tried and not kept: each pass cost
// about as much as one of K22's passes through device memory (the ranking,
// not the memory, bounds a pass), and the round took longer than the
// merges (PERF.md §6). The rank route took 12-19% off the WordCounter's
// top sorts against every round merged (scripts/tune_sort.py, which builds
// a copy with BS_RANK 0; PERF.md row 19).
//
// K25: each oversize bucket is listed by the block that meets it (an atomic
// slot in the list, and a contiguous range of tiles: neither decides where
// a key lands); bs_seg_hist_kernel counts its tiles' digits (and zeroes
// their status words); the block that counts a bucket's last tile finds the
// digits in which its keys differ (a digit whose histogram holds all m keys
// in one bin moves nothing) and lists the bucket's tiles for each of them
// and, when their number is even, for the finishing copy. Then a launch for
// each digit of the low bits - B bits (bs_seg_pass_kernel: K22's tile at
// the bucket's offsets, its look-back stopping at the bucket's first tile in
// the digit's list, its status words tagged with the digit) over the listed
// tiles only, the keys ping-ponging between the two key buffers over the
// bucket's span and the last pass writing the payload to its output; a
// bucket left in the second key buffer (an even number of passes: none for
// equal keys, such as the SENTINEL bucket) is copied into the output
// (bs_seg_finish_kernel). Every K25 launch is a grid of resident blocks
// taking listed tiles from a counter, so an empty list costs a launch. A
// bucket costs at most B / 8 + ceil((bits - B) / 8) passes and a copy: as
// many passes as the passes route at bits = 64.

#define BS_THREADS 1024
#define BS_CAP 8192                     // keys a round (ops/count.py BUCKET_CAP)
#define BS_IPT (BS_CAP / BS_THREADS)    // keys a thread sorts and merges
#define BS_SHARE (BS_CAP / 2)           // keys a block's share (BUCKET_SHARE)
#define BS_SLOTS (BS_CAP + BS_CAP / 16)
#define BS_RANK 128                     // the largest bucket a round ranks (BUCKET_RANK)
#define BS_DENSE 8                      // the most keys a bucket a round ranks, on average

static_assert(BS_CAP >= BS_SHARE, "a share holds at most one oversize bucket: its last");

// the device plan of the oversize buckets (zeroed by bs_edge_kernel)
struct BsPlan {
  unsigned G, T;                  // buckets listed, their tiles
  unsigned hist_tile, fin_tile;   // tile counters of bs_seg_hist_kernel, bs_seg_finish_kernel
  unsigned fin_n;                 // tiles listed for the finishing copy
  unsigned pass_n[RS_DIGITS];     // tiles listed for each digit's pass
  unsigned pass_tile[RS_DIGITS];  // the passes' tile counters
};

// an oversize bucket: keys [s, s + m), its tiles t0 .. t0 + tiles - 1 in the
// histogram's list, base[d] .. in digit d's (for its live digits), fbase ..
// in the finishing copy's
struct BsSeg {
  long long s, m;
  unsigned t0, tiles, live, done, fbase;
  unsigned base[RS_DIGITS];
};

// the scratch of a bucket sort of n keys: the plan, the shares' first
// bucket starts, the list, the tile lists (the histogram's, a digit's each,
// the copy's), the buckets' digit histograms, the tiles' status words
struct BsLayout {
  long long shares, gmax, tmax;
  size_t edges, segs, maps, hist, status, bytes;
};

static BsLayout bs_layout(long long n) {
  BsLayout l;
  auto up = [](size_t x) { return (x + 255) & ~(size_t)255; };
  l.shares = (n + BS_SHARE - 1) / BS_SHARE;
  l.gmax = n / (BS_CAP + 1) + 1;
  l.tmax = (n + RS_TILE - 1) / RS_TILE + l.gmax;
  size_t off = 256;
  l.edges = off;
  off += up(sizeof(long long) * (l.shares + 1));
  l.segs = off;
  off += up(sizeof(BsSeg) * l.gmax);
  l.maps = off;
  off += up(sizeof(unsigned) * (RS_DIGITS + 2) * l.tmax);
  l.hist = off;
  off += up(sizeof(unsigned) * RS_DIGITS * RS_RADIX * l.gmax);
  l.status = off;
  off += up(sizeof(unsigned long long) * RS_RADIX * l.tmax);
  l.bytes = off;
  return l;
}

// key i's bucket: its sign-flipped bits from L up (the bits above the used
// ones are equal in every key)
static __device__ __forceinline__ unsigned long long bs_bucket(const long long* keys, long long i,
                                                               int L) {
  return (((unsigned long long)__ldg(keys + i)) ^ RS_SIGN) >> L;
}

// the least q in [lo, hi) whose bucket is >= x (hi if none), the buckets
// ascending along q: one warp (all lanes) probes 32 places a step
static __device__ long long bs_search(const long long* keys, int L, unsigned long long x,
                                      long long lo, long long hi) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const long long span = hi - lo;
    const long long m = span <= 32 ? lo + lane : lo + span * lane / 32;
    const bool pred = m < hi && bs_bucket(keys, m, L) < x;  // true, then false
    const int t = __popc(__ballot_sync(RS_FULL, pred));
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

// E[e]: the first bucket start at or after share e's first key (a warp an
// edge); E[0] = 0, E[shares] = n; the plan zeroed
__global__ void __launch_bounds__(256)
    bs_edge_kernel(const long long* __restrict__ keys, long long n, int L, long long shares,
                   long long* __restrict__ E, BsPlan* __restrict__ plan) {
  const long long e = ((long long)blockIdx.x * 256 + threadIdx.x) >> 5;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *plan = BsPlan{};
    E[0] = 0;
    E[shares] = n;
  }
  if (e == 0 || e >= shares) return;  // the whole warp
  const long long p = e * BS_SHARE;
  const unsigned long long b = bs_bucket(keys, p, L);
  const long long q = bs_bucket(keys, p - 1, L) != b ? p : bs_search(keys, L, b + 1, p + 1, n);
  if ((threadIdx.x & 31) == 0) E[e] = q;
}

// the round's slot of its key i
static __device__ __forceinline__ int bs_pad(int i) { return i + (i >> 4); }

// One round of K24: the m keys at a (and their payload: pay_mode 0 none, 1
// pay_in, 2 the index idx[i] or i) sorted by their whole key, stably, into
// keys_out and pay_out at a (see the K24 header). L >= 0: the round holds
// whole buckets of the keys' bits from L up, which it may rank; L < 0 (the
// block route): keys in any order, merged.
template <bool ROWS>
static __device__ __forceinline__ void bs_round(const RsSrc& src, const int32_t* pay_in,
                                                int pay_mode, long long a, int m, int L,
                                                long long* keys_out, void* pay_out, bool wide,
                                                unsigned long long* sK, int32_t* sP) {
  __shared__ unsigned s_starts;  // the round's bucket starts
  if (m <= 0) return;
  const bool pay = pay_mode != 0;
  if (threadIdx.x == 0) s_starts = 0;
  {
    unsigned long long u[BS_IPT];
    int32_t v[BS_IPT];
#pragma unroll
    for (int q = 0; q < BS_IPT; ++q) {
      const int i = threadIdx.x + q * BS_THREADS;
      u[q] = 0;
      v[q] = 0;
      if (i < m) {
        u[q] = rs_ukey<ROWS>(src, a + i);
        if (pay_mode == 1)
          v[q] = __ldg(pay_in + a + i);
        else if (pay_mode == 2)
          v[q] = (int32_t)(src.idx ? __ldg(src.idx + a + i) : a + i);
      }
    }
#pragma unroll
    for (int q = 0; q < BS_IPT; ++q) {
      const int i = threadIdx.x + q * BS_THREADS;
      if (i < m) {
        sK[bs_pad(i)] = u[q];
        if (pay) sP[bs_pad(i)] = v[q];
      }
    }
  }
  __syncthreads();
  // ranked where no bucket holds more than BS_RANK keys (key i's bucket is
  // not key i + BS_RANK's) and the buckets hold BS_DENSE keys or fewer on
  // average (a rank costs a pass over the key's bucket; merges, about
  // log2(m) steps whatever the buckets)
  bool big = L < 0;
  unsigned starts = 0;
#pragma unroll
  for (int q = 0; q < BS_IPT; ++q) {
    const int i = threadIdx.x + q * BS_THREADS;
    if (!big && i < m) {
      const unsigned long long b = sK[bs_pad(i)] >> L;
      if (i + BS_RANK < m) big = b == (sK[bs_pad(i + BS_RANK)] >> L);
      starts += i == 0 || b != (sK[bs_pad(i - 1)] >> L);
    }
  }
  starts = __reduce_add_sync(RS_FULL, starts);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s_starts, starts);
  big = __syncthreads_or(big);
  if (!big && m <= BS_DENSE * s_starts) {
    // the rank route: key i to its bucket's first place + its rank there
    int d[BS_IPT];
    unsigned long long x[BS_IPT];
    int32_t v[BS_IPT];
#pragma unroll
    for (int q = 0; q < BS_IPT; ++q) {
      const int i = threadIdx.x + q * BS_THREADS;
      d[q] = -1;
      x[q] = 0;
      v[q] = 0;
      if (i < m) {
        x[q] = sK[bs_pad(i)];
        if (pay) v[q] = sP[bs_pad(i)];
        const unsigned long long b = x[q] >> L;
        int lo = i;
        while (lo > 0 && (sK[bs_pad(lo - 1)] >> L) == b) --lo;
        int r = 0;
        for (int j = lo; j < m; ++j) {
          const unsigned long long y = sK[bs_pad(j)];
          if ((y >> L) != b) break;
          r += y < x[q] || (y == x[q] && j < i);
        }
        d[q] = lo + r;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < BS_IPT; ++q) {
      if (d[q] >= 0) {
        sK[bs_pad(d[q])] = x[q];
        if (pay) sP[bs_pad(d[q])] = v[q];
      }
    }
  } else {
    const int o = threadIdx.x * BS_IPT;
    unsigned long long k[BS_IPT];
    int32_t p[BS_IPT];
#pragma unroll
    for (int q = 0; q < BS_IPT; ++q) {
      k[q] = o + q < m ? sK[bs_pad(o + q)] : ~0ull;  // past m: the largest, and stays last
      p[q] = pay && o + q < m ? sP[bs_pad(o + q)] : 0;
    }
#pragma unroll
    for (int r = 0; r < BS_IPT; ++r) {
#pragma unroll
      for (int q = r & 1; q + 1 < BS_IPT; q += 2) {
        if (k[q] > k[q + 1]) {
          const unsigned long long tk = k[q];
          k[q] = k[q + 1];
          k[q + 1] = tk;
          const int32_t tp = p[q];
          p[q] = p[q + 1];
          p[q + 1] = tp;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < BS_IPT; ++q) {
      if (o + q < m) {
        sK[bs_pad(o + q)] = k[q];
        if (pay) sP[bs_pad(o + q)] = p[q];
      }
    }
    __syncthreads();
    for (int R = BS_IPT; R < m; R <<= 1) {
      int cnt = 0;  // outputs this thread merged
      if (o < m) {
        const int ps = o & ~(2 * R - 1), na = min(R, m - ps), nb = min(R, m - ps - R);
        if (nb > 0 && sK[bs_pad(ps + R - 1)] > sK[bs_pad(ps + R)]) {
          const int diag = o - ps;
          cnt = min(BS_IPT, na + nb - diag);
          // the thread's start, A's keys among the pair's first diag
          // outputs: the least i with A[i] > B[diag - 1 - i]
          int lo = max(0, diag - nb), hi = min(diag, na);
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (sK[bs_pad(ps + mid)] <= sK[bs_pad(ps + R + diag - 1 - mid)])
              lo = mid + 1;
            else
              hi = mid;
          }
          int i = lo, j = diag - lo;
          unsigned long long ka = i < na ? sK[bs_pad(ps + i)] : 0ull;
          unsigned long long kb = j < nb ? sK[bs_pad(ps + R + j)] : 0ull;
          int32_t pa = pay && i < na ? sP[bs_pad(ps + i)] : 0;
          int32_t pb = pay && j < nb ? sP[bs_pad(ps + R + j)] : 0;
#pragma unroll
          for (int q = 0; q < BS_IPT; ++q) {
            if (q < cnt) {
              const bool ta = j >= nb || (i < na && ka <= kb);
              k[q] = ta ? ka : kb;
              p[q] = ta ? pa : pb;
              if (ta) {
                if (++i < na) {
                  ka = sK[bs_pad(ps + i)];
                  if (pay) pa = sP[bs_pad(ps + i)];
                }
              } else if (++j < nb) {
                kb = sK[bs_pad(ps + R + j)];
                if (pay) pb = sP[bs_pad(ps + R + j)];
              }
            }
          }
        }
      }
      // a pair within a warp's 32 BS_IPT outputs needs only the warp's barrier
      if (2 * R <= 32 * BS_IPT)
        __syncwarp();
      else
        __syncthreads();
#pragma unroll
      for (int q = 0; q < BS_IPT; ++q) {
        if (q < cnt) {
          sK[bs_pad(o + q)] = k[q];
          if (pay) sP[bs_pad(o + q)] = p[q];
        }
      }
      if (4 * R <= 32 * BS_IPT)  // the next level's pairs also in the warp
        __syncwarp();
      else
        __syncthreads();
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += BS_THREADS) {
    keys_out[a + i] = (long long)(sK[bs_pad(i)] ^ RS_SIGN);
    if (pay) {
      if (wide)
        reinterpret_cast<long long*>(pay_out)[a + i] = sP[bs_pad(i)];
      else
        reinterpret_cast<int32_t*>(pay_out)[a + i] = sP[bs_pad(i)];
    }
  }
}

// K24: block b sorts the buckets that start in share b (E: the shares'
// first bucket starts) in one or two rounds and lists an oversize last
// bucket for K25; with E null, one block sorts all n <= BS_CAP keys of the
// source (the block route). Dynamic shared memory: BS_SLOTS keys, then
// BS_SLOTS int32 payload values.
template <bool ROWS>
__global__ void __launch_bounds__(BS_THREADS, 1)
    bs_bucket_kernel(const RsSrc src, const int32_t* __restrict__ pay_in, int pay_mode,
                     long long n, int L, const long long* __restrict__ E,
                     long long* __restrict__ keys_out, void* __restrict__ pay_out, int wide,
                     BsPlan* plan, BsSeg* segs, unsigned* tilemap, unsigned* seghist) {
  extern __shared__ __align__(16) unsigned char bs_smem[];
  unsigned long long* sK = reinterpret_cast<unsigned long long*>(bs_smem);
  int32_t* sP = reinterpret_cast<int32_t*>(bs_smem + BS_SLOTS * sizeof(unsigned long long));
  __shared__ long long s_last;
  __shared__ unsigned s_seg[2];
  long long s = 0, e = n;
  if (E) {
    s = E[blockIdx.x];
    e = E[blockIdx.x + 1];
  }
  if (s >= e) return;  // no bucket starts in the share
  long long cut = e;   // the rounds: [s, cut), then [cut, e)
  if (e - s > BS_CAP) {
    // the start of the last bucket (the buckets before it lie in the share)
    if (threadIdx.x < 32) {
      const long long q = bs_search(src.keys, L, bs_bucket(src.keys, e - 1, L), s, e - 1);
      if (threadIdx.x == 0) s_last = q;
    }
    __syncthreads();
    cut = s_last;
    if (e - cut > BS_CAP) {
      const long long m = e - cut;
      const unsigned tiles = (unsigned)((m + RS_TILE - 1) / RS_TILE);
      if (threadIdx.x == 0) {
        const unsigned g = atomicAdd(&plan->G, 1u);
        const unsigned t0 = atomicAdd(&plan->T, tiles);
        BsSeg sg = {};
        sg.s = cut;
        sg.m = m;
        sg.t0 = t0;
        sg.tiles = tiles;
        segs[g] = sg;
        s_seg[0] = g;
        s_seg[1] = t0;
      }
      __syncthreads();
      for (unsigned t = threadIdx.x; t < tiles; t += BS_THREADS) tilemap[s_seg[1] + t] = s_seg[0];
      unsigned* h = seghist + (size_t)s_seg[0] * RS_DIGITS * RS_RADIX;
      for (int t = threadIdx.x; t < RS_DIGITS * RS_RADIX; t += BS_THREADS) h[t] = 0;
      e = cut;
    }
  }
  for (int r = 0; r < 2; ++r) {
    const long long a = r ? cut : s, m = r ? e - cut : cut - s;
    if (r && m > 0) __syncthreads();  // the first round's write-out read sK and sP
    bs_round<ROWS>(src, pay_in, pay_mode, a, (int)m, E ? L : -1, keys_out, pay_out, wide != 0,
                   sK, sP);
  }
}

// K25: the listed buckets' digit histograms (a grid of resident blocks, a
// tile at a time; each tile's status words zeroed for the passes). The
// block that counts a bucket's last tile finds its live digits and lists
// its tiles for their passes (pmap, a row of tmax a digit) and, with an
// even number of them, for the copy (fmap).
__global__ void __launch_bounds__(RS_THREADS)
    bs_seg_hist_kernel(const long long* __restrict__ keys, int digits, long long tmax,
                       BsPlan* plan, BsSeg* segs, const unsigned* __restrict__ tilemap,
                       unsigned* pmap, unsigned* fmap, unsigned* seghist,
                       unsigned long long* status) {
  __shared__ unsigned s_h[RS_DIGITS * RS_RADIX];
  __shared__ unsigned s_t, s_last, s_base[RS_DIGITS + 1];
  const unsigned T = plan->T;
  for (;;) {
    if (threadIdx.x == 0) s_t = atomicAdd(&plan->hist_tile, 1u);
    for (int t = threadIdx.x; t < digits * RS_RADIX; t += RS_THREADS) s_h[t] = 0;
    __syncthreads();
    const unsigned t = s_t;
    if (t >= T) return;
    const unsigned g = tilemap[t];
    const BsSeg sg = segs[g];
    const long long k = t - sg.t0, base = sg.s + k * RS_TILE;
    const int tn = (int)(sg.m - k * RS_TILE < RS_TILE ? sg.m - k * RS_TILE : RS_TILE);
    status[(long long)t * RS_RADIX + threadIdx.x] = 0;
    for (int i0 = threadIdx.x & ~31; i0 < tn; i0 += RS_THREADS) {
      const int i = i0 + (threadIdx.x & 31);
      rs_count_keys(s_h, i < tn ? (unsigned long long)__ldg(keys + base + i) ^ RS_SIGN : 0ull,
                    i < tn, digits);
    }
    __syncthreads();
    unsigned* h = seghist + (size_t)g * RS_DIGITS * RS_RADIX;
    for (int j = threadIdx.x; j < digits * RS_RADIX; j += RS_THREADS)
      if (s_h[j]) atomicAdd(h + j, s_h[j]);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(&segs[g].done, 1u) == sg.tiles - 1;
    __syncthreads();
    if (s_last) {  // every tile of the bucket counted
      __threadfence();
      unsigned live = 0;
      for (int d = 0; d < digits; ++d)
        if (!__syncthreads_or((long long)__ldcg(h + d * RS_RADIX + threadIdx.x) == sg.m))
          live |= 1u << d;
      if (threadIdx.x == 0) {
        segs[g].live = live;
        for (int d = 0; d < digits; ++d)
          if ((live >> d) & 1u) segs[g].base[d] = s_base[d] = atomicAdd(&plan->pass_n[d], sg.tiles);
        if (!(__popc(live) & 1)) segs[g].fbase = s_base[RS_DIGITS] = atomicAdd(&plan->fin_n, sg.tiles);
      }
      __syncthreads();
      for (int d = 0; d <= RS_DIGITS; ++d) {
        if (d < RS_DIGITS ? d < digits && ((live >> d) & 1u) : !(__popc(live) & 1)) {
          unsigned* map = d < RS_DIGITS ? pmap + d * tmax : fmap;
          for (unsigned q = threadIdx.x; q < sg.tiles; q += RS_THREADS) map[s_base[d] + q] = g;
        }
      }
    }
    __syncthreads();
  }
}

// K25: the pass over `digit` of the tiles listed for it (see the K25
// header). Pass j of a bucket (its j-th live digit) reads buf1 and pay1 when
// j is even, buf0 and pay0 when odd, and writes the other; its last pass
// writes the payload to pay_final (int64 when wide).
template <int IN>
__global__ void __launch_bounds__(RS_THREADS, RS_MINB)
    bs_seg_pass_kernel(long long* buf0, long long* buf1, int32_t* pay0, int32_t* pay1,
                       void* pay_final, int wide, int digit, BsPlan* plan,
                       const BsSeg* __restrict__ segs, const unsigned* __restrict__ map,
                       const unsigned* __restrict__ seghist, unsigned long long* status) {
  extern __shared__ __align__(16) unsigned char rs_smem[];
  __shared__ long long s_off[RS_RADIX];
  __shared__ unsigned s_part[RS_WARPS];
  __shared__ unsigned s_t;
  const unsigned T = plan->pass_n[digit];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (;;) {
    if (threadIdx.x == 0) s_t = atomicAdd(&plan->pass_tile[digit], 1u);
    __syncthreads();
    const unsigned c = s_t;
    if (c >= T) return;
    const unsigned g = map[c];
    const BsSeg sg = segs[g];
    const int j = __popc(sg.live & ((1u << digit) - 1u));
    const bool last = j == __popc(sg.live) - 1;
    // the bucket's offsets of the digit: the exclusive scan of its counts
    const unsigned cnt = seghist[(size_t)g * RS_DIGITS * RS_RADIX + digit * RS_RADIX + threadIdx.x];
    unsigned x = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(RS_FULL, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) s_part[warp] = x;
    __syncthreads();
    unsigned before = 0;
    for (int w = 0; w < warp; ++w) before += s_part[w];
    s_off[threadIdx.x] = sg.s + (long long)(before + x - cnt);
    __syncthreads();
    const long long k = c - sg.base[digit], base = sg.s + k * RS_TILE;
    const int tn = (int)(sg.m - k * RS_TILE < RS_TILE ? sg.m - k * RS_TILE : RS_TILE);
    const RsSrc src{j & 1 ? buf0 : buf1, nullptr, nullptr, 0};
    void* pout = last ? pay_final : (void*)(j & 1 ? pay1 : pay0);
    rs_tile<false, IN, true>(src, j & 1 ? pay0 : pay1, c, sg.base[digit], base, tn,
                             RS_BITS * digit, s_off, j & 1 ? buf1 : buf0, pout, last && wide,
                             status, (unsigned)digit + 1, rs_smem);
    __syncthreads();
  }
}

// K25: the tiles listed for the copy (a bucket with an even number of live
// digits lies in buf1): keys into buf0, and with no pass, the payload from
// pay1 into pay_final
template <int IN>
__global__ void __launch_bounds__(RS_THREADS)
    bs_seg_finish_kernel(long long* buf0, const long long* __restrict__ buf1,
                         const int32_t* __restrict__ pay1, void* pay_final, int wide,
                         BsPlan* plan, const BsSeg* __restrict__ segs,
                         const unsigned* __restrict__ map) {
  __shared__ unsigned s_t;
  const unsigned T = plan->fin_n;
  for (;;) {
    if (threadIdx.x == 0) s_t = atomicAdd(&plan->fin_tile, 1u);
    __syncthreads();
    const unsigned c = s_t;
    if (c >= T) return;
    const BsSeg sg = segs[map[c]];
    const long long k = c - sg.fbase, base = sg.s + k * RS_TILE;
    const int tn = (int)(sg.m - k * RS_TILE < RS_TILE ? sg.m - k * RS_TILE : RS_TILE);
    for (int i = threadIdx.x; i < tn; i += RS_THREADS) {
      buf0[base + i] = buf1[base + i];
      if (IN != RS_IN_NONE && !sg.live) {
        if (wide)
          reinterpret_cast<long long*>(pay_final)[base + i] = pay1[base + i];
        else
          reinterpret_cast<int32_t*>(pay_final)[base + i] = pay1[base + i];
      }
    }
    __syncthreads();
  }
}

static constexpr size_t BS_SMEM = BS_SLOTS * (sizeof(unsigned long long) + sizeof(int32_t));

// The scratch bytes lt_radix_buckets takes for n keys, into *bytes.
extern "C" int lt_radix_bucket_scratch(long long n, void* bytes) {
  if (n <= BS_CAP || !bytes) return (int)cudaErrorInvalidValue;
  *(long long*)bytes = (long long)bs_layout(n).bytes;
  return (int)cudaSuccess;
}

template <int IN>
static int bs_seg_launch(long long* k0, long long* k1, void* pay0, const void* pay,
                         void* pay_final, int wide, int digits, const BsLayout& l, BsPlan* plan,
                         BsSeg* segs, unsigned* maps, unsigned* hist,
                         unsigned long long* status, cudaStream_t st) {
  constexpr size_t smem = RS_TILE * (sizeof(long long) + (IN == RS_IN_NONE ? 0 : sizeof(int32_t)));
  int blocks = 0;
  LT_TRY(cudaFuncSetAttribute(bs_seg_pass_kernel<IN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  LT_TRY(resident_blocks(bs_seg_pass_kernel<IN>, RS_THREADS, &blocks, 1 << 30, smem));
  const unsigned grid = (unsigned)(blocks < l.tmax ? blocks : l.tmax);
  for (int d = 0; d < digits; ++d) {
    bs_seg_pass_kernel<IN><<<grid, RS_THREADS, smem, st>>>(
        k0, k1, (int32_t*)pay0, (int32_t*)pay, pay_final, wide, d, plan, segs,
        maps + (size_t)(d + 1) * l.tmax, hist, status);
    LT_TRY(cudaGetLastError());
  }
  LT_TRY(resident_blocks(bs_seg_finish_kernel<IN>, RS_THREADS, &blocks));
  bs_seg_finish_kernel<IN><<<(unsigned)(blocks < l.tmax ? blocks : l.tmax), RS_THREADS, 0, st>>>(
      k0, k1, (const int32_t*)pay, pay_final, wide, plan, segs,
      maps + (size_t)(RS_DIGITS + 1) * l.tmax);
  return (int)cudaGetLastError();
}

// K24 and K25 after the bucket route's passes (lt_radix_pass over digits 0 ..
// bbits / 8 - 1 at base bits - bbits): the n keys (BS_CAP < n < 2**31)
// grouped by bucket (their top bbits = 16 or 24 of the low `bits` bits),
// stably, in keys (buf1), with their int32 payload pay (or null),
// sorted into out (buf0), the payload into pay_final (int64 when wide, else
// int32). keys and pay0 (int32, n) are the oversize buckets' scratch.
// scratch: lt_radix_bucket_scratch(n) bytes, 256-byte aligned.
extern "C" int lt_radix_buckets(void* keys, const void* pay, long long n, int bits, int bbits,
                                void* out, void* pay0, void* pay_final, int wide, void* scratch,
                                long long scratch_bytes, void* stream) {
  if (n <= BS_CAP || n >= (1ll << 31) || (bbits != 16 && bbits != 24) || bits <= bbits ||
      bits > 64 || !keys || !out || !scratch || (pay && (!pay0 || !pay_final)))
    return (int)cudaErrorInvalidValue;
  const BsLayout l = bs_layout(n);
  if (scratch_bytes < (long long)l.bytes) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  char* sc = (char*)scratch;
  BsPlan* plan = (BsPlan*)sc;
  long long* E = (long long*)(sc + l.edges);
  BsSeg* segs = (BsSeg*)(sc + l.segs);
  unsigned* maps = (unsigned*)(sc + l.maps);  // the histogram's, a digit's each, the copy's
  unsigned* hist = (unsigned*)(sc + l.hist);
  unsigned long long* status = (unsigned long long*)(sc + l.status);
  const int L = bits - bbits, digits = (L + RS_BITS - 1) / RS_BITS;
  long long* k1 = (long long*)keys;
  long long* k0 = (long long*)out;
  bs_edge_kernel<<<(unsigned)((l.shares * 32 + 255) / 256), 256, 0, st>>>(k1, n, L, l.shares,
                                                                         E, plan);
  LT_TRY(cudaGetLastError());
  LT_TRY(cudaFuncSetAttribute(bs_bucket_kernel<false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BS_SMEM));
  bs_bucket_kernel<false><<<(unsigned)l.shares, BS_THREADS, BS_SMEM, st>>>(
      RsSrc{k1, nullptr, nullptr, 0}, (const int32_t*)pay, pay ? 1 : 0, n, L, E, k0, pay_final,
      wide, plan, segs, maps, hist);
  LT_TRY(cudaGetLastError());
  int blocks = 0;
  LT_TRY(resident_blocks(bs_seg_hist_kernel, RS_THREADS, &blocks));
  bs_seg_hist_kernel<<<(unsigned)(blocks < l.tmax ? blocks : l.tmax), RS_THREADS, 0, st>>>(
      k1, digits, l.tmax, plan, segs, maps, maps + l.tmax, maps + (size_t)(RS_DIGITS + 1) * l.tmax,
      hist, status);
  LT_TRY(cudaGetLastError());
  if (pay)
    return bs_seg_launch<RS_IN_I32>(k0, k1, pay0, pay, pay_final, wide, digits, l, plan, segs,
                                    maps, hist, status, st);
  return bs_seg_launch<RS_IN_NONE>(k0, k1, nullptr, nullptr, nullptr, 0, digits, l, plan, segs,
                                   maps, hist, status, st);
}

// The block route: K24 alone, one block sorting all n (1 <= n <= BS_CAP) keys
// of the source (keys, or the top 64 bits of rows[idx[i]] / rows[i]) with
// their payload (pay_mode 0 none, 1 int32 pay_in, 2 the index idx[i] or i;
// rows take 0 or 2) into keys_out and pay_out (int64 when wide, else int32).
extern "C" int lt_radix_block(const void* keys, const void* rows, int W, const void* idx,
                              const void* pay_in, int pay_mode, long long n, void* keys_out,
                              void* pay_out, int wide, void* stream) {
  if (!rs_src_ok(keys, rows, W, n) || n < 1 || n > BS_CAP || pay_mode < 0 || pay_mode > 2 ||
      (rows && pay_mode == 1) || !keys_out || (pay_mode && !pay_out) ||
      (pay_mode == 1 && !pay_in))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const RsSrc src = rs_src(keys, rows, W, idx);
  if (rows) {
    LT_TRY(cudaFuncSetAttribute(bs_bucket_kernel<true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BS_SMEM));
    bs_bucket_kernel<true><<<1, BS_THREADS, BS_SMEM, st>>>(
        src, (const int32_t*)pay_in, pay_mode, n, 0, nullptr, (long long*)keys_out, pay_out,
        wide, nullptr, nullptr, nullptr, nullptr);
  } else {
    LT_TRY(cudaFuncSetAttribute(bs_bucket_kernel<false>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BS_SMEM));
    bs_bucket_kernel<false><<<1, BS_THREADS, BS_SMEM, st>>>(
        src, (const int32_t*)pay_in, pay_mode, n, 0, nullptr, (long long*)keys_out, pay_out,
        wide, nullptr, nullptr, nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}

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
