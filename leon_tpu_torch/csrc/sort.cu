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
// payload), which the port first ran as torch.sort: DeviceCounter's slab and
// merge, the WordCounter's top sorts (sort_slab, sort_rows), count_batch's
// top_sort and _tie_rounds (ops/count.py).
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
