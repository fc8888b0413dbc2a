// K1 kmer_scan — canonical k-mer keys of a packed read batch, written
// straight into the count slab; K13 kmer_scan_words (below) — the same
// scan to W u32 words per k-mer, k <= 255.
//
// Replaces: leon_tpu/ops/kmer.py kmer_scan_packed -> unpack_codes_dev,
// _kmer_scan_impl (a lax.scan over base columns producing (B, P, W) u32
// words plus is_rc/valid masks).
//
// Bound on the H100: device-memory bytes written, 8 per position (the
// packed input is 1/32 of that). The reference's (B, P, W) words and masks
// are never materialised: out[read * P + p] gets min(fwd, rc) as one
// int64 key (k <= 31), or INT64_MAX for p > len - k. Design (K17's, below,
// over dense rows): one thread per output key, cut from the packed bits
// with no roll. The k-mer at p is the 2k <= 62-bit field x from bit 2p of
// the read's row (base p lowest; two funnel shifts over words p/16 .. +2,
// which the lanes of a warp share through L1); its reverse complement is
// ~x masked to 2k bits, and the forward key is x with its 32 2-bit groups
// reversed (rev2 of each half, halves swapped) shifted right by 64 - 2k.
// A block takes K1_KEYS / P whole reads, so their keys are one contiguous
// range of out, and its threads walk that range: every store instruction
// of a warp writes 32 consecutive int64s (a thread per read wrote 8 bytes
// P * 8 bytes apart, one sector a lane, and ran a chain of L steps). The
// stores are marked streaming (evict first): the slab is sorted only once
// it is full, far past L2 (14% faster than plain stores at one chunk).
#include "common.cuh"
#include "kmer_words.cuh"

// the 16 2-bit groups of x in reverse order
static __device__ __forceinline__ uint32_t rev2(uint32_t x) {
  const uint32_t r = __brev(x);
  return ((r >> 1) & 0x55555555u) | ((r & 0x55555555u) << 1);
}

#define K1_THREADS 256
#define K1_KEYS 2048  // keys a block writes (whole reads: at least one read)

__global__ void __launch_bounds__(K1_THREADS)
    kmer_scan_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ lengths,
                     int B, int L16, int k, int P, int R, int64_t* __restrict__ out) {
  const long long r0 = (long long)blockIdx.x * R;
  const int n = (int)min((long long)R, (long long)B - r0) * P;  // the block's keys
  const uint32_t* rows = packed + r0 * L16;
  const int32_t* lens = lengths + r0;
  int64_t* o = out + r0 * P;
  const int t = threadIdx.x;
  // key i of the block is (read r, position p), i = r * P + p; a step of
  // K1_THREADS keys is dr reads and dp positions
  const int dr = K1_THREADS / P, dp = K1_THREADS - dr * P;
  int r = t / P, p = t - r * P;
  const uint64_t kmask = (1ull << (2 * k)) - 1;
  const int s = 64 - 2 * k;  // the reversed field's shift, 2..62
  for (int i = t; i < n; i += K1_THREADS) {
    int64_t v = LT_SENTINEL;
    if (p <= __ldg(lens + r) - k) {
      const uint32_t* row = rows + (size_t)r * L16;
      const int a = p >> 4, sh = 2 * (p & 15);
      // words past the row hold no base of this k-mer: read as 0
      const uint32_t w0 = __ldg(row + a);
      const uint32_t w1 = a + 1 < L16 ? __ldg(row + a + 1) : 0u;
      const uint32_t w2 = a + 2 < L16 ? __ldg(row + a + 2) : 0u;
      const uint32_t lo = __funnelshift_r(w0, w1, sh), hi = __funnelshift_r(w1, w2, sh);
      const uint64_t rc = ~(((uint64_t)hi << 32) | lo) & kmask;
      const uint64_t fwd = (((uint64_t)rev2(lo) << 32) | rev2(hi)) >> s;
      v = (int64_t)(fwd < rc ? fwd : rc);
    }
    __stcs(reinterpret_cast<long long*>(o + i), (long long)v);
    p += dp;
    r += dr;
    if (p >= P) {
      p -= P;
      ++r;
    }
  }
}

extern "C" int lt_kmer_scan(const void* packed, const void* lengths, int B, int L16, int L,
                            int k, int P, void* out, void* stream) {
  if (k < 1 || k > 31 || P < 1 || P != L - k + 1 || L16 != (L + 15) / 16)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  const int R = max(1, K1_KEYS / P);  // reads a block takes
  kmer_scan_kernel<<<(unsigned)((B + R - 1) / R), K1_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)packed, (const int32_t*)lengths, B, L16, k, P, R, (int64_t*)out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K13 kmer_scan_words — every canonical k-mer of an unpacked read batch as
// W = ceil(k/16) u32 words (k <= 255, W <= 16), with its strand and
// validity.
//
// Replaces: leon_tpu/ops/kmer.py kmer_scan (129-138) -> _kmer_scan_impl
// (104-126): a lax.scan over base columns carrying (B, W) fwd/rc words
// (shl2 / shr2_ins), then canonical() = lex_less(rc, fwd) per position.
//
// Bound on the H100: device-memory bytes, (4W + 2) written per position
// against 1 read (the codes). The outputs cover every one of the P = L - k
// + 1 positions (the reference scans all L columns, so positions past a
// read's end hold the words of the bytes there); palindromes keep the
// forward strand.
//
// Design: one thread a position, the k-mer cut from the codes with no roll.
// A block takes a job whose outputs are one contiguous range: R whole reads
// (P <= K13_POS: R = K13_POS / P, fewer where their packed codes would pass
// K13_CODE_WORDS), or K13_POS positions of one read. It loads the job's code
// bytes coalesced (a thread 16 columns through aligned u32 loads) and packs
// them 16 to a u32 in shared memory (kmer.pack_codes_np's layout: byte & 3),
// beside a 16-bit mask a word of the columns whose byte is above 3. Each
// position's k-mer is then cut as K17 cuts it (two funnel shifts a word over
// the packed words, ~x as the reverse complement, rev2 for the forward
// strand; the lesser, MSW first) into a tile of rows staged in shared
// memory at an odd word stride, and the block copies the tile out as three
// contiguous ranges (canon words, is_rc and valid bytes) in 16-byte
// streaming stores. (A thread a read rolled its k-mer through all L columns,
// a chain of L dependent steps of O(W) work, and 64-thread blocks stored a
// tile of 8-32 positions between two barriers.)
//
// Dirty bytes. The reference rolls u32 words, so a code byte b > 3 leaks past
// its two bits. In fwd = ((fwd << 2) | b) mod 2^2k the bits of b above bit 1
// land on the bases before it and are masked at 2k: b reaches only the
// windows that hold it. In rc = (rc >> 2) | ((3 - b) mod 2^32) << 2(k - 1),
// unmasked, 3 - b wraps, so its bits above bit 1 fill the top word up to bit
// 32W - 1 and shift down two a column: b at column i reaches every position
// whose window ends at a column j with i <= j <= i + 16W - 1, that is up to
// 16W - k (0..15) positions past the last window that holds it. So the cut
// is exact at a position p (window ending at j = p + k - 1) where no byte
// above 3 lies in columns [j - 16W + 1, j]. Where one does, the position's
// thread rolls the reference's u32 arithmetic (shl2, shr2_ins) over those
// columns from a zero state, reading the raw bytes: exact for any byte, as a
// byte in an earlier column is masked out of fwd and shifted out of rc by j.
// A job with no byte above 3 skips the check.
// ---------------------------------------------------------------------------

#define K13_THREADS 256
#define K13_POS 2048         // positions a job takes at most
#define K13_CODE_WORDS 2048  // packed code words a job holds (8 KB)

// positions a thread takes in a tile: the staged rows stay within 4-17 KB
__host__ __device__ constexpr int k13_items(int W) {
  return W == 1 ? 8 : W == 2 ? 4 : W <= 4 ? 2 : 1;
}

// 4 code bytes -> their 2-bit codes (byte e & 3 at bits 2e)
static __device__ __forceinline__ uint32_t pack4(uint32_t x) {
  uint32_t t = x & 0x03030303u;
  t |= t >> 6;
  return (t & 0xFu) | ((t >> 12) & 0xF0u);
}

// 4 code bytes -> bit e set where byte e is above 3
static __device__ __forceinline__ uint32_t dirty4(uint32_t x) {
  const uint32_t m = (((x >> 2) & 0x3F3F3F3Fu) + 0x7F7F7F7Fu) & 0x80808080u;
  return ((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) | ((m >> 28) & 8u);
}

// columns 16g .. 16g + 15 of a row of L code bytes (bytes past L read as 0):
// the packed word and the dirty mask. The bytes come in through the aligned
// u32 words that hold them (one to five), funnel-shifted into place.
static __device__ __forceinline__ void load16(const uint8_t* __restrict__ row, int L, int g,
                                              uint32_t* pk, uint32_t* dm) {
  const int nb = min(16, L - 16 * g);  // >= 1
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + 16 * g);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
  const int off = (int)(a & 3u), nw = (off + nb + 3) >> 2;
  uint32_t v[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) v[i] = i < nw ? __ldg(w + i) : 0u;
  uint32_t p = 0, d = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t x = __funnelshift_r(v[i], v[i + 1], 8 * off);
    const int keep = nb - 4 * i;  // bytes of x inside the row
    x = keep >= 4 ? x : keep <= 0 ? 0u : x & ((1u << (8 * keep)) - 1u);
    p |= pack4(x) << (8 * i);
    d |= dirty4(x) << (4 * i);
  }
  *pk = p;
  *dm = d;
}

// any byte above 3 in columns lo .. hi of a job's row (its dirty masks)
static __device__ __forceinline__ bool k13_dirty(const uint16_t* d, int lo, int hi) {
  for (int g = lo >> 4; g <= hi >> 4; ++g) {
    uint32_t m = d[g];
    if (g == lo >> 4) m &= 0xFFFFu << (lo & 15);
    if (g == hi >> 4) m &= 0xFFFFu >> (15 - (hi & 15));
    if (m) return true;
  }
  return false;
}

// the canonical k-mer whose window starts at bit-pair sh of w[0] (packed
// codes; w[W] may lie past the window), as K17 cuts it
template <int W>
static __device__ __forceinline__ Kmer<W> k13_cut(const uint32_t* w, int sh, int s, uint32_t top,
                                                  bool* take_rc) {
  uint32_t x[W];
  uint32_t lo = w[0];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t hi = w[i + 1];
    x[i] = __funnelshift_r(lo, hi, sh);
    lo = hi;
  }
  x[W - 1] &= top;
  Kmer<W> fwd, rc;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    rc.w[j] = ~x[j];
    fwd.w[j] = __funnelshift_r(rev2(x[W - 1 - j]), j + 1 < W ? rev2(x[W - 2 - j]) : 0u, s);
  }
  rc.w[W - 1] &= top;
  *take_rc = lex_less<W>(rc, fwd);
  return *take_rc ? rc : fwd;
}

// the reference's roll over code bytes row[lo .. j] from a zero state
template <int W>
static __device__ Kmer<W> k13_roll(const uint8_t* __restrict__ row, int lo, int j, int k,
                                   uint32_t top, bool* take_rc) {
  Kmer<W> fwd = {}, rc = {};
  for (int c = lo; c <= j; ++c) {
    const uint32_t b = __ldg(row + c);
    fwd = shl2<W>(fwd, b, top);
    rc = shr2_ins<W>(rc, 3u - b, k);
  }
  *take_rc = lex_less<W>(rc, fwd);
  return *take_rc ? rc : fwd;
}

// words [0, n) of a tile (word q of the tile at s[(q / W) * SW + q % W])
// to dst: the words before dst's first 16-byte boundary one by one, then
// 16-byte streaming stores, then the last words
template <int W, int SW>
static __device__ __forceinline__ uint32_t k13_staged(const uint32_t* s, int q) {
  return SW == W ? s[q] : s[(q / W) * SW + q % W];
}

template <int W, int SW>
static __device__ __forceinline__ void k13_copy_words(const uint32_t* s, uint32_t* dst, int n) {
  const int t = threadIdx.x;
  const unsigned mis = (unsigned)(reinterpret_cast<uintptr_t>(dst) & 15u);
  const int head = min(n, (int)(((16u - mis) & 15u) >> 2));
  if (t < head) __stcs(dst + t, k13_staged<W, SW>(s, t));
  const int body = (n - head) >> 2, tail = head + 4 * body;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int i = t; i < body; i += K13_THREADS) {
    const int q = head + 4 * i;
    __stcs(d4 + i, make_uint4(k13_staged<W, SW>(s, q), k13_staged<W, SW>(s, q + 1),
                              k13_staged<W, SW>(s, q + 2), k13_staged<W, SW>(s, q + 3)));
  }
  if (tail + t < n) __stcs(dst + tail + t, k13_staged<W, SW>(s, tail + t));
}

// bytes [0, n) of s (16-byte aligned) to dst, likewise
static __device__ __forceinline__ void k13_copy_bytes(const uint8_t* s, uint8_t* dst, int n) {
  const int t = threadIdx.x;
  const int head = min(n, (int)((16u - (unsigned)(reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u));
  if (t < head) dst[t] = s[t];
  const int body = (n - head) >> 4, tail = head + 16 * body;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int i = t; i < body; i += K13_THREADS) {
    const uint8_t* q = s + head + 16 * i;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = q[4 * j] | (q[4 * j + 1] << 8) | (q[4 * j + 2] << 16) | ((uint32_t)q[4 * j + 3] << 24);
    __stcs(d4 + i, make_uint4(v[0], v[1], v[2], v[3]));
  }
  if (tail + t < n) dst[tail + t] = s[tail + t];
}

// A job (block): CH == 0: reads [blockIdx.x R, + R), every position; else
// read blockIdx.x / CH, positions [K13_POS c, + K13_POS) for c =
// blockIdx.x mod CH.
template <int W>
__global__ void __launch_bounds__(K13_THREADS)
    kmer_scan_words_kernel(const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
                           int B, int L, int k, int P, uint32_t top, int R, int CH,
                           uint32_t* __restrict__ canon, uint8_t* __restrict__ is_rc,
                           uint8_t* __restrict__ valid) {
  constexpr int NT = K13_THREADS * k13_items(W);  // positions a tile
  constexpr int SW = W | 1;                       // staged row stride: odd, no bank conflicts
  __shared__ uint32_t s_code[K13_CODE_WORDS];
  __shared__ uint16_t s_dirty[K13_CODE_WORDS];
  __shared__ uint32_t s_rows[NT * SW];
  __shared__ __align__(16) uint8_t s_flags[2][NT];
  long long r0;
  int nr, p0, p1;
  if (CH == 0) {
    r0 = (long long)blockIdx.x * R;
    nr = (int)min((long long)R, (long long)B - r0);
    p0 = 0;
    p1 = P;
  } else {
    r0 = blockIdx.x / CH;
    nr = 1;
    p0 = (int)(blockIdx.x % CH) * K13_POS;
    p1 = min(P, p0 + K13_POS);
  }
  const int np = p1 - p0, n = nr * np;
  // a row's packed words [g0, ge) cover the columns the job's positions read
  // (the dirty reach included); one zero pad word follows them
  const int g0 = max(0, p0 + k - 16 * W) >> 4;
  const int nws = ((p1 + k - 1 + 15) >> 4) - g0 + 1;
  bool dirty = false;
  for (int it = threadIdx.x; it < nr * nws; it += K13_THREADS) {
    const int ri = it / nws, gi = it - ri * nws;
    uint32_t pk = 0, dm = 0;
    if (gi < nws - 1) load16(codes + (size_t)(r0 + ri) * L, L, g0 + gi, &pk, &dm);
    s_code[it] = pk;
    s_dirty[it] = (uint16_t)dm;
    dirty |= dm != 0;
  }
  const bool job_dirty = __syncthreads_or(dirty);
  const int s = 2 * (16 * W - k);  // the reversed field's shift, 0..30
  const long long o0 = r0 * P + p0;  // the job's first output position
  for (int t0 = 0; t0 < n; t0 += NT) {
    const int nt = min(NT, n - t0);
#pragma unroll
    for (int e = 0; e < k13_items(W); ++e) {
      const int f = threadIdx.x + e * K13_THREADS;  // the position's row in the tile
      if (f < nt) {
        const int ri = (t0 + f) / np, p = p0 + t0 + f - ri * np;
        const int j = p + k - 1, lo = max(0, j - 16 * W + 1);
        bool take_rc;
        Kmer<W> c;
        if (job_dirty && k13_dirty(s_dirty + ri * nws, lo - 16 * g0, j - 16 * g0))
          c = k13_roll<W>(codes + (size_t)(r0 + ri) * L, lo, j, k, top, &take_rc);
        else
          c = k13_cut<W>(s_code + ri * nws + (p >> 4) - g0, 2 * (p & 15), s, top, &take_rc);
#pragma unroll
        for (int w = 0; w < W; ++w) s_rows[f * SW + w] = c.w[w];
        s_flags[0][f] = take_rc;
        s_flags[1][f] = p <= __ldg(lengths + r0 + ri) - k;
      }
    }
    __syncthreads();
    const long long ob = o0 + t0;
    k13_copy_words<W, SW>(s_rows, canon + ob * W, nt * W);
    k13_copy_bytes(s_flags[0], is_rc + ob, nt);
    k13_copy_bytes(s_flags[1], valid + ob, nt);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K17 kmer_scan_halves — the canonical k-mers of a packed read batch's VALID
// positions only, compacted read-major, as the counter's P = ceil(W/2)
// sign-flipped int64 planes (17 <= k <= 255, W = 2..16; the main path takes
// it for 32 <= k <= 255).
//
// Replaces: leon_tpu/ops/kmer.py kmer_scan_packed (141) -> unpack_codes_dev,
// _kmer_scan_impl (104-126) at W = ceil(k/16) words, together with the
// valid-row selection the reference's slab sort does by masking.
//
// Bound on the H100: device-memory bytes written, 8P per valid position,
// against 1/4 byte per base read. Invalid rows are dropped, not marked: at
// k = 16W a canonical palindrome can carry an all-ones top word, so no key
// value is free to mark them. Read r's valid positions p = 0 .. len-k land
// at offs[r] + p (offs: the exclusive prefix of the per-read valid counts),
// so the outputs of consecutive reads are one contiguous range.
// Design: one thread per output k-mer, built from the packed bits with no
// roll. Base j of a read sits at bits 2(j mod 16) of word j/16
// (kmer.pack_codes_np), so the k-mer at p is the 2k-bit field x from bit 2p
// (base p lowest: W funnel shifts of neighbouring words, which the lanes of
// a warp share through L1); its reverse complement is ~x (base p + j
// complemented at bits 2j, FORMAT.md §3's order) and the forward k-mer is x
// with its 2-bit groups reversed (rev2 word by word, words in reverse
// order, then a right shift by 2(16W - k)); the canonical one is the lesser,
// MSW first. A block takes K17_READS consecutive reads and walks their
// output range [offs[r0], offs[r0 + K17_READS]) with its threads, each
// finding its read by stepping forward through the block's offsets, so
// every store instruction of a warp writes 32 consecutive int64s of a plane
// and a chunk offers one thread per valid position (a roll along the read ran
// one thread per read through a chain of L steps).
// ---------------------------------------------------------------------------

#define K17_THREADS 256
#define K17_READS 16  // reads a block takes

template <int W>
__global__ void __launch_bounds__(K17_THREADS)
    kmer_scan_halves_kernel(const uint32_t* __restrict__ packed,
                            const int32_t* __restrict__ lengths,
                            const long long* __restrict__ offs, int B, int L16, int k, int P,
                            uint32_t top, const __grid_constant__ PlanePtrs out) {
  constexpr int NH = (W + 1) / 2;  // int64 planes per k-mer
  __shared__ long long s_off[K17_READS + 1];
  const int r0 = blockIdx.x * K17_READS;
  const int nr = min(K17_READS, B - r0);
  const int t = threadIdx.x;
  if (t < nr) {
    s_off[t] = offs[r0 + t];
    if (t == nr - 1) s_off[nr] = s_off[t] + min(max(lengths[r0 + t] - k + 1, 0), P);
  }
  __syncthreads();
  const long long end = s_off[nr];
  const int s = 2 * (16 * W - k);  // the reversed field's shift, 0..30
  const unsigned long long sign = 1ull << 63;
  int ri = 0;
  for (long long o = s_off[0] + t; o < end; o += K17_THREADS) {
    while (o >= s_off[ri + 1]) ++ri;
    const int p = (int)(o - s_off[ri]);
    const uint32_t* row = packed + (size_t)(r0 + ri) * L16;
    const int a = p >> 4, sh = 2 * (p & 15);
    uint32_t x[W];  // the 2k bits from bit 2p; word a + W may lie past the row
    uint32_t lo = __ldg(row + a);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint32_t hi = i + 1 < W || a + W < L16 ? __ldg(row + a + i + 1) : 0u;
      x[i] = __funnelshift_r(lo, hi, sh);
      lo = hi;
    }
    x[W - 1] &= top;
    Kmer<W> fwd, rc;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      rc.w[j] = ~x[j];
      fwd.w[j] = __funnelshift_r(rev2(x[W - 1 - j]), j + 1 < W ? rev2(x[W - 2 - j]) : 0u, s);
    }
    rc.w[W - 1] &= top;
    const Kmer<W> c = lex_less<W>(rc, fwd) ? rc : fwd;
#pragma unroll
    for (int h = 0; h < NH; ++h)
      out.p[h][o] =
          (int64_t)((((unsigned long long)word_or_zero<W>(c, 2 * h + 1) << 32) | c.w[2 * h]) ^
                    sign);
  }
}

// planes: the host array of n_planes = ceil(W/2) output pointers
extern "C" int lt_kmer_scan_halves(const void* packed, const void* lengths, const void* offs,
                                   int B, int L16, int L, int k, int P, unsigned top,
                                   int n_planes, const void* planes, void* stream) {
  if (k < 17 || k > 255 || P < 1 || P != L - k + 1 || L16 != (L + 15) / 16)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  const int W = (k + 15) / 16;
  PlanePtrs out;
  if (n_planes != (W + 1) / 2 || !load_planes(planes, n_planes, &out))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((B + K17_READS - 1) / K17_READS);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* p = (const uint32_t*)packed;
  const int32_t* ln = (const int32_t*)lengths;
  const long long* of = (const long long*)offs;
#define LAUNCH(W_) \
  kmer_scan_halves_kernel<W_><<<grid, K17_THREADS, 0, st>>>(p, ln, of, B, L16, k, P, top, out)
  switch (W) {
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int lt_kmer_scan_words(const void* codes, const void* lengths, int B, int L, int k,
                                  int P, unsigned top, void* canon, void* is_rc, void* valid,
                                  void* stream) {
  if (k < 1 || k > 255 || P < 1 || P != L - k + 1) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  // jobs: R whole reads (a read's packed words and pad fit K13_CODE_WORDS
  // whenever P <= K13_POS), or CH jobs of K13_POS positions a read
  int R = 1, CH = 0;
  long long grid;
  if (P <= K13_POS) {
    R = max(1, min(K13_POS / P, K13_CODE_WORDS / ((L + 15) / 16 + 1)));
    grid = ((long long)B + R - 1) / R;
  } else {
    CH = (P + K13_POS - 1) / K13_POS;
    grid = (long long)B * CH;
  }
  if (grid > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* c = (const uint8_t*)codes;
  const int32_t* ln = (const int32_t*)lengths;
  uint32_t* oc = (uint32_t*)canon;
  uint8_t* orc = (uint8_t*)is_rc;
  uint8_t* ov = (uint8_t*)valid;
#define LAUNCH(W_)                                                                      \
  kmer_scan_words_kernel<W_><<<(unsigned)grid, K13_THREADS, 0, st>>>(c, ln, B, L, k, P, top, \
                                                                    R, CH, oc, orc, ov)
  switch ((k + 15) / 16) {
    LT_W_CASE(1, LAUNCH)
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
