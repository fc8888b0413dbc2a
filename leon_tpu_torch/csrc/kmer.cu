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
// against 1 read (the codes). Design: one thread per read rolls fwd and rc
// as W registers each, with the reference's u32 word arithmetic (the
// same bits for any code byte, not only 0..3), and produces min(fwd, rc),
// is_rc and valid at every one of the P = L - k + 1 positions: the
// reference scans all L columns, so positions past a read's end hold the
// words of the bytes there. Palindromes keep the forward strand. A read's
// outputs are one contiguous row, but the rows of neighbouring threads lie
// P * W words apart, so a thread storing its own row sends each warp store
// to 32 sectors. The block therefore stages a tile of positions of its
// SCAN_ROWS reads in shared memory (rows padded to an odd word stride, so
// the per-thread stores hit 32 banks), then each warp copies whole row
// segments out, lane by lane: every store instruction writes up to 32
// neighbouring words (or bytes) of one row. The codes come in the same way,
// a tile of columns per row per warp load, instead of one scattered byte
// per thread and column. The tile is planes_tile of the W-word k-mer's
// (W + 1) / 2 planes: 32 positions for W <= 4, 16 for W <= 10 and
// 8 past it, so the staged words (64 x (TILE*W + 1) u32, which a tile of 32
// would make 41 KB at W = 5 and 132 KB at W = 16) and code columns stay at
// 45 KB or less, inside the 48 KB of static shared memory.
// ---------------------------------------------------------------------------

#define SCAN_ROWS 64  // reads per block, one thread each
#define SCAN_TILE 32  // positions staged per pass, W <= 4

// positions K13 stages per pass over k-mers of nh int64 planes
__host__ __device__ constexpr int planes_tile(int nh) {
  return nh <= 2 ? SCAN_TILE : nh <= 5 ? 16 : 8;
}

template <int W>
__global__ void __launch_bounds__(SCAN_ROWS)
    kmer_scan_words_kernel(const uint8_t* __restrict__ codes,
                           const int32_t* __restrict__ lengths, int B, int L, int k, int P,
                           uint32_t top, uint32_t* __restrict__ canon,
                           uint8_t* __restrict__ is_rc, uint8_t* __restrict__ valid) {
  constexpr int TILE = planes_tile((W + 1) / 2);
  __shared__ uint8_t sc[SCAN_ROWS][TILE + 4];     // the tile's code columns
  __shared__ uint32_t sw[SCAN_ROWS][TILE * W + 1];  // canonical words
  __shared__ uint8_t sf[2][SCAN_ROWS][TILE + 4];  // is_rc, valid
  const long long row0 = (long long)blockIdx.x * SCAN_ROWS;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nrows = (int)min((long long)SCAN_ROWS, (long long)B - row0);
  const int last = t < nrows ? lengths[row0 + t] - k : -1;  // valid positions: p <= last
  Kmer<W> fwd = {}, rc = {};
  for (int c0 = 0; c0 < L; c0 += TILE) {
    const int nc = min(TILE, L - c0);
    for (int r = warp; r < nrows; r += SCAN_ROWS / 32)
      if (lane < nc) sc[r][lane] = __ldg(codes + (size_t)(row0 + r) * L + c0 + lane);
    __syncthreads();
    // positions [pa, pa + np) end in columns [c0, c0 + nc)
    const int pa = max(0, c0 - k + 1);
    const int np = c0 + nc - k + 1 - pa;
    for (int q = 0; q < nc; ++q) {
      const uint32_t b = sc[t][q];
      fwd = shl2<W>(fwd, b, top);
      rc = shr2_ins<W>(rc, 3u - b, k);
      const int p = c0 + q - k + 1;
      if (p < 0) continue;
      const int i = p - pa;
      const bool take_rc = lex_less<W>(rc, fwd);
#pragma unroll
      for (int w = 0; w < W; ++w) sw[t][i * W + w] = take_rc ? rc.w[w] : fwd.w[w];
      sf[0][t][i] = take_rc;
      sf[1][t][i] = p <= last;
    }
    __syncthreads();
    if (np <= 0) continue;
    for (int r = warp; r < nrows; r += SCAN_ROWS / 32) {
      uint32_t* oc = canon + ((size_t)(row0 + r) * P + pa) * W;
      for (int q = lane; q < np * W; q += 32) oc[q] = sw[r][q];
      if (lane < np) {
        const size_t o = (size_t)(row0 + r) * P + pa + lane;
        is_rc[o] = sf[0][r][lane];
        valid[o] = sf[1][r][lane];
      }
    }
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
  const int threads = SCAN_ROWS;
  const unsigned grid = (unsigned)((B + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* c = (const uint8_t*)codes;
  const int32_t* ln = (const int32_t*)lengths;
  uint32_t* oc = (uint32_t*)canon;
  uint8_t* orc = (uint8_t*)is_rc;
  uint8_t* ov = (uint8_t*)valid;
#define LAUNCH(W_) \
  kmer_scan_words_kernel<W_><<<grid, threads, 0, st>>>(c, ln, B, L, k, P, top, oc, orc, ov)
  switch ((k + 15) / 16) {
    LT_W_CASE(1, LAUNCH)
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
