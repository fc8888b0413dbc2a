// leon_native: host-side native kernels for leon_tpu.
//
// TPU-native framework rule: the JAX/XLA/Pallas path owns device compute;
// the serial host work that the reference implements in C++ gets C++ here
// too. This file provides the entropy backend replacing the reference's
// adaptive range coder ([R] gatb-core tools/compression/RangeCoder.{hpp,cpp};
// SURVEY.md §2.2): a static order-0 interleaved rANS (FORMAT.md §7 method 2).
// Static two-pass tables instead of adaptive models so DECODE is branch-light
// and parallel-friendly; N-way lane interleave for ILP.
//
// Payload layout (little-endian):
//   u8   N                 interleave factor (1 or 4)
//   u16  S                 number of present symbols (1..256)
//   S *  (u8 sym, u16 qfreq-1)   quantized frequencies, sum = 4096
//   N *  u32 state         encoder final states (decoder initial states)
//   renorm byte stream
//
// Build: g++ -O3 -shared -fPIC (see leon_tpu/native/__init__.py).

#ifdef _OPENMP
#include <omp.h>
#endif
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <sys/sysinfo.h>
#include <vector>

namespace {

constexpr uint32_t PROB_BITS = 12;
constexpr uint32_t PROB_SCALE = 1u << PROB_BITS;
constexpr uint32_t RANS_L = 1u << 23;

}  // namespace

extern "C" {

// Returns payload length written to out, 0 if it did not fit in `cap`
// (caller falls back to another method), or -1 on internal error.
int64_t leon_rans_encode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap) {
    if (n <= 0) return 0;
    int64_t counts[256] = {0};
    for (int64_t i = 0; i < n; i++) counts[data[i]]++;

    uint32_t qf[256] = {0};
    uint64_t assigned = 0;
    int S = 0;
    for (int s = 0; s < 256; s++) {
        if (!counts[s]) continue;
        S++;
        uint64_t f = (uint64_t)(((__uint128_t)counts[s] * PROB_SCALE) / (uint64_t)n);
        if (f == 0) f = 1;
        qf[s] = (uint32_t)f;
        assigned += f;
    }
    // exact renormalization of the table to PROB_SCALE
    while (assigned != PROB_SCALE) {
        int best = -1;
        if (assigned < PROB_SCALE) {
            for (int s = 0; s < 256; s++)
                if (qf[s] && (best < 0 || counts[s] > counts[best])) best = s;
            if (best < 0) return -1;
            uint64_t add = PROB_SCALE - assigned;
            qf[best] += (uint32_t)add;
            assigned += add;
        } else {
            for (int s = 0; s < 256; s++)
                if (qf[s] > 1 && (best < 0 || qf[s] > qf[best])) best = s;
            if (best < 0) return -1;
            uint64_t sub = assigned - PROB_SCALE;
            uint32_t can = qf[best] - 1;
            uint32_t d = (uint32_t)(sub < can ? sub : can);
            qf[best] -= d;
            assigned -= d;
        }
    }
    uint32_t cum[257];
    cum[0] = 0;
    for (int s = 0; s < 256; s++) cum[s + 1] = cum[s] + qf[s];

    const int N = n >= 4096 ? 4 : 1;
    int64_t pos = 0;
    auto put8 = [&](uint8_t v) {
        if (pos < cap) out[pos] = v;
        pos++;
    };
    auto put16 = [&](uint16_t v) {
        put8((uint8_t)(v & 0xFF));
        put8((uint8_t)(v >> 8));
    };
    put8((uint8_t)N);
    put16((uint16_t)S);
    for (int s = 0; s < 256; s++)
        if (qf[s]) {
            put8((uint8_t)s);
            put16((uint16_t)(qf[s] - 1));
        }

    std::vector<uint8_t> tmp;
    tmp.reserve((size_t)n / 2 + 64);
    uint32_t x[8];
    for (int i = 0; i < N; i++) x[i] = RANS_L;
    for (int64_t i = n - 1; i >= 0; i--) {
        const int lane = (int)(i % N);
        const uint8_t s = data[i];
        const uint32_t f = qf[s];
        const uint32_t xmax = ((RANS_L >> PROB_BITS) << 8) * f;
        uint32_t v = x[lane];
        while (v >= xmax) {
            tmp.push_back((uint8_t)(v & 0xFF));
            v >>= 8;
        }
        x[lane] = ((v / f) << PROB_BITS) + (v % f) + cum[s];
    }
    for (int i = 0; i < N; i++) {
        uint32_t v = x[i];
        put8((uint8_t)(v & 0xFF));
        put8((uint8_t)((v >> 8) & 0xFF));
        put8((uint8_t)((v >> 16) & 0xFF));
        put8((uint8_t)((v >> 24) & 0xFF));
    }
    for (int64_t i = (int64_t)tmp.size() - 1; i >= 0; i--) put8(tmp[i]);
    if (pos > cap) return 0;
    return pos;
}

// Decodes exactly n symbols; returns n on success, -1 on corruption.
int64_t leon_rans_decode(const uint8_t* pl, int64_t plen, uint8_t* out, int64_t n) {
    if (n <= 0) return n == 0 ? 0 : -1;
    int64_t pos = 0;
    auto need = [&](int64_t k) { return pos + k <= plen; };
    if (!need(3)) return -1;
    const int N = pl[pos++];
    if (N != 1 && N != 4) return -1;
    const int S = pl[pos] | (pl[pos + 1] << 8);
    pos += 2;
    if (S < 1 || S > 256 || !need(3 * S + 4 * N)) return -1;

    uint32_t qf[256] = {0};
    uint32_t cum[257];
    uint8_t slot2sym[PROB_SCALE];
    uint64_t assigned = 0;
    cum[0] = 0;
    {
        uint32_t qtmp[256] = {0};
        for (int i = 0; i < S; i++) {
            const uint8_t sym = pl[pos];
            const uint32_t f = (uint32_t)(pl[pos + 1] | (pl[pos + 2] << 8)) + 1;
            pos += 3;
            if (qtmp[sym]) return -1;  // duplicate symbol entry = corrupt table
            qtmp[sym] = f;
            assigned += f;
        }
        if (assigned != PROB_SCALE) return -1;
        for (int s = 0; s < 256; s++) {
            qf[s] = qtmp[s];
            cum[s + 1] = cum[s] + qf[s];
        }
        for (int s = 0; s < 256; s++)
            for (uint32_t j = cum[s]; j < cum[s + 1]; j++) slot2sym[j] = (uint8_t)s;
    }

    uint32_t x[8];
    for (int i = 0; i < N; i++) {
        x[i] = (uint32_t)pl[pos] | ((uint32_t)pl[pos + 1] << 8) |
               ((uint32_t)pl[pos + 2] << 16) | ((uint32_t)pl[pos + 3] << 24);
        pos += 4;
    }
    const uint8_t* p = pl + pos;
    const uint8_t* pend = pl + plen;
    for (int64_t i = 0; i < n; i++) {
        const int lane = (int)(i % N);
        uint32_t v = x[lane];
        const uint32_t slot = v & (PROB_SCALE - 1);
        const uint8_t s = slot2sym[slot];
        out[i] = s;
        v = qf[s] * (v >> PROB_BITS) + slot - cum[s];
        while (v < RANS_L) {
            if (p >= pend) return -1;
            v = (v << 8) | *p++;
        }
        x[lane] = v;
    }
    return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Order-1 adaptive binary range coder (FORMAT.md §7 method 3) — the quality
// stream backend. Qualities dominate lossless FASTQ size and the reference
// only deflates them ([R] Leon.cpp zlib call; SURVEY.md §2.2 "Quality
// path"); an adaptive order-1 model typically beats zlib by 25-50% on real
// Phred streams. LZMA-style binary coder: each byte is 8 decisions through
// a 255-node probability tree selected by the previous byte.
// ---------------------------------------------------------------------------

namespace {

constexpr uint32_t PBITS = 11;          // probability precision
constexpr uint32_t PMAX = 1u << PBITS;  // 2048
constexpr uint32_t TOP = 1u << 24;

// Count-adaptive rate (q1 only): a fresh bit-tree node adapts fast
// (shift 2) and settles to the steady-state rate (shift 5) after 48
// updates. Measured -4% on E.coli-style qualities and ~4x on
// highly-regular realistic quality strings vs a fixed shift-5 (the count
// table mirrors exactly on the decode side, so the bitstream stays
// deterministic). The o1 coder keeps the fixed rate: its inputs (Bloom
// bitset, event-count varints) are near-stationary and fast adaptation
// measurably loses there. c == nullptr selects the fixed rate.
static inline uint32_t adapt_shift(uint16_t* c) {
    if (c == nullptr) return 5;
    uint16_t n = *c;
    if (n < 48) *c = (uint16_t)(n + 1);
    return 2 + (n >> 4);
}

struct RangeEnc {
    uint64_t low = 0;
    uint32_t range = 0xFFFFFFFFu;
    uint8_t cache = 0;
    int64_t cache_size = 1;
    uint8_t* out;
    int64_t pos = 0, cap;

    void shift_low() {
        if ((uint32_t)(low >> 32) != 0 || (uint32_t)(low >> 24) != 0xFF) {
            uint8_t carry = (uint8_t)(low >> 32);
            while (cache_size) {
                if (pos < cap) out[pos] = (uint8_t)(cache + carry);
                pos++;
                cache = 0xFF;
                cache_size--;
            }
            cache = (uint8_t)(low >> 24);
            cache_size = 0;
        }
        cache_size++;
        low = (low << 8) & 0xFFFFFFFFu;
    }
    void encode_bit(uint16_t* p, uint16_t* c, int bit) {
        uint32_t bound = (range >> PBITS) * *p;
        uint32_t mv = adapt_shift(c);
        if (!bit) {
            range = bound;
            *p = (uint16_t)(*p + ((PMAX - *p) >> mv));
        } else {
            low += bound;
            range -= bound;
            *p = (uint16_t)(*p - (*p >> mv));
        }
        while (range < TOP) {
            range <<= 8;
            shift_low();
        }
    }
    void flush() {
        for (int i = 0; i < 5; i++) shift_low();
    }
};

struct RangeDec {
    uint32_t range = 0xFFFFFFFFu;
    uint32_t code = 0;
    const uint8_t* in;
    int64_t pos = 0, len;

    uint8_t next() { return pos < len ? in[pos++] : 0; }
    void init() {
        next();  // first byte emitted by flush path is always 0
        for (int i = 0; i < 4; i++) code = (code << 8) | next();
    }
    int decode_bit(uint16_t* p, uint16_t* c) {
        uint32_t bound = (range >> PBITS) * *p;
        uint32_t mv = adapt_shift(c);
        int bit;
        if (code < bound) {
            range = bound;
            *p = (uint16_t)(*p + ((PMAX - *p) >> mv));
            bit = 0;
        } else {
            code -= bound;
            range -= bound;
            *p = (uint16_t)(*p - (*p >> mv));
            bit = 1;
        }
        while (range < TOP) {
            range <<= 8;
            code = (code << 8) | next();
        }
        return bit;
    }
};

}  // namespace

extern "C" {

// Returns payload length, 0 if it did not fit (caller falls back), -1 error.
int64_t leon_o1_encode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap) {
    if (n <= 0) return 0;
    std::vector<uint16_t> probs((size_t)256 * 255, PMAX / 2);
    RangeEnc rc;
    rc.out = out;
    rc.cap = cap;
    uint8_t ctx = 0;
    for (int64_t i = 0; i < n; i++) {
        uint16_t* tree = &probs[(size_t)ctx * 255];
        uint8_t sym = data[i];
        uint32_t node = 1;
        for (int b = 7; b >= 0; b--) {
            int bit = (sym >> b) & 1;
            rc.encode_bit(&tree[node - 1], nullptr, bit);
            node = (node << 1) | bit;
        }
        ctx = sym;
    }
    rc.flush();
    if (rc.pos > cap) return 0;
    return rc.pos;
}

int64_t leon_o1_decode(const uint8_t* pl, int64_t plen, uint8_t* out, int64_t n) {
    if (n <= 0) return n == 0 ? 0 : -1;
    std::vector<uint16_t> probs((size_t)256 * 255, PMAX / 2);
    RangeDec rc;
    rc.in = pl;
    rc.len = plen;
    rc.init();
    uint8_t ctx = 0;
    for (int64_t i = 0; i < n; i++) {
        uint16_t* tree = &probs[(size_t)ctx * 255];
        uint32_t node = 1;
        for (int b = 0; b < 8; b++)
            node = (node << 1) | rc.decode_bit(&tree[node - 1], nullptr);
        uint8_t sym = (uint8_t)(node & 0xFF);
        out[i] = sym;
        ctx = sym;
    }
    return n;
}

// --- method 4: position-aware quality model ("q1", FORMAT.md §7) ----------
//
// Context for byte i of a read: (previous qual clamped to 6 bits,
// qual-before-that quantized to 3 bits, position bucket min(i>>4, 15)) —
// the fqzcomp/Quip-family context shape, chosen because Illumina quality
// strings correlate strongly with the previous cycles and with machine
// cycle number. 8192 contexts x 255-node bit-tree. Reference contrast:
// Leon zlib-deflates quality strings ([R] Leon.cpp qual stream); this
// coder is 2-4x smaller on realistic quality data.

static inline uint32_t q1_ctx(const uint8_t* rd, int64_t pos) {
  uint32_t q1 = 0, q2 = 0;
  if (pos >= 1) {
    int v = rd[pos - 1] - 33;
    q1 = (uint32_t)(v < 0 ? 0 : (v > 63 ? 63 : v));
  }
  if (pos >= 2) {
    int v = rd[pos - 2] - 33;
    q2 = (uint32_t)(v < 0 ? 0 : (v > 63 ? 63 : v)) >> 3;
  }
  uint32_t pb = pos >= (15 << 4) ? 15 : (uint32_t)(pos >> 4);
  return (q1 << 7) | (q2 << 4) | pb;  // 64 * 8 * 16 = 8192 contexts
}

int64_t leon_q1_encode(const uint8_t* data, int64_t n, const int64_t* lens,
                       int64_t m, uint8_t* out, int64_t cap) {
  if (n <= 0) return 0;
  std::vector<uint16_t> probs((size_t)8192 * 255, PMAX / 2);
  std::vector<uint16_t> cnts((size_t)8192 * 255, 0);
  RangeEnc rc;
  rc.out = out;
  rc.cap = cap;
  int64_t off = 0;
  for (int64_t r = 0; r < m; r++) {
    const uint8_t* rd = data + off;
    const int64_t L = lens[r];
    if (L < 0 || off + L > n) return -1;
    for (int64_t i = 0; i < L; i++) {
      size_t cx = (size_t)q1_ctx(rd, i) * 255;
      uint16_t* tree = &probs[cx];
      uint16_t* ct = &cnts[cx];
      uint8_t sym = rd[i];
      uint32_t node = 1;
      for (int b = 7; b >= 0; b--) {
        int bit = (sym >> b) & 1;
        rc.encode_bit(&tree[node - 1], &ct[node - 1], bit);
        node = (node << 1) | bit;
      }
    }
    off += L;
  }
  if (off != n) return -1;
  rc.flush();
  if (rc.pos > cap) return 0;
  return rc.pos;
}

int64_t leon_q1_decode(const uint8_t* pl, int64_t plen, const int64_t* lens,
                       int64_t m, uint8_t* out, int64_t n) {
  if (n <= 0) return n == 0 ? 0 : -1;
  std::vector<uint16_t> probs((size_t)8192 * 255, PMAX / 2);
  std::vector<uint16_t> cnts((size_t)8192 * 255, 0);
  RangeDec rc;
  rc.in = pl;
  rc.len = plen;
  rc.init();
  int64_t off = 0;
  for (int64_t r = 0; r < m; r++) {
    uint8_t* rd = out + off;
    const int64_t L = lens[r];
    if (L < 0 || off + L > n) return -1;
    for (int64_t i = 0; i < L; i++) {
      size_t cx = (size_t)q1_ctx(rd, i) * 255;
      uint16_t* tree = &probs[cx];
      uint16_t* ct = &cnts[cx];
      uint32_t node = 1;
      for (int b = 0; b < 8; b++)
        node = (node << 1) | rc.decode_bit(&tree[node - 1], &ct[node - 1]);
      rd[i] = (uint8_t)(node & 0xFF);
    }
    off += L;
  }
  return off == n ? n : -1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Ragged byte moves (parser/assembly hot path).
//
// The Python pipeline moves ragged slices (reads, lines, segments) between
// flat buffers. Vectorized numpy does this via index arrays 8x larger than
// the payload (int64 index per byte); on the throttled shared host that
// memory traffic dominates parse/assembly time. This is the reference's
// tight C++ buffer shuffling ([R] gatb-core bank/impl/BankFasta.cpp) done
// the same way: a memcpy per slice, no index materialization.

extern "C" {

// Copy n slices src[src_starts[i] .. +lens[i]) -> dst[dst_starts[i] ...).
// Gather = consecutive dst starts; scatter = consecutive src starts.
void leon_ragged_move(uint8_t* dst, const int64_t* dst_starts,
                      const uint8_t* src, const int64_t* src_starts,
                      const int64_t* lens, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    memcpy(dst + dst_starts[i], src + src_starts[i],
           static_cast<size_t>(lens[i]));
  }
}

// Fill n slices dst[starts[i] .. +lens[i]) with byte `value`.
void leon_ragged_fill(uint8_t* dst, const int64_t* starts,
                      const int64_t* lens, int64_t n, uint8_t value) {
  for (int64_t i = 0; i < n; ++i) {
    memset(dst + starts[i], value, static_cast<size_t>(lens[i]));
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Header token-delta codec (FORMAT.md §8) — the hot per-header loop of
// codecs/headers.py in C++. Semantics are byte-frozen against the Python
// reference implementation: runs of digits / non-digits, string-equality
// code 0, 1 + zigzag(value delta) otherwise, literal fallback whenever the
// decoder's reconstruction rule (zero-pad to prev's width when prev had
// leading zeros) would not reproduce the original token. The Python loop
// measured ~53k headers/s; chr-scale inputs carry 10M+ headers.
// ---------------------------------------------------------------------------

#include <vector>

namespace {

struct HdrTok {
  int32_t off;
  int32_t len;
  bool digit;
};

inline void hdr_tokenize(const uint8_t* s, int64_t len, std::vector<HdrTok>& out) {
  out.clear();
  int64_t i = 0;
  while (i < len) {
    bool d = s[i] >= '0' && s[i] <= '9';
    int64_t j = i + 1;
    while (j < len && ((s[j] >= '0' && s[j] <= '9') == d)) j++;
    out.push_back({static_cast<int32_t>(i), static_cast<int32_t>(j - i), d});
    i = j;
  }
}

// decimal rendering of v, zero-padded to pad_to when pad_to > natural width
inline int hdr_render(uint64_t v, int pad_to, uint8_t* buf /* >= 24 */) {
  uint8_t tmp[24];
  int n = 0;
  do {
    tmp[n++] = static_cast<uint8_t>('0' + v % 10);
    v /= 10;
  } while (v);
  int total = n > pad_to ? n : pad_to;
  for (int i = 0; i < total - n; ++i) buf[i] = '0';
  for (int i = 0; i < n; ++i) buf[total - n + i] = tmp[n - 1 - i];
  return total;
}

inline uint64_t hdr_zigzag(int64_t d) {
  return (static_cast<uint64_t>(d) << 1) ^ static_cast<uint64_t>(d >> 63);
}

inline int64_t hdr_unzigzag(uint64_t u) {
  return static_cast<int64_t>(u >> 1) ^ -static_cast<int64_t>(u & 1);
}

constexpr int kHdrMaxDigits = 18;

}  // namespace

extern "C" {

// Encode: headers are flat bytes + int64 lens. Outputs: modes u8[n]
// (0 = literal, 1 = token-delta), row_counts i32[n] (numeric-code count
// for mode-1 rows, -1 for literals), codes u64 appended row-major.
// Returns the number of codes written, or -1 if cap_codes would overflow.
int64_t leon_hdr_encode(const uint8_t* flat, const int64_t* lens, int64_t n,
                        uint8_t* modes, int32_t* row_counts,
                        uint64_t* codes, int64_t cap_codes) {
  std::vector<HdrTok> prev_toks, toks;
  const uint8_t* prev = nullptr;
  int64_t prev_len = 0;
  int64_t ncodes = 0;
  int64_t off = 0;
  std::vector<uint64_t> row;  // staged codes for the current header
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* h = flat + off;
    const int64_t hl = lens[i];
    off += hl;
    hdr_tokenize(h, hl, toks);
    bool ok = prev != nullptr && toks.size() == prev_toks.size();
    row.clear();
    if (ok) {
      for (size_t t = 0; t < toks.size() && ok; ++t) {
        const HdrTok& a = toks[t];
        const HdrTok& b = prev_toks[t];
        if (a.digit != b.digit) { ok = false; break; }
        const uint8_t* ta = h + a.off;
        const uint8_t* tb = prev + b.off;
        if (!a.digit) {
          ok = a.len == b.len && memcmp(ta, tb, a.len) == 0;
          continue;
        }
        if (a.len == b.len && memcmp(ta, tb, a.len) == 0) {
          row.push_back(0);
          continue;
        }
        if (a.len > kHdrMaxDigits || b.len > kHdrMaxDigits) { ok = false; break; }
        uint64_t tv = 0, pv = 0;
        for (int j = 0; j < a.len; ++j) tv = tv * 10 + (ta[j] - '0');
        for (int j = 0; j < b.len; ++j) pv = pv * 10 + (tb[j] - '0');
        // reconstruction check: str(tv), zero-padded to prev's width when
        // prev had a leading zero, must equal the original token
        uint8_t recon[24];
        int pad_to = (b.len > 1 && tb[0] == '0') ? b.len : 0;
        int rl = hdr_render(tv, pad_to, recon);
        if (rl != a.len || memcmp(recon, ta, rl) != 0) { ok = false; break; }
        row.push_back(1 + hdr_zigzag(static_cast<int64_t>(tv) -
                                     static_cast<int64_t>(pv)));
      }
    }
    if (ok) {
      modes[i] = 1;
      row_counts[i] = static_cast<int32_t>(row.size());
      if (ncodes + static_cast<int64_t>(row.size()) > cap_codes) return -1;
      for (uint64_t c : row) codes[ncodes++] = c;
    } else {
      modes[i] = 0;
      row_counts[i] = -1;
    }
    prev = h;
    prev_len = hl;
    prev_toks.swap(toks);
  }
  (void)prev_len;
  return ncodes;
}

// Decode: modes + literal blob (flat, int64 lens, in literal order) +
// row-major codes. Writes reconstructed headers into out_flat (int64
// out_lens per header). Returns total bytes written, or -(needed cap)
// when out_cap is too small, or -1 on malformed input.
int64_t leon_hdr_decode(const uint8_t* modes, int64_t n,
                        const uint8_t* lit, const int64_t* lit_lens, int64_t n_lit,
                        const uint64_t* codes, int64_t n_codes,
                        uint8_t* out_flat, int64_t out_cap, int64_t* out_lens) {
  std::vector<HdrTok> prev_toks, toks;
  std::vector<uint8_t> prev;  // previous header bytes (owned copy)
  std::vector<uint8_t> cur;
  int64_t lit_off = 0, lit_i = 0, code_i = 0, out = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (modes[i] == 0) {
      if (lit_i >= n_lit) return -1;
      const int64_t ln = lit_lens[lit_i];
      cur.assign(lit + lit_off, lit + lit_off + ln);
      lit_off += ln;
      lit_i++;
    } else {
      cur.clear();
      const uint8_t* p = prev.data();
      for (const HdrTok& b : prev_toks) {
        if (!b.digit) {
          cur.insert(cur.end(), p + b.off, p + b.off + b.len);
          continue;
        }
        if (code_i >= n_codes) return -1;
        const uint64_t c = codes[code_i++];
        if (c == 0) {
          cur.insert(cur.end(), p + b.off, p + b.off + b.len);
          continue;
        }
        if (b.len > kHdrMaxDigits) return -1;
        uint64_t pv = 0;
        for (int j = 0; j < b.len; ++j) pv = pv * 10 + (p[b.off + j] - '0');
        const int64_t v = static_cast<int64_t>(pv) + hdr_unzigzag(c - 1);
        uint8_t buf[24];
        int pad_to = (b.len > 1 && p[b.off] == '0') ? b.len : 0;
        // negative values cannot round-trip a digit run; reject (the
        // encoder never emits them for valid archives)
        if (v < 0) return -1;
        int rl = hdr_render(static_cast<uint64_t>(v), pad_to, buf);
        cur.insert(cur.end(), buf, buf + rl);
      }
    }
    const int64_t hl = static_cast<int64_t>(cur.size());
    if (out + hl > out_cap) {
      // report a sufficient cap: remaining headers bounded by this one's
      // growth pattern is unknowable; double + slack
      return -(out + hl + (n - i) * (hl + 64));
    }
    memcpy(out_flat + out, cur.data(), hl);
    out_lens[i] = hl;
    out += hl;
    hdr_tokenize(cur.data(), hl, toks);
    prev.swap(cur);
    prev_toks.swap(toks);
  }
  return out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sorted-run k-way merge: the count-finalize hot path at chr scale.
//
// The slab counter spills compacted (distinct kmer, count) runs to host RAM
// once they exceed the HBM budget (ops/count.py DeviceCounter._spill_run) —
// the TPU analog of DSK's temp disk partitions ([R] gatb-core
// kmer/impl/SortingCountAlgorithm, SURVEY.md §3.4). Merging those runs with
// a global np.lexsort + np.add.at measured as the dominant count.finalize
// cost (~200 s at 340M distinct rows); the runs are each sorted, so a
// streaming k-way merge is O(n log R) with sequential access.
//
// Keys are rows of W little-endian u32 words (word W-1 most significant);
// runs ascend in that order. Equal keys sum their int64 counts. Output
// buffers must hold sum(ns) rows. Returns the distinct row count.
// ---------------------------------------------------------------------------

namespace leon_merge {

static inline bool key_less_w(const uint32_t* a, const uint32_t* b,
                              int64_t W) {
  for (int64_t w = W - 1; w >= 0; --w) {
    if (a[w] != b[w]) return a[w] < b[w];
  }
  return false;
}

// Heap k-way merge of run ranges [lo[r], hi[r]) into out; returns rows.
static int64_t merge_ranges(int64_t R, int64_t W,
                            const uint32_t* const* keys,
                            const int64_t* const* counts,
                            const int64_t* lo, const int64_t* hi,
                            uint32_t* out_keys, int64_t* out_counts) {
  struct Head {
    const uint32_t* row;
    int64_t pos;
    int32_t run;
  };
  std::vector<Head> heap;
  heap.reserve(static_cast<size_t>(R));
  auto head_greater = [W](const Head& x, const Head& y) {
    if (key_less_w(x.row, y.row, W)) return false;
    if (key_less_w(y.row, x.row, W)) return true;
    return x.run > y.run;  // equal keys pop grouped and deterministic
  };
  for (int32_t r = 0; r < R; ++r) {
    if (hi[r] > lo[r]) heap.push_back(Head{keys[r] + lo[r] * W, lo[r], r});
  }
  std::make_heap(heap.begin(), heap.end(), head_greater);
  int64_t m = -1;
  while (!heap.empty()) {
    std::pop_heap(heap.begin(), heap.end(), head_greater);
    Head h = heap.back();
    heap.pop_back();
    if (m >= 0 && memcmp(out_keys + m * W, h.row, sizeof(uint32_t) * W) == 0) {
      out_counts[m] += counts[h.run][h.pos];
    } else {
      ++m;
      memcpy(out_keys + m * W, h.row, sizeof(uint32_t) * W);
      out_counts[m] = counts[h.run][h.pos];
    }
    if (++h.pos < hi[h.run]) {
      h.row += W;
      heap.push_back(h);
      std::push_heap(heap.begin(), heap.end(), head_greater);
    }
  }
  return m + 1;
}

// first index in keys[0:n) with row >= pivot (rows ascending)
static int64_t lower_bound_rows(const uint32_t* keys, int64_t n, int64_t W,
                                const uint32_t* pivot) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (key_less_w(keys + mid * W, pivot, W)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

}  // namespace leon_merge

extern "C" {

int64_t leon_merge_runs(int64_t R, int64_t W, const uint32_t* const* keys,
                        const int64_t* const* counts, const int64_t* ns,
                        uint32_t* out_keys, int64_t* out_counts) {
  using namespace leon_merge;
  if (R <= 0) return 0;
  int64_t total = 0, big = 0;
  for (int32_t r = 0; r < R; ++r) {
    total += ns[r];
    if (ns[r] > ns[big]) big = r;
  }
#ifdef _OPENMP
  const int P0 = omp_get_max_threads();
#else
  const int P0 = 1;
#endif
  const int P = (total >= (8 << 20) && P0 > 1) ? (P0 > 8 ? 8 : P0) : 1;
  if (P == 1) {
    std::vector<int64_t> lo(R, 0);
    return merge_ranges(R, W, keys, counts, lo.data(), ns, out_keys,
                        out_counts);
  }
  // key-pivot partition into P ranges (pivots = evenly spaced keys of the
  // largest run; rows == pivot go to the LATER range on every run, so a
  // key never spans ranges and per-range merges are independent).
  // Ranges write DISJOINT slices of out at input-row offsets (an upper
  // bound on their output), then compact left — the chr-scale host merge
  // of ~340M rows dropped from the count.finalize critical path majority
  // to ~1/P of it.
  std::vector<int64_t> los(static_cast<size_t>(P + 1) * R);
  for (int32_t r = 0; r < R; ++r) {
    los[r] = 0;
    los[static_cast<size_t>(P) * R + r] = ns[r];
  }
  for (int p = 1; p < P; ++p) {
    const int64_t pi = ns[big] * p / P;
    const uint32_t* pivot = keys[big] + pi * W;
    for (int32_t r = 0; r < R; ++r) {
      los[static_cast<size_t>(p) * R + r] =
          lower_bound_rows(keys[r], ns[r], W, pivot);
    }
  }
  std::vector<int64_t> in_off(P + 1, 0);
  for (int p = 0; p < P; ++p) {
    int64_t rows = 0;
    for (int32_t r = 0; r < R; ++r) {
      rows += los[static_cast<size_t>(p + 1) * R + r] -
              los[static_cast<size_t>(p) * R + r];
    }
    in_off[p + 1] = in_off[p] + rows;
  }
  std::vector<int64_t> got(P, 0);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
  for (int p = 0; p < P; ++p) {
    got[p] = merge_ranges(R, W, keys, counts,
                          &los[static_cast<size_t>(p) * R],
                          &los[static_cast<size_t>(p + 1) * R],
                          out_keys + in_off[p] * W, out_counts + in_off[p]);
  }
  // compact ranges left (sequential memmove; ranges are key-ordered)
  int64_t m = got[0];
  for (int p = 1; p < P; ++p) {
    if (in_off[p] != m && got[p]) {
      memmove(out_keys + m * W, out_keys + in_off[p] * W,
              sizeof(uint32_t) * W * got[p]);
      memmove(out_counts + m, out_counts + in_off[p],
              sizeof(int64_t) * got[p]);
    }
    m += got[p];
  }
  return m;
}

// Fast sortedness check (ascending, strict or equal allowed) for the W-word
// row order above; returns 1 when sorted. Guards the merge fast path: an
// unsorted partial falls back to the numpy lexsort merge.
int32_t leon_rows_sorted(int64_t n, int64_t W, const uint32_t* keys) {
  for (int64_t i = 1; i < n; ++i) {
    const uint32_t* a = keys + (i - 1) * W;
    const uint32_t* b = keys + i * W;
    for (int64_t w = W - 1; w >= 0; --w) {
      if (a[w] < b[w]) break;
      if (a[w] > b[w]) return 0;
    }
  }
  return 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Canonical k-mer spelling of the UNITIGS payload: the decode-side DICT
// enumeration + bitset-rebuild input (ops/unitig.py spell_canon). The numpy
// form packs every window from scratch (O(n*k) with two full (n, k) gathers
// — measured ~4.7 s of a 43 s 500k-read decompress); this rolling form is
// O(n*W): slide the forward and reverse-complement windows one base at a
// time and emit min(fwd, rc) per position.
//
// codes: concatenated 2-bit base codes of all unitigs; lens: per-unitig code
// counts; out: (sum(len_i - k + 1), W) u32 rows, little-endian words, base i
// of a window at bit 2*(k-1-i) of the big-int (kmer.pack_codes_batch_np
// layout). Returns the row count.
// ---------------------------------------------------------------------------

extern "C" {

int64_t leon_spell_canon(const uint8_t* codes, int64_t n_units,
                         const int64_t* lens, int32_t k, int32_t W,
                         uint32_t* out) {
  std::vector<uint32_t> fwd(static_cast<size_t>(W));
  std::vector<uint32_t> rc(static_cast<size_t>(W));
  const int32_t t_hi = 2 * (k - 1);          // bit offset of the window's MSB base
  const int32_t hi_word = t_hi / 32, hi_bit = t_hi % 32;
  const int32_t top_bits = (2 * k) % 32;     // valid bits in the top word
  const uint32_t top_mask =
      top_bits ? ((top_bits == 32) ? 0xFFFFFFFFu : ((1u << top_bits) - 1u))
               : 0xFFFFFFFFu;
  int64_t m = 0;
  const uint8_t* p = codes;
  for (int64_t u = 0; u < n_units; ++u) {
    const int64_t L = lens[u];
    if (L < k) { p += L; continue; }
    std::fill(fwd.begin(), fwd.end(), 0u);
    std::fill(rc.begin(), rc.end(), 0u);
    for (int64_t i = 0; i < L; ++i) {
      const uint32_t b = p[i] & 3u;
      // fwd' = ((fwd << 2) | b) & mask(2k)
      uint32_t carry = b;
      for (int32_t w = 0; w < W; ++w) {
        const uint32_t nc = fwd[w] >> 30;
        fwd[w] = (fwd[w] << 2) | carry;
        carry = nc;
      }
      fwd[W - 1] &= top_mask;
      // rc' = (rc >> 2) | ((3-b) << 2*(k-1))
      for (int32_t w = 0; w < W - 1; ++w) {
        rc[w] = (rc[w] >> 2) | (rc[w + 1] << 30);
      }
      rc[W - 1] >>= 2;
      rc[hi_word] |= (3u - b) << hi_bit;
      if (i >= k - 1) {
        // canonical = min(fwd, rc) as a big-int (MSW compare first)
        bool rc_less = false;
        for (int32_t w = W - 1; w >= 0; --w) {
          if (rc[w] != fwd[w]) { rc_less = rc[w] < fwd[w]; break; }
        }
        const uint32_t* src = rc_less ? rc.data() : fwd.data();
        memcpy(out + m * W, src, sizeof(uint32_t) * W);
        ++m;
      }
    }
    p += L;
  }
  return m;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Unitig chain construction (ops/unitig.py _np_chains, bit-exact): the host
// builder for solid sets above the device compile cliff
// (config.unitig_device_max_kmers). The numpy form costs ~18 s per 1M rows
// (structured-dtype searchsorted + O(n log n) pointer-doubling gathers);
// this form is O(n) serial chain walking with a 16-bit prefix-bucketed
// binary search — the chr-scale (36M-row) build must finish under the
// encode stage it overlaps.
//
// Semantics replicated exactly (payload bytes are the frozen §4a contract):
//   succ[did] = FIRST (in base order) solid successor's directed id;
//   outc = solid successor count; inc(did) = outc(twin);
//   internal = solid & outc==1 & succ>=0 & inc(succ)==1 & solid(succ);
//   prev = inverse of nxt (ascending-did last-writer);
//   cycles: cut the edge INTO each cycle's min-id node;
//   head/rank via prev-chains, continuing x->nxt[x] only when
//   prev[nxt[x]] == x (the numpy head/rank derives from prev);
//   chain min-id / min-twin-id via nxt-orbit suffix minima (memoized);
//   keep_head = solid & prev<0 & (m <= tm); kept = solid & keep_head[head].
// ---------------------------------------------------------------------------

namespace leon_unitig {

static inline bool row_less(const uint32_t* a, const uint32_t* b, int32_t W) {
  for (int32_t w = W - 1; w >= 0; --w) {
    if (a[w] != b[w]) return a[w] < b[w];
  }
  return false;
}

static inline bool row_eq(const uint32_t* a, const uint32_t* b, int32_t W) {
  return memcmp(a, b, sizeof(uint32_t) * W) == 0;
}

// ((kmer << 2) | base) & mask2k  (unitig.py _np_shl2)
static inline void shl2(const uint32_t* x, uint32_t b, int32_t W,
                        uint32_t top_mask, uint32_t* out) {
  uint32_t carry = b;
  for (int32_t w = 0; w < W; ++w) {
    uint32_t nc = x[w] >> 30;
    out[w] = (x[w] << 2) | carry;
    carry = nc;
  }
  out[W - 1] &= top_mask;
}

// (kmer >> 2) | (base << 2(k-1))  (unitig.py _np_shr2_ins)
static inline void shr2_ins(const uint32_t* x, uint32_t b, int32_t W,
                            int32_t k, uint32_t* out) {
  for (int32_t w = 0; w < W - 1; ++w) {
    out[w] = (x[w] >> 2) | (x[w + 1] << 30);
  }
  out[W - 1] = x[W - 1] >> 2;
  const int32_t t = 2 * (k - 1);
  out[t / 32] |= b << (t % 32);
}

}  // namespace leon_unitig

namespace leon_unitig {

// Shared link-building: rc rows, successor search, internal-edge nxt/prev.
// Fills rc_out (M, W) and the N = 2M directed-node link arrays. The solid
// hash fast path and the non-solid skip are semantics-preserving against
// the numpy mirror (outc/succ of non-solid nodes are never read).
template <typename I>  // int32_t when 2M < 2^31 (halves link-array RSS
                       // at genome scale), int64_t otherwise
static void build_links(int64_t M, int32_t W, const uint32_t* words,
                        const int32_t* counts, int32_t cutoff, int32_t k,
                        uint32_t* rc_out, std::vector<I>& nxt,
                        std::vector<I>& prev,
                        std::vector<uint8_t>& solid2, int32_t nthreads) {
#ifdef _OPENMP
  // callers running this from a background thread under a live encode
  // loop cap the team so the pipeline's drain/frame threads keep a core
  if (nthreads > 0) omp_set_num_threads(nthreads);
#else
  (void)nthreads;
#endif
  const int64_t N = 2 * M;
  const int32_t top_bits = (2 * k) % 32;
  const uint32_t top_mask =
      top_bits ? ((1u << top_bits) - 1u) : 0xFFFFFFFFu;

  // rc_out[i] = revcomp(words[i]) — per-base repack (matches
  // kmer.revcomp_words_batch_np): base i at bit 2*(k-1-i)
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < M; ++i) {
    const uint32_t* wr = words + i * W;
    uint32_t* rr = rc_out + i * W;
    memset(rr, 0, sizeof(uint32_t) * W);
    for (int32_t j = 0; j < k; ++j) {
      const int32_t ts = 2 * (k - 1 - j);                 // source base j
      const uint32_t b = (wr[ts / 32] >> (ts % 32)) & 3u;
      const int32_t td = 2 * j;  // dest position (k-1-j) -> bit 2*(k-1-(k-1-j))
      rr[td / 32] |= (3u - b) << (td % 32);
    }
  }

  // 16-bit prefix bucket index over the sort key's high bits (MSW)
  std::vector<int64_t> bucket(65537, 0);
  for (int64_t i = 0; i < M; ++i) {
    bucket[(words[i * W + (W - 1)] >> 16) + 1]++;
  }
  for (int64_t b = 0; b < 65536; ++b) bucket[b + 1] += bucket[b];

  // SOLID-key open-addressing hash (2k < 64 bits): the successor search
  // below is the build's hot loop, and its prefix-bucketed binary search
  // costs ~20 dependent cache misses per probe over a multi-GB sorted
  // array at genome scale. A linear-probe table of only the SOLID keys
  // (the only matches the candidate test keeps) answers each probe in
  // ~1-2 misses. Capped so the table stays a modest fraction of the row
  // memory; bigger sets keep the binary search.
  int64_t hash_cap_rows = (int64_t)1 << 27;
  {
    // allow bigger tables when the host has the RAM: cap the table at
    // 1/8 of physical memory (12 B/slot, 2 slots/row)
    struct sysinfo si;
    if (sysinfo(&si) == 0) {
      const int64_t budget = (int64_t)(si.totalram * (uint64_t)si.mem_unit / 8);
      while (hash_cap_rows * 2 * 12 * 2 <= budget &&
             hash_cap_rows < ((int64_t)1 << 31)) {
        hash_cap_rows <<= 1;
      }
    }
  }
  const bool use_hash =
      ((W == 2 && 2 * k < 64) || (W == 1 && 2 * k < 32)) &&
      (M <= hash_cap_rows);
  std::vector<uint64_t> hkeys;
  std::vector<uint32_t> hvals;
  uint64_t hmask = 0;
  const uint64_t HEMPTY = ~0ull;
  auto mix64 = [](uint64_t x) -> uint64_t {
    x *= 0x9E3779B97F4A7C15ull;
    x ^= x >> 29;
    x *= 0xBF58476D1CE4E5B9ull;
    x ^= x >> 32;
    return x;
  };
  if (use_hash) {
    int64_t cap = 64;
    while (cap < 2 * M) cap <<= 1;
    hmask = (uint64_t)cap - 1;
    hkeys.assign(cap, HEMPTY);
    hvals.resize(cap);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < M; ++i) {
      if (counts[i] < cutoff) continue;  // only solid rows can match
      const uint64_t key =
          (uint64_t)words[i * W] |
          (W > 1 ? ((uint64_t)words[i * W + 1] << 32) : 0ull);
      uint64_t h = mix64(key) & hmask;
      for (;;) {
        uint64_t expected = HEMPTY;
        auto* slot = reinterpret_cast<std::atomic<uint64_t>*>(&hkeys[h]);
        if (slot->compare_exchange_strong(expected, key,
                                          std::memory_order_relaxed)) {
          hvals[h] = (uint32_t)i;  // rows are distinct: no duplicate race
          break;
        }
        h = (h + 1) & hmask;
      }
    }
  }
  auto hash_find_solid = [&](const uint32_t* key) -> int64_t {
    const uint64_t kk =
        (uint64_t)key[0] | (W > 1 ? ((uint64_t)key[1] << 32) : 0ull);
    uint64_t h = mix64(kk) & hmask;
    while (hkeys[h] != HEMPTY) {
      if (hkeys[h] == kk) return (int64_t)hvals[h];
      h = (h + 1) & hmask;
    }
    return -1;
  };

  auto find = [&](const uint32_t* key) -> int64_t {
    const uint32_t hi = key[W - 1] >> 16;
    int64_t lo = bucket[hi], hiX = bucket[hi + 1];
    while (lo < hiX) {
      const int64_t mid = (lo + hiX) >> 1;
      if (row_less(words + mid * W, key, W)) lo = mid + 1;
      else hiX = mid;
    }
    if (lo < M && row_eq(words + lo * W, key, W)) return lo;
    return -1;
  };
  auto lower_bound_row = [&](const uint32_t* key) -> int64_t {
    const uint32_t hi = key[W - 1] >> 16;
    int64_t lo = bucket[hi], hiX = bucket[hi + 1];
    while (lo < hiX) {
      const int64_t mid = (lo + hiX) >> 1;
      if (row_less(words + mid * W, key, W)) lo = mid + 1;
      else hiX = mid;
    }
    return lo;
  };

  std::vector<I> succ(N, I(-1));
  std::vector<uint8_t> outc(N, 0);
  solid2.assign(N, 0);
  for (int64_t i = 0; i < M; ++i) {
    const uint8_t s = counts[i] >= cutoff ? 1 : 0;
    solid2[2 * i] = s;
    solid2[2 * i + 1] = s;
  }

  // successor search: independent per directed node — the build's hot loop
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t did = 0; did < N; ++did) {
    // outc/succ of a NON-solid directed node are never read (`internal`
    // requires solid2[did], and s = succ[did] only dereferences under
    // it) — skip the searches entirely. At genome scale the distinct
    // run is mostly sub-cutoff error singletons, so this alone removes
    // the majority of the probe work when callers pass full runs.
    if (!solid2[did]) continue;
    uint32_t y[16], yr[16], y0[16];
    const int64_t i = did >> 1;
    const int32_t o = static_cast<int32_t>(did & 1);
    const uint32_t* x = o ? rc_out + i * W : words + i * W;
    const uint32_t* xr = o ? words + i * W : rc_out + i * W;
    shl2(x, 0u, W, top_mask, y0);
    int64_t ymatch[4] = {-1, -1, -1, -1};
    if (!use_hash) {
      // The 4 forward candidates y_b = (x<<2)|b are CONSECUTIVE keys:
      // ONE lower-bound on y_0 plus a <=4-row scan answers all 4
      // memberships (the reverse candidates yr_b spread across the key
      // space and keep individual searches). Cuts searches/node 8 -> 3.
      for (int64_t t = lower_bound_row(y0); t < M; ++t) {
        const uint32_t* r = words + t * W;
        bool hi_eq = (r[0] & ~3u) == y0[0];
        for (int32_t w = 1; hi_eq && w < W; ++w) hi_eq = r[w] == y0[w];
        if (!hi_eq) break;
        ymatch[r[0] & 3u] = t;
      }
    }
    for (uint32_t b = 0; b < 4; ++b) {
      memcpy(y, y0, sizeof(uint32_t) * W);
      y[0] |= b;
      shr2_ins(xr, 3u - b, W, k, yr);
      const bool take_rc = row_less(yr, y, W);
      int64_t j;
      if (use_hash) {
        j = hash_find_solid(take_rc ? yr : y);  // table holds solid only
      } else {
        j = take_rc ? find(yr) : ymatch[b];
        if (j >= 0 && counts[j] < cutoff) j = -1;
      }
      if (j >= 0) {
        outc[did]++;
        if (outc[did] == 1) succ[did] = (I)(j * 2 + (take_rc ? 1 : 0));
      }
    }
  }

  // inc(did) = outc(twin); internal -> nxt
  nxt.assign(N, I(-1));
  for (int64_t did = 0; did < N; ++did) {
    const I s = succ[did];
    const bool internal = solid2[did] && outc[did] == 1 && s >= 0 &&
                          outc[s ^ 1] == 1 && solid2[s];
    nxt[did] = internal ? s : I(-1);
  }

  prev.assign(N, I(-1));
  for (int64_t did = 0; did < N; ++did) {
    if (nxt[did] >= 0) prev[nxt[did]] = (I)did;  // ascending = np last-writer
  }
}

}  // namespace leon_unitig

extern "C" {

int32_t leon_unitig_chains(int64_t M, int32_t W, const uint32_t* words,
                           const int32_t* counts, int32_t cutoff, int32_t k,
                           uint32_t* rc_out, int64_t* nxt, int64_t* head,
                           int64_t* rank, uint8_t* kept, uint8_t* keep_head,
                           int32_t nthreads) {
  using namespace leon_unitig;
  if (M <= 0) return 0;
  const int64_t N = 2 * M;
  std::vector<int64_t> nxt_v, prev;
  std::vector<uint8_t> solid2;
  build_links<int64_t>(M, W, words, counts, cutoff, k, rc_out, nxt_v, prev,
                       solid2, nthreads);
  memcpy(nxt, nxt_v.data(), sizeof(int64_t) * N);

  // --- merged chain resolution: ONE buffered pointer chase per
  // component (replaces the former cycle-cut + suffix-min + head/rank +
  // kept passes, each of which chased every chain again — chains over
  // sorted-random keys pay a cache miss per hop, so the PASS COUNT is
  // the serial wall; a 2M-row single-chain build spent ~3.5 s here).
  // Components of the nxt-graph are pure chains or pure cycles (module
  // contract, see the python mirror's docstring): a head-rooted walk
  // never enters a cycle, and within a chain prev[nxt[x]] == x always
  // (in-degree 1), so the walk needs no guard. Semantics are
  // bit-identical to the numpy reference: per-chain min-id / min-twin-id
  // evaluated over the buffered path, keep_head/kept from the same rule.
  std::vector<uint8_t> visited(N, 0);
  std::vector<int64_t> buf;
  auto process_chain = [&](int64_t h) {
    buf.clear();
    int64_t x = h;
    for (;;) {
      visited[x] = 1;
      buf.push_back(x);
      const int64_t nx = nxt[x];
      if (nx < 0) break;
      x = nx;
    }
    int64_t m = N, tm = N;
    for (size_t t = buf.size(); t-- > 0;) {
      const int64_t v = buf[t];
      if (solid2[v]) {
        if (v < m) m = v;
        if ((v ^ 1) < tm) tm = v ^ 1;
      }
    }
    const uint8_t kh = (solid2[h] && prev[h] < 0 && m <= tm) ? 1 : 0;
    int64_t r = 0;
    for (size_t t = 0; t < buf.size(); ++t, ++r) {
      const int64_t v = buf[t];
      head[v] = h;
      rank[v] = r;
      keep_head[v] = (t == 0) ? kh : 0;
      kept[v] = (solid2[v] && kh) ? 1 : 0;
    }
  };
  for (int64_t h = 0; h < N; ++h) {
    if (prev[h] < 0 && !visited[h]) process_chain(h);
  }
  // leftovers are pure cycles: cut the edge into the min-id node, then
  // the former cycle is a chain rooted there
  for (int64_t s0 = 0; s0 < N; ++s0) {
    if (visited[s0] || nxt[s0] < 0) continue;
    int64_t hv = s0;
    for (int64_t x = nxt[s0]; x != s0; x = nxt[x]) {
      if (x < hv) hv = x;
    }
    const int64_t pv = prev[hv];
    if (pv >= 0) nxt[pv] = -1;
    prev[hv] = -1;
    process_chain(hv);
  }
  return 0;
}

}  // extern "C"

// One-call unitig build: chain resolution PARALLEL over roots plus direct
// base emission — the numpy caller's scatter phase (bases[start + (k-1) +
// rank] etc., ~1 s at 2M rows under the encode-stage GIL) collapses into
// the chase itself. Chain enumeration order (ascending head directed id),
// per-chain lengths and bases are bit-identical to leon_unitig_chains +
// the numpy scatter (tested against it).
//
// Outputs (caller-allocated):
//   rc_out    (M, W) u32   revcomp rows (head prefix codes need them)
//   len_nodes i64[M]       node count per chain   [first n_chains valid]
//   head_ids  i64[M]       directed head id per chain, ascending
//   interior  u8[M]        kept-node bases, chains concatenated in order
// Returns n_chains >= 0, -1 on error, or -2 when the links are not chains
// and cycles, so a walk from a root would never end: rows that are not
// distinct (the all-zero pad rows a caller appends where the clamped
// histogram overcounts the solid rows) can all link to one row that links
// to itself. A walk stops after N nodes, more than any chain holds.
template <typename I>
static int64_t unitig_build_impl(int64_t M, int32_t W, const uint32_t* words,
                                 const int32_t* counts, int32_t cutoff,
                                 int32_t k, uint32_t* rc_out,
                                 int64_t* len_nodes, int64_t* head_ids,
                                 uint8_t* interior, int32_t nthreads) {
  using namespace leon_unitig;
  const int64_t N = 2 * M;
  std::vector<I> nxt, prev;
  std::vector<uint8_t> solid2;
  build_links<I>(M, W, words, counts, cutoff, k, rc_out, nxt, prev, solid2,
                 nthreads);

  // roots (ascending): chain starts. Cycles have no root; found below.
  std::vector<int64_t> roots;
  roots.reserve(1024);
  for (int64_t h = 0; h < N; ++h) {
    if (prev[h] < 0) roots.push_back(h);
  }
  const int64_t R = (int64_t)roots.size();
  std::vector<int64_t> rlen(R, 0);   // chain length when kept, else 0
  std::vector<uint8_t> rkeep(R, 0);
  std::vector<uint8_t> visited(N, 0);
  std::atomic<int> endless(0);

  // phase B: parallel walk per root — min-id/min-twin-id keep rule,
  // length count, visited marking (components are disjoint).
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
  for (int64_t ri = 0; ri < R; ++ri) {
    const int64_t h = roots[ri];
    int64_t m = N, tm = N, n_nodes = 0;
    for (int64_t x = h;; x = nxt[x]) {
      visited[x] = 1;
      if (++n_nodes > N) {
        endless.store(1, std::memory_order_relaxed);
        break;
      }
      if (solid2[x]) {
        if (x < m) m = x;
        if ((x ^ 1) < tm) tm = x ^ 1;
      }
      if (nxt[x] < 0) break;
    }
    if (solid2[h] && m <= tm) {
      rkeep[ri] = 1;
      rlen[ri] = n_nodes;
    }
  }
  if (endless.load()) return -2;

  // cycles: ascending scan finds each cycle at its min member (all
  // smaller ids are visited), cut the incoming edge, keep-rule as usual
  std::vector<std::pair<int64_t, int64_t>> chains;  // (head, len)
  chains.reserve(1024);
  for (int64_t ri = 0; ri < R; ++ri) {
    if (rkeep[ri]) chains.emplace_back(roots[ri], rlen[ri]);
  }
  for (int64_t s0 = 0; s0 < N; ++s0) {
    if (visited[s0] || nxt[s0] < 0) continue;
    int64_t hv = s0, steps = 0;
    for (int64_t x = nxt[s0]; x != s0; x = nxt[x]) {
      if (++steps > N) return -2;  // s0 leads into a cycle it is not on
      if (x < hv) hv = x;
    }
    const int64_t pv = prev[hv];
    if (pv >= 0) nxt[pv] = I(-1);
    prev[hv] = I(-1);
    int64_t m = N, tm = N, n_nodes = 0;
    for (int64_t x = hv;; x = nxt[x]) {
      visited[x] = 1;
      if (++n_nodes > N) return -2;
      if (solid2[x]) {
        if (x < m) m = x;
        if ((x ^ 1) < tm) tm = x ^ 1;
      }
      if (nxt[x] < 0) break;
    }
    if (solid2[hv] && m <= tm) chains.emplace_back(hv, n_nodes);
  }
  std::sort(chains.begin(), chains.end());
  const int64_t n_chains = (int64_t)chains.size();
  if (n_chains > M) return -1;  // capacity contract violated

  std::vector<int64_t> off(n_chains + 1, 0);
  for (int64_t c = 0; c < n_chains; ++c) {
    head_ids[c] = chains[c].first;
    len_nodes[c] = chains[c].second;
    off[c + 1] = off[c] + chains[c].second;
  }
  if (off[n_chains] > M) return -1;  // kept nodes exceed rows: impossible

  // phase C: parallel re-walk emitting each kept node's last base in
  // chain order. F[v] = words[v>>1] (fwd) or rc_out[v>>1] (rc).
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
  for (int64_t c = 0; c < n_chains; ++c) {
    int64_t p = off[c];
    for (int64_t x = head_ids[c];; x = nxt[x]) {
      const int64_t i = x >> 1;
      const uint32_t w0 = (x & 1) ? rc_out[i * W] : words[i * W];
      interior[p++] = (uint8_t)(w0 & 3u);
      if (nxt[x] < 0) break;
    }
  }
  return n_chains;
}

extern "C" {

int64_t leon_unitig_build(int64_t M, int32_t W, const uint32_t* words,
                          const int32_t* counts, int32_t cutoff, int32_t k,
                          uint32_t* rc_out, int64_t* len_nodes,
                          int64_t* head_ids, uint8_t* interior,
                          int32_t nthreads) {
  if (M <= 0) return 0;
  if (2 * M < ((int64_t)1 << 31)) {  // i32 links: halves link-array RSS
    return unitig_build_impl<int32_t>(M, W, words, counts, cutoff, k, rc_out,
                                      len_nodes, head_ids, interior, nthreads);
  }
  return unitig_build_impl<int64_t>(M, W, words, counts, cutoff, k, rc_out,
                                    len_nodes, head_ids, interior, nthreads);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// FASTA/wrapped-FASTQ line-structure count scan (codecs/blocks.py
// _decode_line_struct): per read the stream holds nlines then nlines-1
// explicit lengths; the count positions are a strictly sequential scan the
// numpy path ran as a per-read Python loop (VERDICT r3 weak #6 — at 10M
// FASTA reads it is the decode tail). Returns the final cursor, or -1 if
// the stream is short.
// ---------------------------------------------------------------------------

extern "C" {

int64_t leon_linestruct_scan(const int64_t* vals, int64_t nvals,
                             int64_t n_reads, int64_t* nl_arr,
                             int64_t* cpos) {
  int64_t vp = 0;
  for (int64_t i = 0; i < n_reads; ++i) {
    if (vp >= nvals) return -1;
    cpos[i] = vp;
    const int64_t nl = vals[vp];
    nl_arr[i] = nl;
    vp += 1 + (nl > 1 ? nl - 1 : 0);
  }
  return vp;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host Bloom build (ops/bloom.py build_np, hash family v4): from-scratch
// strand-chain hashes of (M, W) packed k-mer rows + blocked-addressing
// insert. The numpy form loops k table-gather rounds over the whole row set
// (~60-90 s at the chr-scale 36.5M-row build inside count.finalize and the
// decode-side bitset rebuild); this form is a tight per-row loop. T/Tc are
// the v4 base tables from bloom.tables(seed, k) — passed in so the frozen
// fmix32 constants live in exactly one place.
// ---------------------------------------------------------------------------

extern "C" {

int32_t leon_bloom_build(int64_t M, int32_t W, const uint32_t* words,
                         int64_t n_words, int32_t H, int32_t k,
                         const uint32_t* T, const uint32_t* Tc,
                         uint32_t* bitset) {
  if (H < 1 || H > 8) return -1;
  for (int64_t i = 0; i < M; ++i) {
    const uint32_t* wr = words + i * W;
    uint32_t f = 0, r = 0;
    for (int32_t j = 0; j < k; ++j) {
      const int32_t t = 2 * (k - 1 - j);
      const uint32_t b = (wr[t / 32] >> (t % 32)) & 3u;
      const int32_t rf = (k - 1 - j) % 32;
      const int32_t rr = j % 32;
      const uint32_t tv = T[b], cv = Tc[b];
      f ^= rf ? ((tv << rf) | (tv >> (32 - rf))) : tv;
      r ^= rr ? ((cv << rr) | (cv >> (32 - rr))) : cv;
    }
    const uint32_t lo = f < r ? f : r;
    const uint32_t hi = f < r ? r : f;
    const uint32_t wi = static_cast<uint32_t>(
        (static_cast<uint64_t>(lo) * static_cast<uint64_t>(n_words)) >> 32);
    uint32_t mask = 0;
    for (int32_t h = 0; h < H; ++h) {
      const uint32_t bit =
          ((h < 6 ? (hi >> (5 * h)) : (lo >> (5 * (h - 6)))) & 31u);
      mask |= 1u << bit;
    }
    bitset[wi] |= mask;
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Newline index (io/bank.py _line_index): memchr scan writing positions
// directly. The numpy form (arr == 10 -> flatnonzero) materializes a byte
// mask + a second pass; this is the parse hot spot (0.68 s of a 1.2 s
// 117 MB parse, ~2x that again at chr scale). out must hold at least
// `cap` entries; returns the newline count (callers pre-count via a
// cheaper pass or size for the worst case).
// ---------------------------------------------------------------------------

extern "C" {

int64_t leon_line_index(const uint8_t* data, int64_t n, int64_t* out,
                        int64_t cap) {
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  int64_t m = 0;
  while (p < end) {
    const uint8_t* q = static_cast<const uint8_t*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!q) break;
    if (m >= cap) return -1;
    out[m++] = q - data;
    p = q + 1;
  }
  return m;
}

}  // extern "C"
