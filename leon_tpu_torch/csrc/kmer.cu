// K1 kmer_scan — canonical k-mer keys of a packed read batch, written
// straight into the count slab.
//
// Replaces: leon_tpu/ops/kmer.py kmer_scan_packed -> unpack_codes_dev,
// _kmer_scan_impl (a lax.scan over base columns producing (B, P, W) u32
// words plus is_rc/valid masks).
//
// Bound on the H100: device-memory bytes written, 8 per k-mer (the packed
// input is 1/32 of that). The design keeps the reference's O(L) rolling
// update but never materialises the (B, P, W) words or the masks: one
// thread per read rolls forward and reverse-complement k-mers as one
// uint64 (k <= 31) and stores min(fwd, rc) — or INT64_MAX for positions
// past len-k and pad lanes — at out[read * P + p].
#include "common.cuh"

__global__ void kmer_scan_kernel(const uint32_t* __restrict__ packed,
                                 const int32_t* __restrict__ lengths, int B, int L16,
                                 int L, int k, int P, int64_t* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const uint32_t* pr = packed + (size_t)row * L16;
  int64_t* o = out + (size_t)row * P;
  const int last = lengths[row] - k;  // valid positions: p <= last
  const uint64_t kmask = (1ull << (2 * k)) - 1;
  const int shift = 2 * (k - 1);
  uint64_t fwd = 0, rc = 0;
  uint32_t w = 0;
  for (int j = 0; j < L; ++j) {
    if ((j & 15) == 0) w = __ldg(pr + (j >> 4));
    const uint64_t b = (w >> (2 * (j & 15))) & 3u;
    fwd = ((fwd << 2) | b) & kmask;
    rc = (rc >> 2) | ((3ull - b) << shift);
    const int p = j - k + 1;
    if (p >= 0) o[p] = p <= last ? (int64_t)(fwd < rc ? fwd : rc) : LT_SENTINEL;
  }
}

extern "C" int lt_kmer_scan(const void* packed, const void* lengths, int B, int L16, int L,
                            int k, int P, void* out, void* stream) {
  if (k < 1 || k > 31 || P != L - k + 1 || L16 != (L + 15) / 16) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  kmer_scan_kernel<<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)packed, (const int32_t*)lengths, B, L16, L, k, P, (int64_t*)out);
  return (int)cudaGetLastError();
}
