// Floor of K22 radix_sort (leon_tpu_torch/csrc/sort.cu): the least the card
// takes for the memory traffic an LSD radix sort cannot avoid, with nothing
// else in the way: its passes' copies alone. One launch copies a pass's keys
// and payload (read once, written once; 16 bytes a thread at a time,
// evict-first loads, streaming stores, a grid of resident blocks) from one
// buffer to the other; scripts/ab_kernels.py (--only sort) launches it once
// for each pass a case's bits need (the digits in which its keys differ),
// with the payload at the width K22 carries it in that pass, and times it
// beside the kernel. No histogram, no ranking, no look-back, no scatter.
// ab_kernels.py builds it with nvcc into build/ab_kernels/; nothing on the
// main path calls it.
//
// The floor of K22's bucket route (a sort over 41-63 bits of more than
// 8,192 keys, ops/count.py radix_route): lt_read_floor reads the keys
// once (the histogram of the bucket's bytes; 16 bytes a thread at a time,
// the words folded into one value a thread, stored only when it equals a
// constant, so that the loads stay), then a copy for each pass over the
// bucket's bytes (two, or three for a 24-bit bucket past 2**19 keys) and
// one for the bucket sort's one read and write.
//
// The same copy is the floor of K23 merge_path (leon_tpu_torch/csrc/sort.cu):
// a merge of R sorted runs in pairwise rounds reads and writes every element
// and count once a round, so lt_merge_floor copies the runs' rows and counts
// ceil(log2 R) times, buffer to buffer in turns. No search, no merge.
#include <cstdint>
#include <cuda_runtime.h>

#define FLOOR_THREADS 256

__global__ void __launch_bounds__(FLOOR_THREADS)
    sort_floor_kernel(const int4* __restrict__ keys, int4* __restrict__ keys_out,
                      long long key_groups, const int4* __restrict__ pay,
                      int4* __restrict__ pay_out, long long pay_groups) {
  const long long step = (long long)gridDim.x * FLOOR_THREADS;
  for (long long g = (long long)blockIdx.x * FLOOR_THREADS + threadIdx.x; g < key_groups;
       g += step)
    __stcs(keys_out + g, __ldcs(keys + g));
  for (long long g = (long long)blockIdx.x * FLOOR_THREADS + threadIdx.x; g < pay_groups;
       g += step)
    __stcs(pay_out + g, __ldcs(pay + g));
}

// One pass's copy: key_bytes of keys and pay_bytes of payload (each a
// multiple of 16, 16-byte aligned; pay may be null with pay_bytes 0).
extern "C" int lt_sort_floor(const void* keys, void* keys_out, long long key_bytes,
                             const void* pay, void* pay_out, long long pay_bytes, void* stream) {
  if (key_bytes < 0 || pay_bytes < 0 || key_bytes % 16 || pay_bytes % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sort_floor_kernel, FLOOR_THREADS,
                                                      0);
  if (e != cudaSuccess) return (int)e;
  sort_floor_kernel<<<sms * per_sm, FLOOR_THREADS, 0, (cudaStream_t)stream>>>(
      (const int4*)keys, (int4*)keys_out, key_bytes / 16, (const int4*)pay, (int4*)pay_out,
      pay_bytes / 16);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(FLOOR_THREADS)
    read_floor_kernel(const int4* __restrict__ data, long long groups, long long* sink) {
  const long long step = (long long)gridDim.x * FLOOR_THREADS;
  int x = 0;
  for (long long g = (long long)blockIdx.x * FLOOR_THREADS + threadIdx.x; g < groups; g += step) {
    const int4 v = __ldcs(data + g);
    x ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (x == 0x5eed1234) *sink = x;  // (almost) never: keeps the loads
}

// One read of bytes (a multiple of 16, 16-byte aligned) of data.
extern "C" int lt_read_floor(const void* data, long long bytes, void* sink, void* stream) {
  if (bytes < 0 || bytes % 16) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, read_floor_kernel, FLOOR_THREADS,
                                                      0);
  if (e != cudaSuccess) return (int)e;
  read_floor_kernel<<<sms * per_sm, FLOOR_THREADS, 0, (cudaStream_t)stream>>>(
      (const int4*)data, bytes / 16, (long long*)sink);
  return (int)cudaGetLastError();
}

// K23's floor: `rounds` copies of row_bytes of rows and count_bytes of
// counts (each a multiple of 16, 16-byte aligned), a to b, then b to a, ...
extern "C" int lt_merge_floor(void* a_rows, void* b_rows, long long row_bytes, void* a_counts,
                              void* b_counts, long long count_bytes, int rounds, void* stream) {
  for (int r = 0; r < rounds; ++r) {
    const bool even = r % 2 == 0;
    const int e = lt_sort_floor(even ? a_rows : b_rows, even ? b_rows : a_rows, row_bytes,
                                even ? a_counts : b_counts, even ? b_counts : a_counts,
                                count_bytes, stream);
    if (e) return e;
  }
  return 0;
}
