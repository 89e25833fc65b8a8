/* C ABI round-trip test, mirroring the reference's pco_c test program
 * (ref: pco_c/test/test_cpcodec.c), over the port's shim: compression runs
 * on the host, decompression on the card (it needs a CUDA device).
 *
 * Run with PYTHONPATH holding the repository root and the site-packages of
 * the Python that has torch (the shim embeds CPython):
 *   gcc test_cpcodec.c -L. -lcpcodec -o test_cpcodec && \
 *   PYTHONPATH=<repository root>:<site-packages> ./test_cpcodec
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

#include "cpcodec.h"

#define N 10000
#define I64_TYPE_BYTE 4
#define F32_TYPE_BYTE 5

int main(void) {
  if (pco_init() != PCO_SUCCESS) {
    fprintf(stderr, "pco_init failed\n");
    return 1;
  }

  /* ---- i64 round trip ---- */
  int64_t* nums = malloc(N * sizeof(int64_t));
  int64_t acc = 0;
  for (size_t i = 0; i < N; i++) {
    acc += (int64_t)(i % 100) - 3;
    nums[i] = acc;
  }
  size_t cap = pco_standalone_guarantee_file_size(I64_TYPE_BYTE, N);
  if (cap == 0) {
    fprintf(stderr, "guarantee_file_size returned 0\n");
    return 1;
  }
  unsigned char* dst = malloc(cap);
  size_t written = 0;
  int rc = pco_standalone_simple_compress_into(nums, N, I64_TYPE_BYTE, 8, dst,
                                               cap, &written);
  if (rc != PCO_SUCCESS || written == 0 || written > cap) {
    fprintf(stderr, "compress failed rc=%d written=%zu\n", rc, written);
    return 1;
  }
  int64_t* out = malloc(N * sizeof(int64_t));
  size_t n_out = 0;
  rc = pco_standalone_simple_decompress_into(dst, written, I64_TYPE_BYTE, out,
                                             N, &n_out);
  if (rc != PCO_SUCCESS || n_out != N) {
    fprintf(stderr, "decompress failed rc=%d n=%zu\n", rc, n_out);
    return 1;
  }
  for (size_t i = 0; i < N; i++) {
    if (out[i] != nums[i]) {
      fprintf(stderr, "mismatch at %zu: %lld != %lld\n", i,
              (long long)out[i], (long long)nums[i]);
      return 1;
    }
  }
  printf("i64 round trip OK (%zu -> %zu bytes)\n", (size_t)(N * 8), written);

  /* ---- f32 round trip ---- */
  float* fnums = malloc(N * sizeof(float));
  for (size_t i = 0; i < N; i++) fnums[i] = (float)(i % 777) * 0.25f;
  size_t fcap = pco_standalone_guarantee_file_size(F32_TYPE_BYTE, N);
  unsigned char* fdst = malloc(fcap);
  size_t fwritten = 0;
  rc = pco_standalone_simple_compress_into(fnums, N, F32_TYPE_BYTE, 8, fdst,
                                           fcap, &fwritten);
  if (rc != PCO_SUCCESS) {
    fprintf(stderr, "f32 compress failed rc=%d\n", rc);
    return 1;
  }
  float* fout = malloc(N * sizeof(float));
  size_t fn_out = 0;
  rc = pco_standalone_simple_decompress_into(fdst, fwritten, F32_TYPE_BYTE,
                                             fout, N, &fn_out);
  if (rc != PCO_SUCCESS || fn_out != N) {
    fprintf(stderr, "f32 decompress failed rc=%d\n", rc);
    return 1;
  }
  for (size_t i = 0; i < N; i++) {
    if (fout[i] != fnums[i]) {
      fprintf(stderr, "f32 mismatch at %zu\n", i);
      return 1;
    }
  }
  printf("f32 round trip OK (%zu -> %zu bytes)\n", (size_t)(N * 4), fwritten);

  /* ---- allocating decompress (the Java binding's surface) ---- */
  unsigned char atype = 0;
  void* adata = NULL;
  size_t an = 0;
  rc = pco_standalone_simple_decompress_alloc(fdst, fwritten, &atype, &adata,
                                              &an);
  if (rc != PCO_SUCCESS || atype != F32_TYPE_BYTE || an != N || !adata) {
    fprintf(stderr, "alloc decompress failed rc=%d type=%d n=%zu\n", rc,
            (int)atype, an);
    return 1;
  }
  for (size_t i = 0; i < N; i++) {
    if (((float*)adata)[i] != fnums[i]) {
      fprintf(stderr, "alloc decompress mismatch at %zu\n", i);
      return 1;
    }
  }
  pco_free(adata);
  printf("alloc decompress OK (inferred type %d, n=%zu)\n", (int)atype, an);

  /* ---- truncation must error, not crash ---- */
  rc = pco_standalone_simple_decompress_into(dst, written / 2, I64_TYPE_BYTE,
                                             out, N, &n_out);
  if (rc == PCO_SUCCESS && n_out == N) {
    fprintf(stderr, "truncated input decoded fully?!\n");
    return 1;
  }
  printf("truncation handled (rc=%d)\n", rc);
  printf("ALL C ABI TESTS PASSED\n");
  return 0;
}
