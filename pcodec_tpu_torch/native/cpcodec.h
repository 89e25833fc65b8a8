/* C API for pcodec_tpu_torch — the pco_c equivalent.
 *
 * Caller-allocates surface mirroring the reference's generated header
 * (ref: pco_c/include/cpcodec_generated.h, pco_c/src/lib.rs:128-195).
 *
 * Number type bytes (ref: pco/src/data_types, NUMBER_TYPE_BYTE):
 *   u32=1 u64=2 i32=3 i64=4 f32=5 f64=6 u16=7 i16=8 f16=9 u8=10 i8=11
 */
#ifndef CPCODEC_TPU_TORCH_H
#define CPCODEC_TPU_TORCH_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

enum {
  PCO_SUCCESS = 0,
  PCO_INVALID_ARGUMENT = 1,
  PCO_COMPRESSION_ERROR = 2,
  PCO_DECOMPRESSION_ERROR = 3,
  PCO_INSUFFICIENT_DATA = 4,
};

/* Initialize the runtime (idempotent; implicit on first call). */
int pco_init(void);

/* Worst-case byte size of a standalone file holding n numbers
 * (ref: pco/src/standalone/guarantee.rs:11-38). */
size_t pco_standalone_guarantee_file_size(unsigned char number_type_byte,
                                          size_t n);

/* Compress n numbers at src into dst (capacity dst_capacity bytes).
 * On success writes the byte count to *dst_written. */
int pco_standalone_simple_compress_into(
    const void* src, size_t n, unsigned char number_type_byte,
    unsigned int compression_level, unsigned char* dst, size_t dst_capacity,
    size_t* dst_written);

/* Decompress src (src_len bytes) into dst (capacity in ELEMENTS).
 * On success writes the element count to *n_written. */
int pco_standalone_simple_decompress_into(
    const unsigned char* src, size_t src_len, unsigned char number_type_byte,
    void* dst, size_t dst_capacity_elems, size_t* n_written);

/* Decompress a whole file without knowing the type or count up front
 * (allocating convenience surface used by the Java binding). On success
 * *out_data holds malloc'd number data (free with pco_free), *out_n the
 * element count, *out_type_byte the inferred number type (0 if the file
 * holds no chunks; *out_data is then NULL). */
int pco_standalone_simple_decompress_alloc(
    const unsigned char* src, size_t src_len, unsigned char* out_type_byte,
    void** out_data, size_t* out_n);

void pco_free(void* p);

#ifdef __cplusplus
}
#endif

#endif /* CPCODEC_TPU_TORCH_H */
