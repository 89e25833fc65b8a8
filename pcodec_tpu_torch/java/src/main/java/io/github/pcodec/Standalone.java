package io.github.pcodec;

import java.util.Optional;

/**
 * Standalone-format compression entry points, implemented by a JNI shim
 * (jni/pco_jni.cpp) over the pcodec_tpu_torch C ABI (native/cpcodec.h).
 *
 * Load path: System.loadLibrary("pco_tpu_java"); set -Djava.library.path to
 * the directory holding libpco_tpu_java.so (see java/README.md).
 */
public class Standalone {
    static {
        System.loadLibrary("pco_tpu_java");
    }

    /** Compresses an array of numbers into standalone .pco bytes. */
    public static native byte[] simple_compress(NumArray src, ChunkConfig config)
            throws IllegalArgumentException;

    /**
     * Decompresses standalone .pco bytes into a typed array. Returns an empty
     * Optional when the file holds no chunks (number type unknowable).
     */
    public static native Optional<NumArray> simple_decompress(byte[] src)
            throws RuntimeException;
}
