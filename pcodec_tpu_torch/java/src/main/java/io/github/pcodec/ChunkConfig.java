package io.github.pcodec;

/**
 * Compression configuration (a subset of the full ChunkConfig, matching the
 * reference Java binding's surface: compression level only for now).
 */
public class ChunkConfig {
    int compressionLevel = 8;

    public ChunkConfig() {}

    /**
     * @param compressionLevel 0..=12
     */
    public ChunkConfig withCompressionLevel(int compressionLevel) {
        this.compressionLevel = compressionLevel;
        return this;
    }
}
