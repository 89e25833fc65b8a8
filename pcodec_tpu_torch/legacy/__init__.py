"""Legacy quantile-compression (.qco) codec.

The reference workspace ships its frozen predecessor `q_compress` 0.11.x
(ref: quantile-compression/q_compress/) and uses it as a CLI bench codec.
This package is a from-scratch Python implementation of that format:
Huffman prefixes over quantile ranges with run-length jumpstarts and GCD
multipliers, validated against the 9 pinned binary assets in
quantile-compression/q_compress/assets/.
"""

from pcodec_tpu_torch.legacy.qco import (
    auto_compress,
    auto_decompress,
    qco_compress,
    qco_decompress,
    wrapped_compress,
    wrapped_decompress,
)

__all__ = [
    "auto_compress",
    "auto_decompress",
    "qco_compress",
    "qco_decompress",
    "wrapped_compress",
    "wrapped_decompress",
]
