"""Drop-in module shape of the reference Python binding's
``pcodec.standalone`` (ref: pco_python/src/lib.rs:32-41, standalone.rs:44-133):
``simple_compress`` / ``simple_decompress`` / ``simple_decompress_into``,
plus the standalone file-size guarantee helpers.

A user of the reference switches by replacing ``import pcodec`` with
``import pcodec_tpu_torch as pcodec`` — ``pcodec.standalone.simple_compress(...)``
then works unchanged.
"""

from pcodec_tpu_torch.codec.guarantee import (  # noqa: F401
    standalone_chunk_size as chunk_size,
    standalone_file_size as file_size,
    standalone_header_size as header_size,
)
from pcodec_tpu_torch.codec.standalone import (  # noqa: F401
    Progress,
    simple_compress,
    simple_decompress_into,
)
from pcodec_tpu_torch.codec import standalone as _impl


def simple_decompress(src: bytes):
    """Decompress an entire standalone file into a numpy array, or None for
    an empty (terminator-only) file — the reference binding's return shape
    (ref: pco_python/src/standalone.rs:109-131). The richer
    ``pcodec_tpu_torch.simple_decompress`` additionally returns the NumberType."""
    out, _nt = _impl.simple_decompress(src)
    if len(out) == 0:
        # chunks are never empty, so 0 numbers == terminator-only file
        return None
    return out
