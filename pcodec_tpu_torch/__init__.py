"""pcodec_tpu_torch: the Pco codec (format v4.1) with a PyTorch/CUDA device layer.

The host layer (format, binning, modes, delta, codec, native) is a copy of
the JAX package's framework-free host modules. The device layer decodes
PCT containers (`ops/container_decode.py`) and standalone `.pco` files
(`ops/standalone_decode.py`) and encodes PCT containers to a file
image on the card (`ops/container_encode.py`, `ops/row_sort.py`,
`ops/assemble.py`; from a numpy array or from a tensor already on the
card), with hand-written CUDA kernels on an NVIDIA GPU, or with their
plain PyTorch versions on the CPU; `parallel/` shards the decode and the
encode over a list of devices. The top-level names are the JAX package's
(`simple_compress`, `PagingSpec`, the errors, `__version__`, ...) and the
device entry points.
"""

from pcodec_tpu_torch.codec.chunk_config import ChunkConfig, DeltaSpec, ModeSpec, PagingSpec  # noqa: F401
from pcodec_tpu_torch.codec.standalone import (  # noqa: F401
    Progress,
    simple_compress,
    simple_decompress,
    simple_decompress_into,
)
from pcodec_tpu_torch.codec import guarantee, wrapped  # noqa: F401
from pcodec_tpu_torch.codec.container import (  # noqa: F401
    container_compress,
    container_decompress,
    parse_container,
)
from pcodec_tpu_torch.constants import DEFAULT_COMPRESSION_LEVEL, FULL_BATCH_N  # noqa: F401
from pcodec_tpu_torch import standalone  # noqa: F401  (pcodec.standalone module shape)
from pcodec_tpu_torch.errors import (  # noqa: F401
    CorruptionError,
    InsufficientDataError,
    InvalidArgumentError,
    PcoError,
)
from pcodec_tpu_torch.ops.assemble import encode_container_device, encode_container_image_device  # noqa: F401
from pcodec_tpu_torch.ops.container_decode import decode_container_device  # noqa: F401
from pcodec_tpu_torch.ops.standalone_decode import (  # noqa: F401
    decode_standalone_device,
    decode_standalone_with_device,
)
from pcodec_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    sharded_container_decode,
    sharded_container_encode,
    sharded_decode_standalone,
)

__version__ = "0.1.0"
