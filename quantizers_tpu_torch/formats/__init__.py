"""compressed-tensors-compatible checkpoint I/O over torch tensors."""

from .compressed_tensors import (  # noqa: F401
    build_quantization_config,
    compress_tensor,
    compression_ratio,
    decompress_tensor,
    fp4_decode,
    fp4_encode,
    pack_fp4_to_uint8,
    pack_int_to_int32,
    parse_quantization_config,
    unpack_int32_to_int,
    unpack_uint8_to_fp4,
)
from .checkpoint import (  # noqa: F401
    CompressedModelReader,
    CompressedParam,
    save_compressed_model,
)
from .safetensors_io import (  # noqa: F401
    INDEX_NAME,
    LazySafetensors,
    ShardedReader,
    ShardedWriter,
    natural_sort_key,
    read_safetensors,
    write_safetensors,
)
