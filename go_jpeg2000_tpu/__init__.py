"""go_jpeg2000_tpu — accelerator-native JPEG 2000 + HTJ2K engine (JAX/XLA).

A from-scratch implementation of ISO/IEC 15444-1 (JPEG 2000 core) and
15444-15 (HTJ2K) with the capabilities of the reference Go library
(mrjoshuak/go-jpeg2000), redesigned for an accelerator (a GPU through XLA):

- device (jnp): MCT, colorspace, 5/3 + 9/7 lifting DWT, quantization,
  HT block-coding fields and stream compaction
- host (Python/C++): codestream syntax, Tier-2 packets, entropy backends
- parallel: tile sharding over a jax.sharding.Mesh with halo exchange

Public API (parity with /root/reference/jpeg2000.go:318-342):
    encode(image, options) -> bytes
    decode(data, config) -> np.ndarray
    decode_metadata(data) -> Metadata
"""

from .utils import compile_cache as _compile_cache

_compile_cache.enable()

from .options import (ColorSpace, Config, Format, Metadata, Options, Profile,
                      ProgressionOrder, default_options)
from .models.encoder import encode
from .models.decoder import decode, decode_metadata, DecodeError
from .utils.metrics import counters

__version__ = "0.1.0"

__all__ = [
    "encode", "decode", "decode_metadata", "DecodeError",
    "Options", "Config", "Metadata", "Format", "Profile",
    "ProgressionOrder", "ColorSpace", "default_options", "counters",
]
