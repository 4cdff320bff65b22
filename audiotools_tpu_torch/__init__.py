"""PyTorch/CUDA port of the audiotools_tpu device paths.

The JAX package ``audiotools_tpu`` stays the reference: every function
here is held bit for bit against its counterpart there by the tests.
The port stands alone: it imports neither jax nor anything of the
reference, and keeps its own copies of the host layers it needs (the
``_native`` C++ FLAC library, the ``ref`` scalar oracles, the PCM
readers in ``pcm``), under the reference's module names.

Layout mirrors the reference: ``ops/`` holds the array programs,
``codecs/`` the encoder and decoder entry points
(``codecs.flac_enc_fast.encode_flac_fast``,
``codecs.flac_dec.TorchFlacDecoder``), ``csrc/`` the hand-written CUDA
kernels (built by ``kernels.py`` on first use).
"""

from ._device import resolve_device

# the reference package's version, which the tags the port writes name
VERSION = "0.1.0"

__all__ = ["VERSION", "resolve_device"]
