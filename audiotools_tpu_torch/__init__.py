"""PyTorch/CUDA port of the audiotools_tpu device paths.

The JAX package ``audiotools_tpu`` stays the reference: every function
here is held bit for bit against its counterpart there.  Layers with no
device code (the ``_native`` C++ host kernels, the ``ref`` oracles,
``pcmstream``, ``pcm``) are imported from the reference, which loads
them without pulling in jax.  This package never imports jax.

Layout mirrors the reference: ``ops/`` holds the array programs,
``codecs/`` the encoder entry points, ``csrc/`` the hand-written
CUDA kernels (built by ``kernels.py`` on first use).  ``pcm.py``
re-exports the reference's PCM reader and FLAC decoder, so a caller
of the port needs no module of the reference.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
