"""ALAC codec entry points: the card path, or the scalar oracle.

Port of the reference's ``codecs/alac.py``.  ``encode_mdat`` and
``decoder_for_file`` are what ``formats.m4a`` (``write_m4a``,
``ALACAudio.to_pcm``) encodes and decodes through:

* by default, ``codecs.alac_fast.encode_mdat_fast`` and
  ``codecs.alac_dec.TorchALACDecoder`` on the given device;
* with ``ATPU_ALAC_ORACLE=1``, read at each call, the reference's
  scalar NumPy encoder and decoder (``ref.alac.encode_mdat``,
  ``ref.alac.ALACDecoder``) on the host: they write the same mdat and
  decode the same samples, launch no kernel and touch no card.

Only the variable selects the oracle: a card path that fails to
import, build or launch raises, where the reference's dispatcher fell
back to the oracle on an ImportError.  The reference's
``ATPU_ALAC_DEC_BACKEND`` (host C++ or JAX) has no counterpart: the
port decodes on its device.
"""

from __future__ import annotations

import os


def _use_oracle():
    """True when ATPU_ALAC_ORACLE is 1"""
    return os.environ.get("ATPU_ALAC_ORACLE", "0") == "1"


def encode_mdat(file, pcmreader, device="cuda", timings=None, **options):
    """writes an mdat atom from a PCMReader to a binary file with the
    reference's keyword options; returns (frame_byte_sizes,
    total_pcm_frames).  device, timings: as encode_mdat_fast takes them
    (the oracle records no timings)"""
    if _use_oracle():
        from ..ref.alac import encode_mdat as oracle_mdat
        return oracle_mdat(file, pcmreader, **options)
    from .alac_fast import encode_mdat_fast
    return encode_mdat_fast(file, pcmreader, device=device, timings=timings,
                            **options)


def decoder_for_file(file_or_path, device="cuda"):
    """a PCMReader decoding the ALAC stream of an M4A path or binary
    file.  device: where the card path runs"""
    if _use_oracle():
        from ..ref.alac import ALACDecoder
        return ALACDecoder(file_or_path)
    from .alac_dec import TorchALACDecoder
    return TorchALACDecoder(file_or_path, device=device)
