"""FLAC codec entry points: the card path, or the scalar oracle.

Port of the reference's ``codecs/flac.py``.  ``encode_flac`` and
``decoder_for_file`` are what ``formats.flac.FlacAudio`` and
``OggFlacAudio`` encode and decode through:

* by default, ``codecs.flac_enc_fast.encode_flac_fast`` and
  ``codecs.flac_dec.TorchFlacDecoder`` on the given device;
* with ``ATPU_FLAC_ORACLE=1``, read at each call, the reference's
  scalar NumPy encoder and decoder (``ref.flac_enc.encode_flac``,
  ``ref.flac_dec.FlacDecoder``) on the host: they write the same bytes
  and decode the same samples, launch no kernel and touch no card.

Only the variable selects the oracle: a card path that fails to
import, build or launch raises, where the reference's dispatcher fell
back to the oracle on an ImportError.  The reference's
``ATPU_FLAC_DEC_BACKEND`` (host C++ or JAX) has no counterpart: the
port decodes on its device.
"""

from __future__ import annotations

import os


def _use_oracle():
    """True when ATPU_FLAC_ORACLE is 1"""
    return os.environ.get("ATPU_FLAC_ORACLE", "0") == "1"


def encode_flac(filename, pcmreader, padding_size=4096, device="cuda",
                **options):
    """encodes a FLAC stream (a path or a writable binary file) from a
    PCMReader with the reference's keyword options; returns (byte
    offset, pcm frames) pairs, one a frame.  ``padding_size`` None
    writes no PADDING block.  device: where the card path runs"""
    if _use_oracle():
        from ..ref.flac_enc import encode_flac as oracle_encode
        return oracle_encode(filename, pcmreader, padding_bytes=padding_size,
                             **options)
    from .flac_enc_fast import encode_flac_fast
    return encode_flac_fast(filename, pcmreader, padding_size=padding_size,
                            device=device, **options)


def decoder_for_file(file, channel_mask=None, device="cuda"):
    """a PCMReader decoding the FLAC stream of a path or a binary file
    positioned at its 'fLaC' marker.  device: where the card path
    runs"""
    if _use_oracle():
        from ..ref.flac_dec import FlacDecoder
        return FlacDecoder(file, None if channel_mask is None
                           else int(channel_mask))
    from .flac_dec import TorchFlacDecoder
    return TorchFlacDecoder(file, channel_mask, device=device)
