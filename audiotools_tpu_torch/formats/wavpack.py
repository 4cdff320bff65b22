"""The WavPack file writer.

Port of the write path of the reference's ``WavPackAudio.from_pcm``
(``audiotools_tpu/formats/wavpack.py``): its compression modes, each a
block size and a pass count, and the RIFF header the first block
stores; the correlation passes on a torch device
(``codecs.wavpack.encode_wavpack``).  APE tags and ``from_wave``'s
foreign RIFF chunks are not ported.
"""

from __future__ import annotations

from ..codecs.wavpack import encode_wavpack
from ..pcm import CounterPCMReader

DEFAULT_COMPRESSION = "standard"
OPTIONS = {"veryfast": {"block_size": 44100, "correlation_passes": 1},
           "fast": {"block_size": 44100, "correlation_passes": 2},
           "standard": {"block_size": 44100, "correlation_passes": 5},
           "high": {"block_size": 44100, "correlation_passes": 10},
           "veryhigh": {"block_size": 44100, "correlation_passes": 16}}


def write_wavpack(path_or_file, pcmreader, compression=DEFAULT_COMPRESSION,
                  total_pcm_frames=None, device="cuda", timings=None):
    """encodes a WavPack file from a PCMReader

    path_or_file: a path or a writable, seekable binary file.
    compression: a key of OPTIONS.  With total_pcm_frames the block
    headers carry it from the start, as the reference writes them
    (ValueError when the reader gives another count).  device and
    timings as in ``codecs.wavpack.encode_wavpack``.  The reader is
    closed at the end."""
    if compression not in OPTIONS:
        raise ValueError("unknown WavPack compression %r" % (compression,))
    counter = CounterPCMReader(pcmreader)
    try:
        encode_wavpack(
            path_or_file, counter, total_pcm_frames=total_pcm_frames or 0,
            device=device, timings=timings, **OPTIONS[compression])
        if (total_pcm_frames is not None and
                counter.frames_written != total_pcm_frames):
            raise ValueError("total PCM frames mismatch")
    finally:
        pcmreader.close()
