"""The reference's ``pcmstream`` names, where its users import them from.

The port keeps the PCMReader protocol and its wrappers in ``pcm``, with
the frame lists they pass; this module only re-exports them under the
reference's module name."""

from .pcm import (  # noqa: F401
    BUFFER_SIZE,
    FRAMELIST_SIZE,
    BufferedPCMReader,
    ChannelMask,
    CounterPCMReader,
    LimitedFileReader,
    LimitedPCMReader,
    PCMCat,
    PCMConverter,
    PCMReader,
    PCMReaderDeHead,
    PCMReaderError,
    PCMReaderHead,
    PCMReaderProgress,
    PCMReaderWindow,
    RemaskedPCMReader,
    ReorderedPCMReader,
    pcm_cmp,
    pcm_frame_cmp,
    pcm_split,
    resampled_frame_count,
    stripped_pcm_cmp,
    threaded_transfer_framelist_data,
    to_pcm_progress,
    transfer_data,
    transfer_framelist_data,
)
