"""PyTorch/CUDA port of audiotools_tpu, with its package-root API.

The JAX package ``audiotools_tpu`` stays the reference: every function
here is held bit for bit against its counterpart there by the tests.
The port stands alone: it imports neither jax nor anything of the
reference, and keeps its own copies of the host layers it needs (the
``_native`` C++ library, the ``ref`` scalar oracles, the PCM readers in
``pcm``), under the reference's module names.

Layout mirrors the reference: ``ops/`` holds the array programs,
``codecs/`` the encoder and decoder entry points
(``codecs.flac_enc_fast.encode_flac_fast``,
``codecs.flac_dec.TorchFlacDecoder``), ``csrc/`` the hand-written CUDA
kernels (built by ``kernels.py`` on first use), ``formats/`` the file
classes, ``cli/`` the tools, ``player`` and ``ui`` playback and the
interactive modes.

The root exports the reference root's public names (Python Audio
Tools' ``audiotools`` API): ``open``, ``open_files``, ``TYPE_MAP``, the
PCMReader chain, ``MetaData``, ``CDDA``, ``ExecProgressQueue``,
``calculate_replay_gain``, ``metadata_lookup``, the messenger and
helper names and the exceptions, each the object the port's modules
use and raise.  A file opened with ``open`` decodes on the current card
unless a ``device`` is given (``"cpu"`` runs the plain versions).
Importing the package makes no CUDA context and builds no kernel.
"""

# the reference package's version, which the tags the port writes name;
# defined before the imports below, since format modules import it
VERSION = "0.1.0"

from ._device import resolve_device  # noqa: E402,F401
from .pcm import (  # noqa: E402,F401
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
from . import pcm  # noqa: E402,F401
from .audiofile import (  # noqa: E402,F401
    AiffContainer,
    AlbumMetaData,
    AudioFile,
    DecodingError,
    DummyAudioFile,
    EncodingError,
    Image,
    InvalidFile,
    InvalidFilenameFormat,
    MetaData,
    ReplayGain,
    Sheet,
    SheetException,
    SheetIndex,
    SheetTrack,
    UnsupportedBitsPerSample,
    UnsupportedChannelCount,
    UnsupportedChannelMask,
    UnsupportedFile,
    UnsupportedTracknameField,
    WaveContainer,
    build_timestamp,
    parse_timestamp,
    read_sheet,
)
from .dispatch import (  # noqa: E402,F401
    AVAILABLE_TYPES,
    TYPE_MAP,
    AmbiguousAudioType,
    DuplicateFile,
    DuplicateOutputFile,
    Filename,
    OutputFileIsInput,
    UnknownAudioType,
    file_type,
    filename_to_type,
    group_tracks,
    open,
    open_directory,
    open_files,
    sorted_tracks,
)
from .utils.config import DEFAULT_TYPE, MAX_JOBS  # noqa: E402,F401
from .utils.files import TemporaryFile, make_dirs  # noqa: E402,F401
from .cdio import CDDA, CDTrackLog, CDTrackReader  # noqa: E402,F401
from .parallel.queue import (  # noqa: E402,F401
    ExecProgressQueue,
    ExecQueueError,
)
from .services.lookup import (  # noqa: E402,F401
    accuraterip_lookup,
    accuraterip_sheet_lookup,
    metadata_lookup,
    track_metadata_lookup,
)
from .utils.messenger import (  # noqa: E402,F401
    DummyOutput,
    Messenger,
    ProgressDisplay,
    ProgressRow,
    ReplayGainProgressDisplay,
    SilentMessenger,
    SingleProgressDisplay,
    output_list,
    output_progress,
    output_table,
    output_table_blank,
    output_table_divider,
    output_table_row,
    output_text,
)
from .utils.helpers import (  # noqa: E402,F401
    at_a_time,
    get_umask,
    ignore_sigint,
    iter_first,
    iter_last,
    khz,
    most_numerous,
)
from .meta.image import InvalidImage  # noqa: E402,F401
from .replaygain import applicable_replay_gain  # noqa: E402,F401

# the reference re-exports these standard library names for its tools
from optparse import OptionGroup, OptionParser  # noqa: E402,F401
from configparser import RawConfigParser  # noqa: E402,F401


def calculate_replay_gain(tracks, progress=None, device="cuda"):
    """yields (track, gain, peak, album_gain, album_peak) for each of
    ``tracks``, analysed as one album on ``device``"""
    from .replaygain import calculate_replay_gain_values
    return calculate_replay_gain_values(tracks, progress, device=device)


# the submodules the reference's root holds as attributes once imported
# (``audiotools.pcmstream``, ``audiotools.sheets``, ...), imported here on
# first use so that importing the root stays light
_SUBMODULES = frozenset((
    "_native", "audiofile", "bitstream", "cdio", "cli", "codecs",
    "dispatch", "formats", "meta", "ogg", "ops", "parallel", "pcm",
    "pcmstream", "ref", "replaygain", "services", "sheets", "sines",
    "text", "utils"))


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib
        return importlib.import_module("." + name, __name__)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
