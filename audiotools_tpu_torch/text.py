"""The strings the port's tag and format classes report, copied from
the reference's ``audiotools_tpu/text.py`` so that they compare equal:
the fixes ``clean`` finds (which tracklint prints), the compression
modes' descriptions (which audiotools-config lists), the Ogg page
errors (which trackverify prints), the ID3 header error, and the
labels of ``ui`` (its widgets, listings and line-oriented prompts).
The tools' own strings are in ``cli/text.py``."""

CLEAN_REMOVE_DUPLICATE_TAG = "removed duplicate tag %(field)s"
CLEAN_REMOVE_TRAILING_WHITESPACE = "removed trailing whitespace from %(field)s"
CLEAN_REMOVE_LEADING_WHITESPACE = "removed leading whitespace from %(field)s"
CLEAN_REMOVE_LEADING_WHITESPACE_ZEROES = ("removed leading whitespace/zeroes "
                                          "from %(field)s")
CLEAN_REMOVE_LEADING_ZEROES = "removed leading zeroes from %(field)s"
CLEAN_REMOVE_EMPTY_TAG = "removed empty field %(field)s"
CLEAN_STRIP_WHITESPACE = "stripped whitespace from %(field)s"
CLEAN_FIX_IMAGE_FIELDS = "fixed embedded image metadata fields"
CLEAN_FLAC_REMOVE_SEEKPOINT = "removed misordered seekpoint"
CLEAN_FLAC_MULTIPLE_STREAMINFO = "removed duplicate STREAMINFO"
CLEAN_FLAC_MULTIPLE_VORBISCOMMENT = "removed duplicate Vorbis comment block"
CLEAN_FLAC_MULTIPLE_SEEKTABLE = "removed duplicate seektable"

COMP_FLAC_0 = "least amount of compression"
COMP_FLAC_8 = "most amount of compression"
COMP_WAVPACK_VERYFAST = "fastest encode/decode, worst compression"
COMP_WAVPACK_VERYHIGH = "slowest encode/decode, best compression"
COMP_TTA = "fixed compression (True Audio has one mode)"
COMP_SHN = "fixed compression (Shorten has one mode)"
COMP_ALAC = "fixed compression (Apple Lossless has one mode)"
COMP_LAME_0 = "high quality, larger files"
COMP_LAME_9 = "low quality, smaller files"
COMP_TWOLAME_64 = "smallest files"
COMP_TWOLAME_384 = "highest quality"
COMP_VORBIS_0 = "smallest files"
COMP_VORBIS_10 = "highest quality"
COMP_OPUS_0 = "fastest encode"
COMP_OPUS_10 = "best quality"

ERR_ID3_INVALID_HEADER = "invalid ID3 header"

ERR_OGG_INVALID_PAGE = "invalid Ogg page marker"
ERR_OGG_CHECKSUM_MISMATCH = "Ogg page checksum mismatch"

ERR_OUTPUT_IS_INPUT = "%(filename)s cannot be both input and output file"
ERR_OUTPUT_DUPLICATE_NAME = ("output file occurs more than once; use "
                             "--format with distinguishing fields")
ERR_OUTPUT_INVALID_FORMAT = ("unable to build output filenames from format "
                             "string")
ERR_URWID_REQUIRED = ("urwid is required for interactive mode; run without "
                      "-I or install urwid")
ERR_TERMIOS_ERROR = "unable to get tty settings (%(error)s)"
LAB_CANCEL_BUTTON = "Cancel"
LAB_APPLY_BUTTON = "Apply"
LAB_NEXT_BUTTON = "Next"
LAB_PREVIOUS_BUTTON = "Previous"
LAB_KEY_NEXT = "next %s"
LAB_KEY_PREVIOUS = "previous %s"
LAB_SELECT_BEST_MATCH = "Select Best Match"
LAB_TRACK_METADATA = "Track Metadata"
LAB_OUTPUT_OPTIONS = "Output Options"
LAB_AVAILABLE_FORMATS = "Available Formats"
LAB_AVAILABLE_QUALITIES = "Available Qualities for \"%s\""
LAB_OPTIONS_OUTPUT_DIRECTORY = "Output Directory:"
LAB_OPTIONS_FILENAME_FORMAT = "Filename Format:"
LAB_OPTIONS_AUDIO_CLASS = "Audio Format:"
LAB_OPTIONS_AUDIO_QUALITY = "Audio Quality:"
LAB_CHOOSE_METADATA = "multiple metadata choices:"
LAB_NO_QUALITY_SETTINGS = "(no quality settings)"
LAB_PLAY_STATUS = ("Track %(track_number)d/%(track_total)d "
                   "[%(minutes)d:%(seconds)2.2d / "
                   "%(total_minutes)d:%(total_seconds)2.2d] "
                   "%(channels)dch %(sample_rate)dHz "
                   "%(bits_per_sample)d-bit")
LAB_PLAY_BUTTON = "Play"
LAB_PAUSE_BUTTON = "Pause"
LAB_STOP_BUTTON = "Stop"
LAB_PLAY_TRACK = "Track"
METADATA_TRACK_NAME = "Track Name"
