"""The strings the port's track2track, trackverify, trackcmp, trackinfo
and tracklength print, copied from the reference's
``audiotools_tpu/text.py`` so that their lines compare equal."""

ERR_1_FILE_REQUIRED = "you must specify at least 1 supported audio file"
ERR_UNSUPPORTED_AUDIO_TYPE = "unsupported audio type \"%(type)s\""
ERR_SUPPORTED_TYPES = "supported types: %(types)s"
ERR_UNSUPPORTED_COMPRESSION = ("\"%(quality)s\" is not a supported "
                               "compression mode for type \"%(type)s\"")
ERR_OUTPUT_IS_INPUT = "%(filename)s cannot be both input and output file"
ERR_OUTPUT_DUPLICATE_NAME = ("output file occurs more than once; use "
                             "--format with distinguishing fields")
ERR_ONE_OUTPUT_FILE = "you may specify only 1 input file for use with -o"
ERR_MAKEDIRS = "unable to create directory for \"%(filename)s\": %(error)s"
ERR_PAIRS_REQUIRED = "you must specify pairs of files or 2 directories"

HELP_VERBOSITY = "the verbosity level to execute at"
HELP_VERSION = "display version number and exit"
HELP_TYPE = "the audio type to convert to"
HELP_QUALITY = "the quality to store audio at"
HELP_DIR = "the directory to store new files in"
HELP_FORMAT = "the format string for new filenames"
HELP_OUTPUT = "an output file (single input only)"
HELP_JOINT = "the maximum number of parallel jobs"
HELP_METADATA_LOOKUP = ("treat the input files as one album and look up "
                        "metadata from online services")
HELP_INTERACTIVE = "edit metadata and output options interactively"
HELP_SAMPLE_RATE = "convert audio to the given sample rate"
HELP_CHANNELS = "convert audio to the given channel count"
HELP_BITS_PER_SAMPLE = "convert audio to the given bits-per-sample"
HELP_REPLAY_GAIN = "add ReplayGain metadata to output files"
HELP_NO_REPLAY_GAIN = "do not add ReplayGain metadata"
HELP_VERIFY_ACCURATERIP = "verify tracks against the AccurateRip database"
HELP_DEVICES = ("the torch devices to run jobs on: a count N of cards "
                "(cuda:0 .. cuda:N-1) or a comma list such as cuda:0,cpu "
                "(default: the current card)")

DESC_TRACK2TRACK = "convert audio files from one format to another"
LAB_T2T_CONVERTED = "%(source)s -> %(destination)s"
DESC_TRACKCMP = "compare audio files for PCM equality"
LAB_TRACKCMP_OK = "%(file1)s <> %(file2)s : OK"
LAB_TRACKCMP_MISMATCH = ("%(file1)s <> %(file2)s : differ at PCM frame "
                         "%(frame)d")
LAB_CMP_MISSING = "%(filename)s: missing"
DESC_TRACKVERIFY = "verify the losslessness of audio files"
LAB_TRACKVERIFY_OK = "%(filename)s : OK"
LAB_TRACKVERIFY_FAILED = "%(filename)s : %(error)s"
LAB_TRACKVERIFY_RESULTS = "Results:"

RG_ADDING_REPLAYGAIN_WAIT = ("Adding ReplayGain metadata; this may take "
                             "some time")
RG_REPLAYGAIN_ADDED = "ReplayGain added"

ERR_FILE_MESSAGE = "%(filename)s: %(message)s"
DESC_TRACKINFO = "display audio file metadata and attributes"
HELP_INFO_NO_METADATA = "do not display metadata"
HELP_INFO_LOW_LEVEL = "display low-level format metadata"
HELP_INFO_BITRATE = "display the file's bitrate"
HELP_INFO_PERCENTAGE = "display the wasted-space percentage"
HELP_INFO_CHANNEL_ASSIGNMENT = "display the file's channel assignment"
LAB_INFO_ATTRIBS = ("%(filename)s: %(minutes)d:%(seconds)2.2d, "
                    "%(channels)dch, %(sample_rate)dHz, "
                    "%(bits_per_sample)d-bit, %(name)s")
LAB_INFO_CHANNELS = "Assigned Channels:"
LAB_INFO_CHANNEL = "channel %(channel)d -> %(name)s"
LAB_INFO_CHANNEL_UNDEFINED = "channel %(channel)d -> undefined"
LAB_BITRATE_LINE = "%(bitrate)4.4s kbps: %(filename)s"
LAB_PERCENTAGE_LINE = "%(percent)3.3s%%: %(filename)s"
DESC_TRACKLENGTH = "display the total length of audio files"
LAB_TRACKLENGTH_TOTAL = "%(hours)d:%(minutes)2.2d:%(seconds)2.2d"
