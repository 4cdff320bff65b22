"""The strings the port reports, copied from the reference's
``audiotools_tpu/text.py`` so that they compare equal: every string of
it, under its name (the tools import them through ``cli/text``), the
fixes ``clean`` finds, the compression modes' descriptions, the Ogg
page errors, the labels of ``ui`` and the speaker names that
``str(ChannelMask)`` lists among them.  ``HELP_DEVICES`` is the port's
own, for its ``--devices`` option."""

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

HELP_DEVICES = ("the torch devices to run jobs on: a count N of cards "
                "(cuda:0 .. cuda:N-1) or a comma list such as cuda:0,cpu "
                "(default: the current card)")

# the reference's other strings, as it defines them
ERR_1_FILE_REQUIRED = 'you must specify at least 1 supported audio file'
ERR_FILES_REQUIRED = ('you must specify at least 1 supported audio '
                      'file;\nperhaps "%(command)s"')
ERR_FILE_NOT_FOUND = 'file or directory not found'
ERR_UNSUPPORTED_TYPE = 'unsupported audio type %(type)r'
ERR_UNSUPPORTED_AUDIO_TYPE = 'unsupported audio type "%(type)s"'
ERR_SUPPORTED_TYPES = 'supported types: %(types)s'
ERR_UNSUPPORTED_COMPRESSION = ('"%(quality)s" is not a supported '
                               'compression mode for type "%(type)s"')
ERR_NO_COMPRESSION_MODES = 'audio type "%(type)s" has no quality settings'
ERR_DUPLICATE_FILE = 'file %(filename)s included more than once'
ERR_OPEN_IOERROR = 'unable to open %(filename)s'
ERR_ENCODING_ERROR = 'unable to write %(filename)s'
ERR_DECODING_ERROR = 'unable to read %(filename)s'
ERR_INVALID_FILENAME_FORMAT = 'invalid filename format string'
ERR_ONE_OUTPUT_FILE = 'you may specify only 1 input file for use with -o'
ERR_MAKEDIRS = 'unable to create directory for "%(filename)s": %(error)s'
ERR_NO_STDIN_TTY = 'standard input is not a tty'
LAB_CHOICE_PROMPT = 'choice [1]: '
LAB_DEFAULT_SUFFIX = ' (default)'
LAB_X_OF_Y = '%(x)d of %(y)d'
LAB_TRACK_X_OF_Y = 'track %(x)d of %(y)d'
HELP_VERBOSITY = 'the verbosity level to execute at'
HELP_VERSION = 'display version number and exit'
HELP_TYPE = 'the audio type to convert to'
HELP_QUALITY = 'the quality to store audio at'
HELP_DIR = 'the directory to store new files in'
HELP_FORMAT = 'the format string for new filenames'
HELP_OUTPUT = 'an output file (single input only)'
HELP_JOINT = 'the maximum number of parallel jobs'
HELP_NO_MUSICBRAINZ = 'do not query the MusicBrainz service'
HELP_MUSICBRAINZ_SERVER = 'the MusicBrainz server to query'
HELP_NO_FREEDB = 'do not query the FreeDB service'
HELP_FREEDB_SERVER = 'the FreeDB server to query'
HELP_METADATA_LOOKUP = ('treat the input files as one album and look up '
                        'metadata from online services')
HELP_USE_DEFAULT = ('with -M, use the default blank choice instead of the '
                    'first service match')
HELP_INTERACTIVE = 'edit metadata and output options interactively'
HELP_SAMPLE_RATE = 'convert audio to the given sample rate'
HELP_CHANNELS = 'convert audio to the given channel count'
HELP_BITS_PER_SAMPLE = 'convert audio to the given bits-per-sample'
HELP_REPLAY_GAIN = 'add ReplayGain metadata to output files'
HELP_NO_REPLAY_GAIN = 'do not add ReplayGain metadata'
HELP_CUESHEET = 'a cuesheet to embed or split tracks with'
HELP_ALBUM_NUMBER = 'the album number of this disc'
HELP_ALBUM_TOTAL = "the total albums of this disc's set"
DESC_TRACK2TRACK = 'convert audio files from one format to another'
LAB_T2T_USING_METADATA = 'Using metadata: %(album)s'
LAB_T2T_CONVERTED = '%(source)s -> %(destination)s'
LAB_UNTITLED = '(untitled)'
DESC_TRACKCAT = 'concatenate audio files into one'
HELP_CAT_OUTPUT = 'the output file to write'
ERR_TRACKCAT_SAMPLE_RATES = 'all files must have the same sample rate'
ERR_TRACKCAT_CHANNELS = 'all files must have the same channel count'
ERR_TRACKCAT_BPS = 'all files must have the same bits-per-sample'
DESC_TRACKSPLIT = 'split an audio file by cuesheet'
ERR_TRACKSPLIT_ONE_FILE = 'you must specify exactly 1 supported audio file'
ERR_TRACKSPLIT_NO_CUESHEET = 'you must specify a cuesheet to split audio with'
ERR_TRACKSPLIT_SHORT = "the audio file is shorter than the cuesheet's tracks"
DESC_TRACKCMP = 'compare audio files for PCM equality'
LAB_TRACKCMP_OK = '%(file1)s <> %(file2)s : OK'
LAB_TRACKCMP_MISMATCH = ('%(file1)s <> %(file2)s : differ at PCM frame '
                         '%(frame)d')
ERR_TRACKCMP_PAIR = 'you must specify 2 files or 2 directories'
ERR_TRACKCMP_MISSING = '%(filename)s: missing in %(directory)s'
DESC_TRACKINFO = 'display audio file metadata and attributes'
HELP_INFO_NO_METADATA = 'do not display metadata'
HELP_INFO_LOW_LEVEL = 'display low-level format metadata'
HELP_INFO_BITRATE = "display the file's bitrate"
HELP_INFO_PERCENTAGE = 'display the wasted-space percentage'
HELP_INFO_CHANNEL_ASSIGNMENT = "display the file's channel assignment"
LAB_INFO_ATTRIBS = ('%(filename)s: %(minutes)d:%(seconds)2.2d, '
                    '%(channels)dch, %(sample_rate)dHz, '
                    '%(bits_per_sample)d-bit, %(name)s')
LAB_INFO_CHANNELS = 'Assigned Channels:'
LAB_INFO_CHANNEL = 'channel %(channel)d -> %(name)s'
LAB_INFO_CHANNEL_UNDEFINED = 'channel %(channel)d -> undefined'
DESC_TRACKLENGTH = 'display the total length of audio files'
LAB_TRACKLENGTH_TOTAL = '%(hours)d:%(minutes)2.2d:%(seconds)2.2d'
DESC_TRACKRENAME = 'rename audio files by metadata'
LAB_TRACKRENAME_RENAMED = '%(source)s -> %(destination)s'
ERR_TRACKRENAME_COLLISION = 'unable to rename "%(source)s": target exists'
DESC_TRACKTAG = 'update audio file metadata'
HELP_TAG_NAME = "the track's name"
HELP_TAG_ARTIST = "the track's artist"
HELP_TAG_PERFORMER = "the track's performer"
HELP_TAG_COMPOSER = "the track's composer"
HELP_TAG_CONDUCTOR = "the track's conductor"
HELP_TAG_ALBUM = "the track's album name"
HELP_TAG_NUMBER = "the track's number on the album"
HELP_TAG_TRACK_TOTAL = 'the total number of tracks on the album'
HELP_TAG_ALBUM_NUMBER = "the album's number in its set"
HELP_TAG_ALBUM_TOTAL = 'the total number of albums in the set'
HELP_TAG_YEAR = "the album's release year"
HELP_TAG_DATE = "the track's recording date"
HELP_TAG_CATALOG = "the album's catalog number"
HELP_TAG_ISRC = "the track's ISRC code"
HELP_TAG_PUBLISHER = "the album's publisher"
HELP_TAG_MEDIA = "the album's source media"
HELP_TAG_COPYRIGHT = "the track's copyright information"
HELP_TAG_COMMENT = 'a track comment'
HELP_TAG_COMMENT_FILE = 'a file containing a track comment'
HELP_TAG_REMOVE = 'remove all existing metadata first'
HELP_TAG_FRONT_COVER = "an image file of the album's front cover"
HELP_TAG_BACK_COVER = "an image file of the album's back cover"
HELP_TAG_LEAFLET = "an image file of the album's leaflet"
HELP_TAG_MEDIA_IMAGE = "an image file of the album's media"
HELP_TAG_OTHER_IMAGE = 'another image file associated with the album'
HELP_TAG_REMOVE_IMAGES = 'remove existing images first'
LAB_TRACKTAG_TAGGED = 'tagged %(filename)s'
ERR_TRACKTAG_COMMENT_IOERROR = 'unable to open comment file %(filename)s'
ERR_TRACKTAG_COMMENT_NOT_UTF8 = 'comment file %(filename)s is not UTF-8 text'
DESC_TRACKVERIFY = 'verify the losslessness of audio files'
HELP_VERIFY_ACCURATERIP = 'verify tracks against the AccurateRip database'
LAB_TRACKVERIFY_OK = '%(filename)s : OK'
LAB_TRACKVERIFY_FAILED = '%(filename)s : %(error)s'
LAB_TRACKVERIFY_RESULTS = 'Results:'
LAB_TRACKVERIFY_SUCCESS_RATE = ('%(success)d of %(total)d files OK '
                                '(%(rate).1f%%)')
LAB_ACCURATERIP_MATCH = '%(filename)s : AccurateRip confidence %(confidence)d'
LAB_ACCURATERIP_MISMATCH = '%(filename)s : AccurateRip MISMATCH'
LAB_ACCURATERIP_NOT_FOUND = ('%(filename)s : not present in AccurateRip '
                             'database')
DESC_TRACKLINT = 'detect and fix broken audio file metadata'
HELP_LINT_FIX = 'fix detected problems'
HELP_LINT_DB = 'the undo database file to store backups in'
HELP_LINT_UNDO = 'undo fixes from the undo database'
ERR_UNDO_REQUIRES_DB = '--undo requires --db'
LAB_RESTORED = '* %(filename)s: restored'
LAB_NO_BACKUP = '* %(filename)s: no stored backup'
LAB_FIXED = '* %(filename)s: fixed'
LAB_LINT_MESSAGE = '* %(filename)s: %(message)s'
DESC_TRACKPLAY = 'play audio files'
HELP_PLAY_OUTPUT = 'the audio output to play to'
HELP_PLAY_SHUFFLE = 'play files in random order'
HELP_PLAY_REPEAT = 'repeat the playlist endlessly'
LAB_PLAYING = 'playing %(filename)s'
LAB_STOPPED = 'stopped'
ERR_NO_OUTPUT = 'no available audio output'
DESC_CD2TRACK = 'extract CD audio to files'
DESC_CDINFO = 'display CD information'
DESC_CDPLAY = 'play audio CDs'
HELP_CDROM = 'the CD-ROM device or disc image to read'
HELP_READ_SPEED = 'the speed to read the CD at'
ERR_NO_CDDA = ('physical CD-ROM devices are not supported in this build; '
               'use a cue/toc disc image')
ERR_TRACK_NOT_FOUND = 'track %(track)d not found on disc'
LAB_TRACK_PROGRESS = 'track %(track)d'
LAB_RIPPED_TRACK = 'ripped track %(track)d'
LAB_CDINFO_TRACKS = 'Tracks : %(count)d'
LAB_CDINFO_LENGTH = 'Length : %(minutes)d:%(seconds)2.2d'
LAB_CDINFO_FREEDB = 'FreeDB ID      : %(id)s'
LAB_CDINFO_MUSICBRAINZ = 'MusicBrainz ID : %(id)s'
LAB_CDINFO_ACCURATERIP = 'AccurateRip ID : %(id)s'
LAB_CDINFO_HEADER = '#  Offset   Length   Seconds'
LAB_CDPLAY_TRACK = 'playing track %(track)d'
LAB_ACCURATERIP_DISC_ID = 'AccurateRip disc ID: %(id)s'
LAB_USING_METADATA = 'Using metadata: %(album)s'
DESC_DVDA2TRACK = 'extract DVD-Audio titles to files'
DESC_DVDAINFO = 'display DVD-Audio disc information'
HELP_AUDIO_TS = "the disc's AUDIO_TS directory"
HELP_DVDA_TITLE = 'the title number to extract'
ERR_NO_AUDIO_TS = "you must specify the disc's AUDIO_TS directory with -A"
ERR_INVALID_TITLE = 'title %(title)d not found on disc'
LAB_DVDA_TITLE = 'Title %(title)d'
LAB_DVDA_TRACK = 'title %(title)d - track %(track)2.2d'
LAB_DVDA_EXTRACTED = 'extracted track %(track)d'
DESC_TRACK2CD = 'burn audio files to CD or build a disc image'
HELP_T2CD_CUESHEET = 'the cuesheet to arrange tracks with'
HELP_T2CD_IMAGE = 'write a disc image to the given path instead of burning'
ERR_T2CD_NO_BURNER = ('no CD burning backend is available; use --image to '
                      'build cue/bin files')
ERR_T2CD_NO_BURNER_IMAGE = ('no CD burning binary found (cdrdao/cdrecord); '
                            'image retained at %(cue)s')
LAB_T2CD_WROTE = 'wrote %(cue)s + %(bin)s'
HELP_SPEED = 'the speed to burn the CD at'
DESC_COVERDUMP = 'extract cover art from an audio file'
DESC_COVERTAG = 'attach cover art to audio files'
DESC_COVERVIEW = "display an audio file's cover art"
HELP_COVERDUMP_PREFIX = 'the prefix for dumped image files'
ERR_NO_IMAGES = 'no images found in %(filename)s'
ERR_NO_IMAGES_PLAIN = 'no images found'
LAB_DUMPED_IMAGE = 'dumped %(output)s'
LAB_VIEWER_UNAVAILABLE = 'viewer unavailable (%(error)s); listing instead'
DESC_CONFIG = 'display and edit audiotools configuration'
LAB_CONFIG_SYSTEM = 'System:'
LAB_CONFIG_DEFAULT_TYPE = '  default type : %(type)s'
LAB_CONFIG_MAX_JOBS = '  maximum jobs : %(jobs)d'
LAB_CONFIG_FORMATS = 'Available Formats:'
LAB_CONFIG_SET = 'set %(section)s.%(option)s = %(value)s'
ERR_ID3_INVALID_VERSION = 'invalid ID3 major version'
ERR_APE_INVALID_HEADER = 'invalid ApeTag header'
ERR_VORBIS_INVALID_COMMENT = 'invalid Vorbis comment'
ERR_IMAGE_UNKNOWN_TYPE = 'unknown image type'
ERR_FLAC_INVALID_FILE = 'invalid FLAC file'
ERR_FLAC_MD5_MISMATCH = 'MD5 mismatch at end of stream'
ERR_WAV_INVALID_FILE = 'invalid RIFF WAVE file'
ERR_AIFF_INVALID_FILE = 'invalid AIFF file'
ERR_MP3_INVALID_FRAME = 'invalid MPEG frame header'
ERR_TTA_INVALID_SIGNATURE = 'invalid TTA signature'
ERR_TTA_INVALID_CRC = 'invalid CRC32 in frame'
ERR_WAVPACK_INVALID_BLOCK = 'invalid WavPack block'
ERR_SHN_INVALID_MAGIC = 'invalid Shorten magic number'
ERR_ALAC_INVALID_ATOM = 'required atom not found'
MASK_FRONT_LEFT = 'front_left'
MASK_FRONT_RIGHT = 'front_right'
MASK_FRONT_CENTER = 'front_center'
MASK_LFE = 'low_frequency'
MASK_BACK_LEFT = 'back_left'
MASK_BACK_RIGHT = 'back_right'
MASK_FRONT_LEFT_OF_CENTER = 'front_left_of_center'
MASK_FRONT_RIGHT_OF_CENTER = 'front_right_of_center'
MASK_BACK_CENTER = 'back_center'
MASK_SIDE_LEFT = 'side_left'
MASK_SIDE_RIGHT = 'side_right'
MASK_TOP_CENTER = 'top_center'
MASK_TOP_FRONT_LEFT = 'top_front_left'
MASK_TOP_FRONT_CENTER = 'top_front_center'
MASK_TOP_FRONT_RIGHT = 'top_front_right'
MASK_TOP_BACK_LEFT = 'top_back_left'
MASK_TOP_BACK_CENTER = 'top_back_center'
MASK_TOP_BACK_RIGHT = 'top_back_right'
METADATA_TRACK_NUMBER = 'Track Number'
METADATA_TRACK_TOTAL = 'Track Total'
METADATA_ALBUM_NAME = 'Album Name'
METADATA_ARTIST_NAME = 'Artist Name'
METADATA_PERFORMER_NAME = 'Performer Name'
METADATA_COMPOSER_NAME = 'Composer Name'
METADATA_CONDUCTOR_NAME = 'Conductor Name'
METADATA_MEDIA = 'Media'
METADATA_ISRC = 'ISRC'
METADATA_CATALOG = 'Catalog Number'
METADATA_COPYRIGHT = 'Copyright'
METADATA_PUBLISHER = 'Publisher'
METADATA_YEAR = 'Release Year'
METADATA_DATE = 'Recording Date'
METADATA_ALBUM_NUMBER = 'Album Number'
METADATA_ALBUM_TOTAL = 'Album Total'
METADATA_COMMENT = 'Comment'
METADATA_SUFFIX = 'suffix'
METADATA_ALBUM_TRACK_NUMBER = 'album/track number'
METADATA_BASENAME = 'base filename'
CLEAN_FIX_TAG_FORMATTING = 'fixed formatting of %(field)s'
CLEAN_REMOVE_DUPLICATE_ID3V2 = 'removed duplicate ID3v2 tag'
CLEAN_FLAC_REORDER_SEEKPOINTS = 'reordered seektable seekpoints'
CLEAN_FLAC_REMOVE_ID3V2 = 'removed ID3v2 tag'
CLEAN_FLAC_REMOVE_ID3V1 = 'removed ID3v1 tag'
CLEAN_FLAC_POPULATE_MD5 = 'populated empty MD5SUM'
CLEAN_FLAC_ADD_CHANNELMASK = 'added WAVEFORMATEXTENSIBLE_CHANNEL_MASK'
CLEAN_WAV_MULTIPLE_FMT_CHUNKS = 'removed duplicate fmt chunk'
CLEAN_WAV_MULTIPLE_DATA_CHUNKS = 'removed duplicate data chunk'
CLEAN_WAV_REORDERED_DATA_CHUNK = 'moved data chunk after fmt chunk'
CLEAN_AIFF_MULTIPLE_COMM_CHUNKS = 'removed duplicate COMM chunk'
CLEAN_AIFF_MULTIPLE_SSND_CHUNKS = 'removed duplicate SSND chunk'
CLEAN_AIFF_REORDERED_SSND_CHUNK = 'moved SSND chunk after COMM chunk'
RG_ADDING_REPLAYGAIN = 'Adding ReplayGain'
RG_APPLYING_REPLAYGAIN = 'Applying ReplayGain'
RG_ADDING_REPLAYGAIN_TO_ALBUM = 'Adding ReplayGain to album %(album)d'
RG_APPLYING_REPLAYGAIN_TO_ALBUM = 'Applying ReplayGain to album %(album)d'
RG_ADDING_REPLAYGAIN_WAIT = ('Adding ReplayGain metadata; this may take '
                             'some time')
RG_APPLYING_REPLAYGAIN_WAIT = 'Applying ReplayGain; this may take some time'
RG_REPLAYGAIN_ADDED = 'ReplayGain added'
RG_REPLAYGAIN_ADDED_TO_ALBUM = 'ReplayGain added to album %(album)d'
RG_REPLAYGAIN_APPLIED = 'ReplayGain applied'
RG_REPLAYGAIN_APPLIED_TO_ALBUM = 'ReplayGain applied to album %(album)d'
LAB_CONFIG_QUALITY = 'Quality Modes:'
LAB_CONFIG_QUALITY_DEFAULT = '%(mode)s (default)'
HELP_CONFIG_TYPE = 'set the default audio type'
HELP_READ_OFFSET = 'drive read offset, in PCM samples'
HELP_CD_TRACKS = 'track numbers to rip (default: all)'
ERR_FILE_MESSAGE = '%(filename)s: %(message)s'
ERR_INVALID_FIELD_VALUE = 'invalid value for %(field)s'
ERR_PAIRS_REQUIRED = 'you must specify pairs of files or 2 directories'
LAB_CMP_MISSING = '%(filename)s: missing'
LAB_DVDA_TITLESET = 'Titleset %(titleset)d:'
LAB_COVER_LINE = ('%(index)d: %(type)s %(width)dx%(height)d %(mime)s '
                  '(%(size)d bytes)')
LAB_BITRATE_LINE = '%(bitrate)4.4s kbps: %(filename)s'
LAB_PERCENTAGE_LINE = '%(percent)3.3s%%: %(filename)s'
