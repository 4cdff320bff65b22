"""The strings the port's tag and format classes report, copied from
the reference's ``audiotools_tpu/text.py`` so that they compare equal:
the fixes ``clean`` finds (which tracklint prints), the compression
modes' descriptions (which audiotools-config lists), the Ogg page
errors (which trackverify prints) and the ID3 header error.  The tools' own
strings are in ``cli/text.py``."""

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
