"""The tag formats: the port of the reference's ``audiotools_tpu/meta/``.

``image`` (``image_metrics`` of JPEG, PNG, GIF, BMP and TIFF bytes),
``vorbiscomment`` (``VorbisComment``: FLAC's, Vorbis's and Opus's
comments), ``ape`` (``ApeTag`` and ``ApeTaggedAudio``, the tags TTA and
WavPack append), ``m4a_atoms`` (the M4A atom tree and ``M4A_META_Atom``,
ALAC's iTunes items), ``id3`` (ID3v2.2, v2.3 and v2.4 tags,
``ID3CommentPair``, and the skip over ID3v2 tags in front of a FLAC,
TTA, MP3 or MP2 stream) and ``id3v1`` (the 128-byte ID3v1 tag).  Each
tag class is a ``audiofile.MetaData``; its ``converted`` takes any
other's fields.
"""
