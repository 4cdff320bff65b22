"""The tag formats: the port of the reference's ``audiotools_tpu/meta/``
without ID3's tags (which only the lossy formats read); ``id3`` holds
only the skip over ID3v2 tags in front of a FLAC or TTA stream.

``image`` (``image_metrics`` of JPEG, PNG, GIF, BMP and TIFF bytes),
``vorbiscomment`` (``VorbisComment``, FLAC's comments), ``ape``
(``ApeTag`` and ``ApeTaggedAudio``, the tags TTA and WavPack append)
and ``m4a_atoms`` (the M4A atom tree and ``M4A_META_Atom``, ALAC's
iTunes items).  Each tag class is a ``audiofile.MetaData``; its
``converted`` takes any other's fields.
"""
