"""ID3v2 tags in front of a stream: how many there are, and how far to
skip them.

The port's copy of ``skip_id3v2_comment`` and ``total_id3v2_comments``
from the reference's ``audiotools_tpu/meta/id3.py``.  FLAC and TTA
files may begin with one or more ID3v2 tags (an encoder's or a
tagger's); their readers start past them.  The tags' frames are not
parsed here.
"""

from __future__ import annotations


def _tag_size(header):
    """the size after its 10-byte header of the ID3v2 tag whose header
    is ``header``, or None when the bytes are no such header"""
    if len(header) == 10 and header[0:3] == b"ID3" and header[3] in (2, 3, 4):
        size = 0
        for b in header[6:10]:
            size = (size << 7) | (b & 0x7F)
        return size
    return None


def skip_id3v2_comment(file):
    """seeks a binary file past the ID3v2 tags at its position (stacked
    tags too); returns the bytes skipped, 0 when there is no tag"""
    start = file.tell()
    skipped = 0
    while True:
        size = _tag_size(file.read(10))
        if size is None:
            file.seek(start + skipped, 0)
            return skipped
        skipped += 10 + size
        file.seek(start + skipped, 0)


def total_id3v2_comments(file):
    """the number of ID3v2 tags one after another at a binary file's
    position, which is kept"""
    start = file.tell()
    count = 0
    while True:
        size = _tag_size(file.read(10))
        if size is None:
            break
        file.seek(size, 1)
        count += 1
    file.seek(start, 0)
    return count
