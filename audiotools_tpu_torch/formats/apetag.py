"""What TTA and WavPack files need of APEv2 tags.

The reference's ``meta/ape.py`` is not ported.  This module reads the
keys of the items of the tag at a file's end, so that a conversion can
refuse tags it would drop, and appends the empty tag (a header and a
footer, no items) that the reference's ``set_metadata`` writes for a
MetaData with no fields set.
"""

from __future__ import annotations

import struct

APE_VERSION = 2000
HAS_HEADER = 0x80000000
IS_HEADER = 0x20000000


def _header(flags, size, items):
    return (b"APETAGEX" + struct.pack("<IIII", APE_VERSION, size, items,
                                      flags) + b"\x00" * 8)


# a tag of no items, with its header: the tag size counts the footer
EMPTY_TAG = (_header(HAS_HEADER | IS_HEADER, 32, 0) +
             _header(HAS_HEADER, 32, 0))


def _footer(f):
    """(tag size with the footer, item count, flags) of the tag ending
    the file, or None"""
    try:
        f.seek(-32, 2)
    except OSError:
        return None
    footer = f.read(32)
    if len(footer) < 32 or footer[0:8] != b"APETAGEX":
        return None
    (_version, size, items, flags) = struct.unpack("<IIII", footer[8:24])
    return (size, items, flags)


def item_keys(filename):
    """None when the file ends without an APEv2 tag, else its items'
    keys in order"""
    with open(filename, "rb") as f:
        footer = _footer(f)
        if footer is None:
            return None
        (size, items, _flags) = footer
        f.seek(-size, 2)
        body = f.read(size - 32)
    keys = []
    pos = 0
    for _ in range(items):
        if pos + 8 > len(body):
            break
        (value_size, _item_flags) = struct.unpack("<II", body[pos:pos + 8])
        end = body.find(b"\x00", pos + 8)
        if end < 0:
            break
        keys.append(body[pos + 8:end].decode("ascii", "replace"))
        pos = end + 1 + value_size
    return keys


def append_empty_tag(filename):
    """appends EMPTY_TAG to a file that ends without a tag"""
    with open(filename, "r+b") as f:
        if _footer(f) is None:
            f.seek(0, 2)
            f.write(EMPTY_TAG)
