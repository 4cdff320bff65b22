"""ID3v1 tags: the fixed 128 bytes at the end of an MP3 or MP2 file.

The port's copy of the reference's ``audiotools_tpu/meta/id3v1.py``:
"TAG", 30-byte latin-1 title, artist and album fields, a 4-byte year, a
28-byte comment, a track number byte (ID3v1.1) and a genre byte, read
from the last 128 bytes of a file and written at a file's position.
"""

from __future__ import annotations

import os

from .. import text
from ..audiofile import MetaData


def _pad(text, length):
    """latin-1 encodes and NUL-pads text to a fixed field width"""
    data = (text or "").encode("latin-1", "replace")[:length]
    return data + b"\x00" * (length - len(data))


def _unpad(data):
    return data.split(b"\x00", 1)[0].decode("latin-1",
                                            "replace").rstrip()


class ID3v1Comment(MetaData):
    """a 128-byte ID3v1 tag, read as ID3v1.1 (a track number byte after
    a 28-byte comment) where its comment's 29th byte is 0"""

    NAME = "ID3v1.1"

    def __init__(self, track_name="", artist_name="", album_name="",
                 year="", comment="", track_number=0, genre=0):
        d = self.__dict__
        d["__track_name__"] = track_name
        d["__artist_name__"] = artist_name
        d["__album_name__"] = album_name
        d["__year__"] = year
        d["__comment__"] = comment
        d["__track_number__"] = track_number
        d["__genre__"] = genre

    def copy(self):
        return ID3v1Comment(self.__track_name__, self.__artist_name__,
                            self.__album_name__, self.__year__,
                            self.__comment__, self.__track_number__,
                            self.__genre__)

    def __repr__(self):
        return ("ID3v1Comment(%r, %r, %r, %r, %r, %r, %r)" %
                (self.__track_name__, self.__artist_name__,
                 self.__album_name__, self.__year__, self.__comment__,
                 self.__track_number__, self.__genre__))

    def raw_info(self):
        return os.linesep.join([
            "ID3v1.1:",
            "  track name = %s" % (self.__track_name__,),
            " artist name = %s" % (self.__artist_name__,),
            "  album name = %s" % (self.__album_name__,),
            "        year = %s" % (self.__year__,),
            "     comment = %s" % (self.__comment__,),
            "track number = %d" % (self.__track_number__,),
            "       genre = %d" % (self.__genre__,)])

    _FIELD_MAP = {"track_name": "__track_name__",
                  "artist_name": "__artist_name__",
                  "album_name": "__album_name__",
                  "year": "__year__",
                  "comment": "__comment__"}

    def __getattr__(self, attr):
        if attr in self._FIELD_MAP:
            value = self.__dict__[self._FIELD_MAP[attr]]
            return value if value else None
        elif attr == "track_number":
            number = self.__dict__["__track_number__"]
            return number if number else None
        elif attr in MetaData.FIELDS:
            return None
        else:
            raise AttributeError(attr)

    def __setattr__(self, attr, value):
        if attr in self._FIELD_MAP:
            self.__dict__[self._FIELD_MAP[attr]] = \
                str(value) if value is not None else ""
        elif attr == "track_number":
            self.__dict__["__track_number__"] = \
                int(value) if value is not None else 0
        elif attr in MetaData.FIELDS:
            pass                # unstorable field: dropped
        else:
            self.__dict__[attr] = value

    def __delattr__(self, attr):
        if attr in self._FIELD_MAP:
            self.__dict__[self._FIELD_MAP[attr]] = ""
        elif attr == "track_number":
            self.__dict__["__track_number__"] = 0
        elif attr in MetaData.FIELDS:
            pass
        else:
            MetaData.__delattr__(self, attr)

    @classmethod
    def parse(cls, file):
        """reads an ID3v1 tag from the last 128 bytes of a file

        raises ValueError if the tag is missing or invalid"""
        file.seek(-128, 2)
        data = file.read(128)
        if len(data) != 128 or data[0:3] != b"TAG":
            raise ValueError("invalid ID3v1 tag")
        track_number = 0
        comment_field = data[97:127]
        if comment_field[28] == 0:
            track_number = comment_field[29]
            comment_field = comment_field[:28]
        return cls(track_name=_unpad(data[3:33]),
                   artist_name=_unpad(data[33:63]),
                   album_name=_unpad(data[63:93]),
                   year=_unpad(data[93:97]),
                   comment=_unpad(comment_field),
                   track_number=track_number,
                   genre=data[127])

    def build(self, file):
        """writes the 128-byte tag at the current file position"""
        file.write(b"TAG")
        file.write(_pad(self.__track_name__, 30))
        file.write(_pad(self.__artist_name__, 30))
        file.write(_pad(self.__album_name__, 30))
        file.write(_pad(self.__year__, 4))
        file.write(_pad(self.__comment__, 28))
        file.write(bytes([0, self.__track_number__ & 0xFF,
                          self.__genre__ & 0xFF]))

    def size(self):
        return 128

    @classmethod
    def supports_images(cls):
        return False

    def images(self):
        return []

    @classmethod
    def converted(cls, metadata):
        """converts a MetaData object to an ID3v1Comment"""
        if metadata is None:
            return None
        if isinstance(metadata, ID3v1Comment):
            return metadata.copy()
        return cls(track_name=metadata.track_name or "",
                   artist_name=metadata.artist_name or "",
                   album_name=metadata.album_name or "",
                   year=str(metadata.year) if metadata.year else "",
                   comment=metadata.comment or "",
                   track_number=metadata.track_number or 0)

    def clean(self):
        """returns (cleaned metadata, list of fix descriptions)"""
        fixes = []
        fields = {}
        for (attr, key) in self._FIELD_MAP.items():
            value = self.__dict__[key]
            stripped = value.strip()
            if stripped != value:
                fixes.append(text.CLEAN_STRIP_WHITESPACE % {"field": attr})
            fields[attr] = stripped
        return (ID3v1Comment(track_name=fields["track_name"],
                             artist_name=fields["artist_name"],
                             album_name=fields["album_name"],
                             year=fields["year"],
                             comment=fields["comment"],
                             track_number=self.__track_number__,
                             genre=self.__genre__), fixes)
