"""ID3 tags: ID3v2.2, ID3v2.3 and ID3v2.4, the pair of an ID3v2 and an
ID3v1 tag, and the skip over ID3v2 tags in front of a stream.

The port's copy of the reference's ``audiotools_tpu/meta/id3.py``: one
frame hierarchy (raw, text, user text, URL, comment and picture frames)
written per version (v2.2's 3-byte ids and 24-bit sizes, v2.3's 32-bit
sizes and flags, v2.4's syncsafe frame sizes and UTF-8 text), syncsafe
tag sizes, track and album numbers as "N/T" text, APIC and PIC frames as
``audiofile.Image``, ``ID3CommentPair`` (an ID3v2 tag with the ID3v1
tag after the stream, which MP3 and MP2 write) and
``read_id3v2_comment``.  ``skip_id3v2_comment`` and
``total_id3v2_comments`` find the stream past the ID3v2 tags in front
of a FLAC, TTA, MP3 or MP2 file.
"""

from __future__ import annotations

import os
import re

from .. import text
from ..audiofile import Image, MetaData
from ..bitstream import BitstreamReader, BitstreamRecorder
from .image import InvalidImage, image_metrics


def decode_syncsafe32(value):
    """decodes a 32-bit syncsafe integer (7 data bits per byte)"""
    out = 0
    for i in (3, 2, 1, 0):
        out = (out << 7) | ((value >> (i * 8)) & 0x7F)
    return out


def encode_syncsafe32(value):
    """encodes an integer to 32-bit syncsafe form"""
    out = 0
    for i in (3, 2, 1, 0):
        out |= ((value >> (i * 7)) & 0x7F) << (i * 8)
    return out


# ---------------------------------------------------------------------
# text encodings per ID3v2 version


def _decode_text(encoding, data, is_v24):
    """decodes frame text bytes per the frame's encoding byte"""
    if encoding == 0:
        return data.decode("latin-1", "replace")
    elif encoding == 1:
        return data.decode("utf-16", "replace")
    elif encoding == 2 and is_v24:
        return data.decode("utf-16-be", "replace")
    elif encoding == 3 and is_v24:
        return data.decode("utf-8", "replace")
    else:
        return data.decode("latin-1", "replace")


def _encode_text(encoding, text, is_v24):
    if encoding == 0:
        return text.encode("latin-1", "replace")
    elif encoding == 1:
        return text.encode("utf-16")      # includes BOM
    elif encoding == 2 and is_v24:
        return text.encode("utf-16-be")
    elif encoding == 3 and is_v24:
        return text.encode("utf-8")
    else:
        return text.encode("latin-1", "replace")


def _terminator(encoding):
    return b"\x00\x00" if encoding in (1, 2) else b"\x00"


def _split_terminated(encoding, data):
    """splits (terminated_string_bytes, remainder) per encoding"""
    term = _terminator(encoding)
    step = len(term)
    for i in range(0, len(data) - step + 1, step):
        if data[i:i + step] == term:
            return (data[:i], data[i + step:])
    return (data, b"")


def _best_encoding(text, is_v24):
    """the narrowest encoding that can represent the text"""
    try:
        text.encode("latin-1")
        return 0
    except (UnicodeEncodeError, UnicodeDecodeError):
        return 3 if is_v24 else 1


def _number_pair(number, total):
    """the text of a track or album number pair: both -> "N/T", the
    number only -> "N", the total only -> "0/T" """
    if total is None:
        return "%d" % (number,)
    elif number is None:
        return "0/%d" % (total,)
    else:
        return "%d/%d" % (number, total)


# ---------------------------------------------------------------------
# frames


class ID3Frame:
    """a raw (opaque) ID3v2 frame"""

    def __init__(self, frame_id, data):
        self.id = frame_id          # bytes, 3 or 4 chars
        self.data = data

    def copy(self):
        return ID3Frame(self.id, self.data)

    def __repr__(self):
        return "ID3Frame(%r, %d bytes)" % (self.id, len(self.data))

    def raw_info(self):
        return "%s = <%d bytes>" % (self.id.decode("ascii", "replace"),
                                    len(self.data))

    def body(self, is_v24):
        """returns the frame body bytes"""
        return self.data

    @classmethod
    def parse(cls, frame_id, data, is_v24):
        return cls(frame_id, data)


class ID3TextFrame(ID3Frame):
    """a T??/T??? text information frame (one or more strings)"""

    def __init__(self, frame_id, encoding, strings):
        self.id = frame_id
        self.encoding = encoding
        self.strings = list(strings)

    def copy(self):
        return ID3TextFrame(self.id, self.encoding, self.strings)

    def __repr__(self):
        return "ID3TextFrame(%r, %d, %r)" % (self.id, self.encoding,
                                             self.strings)

    def __str__(self):
        return self.strings[0] if self.strings else ""

    def raw_info(self):
        return "%s = %s" % (self.id.decode("ascii", "replace"),
                            "/".join(self.strings))

    def number(self):
        """the integer part before any '/' (None if no digits)"""
        text = self.strings[0] if self.strings else ""
        match = re.search(r"\d+", text.split("/")[0])
        return int(match.group(0)) if match else None

    def total(self):
        """the integer part after '/' (None if absent)"""
        text = self.strings[0] if self.strings else ""
        parts = text.split("/")
        if len(parts) < 2:
            return None
        match = re.search(r"\d+", parts[1])
        return int(match.group(0)) if match else None

    def body(self, is_v24):
        term = _terminator(self.encoding)
        joined = term.join(_encode_text(self.encoding, s, is_v24)
                           for s in self.strings)
        return bytes([self.encoding]) + joined

    @classmethod
    def parse(cls, frame_id, data, is_v24):
        if not data:
            return cls(frame_id, 0, [""])
        encoding = data[0]
        rest = data[1:]
        term = _terminator(encoding)
        # strip one trailing terminator, then split on terminators
        if rest.endswith(term):
            rest = rest[:-len(term)]
        strings = [_decode_text(encoding, part, is_v24)
                   for part in (rest.split(term) if rest else [b""])]
        return cls(frame_id, encoding, strings)

    @classmethod
    def converted(cls, frame_id, text, is_v24):
        return cls(frame_id, _best_encoding(text, is_v24), [text])


class ID3UserTextFrame(ID3Frame):
    """a TXX/TXXX user-defined text frame (description + value)"""

    def __init__(self, frame_id, encoding, description, value):
        self.id = frame_id
        self.encoding = encoding
        self.description = description
        self.value = value

    def copy(self):
        return ID3UserTextFrame(self.id, self.encoding,
                                self.description, self.value)

    def __str__(self):
        return self.value

    def raw_info(self):
        return "%s = (%s) %s" % (self.id.decode("ascii", "replace"),
                                 self.description, self.value)

    def body(self, is_v24):
        return (bytes([self.encoding]) +
                _encode_text(self.encoding, self.description, is_v24) +
                _terminator(self.encoding) +
                _encode_text(self.encoding, self.value, is_v24))

    @classmethod
    def parse(cls, frame_id, data, is_v24):
        encoding = data[0] if data else 0
        (desc, rest) = _split_terminated(encoding, data[1:])
        return cls(frame_id, encoding,
                   _decode_text(encoding, desc, is_v24),
                   _decode_text(encoding, rest, is_v24))


class ID3WebFrame(ID3Frame):
    """a W??/W??? URL frame (latin-1 URL)"""

    def __init__(self, frame_id, url):
        self.id = frame_id
        self.url = url

    def copy(self):
        return ID3WebFrame(self.id, self.url)

    def __str__(self):
        return self.url

    def raw_info(self):
        return "%s = %s" % (self.id.decode("ascii", "replace"),
                            self.url)

    def body(self, is_v24):
        return self.url.encode("latin-1", "replace")

    @classmethod
    def parse(cls, frame_id, data, is_v24):
        return cls(frame_id, data.decode("latin-1", "replace"))


class ID3CommentFrame(ID3Frame):
    """a COM/COMM comment frame (language + description + text)"""

    def __init__(self, frame_id, encoding, language, description,
                 text):
        self.id = frame_id
        self.encoding = encoding
        self.language = language        # 3 bytes
        self.description = description
        self.text = text

    def copy(self):
        return ID3CommentFrame(self.id, self.encoding, self.language,
                               self.description, self.text)

    def __str__(self):
        return self.text

    def raw_info(self):
        return "%s = (%s, %s) %s" % (
            self.id.decode("ascii", "replace"),
            self.language.decode("ascii", "replace"),
            self.description, self.text)

    def body(self, is_v24):
        return (bytes([self.encoding]) + self.language[:3].ljust(3) +
                _encode_text(self.encoding, self.description, is_v24) +
                _terminator(self.encoding) +
                _encode_text(self.encoding, self.text, is_v24))

    @classmethod
    def parse(cls, frame_id, data, is_v24):
        encoding = data[0] if data else 0
        language = data[1:4]
        (desc, rest) = _split_terminated(encoding, data[4:])
        return cls(frame_id, encoding, language,
                   _decode_text(encoding, desc, is_v24),
                   _decode_text(encoding, rest, is_v24))

    @classmethod
    def converted(cls, frame_id, text, is_v24):
        return cls(frame_id, _best_encoding(text, is_v24), b"eng",
                   "", text)


class ID3ImageFrame(Image):
    """a PIC (v2.2) / APIC (v2.3+) attached picture frame

    v2.2 stores a 3-byte image format; v2.3+ a MIME type string."""

    # ID3 picture type -> framework Image type (0-4: other, front,
    # back, leaflet, media)
    TYPE_FROM_ID3 = {3: 0, 4: 1, 5: 2, 6: 3}
    TYPE_TO_ID3 = {0: 3, 1: 4, 2: 5, 3: 6, 4: 0}

    def __init__(self, frame_id, encoding, mime_type, pic_type,
                 description, data):
        try:
            metrics = image_metrics(data)
            (width, height, depth, count) = (
                metrics.width, metrics.height,
                metrics.bits_per_pixel, metrics.color_count)
        except InvalidImage:
            (width, height, depth, count) = (0, 0, 0, 0)
        Image.__init__(self, data, mime_type, width, height, depth,
                       count, description,
                       self.TYPE_FROM_ID3.get(pic_type, 4))
        self.id = frame_id
        self.encoding = encoding
        self.pic_type = pic_type

    def copy(self):
        return ID3ImageFrame(self.id, self.encoding, self.mime_type,
                             self.pic_type, self.description,
                             self.data)

    def raw_info(self):
        return "%s = (%s, %d bytes) %s" % (
            self.id.decode("ascii", "replace"), self.mime_type,
            len(self.data), self.description)

    def body(self, is_v24):
        out = bytes([self.encoding])
        if self.id == b"PIC":
            fmt = {"image/jpeg": b"JPG", "image/png": b"PNG",
                   "image/gif": b"GIF"}.get(self.mime_type, b"UNK")
            out += fmt
        else:
            out += self.mime_type.encode("ascii", "replace") + b"\x00"
        out += bytes([self.pic_type])
        out += (_encode_text(self.encoding, self.description,
                             is_v24) + _terminator(self.encoding))
        return out + self.data

    @classmethod
    def parse(cls, frame_id, data, is_v24):
        encoding = data[0] if data else 0
        if frame_id == b"PIC":
            fmt = data[1:4]
            mime = {b"JPG": "image/jpeg", b"PNG": "image/png",
                    b"GIF": "image/gif"}.get(fmt,
                                             "application/octet-stream")
            rest = data[4:]
        else:
            nul = data.index(b"\x00", 1)
            mime = data[1:nul].decode("ascii", "replace")
            rest = data[nul + 1:]
        pic_type = rest[0] if rest else 0
        (desc, img) = _split_terminated(encoding, rest[1:])
        return cls(frame_id, encoding,
                   mime, pic_type,
                   _decode_text(encoding, desc, is_v24), img)

    @classmethod
    def converted(cls, frame_id, image, is_v24):
        return cls(frame_id,
                   _best_encoding(image.description or "", is_v24),
                   image.mime_type,
                   cls.TYPE_TO_ID3.get(image.type, 0),
                   image.description or "", image.data)


# ---------------------------------------------------------------------
# comments


class ID3v22Comment(MetaData):
    """an ID3v2.2 tag: 3-byte frame ids, 24-bit frame sizes"""

    NAME = "ID3v2.2"
    VERSION = 2
    IS_V24 = False
    IMAGE_FRAME_ID = b"PIC"
    COMMENT_FRAME_ID = b"COM"
    USER_TEXT_ID = b"TXX"
    USER_WEB_ID = b"WXX"

    ATTRIBUTE_MAP = {"track_name": b"TT2",
                     "track_number": b"TRK",
                     "track_total": b"TRK",
                     "album_name": b"TAL",
                     "artist_name": b"TP1",
                     "performer_name": b"TP2",
                     "conductor_name": b"TP3",
                     "composer_name": b"TCM",
                     "media": b"TMT",
                     "ISRC": b"TRC",
                     "copyright": b"TCR",
                     "publisher": b"TPB",
                     "year": b"TYE",
                     "date": b"TRD",
                     "album_number": b"TPA",
                     "album_total": b"TPA",
                     "comment": b"COM"}

    def __init__(self, frames, total_size=None):
        self.__dict__["frames"] = list(frames)
        self.__dict__["total_size"] = total_size

    def copy(self):
        return self.__class__([f.copy() for f in self.frames],
                              self.total_size)

    def __iter__(self):
        return iter(self.frames)

    def __repr__(self):
        return "%s(%r)" % (self.__class__.__name__, self.frames)

    def raw_info(self):
        return os.linesep.join(
            ["%s:" % (self.NAME,)] +
            [" " + f.raw_info() for f in self.frames])

    def __getitem__(self, frame_id):
        matches = [f for f in self.frames if f.id == frame_id]
        if matches:
            return matches
        raise KeyError(frame_id)

    def __delitem__(self, frame_id):
        self.__dict__["frames"] = [f for f in self.frames
                                   if f.id != frame_id]

    def keys(self):
        """returns the distinct frame IDs present"""
        seen = []
        for frame in self.frames:
            if frame.id not in seen:
                seen.append(frame.id)
        return seen

    def values(self):
        """returns the frame lists per distinct frame ID"""
        return [self[key] for key in self.keys()]

    def items(self):
        """returns (frame_id, frame_list) pairs"""
        return [(key, self[key]) for key in self.keys()]

    # ---- field access -------------------------------------------------

    def __getattr__(self, attr):
        if attr in self.ATTRIBUTE_MAP:
            try:
                frame = self[self.ATTRIBUTE_MAP[attr]][0]
            except KeyError:
                return None
            if attr in ("track_number", "album_number"):
                return frame.number()
            elif attr in ("track_total", "album_total"):
                return frame.total()
            else:
                text = str(frame)
                return text if text else None
        elif attr in MetaData.FIELDS:
            return None
        else:
            raise AttributeError(attr)

    def __setattr__(self, attr, value):
        if attr not in self.ATTRIBUTE_MAP:
            self.__dict__[attr] = value
            return
        if value is None:
            self.__delattr__(attr)
            return
        frame_id = self.ATTRIBUTE_MAP[attr]
        if attr in ("track_number", "album_number",
                    "track_total", "album_total"):
            if attr.endswith("number"):
                total_attr = attr.replace("number", "total")
                text = _number_pair(int(value),
                                    getattr(self, total_attr))
            else:
                number_attr = attr.replace("total", "number")
                text = _number_pair(getattr(self, number_attr),
                                    int(value))
            new_frame = ID3TextFrame.converted(frame_id, text,
                                               self.IS_V24)
        elif attr == "comment":
            new_frame = ID3CommentFrame.converted(
                self.COMMENT_FRAME_ID, str(value), self.IS_V24)
        else:
            new_frame = ID3TextFrame.converted(frame_id, str(value),
                                               self.IS_V24)
        frames = self.frames
        for (i, f) in enumerate(frames):
            if f.id == frame_id:
                frames[i] = new_frame
                # drop any duplicates of the same frame id
                self.__dict__["frames"] = (
                    frames[:i + 1] +
                    [g for g in frames[i + 1:] if g.id != frame_id])
                return
        frames.append(new_frame)

    def __delattr__(self, attr):
        if attr not in self.ATTRIBUTE_MAP:
            MetaData.__delattr__(self, attr)
            return
        frame_id = self.ATTRIBUTE_MAP[attr]
        if attr in ("track_number", "album_number"):
            total = getattr(self, attr.replace("number", "total"))
            if total is not None:
                # keep the total half: "0/T"
                new_frame = ID3TextFrame.converted(
                    frame_id, _number_pair(None, total), self.IS_V24)
                frames = self.frames
                for (i, f) in enumerate(frames):
                    if f.id == frame_id:
                        frames[i] = new_frame
                        return
                frames.append(new_frame)
                return
            del self[frame_id]
        elif attr in ("track_total", "album_total"):
            number = getattr(self, attr.replace("total", "number"))
            if number is not None:
                frame_id = self.ATTRIBUTE_MAP[attr]
                new_frame = ID3TextFrame.converted(
                    frame_id, "%d" % (number,), self.IS_V24)
                frames = self.frames
                for (i, f) in enumerate(frames):
                    if f.id == frame_id:
                        frames[i] = new_frame
                        return
            else:
                try:
                    del self[frame_id]
                except KeyError:
                    pass
        else:
            try:
                del self[frame_id]
            except KeyError:
                pass

    # ---- images ---------------------------------------------------------

    @classmethod
    def supports_images(cls):
        return True

    def images(self):
        return [f for f in self.frames
                if isinstance(f, ID3ImageFrame)]

    def add_image(self, image):
        self.frames.append(ID3ImageFrame.converted(
            self.IMAGE_FRAME_ID, image, self.IS_V24))

    def delete_image(self, image):
        self.__dict__["frames"] = [
            f for f in self.frames
            if not (isinstance(f, ID3ImageFrame) and f == image)]

    # ---- serialization ----------------------------------------------------

    @classmethod
    def _frame_class(cls, frame_id):
        if frame_id == cls.IMAGE_FRAME_ID:
            return ID3ImageFrame
        elif frame_id == cls.COMMENT_FRAME_ID:
            return ID3CommentFrame
        elif frame_id == cls.USER_TEXT_ID:
            return ID3UserTextFrame
        elif frame_id == cls.USER_WEB_ID:
            return ID3WebFrame
        elif frame_id.startswith(b"T"):
            return ID3TextFrame
        elif frame_id.startswith(b"W"):
            return ID3WebFrame
        else:
            return ID3Frame

    @classmethod
    def parse(cls, reader):
        """parses an ID3v2.2 tag from a BitstreamReader positioned at
        the 'ID3' marker"""
        (tag, major, minor, flags) = reader.parse("3b 8u 8u 8u")
        if tag != b"ID3":
            raise ValueError(text.ERR_ID3_INVALID_HEADER)
        if major != cls.VERSION:
            raise ValueError("invalid major version")
        total_size = remaining = decode_syncsafe32(reader.read(32))
        frames = []
        while remaining > 6:
            frame_id = reader.read_bytes(3)
            frame_size = reader.read(24)
            if frame_id == b"\x00\x00\x00":
                break
            data = reader.read_bytes(frame_size)
            frames.append(cls._frame_class(frame_id).parse(
                frame_id, data, cls.IS_V24))
            remaining -= (6 + frame_size)
        return cls(frames, total_size)

    def _frame_header_size(self):
        return 6

    def _write_frame_header(self, rec, frame_id, size):
        rec.write_bytes(frame_id)
        rec.write(24, size)

    def build(self, writer):
        """writes the full tag to a BitstreamWriter"""
        bodies = [(f.id, f.body(self.IS_V24)) for f in self.frames]
        tags_size = sum(self._frame_header_size() + len(b)
                        for (_i, b) in bodies)
        total = max(tags_size, self.total_size or 0)
        writer.write_bytes(b"ID3")
        writer.write(8, self.VERSION)
        writer.write(8, 0)
        writer.write(8, 0)
        writer.write(32, encode_syncsafe32(total))
        for (frame_id, body) in bodies:
            self._write_frame_header(writer, frame_id, len(body))
            writer.write_bytes(body)
        if total > tags_size:
            writer.write_bytes(b"\x00" * (total - tags_size))

    def size(self):
        """the tag's complete size in bytes, including header"""
        rec = BitstreamRecorder(False)
        self.build(rec)
        return len(rec.data())

    @classmethod
    def converted(cls, metadata):
        """converts a MetaData object to this class"""
        if metadata is None:
            return None
        if type(metadata) is cls:       # exact: v2.3 is a v2.2 subclass
            return cls([f.copy() for f in metadata.frames],
                       metadata.total_size)
        frames = []
        for attr in metadata.FIELDS:
            value = getattr(metadata, attr)
            if value is None or attr not in cls.ATTRIBUTE_MAP:
                continue
            frame_id = cls.ATTRIBUTE_MAP[attr]
            if any(f.id == frame_id for f in frames):
                continue
            if attr in ("track_number", "track_total"):
                text = _number_pair(metadata.track_number,
                                    metadata.track_total)
                frames.append(ID3TextFrame.converted(
                    frame_id, text, cls.IS_V24))
            elif attr in ("album_number", "album_total"):
                text = _number_pair(metadata.album_number,
                                    metadata.album_total)
                frames.append(ID3TextFrame.converted(
                    frame_id, text, cls.IS_V24))
            elif attr == "comment":
                frames.append(ID3CommentFrame.converted(
                    cls.COMMENT_FRAME_ID, str(value), cls.IS_V24))
            else:
                frames.append(ID3TextFrame.converted(
                    frame_id, str(value), cls.IS_V24))
        tag = cls(frames)
        for image in metadata.images():
            tag.add_image(image)
        return tag

    def clean(self):
        """returns (cleaned metadata, list of fix descriptions)"""
        fixes = []
        new_frames = []
        for frame in self.frames:
            if isinstance(frame, ID3TextFrame):
                strings = []
                changed = False
                for s in frame.strings:
                    stripped = s.strip()
                    if stripped != s:
                        fixes.append(
                            text.CLEAN_STRIP_WHITESPACE %
                            {"field": frame.id.decode(
                                "ascii", "replace")})
                        changed = True
                    # remove leading zeroes from integer-bearing pairs
                    if frame.id in (self.ATTRIBUTE_MAP["track_number"],
                                    self.ATTRIBUTE_MAP["album_number"]):
                        fixed = "/".join(
                            (part.lstrip("0") or "0")
                            if part.strip().isdigit() else part
                            for part in stripped.split("/"))
                        if fixed != stripped:
                            fixes.append(
                                text.CLEAN_REMOVE_LEADING_ZEROES %
                                {"field": frame.id.decode(
                                    "ascii", "replace")})
                            changed = True
                        stripped = fixed
                    strings.append(stripped)
                if all(not s for s in strings):
                    fixes.append(text.CLEAN_REMOVE_EMPTY_TAG %
                                 {"field": frame.id.decode(
                                     "ascii", "replace")})
                    continue
                if changed:
                    new_frames.append(ID3TextFrame(
                        frame.id, frame.encoding, strings))
                else:
                    new_frames.append(frame.copy())
            else:
                new_frames.append(frame.copy())
        return (self.__class__(new_frames, self.total_size), fixes)


class ID3v23Comment(ID3v22Comment):
    """an ID3v2.3 tag: 4-byte frame ids, 32-bit frame sizes and flags"""

    NAME = "ID3v2.3"
    VERSION = 3
    IS_V24 = False
    IMAGE_FRAME_ID = b"APIC"
    COMMENT_FRAME_ID = b"COMM"
    USER_TEXT_ID = b"TXXX"
    USER_WEB_ID = b"WXXX"

    ATTRIBUTE_MAP = {"track_name": b"TIT2",
                     "track_number": b"TRCK",
                     "track_total": b"TRCK",
                     "album_name": b"TALB",
                     "artist_name": b"TPE1",
                     "performer_name": b"TPE2",
                     "composer_name": b"TCOM",
                     "conductor_name": b"TPE3",
                     "media": b"TMED",
                     "ISRC": b"TSRC",
                     "copyright": b"TCOP",
                     "publisher": b"TPUB",
                     "year": b"TYER",
                     "date": b"TRDA",
                     "album_number": b"TPOS",
                     "album_total": b"TPOS",
                     "comment": b"COMM"}

    @classmethod
    def _read_frame_size(cls, reader):
        return reader.read(32)

    @classmethod
    def parse(cls, reader):
        (tag, major, minor, flags) = reader.parse("3b 8u 8u 8u")
        if tag != b"ID3":
            raise ValueError(text.ERR_ID3_INVALID_HEADER)
        if major != cls.VERSION:
            raise ValueError("invalid major version")
        total_size = remaining = decode_syncsafe32(reader.read(32))
        frames = []
        while remaining > 10:
            frame_id = reader.read_bytes(4)
            if frame_id == b"\x00\x00\x00\x00":
                break
            frame_size = cls._read_frame_size(reader)
            reader.read(16)     # frame flags
            data = reader.read_bytes(frame_size)
            frames.append(cls._frame_class(frame_id).parse(
                frame_id, data, cls.IS_V24))
            remaining -= (10 + frame_size)
        return cls(frames, total_size)

    def _frame_header_size(self):
        return 10

    def _write_frame_header(self, rec, frame_id, size):
        rec.write_bytes(frame_id)
        rec.write(32, size)
        rec.write(16, 0)


class ID3v24Comment(ID3v23Comment):
    """an ID3v2.4 tag: syncsafe frame sizes, UTF-8 and UTF-16BE text"""

    NAME = "ID3v2.4"
    VERSION = 4
    IS_V24 = True

    @classmethod
    def _read_frame_size(cls, reader):
        return decode_syncsafe32(reader.read(32))

    def _write_frame_header(self, rec, frame_id, size):
        rec.write_bytes(frame_id)
        rec.write(32, encode_syncsafe32(size))
        rec.write(16, 0)


class ID3CommentPair(MetaData):
    """an ID3v2 tag and the ID3v1 tag at the file's end, as MP3 files
    carry them; a field is read from the ID3v2 half first and written
    to both"""

    def __init__(self, id3v2, id3v1):
        self.__dict__["id3v2"] = id3v2
        self.__dict__["id3v1"] = id3v1

    def __repr__(self):
        return "ID3CommentPair(%r, %r)" % (self.id3v2, self.id3v1)

    def raw_info(self):
        return os.linesep.join([self.id3v2.raw_info(),
                                self.id3v1.raw_info()])

    def __getattr__(self, attr):
        if attr in MetaData.FIELDS:
            value = getattr(self.id3v2, attr)
            if value is not None:
                return value
            return getattr(self.id3v1, attr)
        raise AttributeError(attr)

    def __setattr__(self, attr, value):
        if attr in MetaData.FIELDS:
            setattr(self.id3v2, attr, value)
            setattr(self.id3v1, attr, value)
        else:
            self.__dict__[attr] = value

    def __delattr__(self, attr):
        if attr in MetaData.FIELDS:
            delattr(self.id3v2, attr)
            delattr(self.id3v1, attr)
        else:
            MetaData.__delattr__(self, attr)

    @classmethod
    def supports_images(cls):
        return True

    def images(self):
        return self.id3v2.images()

    def add_image(self, image):
        self.id3v2.add_image(image)

    def delete_image(self, image):
        self.id3v2.delete_image(image)

    @classmethod
    def converted(cls, metadata,
                  id3v2_class=ID3v23Comment):
        from .id3v1 import ID3v1Comment
        if metadata is None:
            return None
        if isinstance(metadata, ID3CommentPair):
            return ID3CommentPair(metadata.id3v2.copy(),
                                  metadata.id3v1.copy())
        return ID3CommentPair(id3v2_class.converted(metadata),
                              ID3v1Comment.converted(metadata))

    def clean(self):
        (v2, fixes2) = self.id3v2.clean()
        (v1, fixes1) = self.id3v1.clean()
        return (ID3CommentPair(v2, v1), fixes2 + fixes1)


# ---------------------------------------------------------------------
# file-level helpers


_VERSION_MAP = {2: ID3v22Comment, 3: ID3v23Comment, 4: ID3v24Comment}


def read_id3v2_comment(file):
    """reads an ID3v2 comment at the current file position

    returns an ID3v22/23/24Comment; raises ValueError if absent"""
    start = file.tell()
    header = file.read(10)
    file.seek(start, 0)
    if len(header) < 10 or header[0:3] != b"ID3":
        raise ValueError("no ID3v2 tag found")
    version = header[3]
    if version not in _VERSION_MAP:
        raise ValueError("unsupported ID3v2 version")
    reader = BitstreamReader(file, False)
    return _VERSION_MAP[version].parse(reader)


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
