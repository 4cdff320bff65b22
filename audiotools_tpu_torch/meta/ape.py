"""APEv2 tags: the tag TTA and WavPack files append.

A copy of the reference's ``audiotools_tpu/meta/ape.py``: ``ApeTagItem``
(text, binary and external items), ``ApeTag`` (the 32-byte
little-endian header and footer, "Track" and "Media" as slashed number
pairs, the front and back covers as binary items of a description and
the image) and ``ApeTaggedAudio``, the get/set/update/delete_metadata
of a class whose files end with the tag, and ``ApeTag.clean``
(tracklint's fixes).  ``ApeAudio`` (Monkey's Audio, which neither
package decodes) is not ported.

``clean`` reports its fixes with the reference's strings, where the
reference's own ``ApeTag.clean`` raises: a local variable there hides
its ``text`` module, so any tag with something to fix ends in
AttributeError (UnboundLocalError for a duplicate item before any text
item).  The port does not copy that fault.
"""

from __future__ import annotations

import re
import struct

from .. import text
from ..audiofile import Image, MetaData

PREAMBLE = b"APETAGEX"
VERSION = 2000


def __number_pair__(number, total):
    """formats a number/total pair as the slashed text convention"""
    if number is None:
        number = 0
    if total is None:
        return "%d" % (number,)
    else:
        return "%d/%d" % (number, total)


class ApeTagItem:
    """a single item in the ApeTag"""

    def __init__(self, item_type, read_only, key, data):
        """item_type: 0=UTF-8, 1=binary, 2=external, 3=reserved
        read_only: 1 if read-only; key: ASCII str; data: bytes"""
        self.type = item_type
        self.read_only = read_only
        self.key = key
        self.data = data

    def copy(self):
        return ApeTagItem(self.type, self.read_only, self.key,
                          self.data)

    def __repr__(self):
        return "ApeTagItem(%r, %r, %r, %r)" % (
            self.type, self.read_only, self.key, self.data)

    def __str__(self):
        return self.data.rstrip(b"\x00").decode('utf-8', 'replace')

    @classmethod
    def parse(cls, data, offset):
        """parses an item from bytes at offset

        returns (ApeTagItem, new_offset)"""
        (length, flags) = struct.unpack_from("<II", data, offset)
        offset += 8
        end = data.index(b"\x00", offset)
        key = data[offset:end].decode('ascii', 'replace')
        offset = end + 1
        value = data[offset:offset + length]
        offset += length
        return (cls((flags >> 1) & 0x3, flags & 0x1, key, value),
                offset)

    def build(self):
        """returns the item as bytes"""
        flags = (self.read_only & 0x1) | ((self.type & 0x3) << 1)
        return (struct.pack("<II", len(self.data), flags) +
                self.key.encode('ascii') + b"\x00" + self.data)

    @classmethod
    def binary(cls, key, data):
        return cls(1, 0, key, data)

    @classmethod
    def string(cls, key, data):
        return cls(0, 0, key, data.encode('utf-8', 'replace'))


class ApeTag(MetaData):
    """a complete APEv2 tag"""

    ITEM = ApeTagItem

    ATTRIBUTE_MAP = {'track_name': 'Title',
                     'track_number': 'Track',
                     'track_total': 'Track',
                     'album_number': 'Media',
                     'album_total': 'Media',
                     'album_name': 'Album',
                     'artist_name': 'Artist',
                     'performer_name': 'Performer',
                     'composer_name': 'Composer',
                     'conductor_name': 'Conductor',
                     'ISRC': 'ISRC',
                     'catalog': 'Catalog',
                     'copyright': 'Copyright',
                     'publisher': 'Publisher',
                     'year': 'Year',
                     'date': 'Record Date',
                     'comment': 'Comment'}

    INTEGER_ITEMS = ('Track', 'Media')

    def __init__(self, tags, contains_header=True,
                 contains_footer=True):
        for tag in tags:
            if not isinstance(tag, ApeTagItem):
                raise ValueError("%r is not an ApeTagItem" % (tag,))
        self.__dict__["tags"] = list(tags)
        self.__dict__["contains_header"] = contains_header
        self.__dict__["contains_footer"] = contains_footer

    def __repr__(self):
        return "ApeTag(%r, %r, %r)" % (self.tags,
                                       self.contains_header,
                                       self.contains_footer)

    def __eq__(self, metadata):
        if isinstance(metadata, ApeTag):
            if set(self.keys()) != set(metadata.keys()):
                return False
            for tag in self.tags:
                try:
                    if tag.data != metadata[tag.key].data:
                        return False
                except KeyError:
                    return False
            return True
        elif isinstance(metadata, MetaData):
            return MetaData.__eq__(self, metadata)
        else:
            return False

    def keys(self):
        return [tag.key for tag in self.tags]

    def __getitem__(self, key):
        for tag in self.tags:
            if tag.key == key:
                return tag
        raise KeyError(key)

    def __setitem__(self, key, value):
        for i in range(len(self.tags)):
            if self.tags[i].key == key:
                self.tags[i] = value
                return
        self.tags.append(value)

    def __delitem__(self, key):
        old_count = len(self.tags)
        self.__dict__["tags"] = [t for t in self.tags if t.key != key]
        if len(self.tags) == old_count:
            raise KeyError(key)

    def __getattr__(self, attr):
        if attr in ("track_number", "album_number"):
            key = {"track_number": "Track",
                   "album_number": "Media"}[attr]
            try:
                text = str(self[key])
                match = re.search(r'\d+', text)
                if match is not None:
                    number = int(match.group(0))
                    if ((number == 0) and
                            (re.search(r'/.*?(\d+)', text) is not None)):
                        return None
                    return number
                return None
            except KeyError:
                return None
        elif attr in ("track_total", "album_total"):
            key = {"track_total": "Track",
                   "album_total": "Media"}[attr]
            try:
                match = re.search(r'/.*?(\d+)', str(self[key]))
                if match is not None:
                    return int(match.group(1))
                return None
            except KeyError:
                return None
        elif attr in self.ATTRIBUTE_MAP:
            try:
                return str(self[self.ATTRIBUTE_MAP[attr]])
            except KeyError:
                return None
        elif attr in MetaData.FIELDS:
            return None
        else:
            try:
                return self.__dict__[attr]
            except KeyError:
                raise AttributeError(attr)

    def __setattr__(self, attr, value):
        def tag_text(key):
            return self[key].data.decode('utf-8', 'replace')

        def set_tag_text(key, text):
            self[key].data = text.encode('utf-8', 'replace')

        if attr in self.ATTRIBUTE_MAP:
            if value is None:
                delattr(self, attr)
            elif attr in ("track_number", "album_number"):
                key = self.ATTRIBUTE_MAP[attr]
                try:
                    set_tag_text(key, re.sub(r'\d+', str(int(value)),
                                             tag_text(key), 1))
                except KeyError:
                    total = (self.track_total
                             if attr == "track_number"
                             else self.album_total)
                    self[key] = self.ITEM.string(
                        key, __number_pair__(value, total))
            elif attr in ("track_total", "album_total"):
                key = self.ATTRIBUTE_MAP[attr]
                try:
                    if re.search(r'/\D*\d+', tag_text(key)) is not None:
                        set_tag_text(key, re.sub(
                            r'(/\D*)(\d+)', "\\g<1>" + str(int(value)),
                            tag_text(key), 1))
                    else:
                        set_tag_text(key, "%s/%d" % (tag_text(key),
                                                     value))
                except KeyError:
                    number = (self.track_number
                              if attr == "track_total"
                              else self.album_number)
                    self[key] = self.ITEM.string(
                        key, __number_pair__(number, value))
            else:
                self[self.ATTRIBUTE_MAP[attr]] = self.ITEM.string(
                    self.ATTRIBUTE_MAP[attr], str(value))
        else:
            self.__dict__[attr] = value

    def __delattr__(self, attr):
        def tag_text(key):
            return self[key].data.decode('utf-8', 'replace')

        def set_tag_text(key, text):
            self[key].data = text.encode('utf-8', 'replace')

        if attr in ("track_number", "album_number"):
            key = {"track_number": "Track",
                   "album_number": "Media"}[attr]
            try:
                if re.search(r'\d+.*?/.*?\d+',
                             tag_text(key)) is not None:
                    set_tag_text(key, re.sub(r'\d+', "0",
                                             tag_text(key), 1))
                else:
                    del self[key]
            except KeyError:
                pass
        elif attr in ("track_total", "album_total"):
            key = {"track_total": "Track",
                   "album_total": "Media"}[attr]
            try:
                number = re.search(r'\d+',
                                   tag_text(key).split("/")[0])
                if (number is not None) and (int(number.group(0)) != 0):
                    set_tag_text(key, re.sub(r'\s*/.*', "",
                                             tag_text(key)))
                else:
                    if re.search(r'/\D*?\d+',
                                 tag_text(key)) is not None:
                        del self[key]
            except KeyError:
                pass
        elif attr in self.ATTRIBUTE_MAP:
            try:
                del self[self.ATTRIBUTE_MAP[attr]]
            except KeyError:
                pass
        elif attr in MetaData.FIELDS:
            pass
        else:
            try:
                del self.__dict__[attr]
            except KeyError:
                raise AttributeError(attr)

    @classmethod
    def converted(cls, metadata):
        """converts a MetaData object to an ApeTag object"""
        if metadata is None:
            return None
        elif isinstance(metadata, ApeTag):
            return ApeTag([tag.copy() for tag in metadata.tags],
                          contains_header=metadata.contains_header,
                          contains_footer=metadata.contains_footer)
        else:
            tags = cls([])
            for (field, key) in cls.ATTRIBUTE_MAP.items():
                if ((field not in cls.INTEGER_FIELDS) and
                        (getattr(metadata, field) is not None)):
                    tags[key] = cls.ITEM.string(
                        key, str(getattr(metadata, field)))

            if ((metadata.track_number is not None) or
                    (metadata.track_total is not None)):
                tags["Track"] = cls.ITEM.string(
                    "Track", __number_pair__(metadata.track_number,
                                             metadata.track_total))
            if ((metadata.album_number is not None) or
                    (metadata.album_total is not None)):
                tags["Media"] = cls.ITEM.string(
                    "Media", __number_pair__(metadata.album_number,
                                             metadata.album_total))
            for image in metadata.images():
                tags.add_image(image)
            return tags

    def raw_info(self):
        from os import linesep
        lines = ["APEv2:"]
        for tag in self.tags:
            if tag.type == 0:
                lines.append("%s = %s" % (tag.key, tag))
            else:
                lines.append("%s = (%s) %d bytes" %
                             (tag.key,
                              {1: "binary",
                               2: "external"}.get(tag.type, "reserved"),
                              len(tag.data)))
        return linesep.join(lines)

    def __parse_image__(self, key, image_type):
        data = self[key].data
        null = data.index(b"\x00")
        description = data[:null].decode('utf-8', 'replace')
        try:
            return Image.new(data[null + 1:], description, image_type)
        except (ImportError, ValueError):
            return Image(data=data[null + 1:], mime_type="",
                         width=0, height=0, color_depth=0,
                         color_count=0, description=description,
                         type=image_type)

    def add_image(self, image):
        if image.type == 0:
            self['Cover Art (front)'] = self.ITEM.binary(
                'Cover Art (front)',
                image.description.encode('utf-8', 'replace') +
                b"\x00" + image.data)
        elif image.type == 1:
            self['Cover Art (back)'] = self.ITEM.binary(
                'Cover Art (back)',
                image.description.encode('utf-8', 'replace') +
                b"\x00" + image.data)

    def delete_image(self, image):
        if (image.type == 0) and ('Cover Art (front)' in self.keys()):
            del self['Cover Art (front)']
        elif (image.type == 1) and ('Cover Art (back)' in self.keys()):
            del self['Cover Art (back)']

    def images(self):
        img = []
        if 'Cover Art (front)' in self.keys():
            img.append(self.__parse_image__('Cover Art (front)', 0))
        if 'Cover Art (back)' in self.keys():
            img.append(self.__parse_image__('Cover Art (back)', 1))
        return img

    @classmethod
    def read(cls, apefile):
        """returns an ApeTag from an APEv2-tagged file object, or None"""
        try:
            apefile.seek(-32, 2)
        except OSError:
            return None
        footer = apefile.read(32)
        if len(footer) < 32 or footer[0:8] != PREAMBLE:
            return None
        (version, tag_size, item_count,
         flags) = struct.unpack("<IIII", footer[8:24])
        if version != VERSION:
            return None

        apefile.seek(-tag_size, 2)
        data = apefile.read(tag_size - 32)
        offset = 0
        tags = []
        for _ in range(item_count):
            (tag, offset) = ApeTagItem.parse(data, offset)
            tags.append(tag)
        return cls(tags,
                   contains_header=bool(flags & (1 << 31)),
                   contains_footer=True)

    def build(self):
        """returns the complete APEv2 tag as bytes"""
        items = b"".join(tag.build() for tag in self.tags)
        tag_size = len(items) + 32

        def tag_flags(is_header):
            flags = 0
            if is_header:
                flags |= (1 << 29)
            if not self.contains_footer:
                flags |= (1 << 30)
            if self.contains_header:
                flags |= (1 << 31)
            return flags

        out = b""
        if self.contains_header:
            out += (PREAMBLE +
                    struct.pack("<IIII", VERSION, tag_size,
                                len(self.tags), tag_flags(True)) +
                    b"\x00" * 8)
        out += items
        if self.contains_footer:
            out += (PREAMBLE +
                    struct.pack("<IIII", VERSION, tag_size,
                                len(self.tags), tag_flags(False)) +
                    b"\x00" * 8)
        return out

    def clean(self):
        """a (ApeTag, fixes performed) pair: duplicate keys dropped, text
        items stripped of whitespace, "Track" and "Media" of leading
        zeroes, empty text items dropped"""
        fixes_performed = []
        used_tags = set()
        tag_items = []
        for tag in self.tags:
            if tag.key.upper() in used_tags:
                fixes_performed.append(
                    text.CLEAN_REMOVE_DUPLICATE_TAG % {"field": tag.key})
                continue
            used_tags.add(tag.key.upper())
            if tag.type != 0:
                tag_items.append(tag)
                continue
            value = tag.data.decode('utf-8', 'replace')
            fix1 = value.rstrip()
            if fix1 != value:
                fixes_performed.append(
                    text.CLEAN_REMOVE_TRAILING_WHITESPACE % {"field": tag.key})
            fix2 = fix1.lstrip()
            if fix2 != fix1:
                fixes_performed.append(
                    text.CLEAN_REMOVE_LEADING_WHITESPACE % {"field": tag.key})
            if tag.key in self.INTEGER_ITEMS:
                if "/" in fix2:
                    (number, total) = fix2.split("/", 1)
                    fix3 = "%s/%s" % (number.rstrip().lstrip("0"),
                                      total.lstrip().lstrip("0"))
                else:
                    fix3 = fix2.lstrip("0")
                if fix3 != fix2:
                    fixes_performed.append(
                        text.CLEAN_REMOVE_LEADING_ZEROES % {"field": tag.key})
            else:
                fix3 = fix2
            if len(fix3) == 0:
                fixes_performed.append(
                    text.CLEAN_REMOVE_EMPTY_TAG % {"field": tag.key})
            else:
                tag_items.append(ApeTagItem.string(tag.key, fix3))
        return (ApeTag(tag_items, self.contains_header, self.contains_footer),
                fixes_performed)


class ApeTaggedAudio:
    """a mixin for audio formats which store APEv2 tags at the end"""

    def get_metadata(self):
        """returns an ApeTag object, or None"""
        with open(self.filename, "rb") as f:
            return ApeTag.read(f)

    def update_metadata(self, metadata):
        """writes an ApeTag back to the file"""
        if metadata is None:
            return
        elif not isinstance(metadata, ApeTag):
            raise ValueError("metadata not from audio file")

        with open(self.filename, "rb") as f:
            f.seek(0, 2)
            file_size = f.tell()
            old_tag_size = _existing_tag_size(f)

        with open(self.filename, "r+b") as f:
            f.seek(file_size - old_tag_size, 0)
            f.write(metadata.build())
            f.truncate()

    def set_metadata(self, metadata):
        """converts and sets this track's metadata"""
        if metadata is None:
            return
        old_metadata = self.get_metadata()
        new_metadata = ApeTag.converted(metadata)

        if old_metadata is not None:
            # preserve ReplayGain and cuesheet tags
            for tag in ["replaygain_track_gain",
                        "replaygain_track_peak",
                        "replaygain_album_gain",
                        "replaygain_album_peak",
                        "Cuesheet"]:
                try:
                    new_metadata[tag] = old_metadata[tag]
                except KeyError:
                    try:
                        del new_metadata[tag]
                    except KeyError:
                        pass
        self.update_metadata(new_metadata)

    def delete_metadata(self):
        """removes the ApeTag from the file"""
        with open(self.filename, "rb") as f:
            f.seek(0, 2)
            file_size = f.tell()
            old_tag_size = _existing_tag_size(f)
        if old_tag_size:
            with open(self.filename, "r+b") as f:
                f.truncate(file_size - old_tag_size)


def _existing_tag_size(f):
    """returns the byte size of an existing APEv2 tag at EOF, or 0"""
    try:
        f.seek(-32, 2)
    except OSError:
        return 0
    footer = f.read(32)
    if len(footer) < 32 or footer[0:8] != PREAMBLE:
        return 0
    (version, tag_size, _items, flags) = struct.unpack("<IIII",
                                                       footer[8:24])
    if version != VERSION:
        return 0
    total = tag_size
    if flags & (1 << 31):
        total += 32
    return total
