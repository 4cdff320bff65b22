"""VorbisComment: a vendor string and KEY=value comment strings,
mapped onto the MetaData fields.

A copy of the reference's ``audiotools_tpu/meta/vorbiscomment.py``:
the map between MetaData fields and comment keys, the key aliases, the
slashed TRACKNUMBER and DISCNUMBER values, several values to a key
kept on set, and ``clean`` (the fixes tracklint reports and makes).
"""

from __future__ import annotations

import re

from .. import VERSION, text
from ..audiofile import MetaData

# the vendor string of the comments the port writes
VENDOR_STRING = "tpu-audio-tools %s" % (VERSION,)


class VorbisComment(MetaData):
    ATTRIBUTE_MAP = {'track_name': 'TITLE',
                     'track_number': 'TRACKNUMBER',
                     'track_total': 'TRACKTOTAL',
                     'album_name': 'ALBUM',
                     'artist_name': 'ARTIST',
                     'performer_name': 'PERFORMER',
                     'composer_name': 'COMPOSER',
                     'conductor_name': 'CONDUCTOR',
                     'media': 'SOURCE MEDIUM',
                     'ISRC': 'ISRC',
                     'catalog': 'CATALOG',
                     'copyright': 'COPYRIGHT',
                     'publisher': 'PUBLISHER',
                     'year': 'DATE',
                     'album_number': 'DISCNUMBER',
                     'album_total': 'DISCTOTAL',
                     'comment': 'COMMENT'}

    ALIASES = {}
    for aliases in [frozenset(['TRACKTOTAL', 'TOTALTRACKS']),
                    frozenset(['DISCTOTAL', 'TOTALDISCS']),
                    frozenset(['ALBUM ARTIST', 'ALBUMARTIST',
                               'PERFORMER'])]:
        for alias in aliases:
            ALIASES[alias] = aliases
    del aliases, alias

    def __init__(self, comment_strings, vendor_string):
        """comment_strings is a list of strings, vendor_string a string"""
        self.__dict__["comment_strings"] = list(comment_strings)
        self.__dict__["vendor_string"] = vendor_string

    def keys(self):
        return list({comment.split("=", 1)[0]
                     for comment in self.comment_strings
                     if "=" in comment})

    def values(self):
        return [self[key] for key in self.keys()]

    def items(self):
        return [(key, self[key]) for key in self.keys()]

    def __contains__(self, key):
        matching_keys = self.ALIASES.get(key.upper(),
                                         frozenset([key.upper()]))
        return any(item_key.upper() in matching_keys
                   for (item_key, _) in
                   [comment.split("=", 1)
                    for comment in self.comment_strings if "=" in comment])

    def __getitem__(self, key):
        matching_keys = self.ALIASES.get(key.upper(),
                                         frozenset([key.upper()]))
        values = [item_value for (item_key, item_value) in
                  [comment.split("=", 1)
                   for comment in self.comment_strings if "=" in comment]
                  if item_key.upper() in matching_keys]
        if len(values) > 0:
            return values
        else:
            raise KeyError(key)

    def __setitem__(self, key, values):
        new_values = list(values)
        new_comment_strings = []
        matching_keys = self.ALIASES.get(key.upper(),
                                         frozenset([key.upper()]))

        for comment in self.comment_strings:
            if "=" in comment:
                (c_key, c_value) = comment.split("=", 1)
                if c_key.upper() in matching_keys:
                    try:
                        new_comment_strings.append(
                            "%s=%s" % (c_key, new_values.pop(0)))
                    except IndexError:
                        continue
                else:
                    new_comment_strings.append(comment)
            else:
                new_comment_strings.append(comment)

        for new_value in new_values:
            new_comment_strings.append("%s=%s" % (key.upper(), new_value))

        self.__dict__["comment_strings"] = new_comment_strings

    def __repr__(self):
        return "VorbisComment(%s, %s)" % \
            (repr(self.comment_strings), repr(self.vendor_string))

    def __comment_name__(self):
        return "Vorbis Comment"

    def raw_info(self):
        """returns a string of low-level MetaData information"""
        from os import linesep
        return linesep.join(
            ["%s:  %s" % (self.__comment_name__(), self.vendor_string)] +
            list(self.comment_strings))

    def __getattr__(self, attr):
        if attr in ("track_number", "album_number"):
            try:
                for value in self[self.ATTRIBUTE_MAP[attr]]:
                    integer = re.search(r'\d+', value)
                    if integer is not None:
                        return int(integer.group(0))
                return None
            except KeyError:
                return None
        elif attr in ("track_total", "album_total"):
            try:
                for value in self[self.ATTRIBUTE_MAP[attr]]:
                    integer = re.search(r'\d+', value)
                    if integer is not None:
                        return int(integer.group(0))
            except KeyError:
                pass
            # fall back to slashed TRACKNUMBER/DISCNUMBER values
            try:
                for value in self[{"track_total": "TRACKNUMBER",
                                   "album_total": "DISCNUMBER"}[attr]]:
                    integer = re.search(r'/\D*(\d+)', value)
                    if integer is not None:
                        return int(integer.group(1))
                return None
            except KeyError:
                return None
        elif attr in self.ATTRIBUTE_MAP:
            try:
                return self[self.ATTRIBUTE_MAP[attr]][0]
            except KeyError:
                return None
        elif attr in self.FIELDS:
            return None
        else:
            try:
                return self.__dict__[attr]
            except KeyError:
                raise AttributeError(attr)

    def __setattr__(self, attr, value):
        if (value is None) and (attr in self.FIELDS):
            delattr(self, attr)
        elif attr in ("track_number", "album_number"):
            key = self.ATTRIBUTE_MAP[attr]
            try:
                new_values = self[key]
                for i in range(len(new_values)):
                    if re.search(r'\d+', new_values[i]) is not None:
                        new_values[i] = re.sub(r'\d+', str(int(value)),
                                               new_values[i], 1)
                        self[key] = new_values
                        break
                else:
                    self[key] = self[key] + [str(int(value))]
            except KeyError:
                self[key] = [str(int(value))]
        elif attr in ("track_total", "album_total"):
            key = self.ATTRIBUTE_MAP[attr]
            try:
                new_values = self[key]
                for i in range(len(new_values)):
                    if re.search(r'\d+', new_values[i]) is not None:
                        new_values[i] = re.sub(r'\d+', str(int(value)),
                                               new_values[i], 1)
                        self[key] = new_values
                        return
            except KeyError:
                new_values = []
            try:
                slashed_key = {"track_total": "TRACKNUMBER",
                               "album_total": "DISCNUMBER"}[attr]
                new_slashed_values = self[slashed_key]
                for i in range(len(new_slashed_values)):
                    if re.search(r'/\D*\d+',
                                 new_slashed_values[i]) is not None:
                        new_slashed_values[i] = re.sub(
                            r'(/\D*)(\d+)',
                            '\\g<1>' + str(int(value)),
                            new_slashed_values[i], 1)
                        self[slashed_key] = new_slashed_values
                        return
            except KeyError:
                pass
            self[key] = new_values + [str(int(value))]
        elif attr in self.ATTRIBUTE_MAP:
            key = self.ATTRIBUTE_MAP[attr]
            try:
                current_values = self[key]
                self[key] = [str(value)] + current_values[1:]
            except KeyError:
                self[key] = [str(value)]
        elif attr in self.FIELDS:
            pass
        else:
            self.__dict__[attr] = value

    def __delattr__(self, attr):
        if attr in ("track_number", "album_number"):
            key = self.ATTRIBUTE_MAP[attr]
            try:
                slashed_field = re.compile(r'/\s*(.*)')
                orphaned_totals = [match.group(1) for match in
                                   [slashed_field.search(value)
                                    for value in self[key]]
                                   if match is not None]
                self[key] = []
                if len(orphaned_totals) > 0:
                    total_key = {"track_number": "TRACKTOTAL",
                                 "album_number": "DISCTOTAL"}[attr]
                    try:
                        self[total_key] = self[total_key] + orphaned_totals
                    except KeyError:
                        self[total_key] = orphaned_totals
            except KeyError:
                pass
        elif attr in ("track_total", "album_total"):
            slashed_key = {"track_total": "TRACKNUMBER",
                           "album_total": "DISCNUMBER"}[attr]
            slashed_field = re.compile(r'(.*?)\s*/.*')

            def slash_filter(s):
                match = slashed_field.match(s)
                return match.group(1) if match is not None else s

            self[self.ATTRIBUTE_MAP[attr]] = []
            try:
                self[slashed_key] = [slash_filter(s)
                                     for s in self[slashed_key]]
            except KeyError:
                pass
        elif attr in self.ATTRIBUTE_MAP:
            self[self.ATTRIBUTE_MAP[attr]] = []
        elif attr in self.FIELDS:
            pass
        else:
            try:
                del self.__dict__[attr]
            except KeyError:
                raise AttributeError(attr)

    def __eq__(self, metadata):
        if isinstance(metadata, self.__class__):
            return self.comment_strings == metadata.comment_strings
        else:
            return MetaData.__eq__(self, metadata)

    @classmethod
    def converted(cls, metadata):
        """converts metadata from another class to VorbisComment"""
        if metadata is None:
            return None
        elif isinstance(metadata, VorbisComment):
            return cls(metadata.comment_strings[:],
                       metadata.vendor_string)
        elif metadata.__class__.__name__ == 'FlacMetaData':
            if metadata.has_block(4):
                vorbis_comment = metadata.get_block(4)
                return cls(vorbis_comment.comment_strings[:],
                           vorbis_comment.vendor_string)
            else:
                return cls([], VENDOR_STRING)
        else:
            comment_strings = []
            for (attr, key) in cls.ATTRIBUTE_MAP.items():
                value = getattr(metadata, attr)
                if value is not None:
                    comment_strings.append("%s=%s" % (key, value))
            return cls(comment_strings, VENDOR_STRING)

    @classmethod
    def supports_images(cls):
        return False

    def images(self):
        return []

    def clean(self):
        """a (VorbisComment, fixes performed) pair: the known fields'
        empty values dropped, their values stripped of whitespace, the
        numbers of leading zeroes"""
        fixes_performed = []
        reverse_attr_map = {}
        for (attr, key) in self.ATTRIBUTE_MAP.items():
            reverse_attr_map[key] = attr
            if key in self.ALIASES:
                for alias in self.ALIASES[key]:
                    reverse_attr_map[alias] = attr

        cleaned_fields = []
        for comment_string in self.comment_strings:
            if "=" not in comment_string:
                cleaned_fields.append(comment_string)
                continue
            (key, value) = comment_string.split("=", 1)
            if key.upper() not in reverse_attr_map:
                cleaned_fields.append(comment_string)
                continue
            attr = reverse_attr_map[key.upper()]
            if len(value.strip()) == 0:
                fixes_performed.append(
                    text.CLEAN_REMOVE_EMPTY_TAG % {"field": key})
                continue
            fix1 = value.rstrip()
            if fix1 != value:
                fixes_performed.append(
                    text.CLEAN_REMOVE_TRAILING_WHITESPACE % {"field": key})
            fix2 = fix1.lstrip()
            if fix2 != fix1:
                fixes_performed.append(
                    text.CLEAN_REMOVE_LEADING_WHITESPACE % {"field": key})

            if attr in ("track_number", "album_number"):
                match = re.match(r'(.*?)\s*/\s*(.*)', fix2)
                if match is not None:
                    fix3 = "%s/%s" % (match.group(1).lstrip("0"),
                                      match.group(2).lstrip("0"))
                    if fix3 != fix2:
                        fixes_performed.append(
                            text.CLEAN_REMOVE_LEADING_WHITESPACE_ZEROES %
                            {"field": key})
                else:
                    fix3 = fix2.lstrip("0")
                    if fix3 != fix2:
                        fixes_performed.append(
                            text.CLEAN_REMOVE_LEADING_ZEROES % {"field": key})
            elif attr in ("track_total", "album_total"):
                fix3 = fix2.lstrip("0")
                if fix3 != fix2:
                    fixes_performed.append(
                        text.CLEAN_REMOVE_LEADING_ZEROES % {"field": key})
            else:
                fix3 = fix2
            cleaned_fields.append("%s=%s" % (key, fix3))

        return (self.__class__(cleaned_fields, self.vendor_string),
                fixes_performed)
