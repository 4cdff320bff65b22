"""cdrdao TOC files (.toc): read into a ``Sheet`` and written from one.

A copy of the reference's ``audiotools_tpu/sheets/toc.py``: the CD_DA
header required, each TRACK's START pregap, INDEX points and the
lengths of its FILE/AUDIOFILE lines turned into absolute offsets;
``write_tocfile`` writes a track's AUDIOFILE start and length.
"""

from __future__ import annotations

import re
from fractions import Fraction

from ..audiofile import (Sheet, SheetTrack, SheetIndex, SheetException)


class TOCException(SheetException):
    """raised by TOC file parsing errors"""


def _parse_timestamp(stamp):
    """M:S:F or frame count -> seconds as a Fraction"""
    match = re.match(r'^(\d+):(\d+):(\d+)$', stamp)
    if match is not None:
        (m, s, f) = map(int, match.groups())
        return Fraction((m * 60 + s) * 75 + f, 75)
    elif re.match(r'^\d+$', stamp):
        return Fraction(int(stamp), 75)
    else:
        raise TOCException("invalid timestamp %r" % (stamp,))


def read_tocfile(filename):
    """returns a Sheet from a .toc filename"""
    with open(filename, "r", encoding="utf-8", errors="replace") as f:
        return read_tocfile_string(f.read())


def read_tocfile_string(tocfile):
    """returns a Sheet from a TOC file string"""
    lines = [line.split("//")[0].strip()
             for line in tocfile.splitlines()]
    if not any(line == "CD_DA" for line in lines):
        raise TOCException("missing CD_DA header")

    catalog = None
    tracks = []
    track_number = 0
    current = None       # {"audio":, "ISRC":, "start":, "indexes": []}
    position = Fraction(0)

    for line in lines:
        if not line:
            continue
        tokens = line.split()
        keyword = tokens[0].upper()

        if keyword == "CATALOG" and len(tokens) >= 2:
            catalog = tokens[1].strip('"')
        elif keyword == "TRACK":
            if current is not None:
                tracks.append(current)
                position += current["length"]
            track_number += 1
            current = {"number": track_number,
                       "audio": (len(tokens) >= 2 and
                                 tokens[1].upper() == "AUDIO"),
                       "ISRC": None,
                       "pregap": Fraction(0),
                       "indexes": [],
                       "length": Fraction(0)}
        elif keyword == "ISRC" and len(tokens) >= 2:
            if current is not None:
                current["ISRC"] = tokens[1].strip('"')
        elif keyword in ("FILE", "AUDIOFILE"):
            # FILE "name" start [length]
            match = re.match(
                r'(?:AUDIO)?FILE\s+".*?"\s+(\S+)(?:\s+(\S+))?', line,
                re.IGNORECASE)
            if (match is not None) and (current is not None):
                if match.group(2) is not None:
                    current["length"] += _parse_timestamp(
                        match.group(2))
        elif keyword == "START" and current is not None:
            if len(tokens) >= 2:
                current["pregap"] = _parse_timestamp(tokens[1])
            else:
                current["pregap"] = Fraction(0)
        elif keyword == "INDEX" and current is not None:
            if len(tokens) >= 2:
                current["indexes"].append(_parse_timestamp(tokens[1]))

    if current is not None:
        tracks.append(current)

    if len(tracks) == 0:
        raise TOCException("no tracks in TOC file")

    # convert to Sheet objects with absolute offsets
    sheet_tracks = []
    position = Fraction(0)
    for t in tracks:
        indexes = []
        if t["pregap"] > 0:
            indexes.append(SheetIndex(0, position))
            indexes.append(SheetIndex(1, position + t["pregap"]))
        else:
            indexes.append(SheetIndex(1, position))
        for (n, extra) in enumerate(t["indexes"]):
            indexes.append(SheetIndex(2 + n,
                                      position + t["pregap"] + extra))
        sheet_tracks.append(SheetTrack(t["number"], indexes,
                                       t["audio"], t["ISRC"]))
        position += t["length"]

    return Sheet(sheet_tracks, catalog_number=catalog)


def write_tocfile(sheet, filename, file_wrapper, total_pcm_frames=None,
                  sample_rate=44100):
    """writes a Sheet object to an output file object as a TOC file"""
    file_wrapper.write("CD_DA\r\n\r\n")
    if sheet.catalog() is not None:
        file_wrapper.write("CATALOG \"%s\"\r\n\r\n" %
                           (sheet.catalog(),))

    tracks = list(sheet.tracks())
    for (i, track) in enumerate(tracks):
        file_wrapper.write("TRACK %s\r\n" %
                           ("AUDIO" if track.audio()
                            else "MODE1_RAW"))
        if track.ISRC() is not None:
            file_wrapper.write("ISRC \"%s\"\r\n" % (track.ISRC(),))

        start = min(index.offset() for index in track.indexes())
        if i + 1 < len(tracks):
            end = min(index.offset()
                      for index in tracks[i + 1].indexes())
            length = end - start
            frames = int(length * 75)
            stamp = "%d:%02d:%02d" % (frames // 75 // 60,
                                      (frames // 75) % 60,
                                      frames % 75)
            file_wrapper.write(
                "AUDIOFILE \"%s\" %s %s\r\n" %
                (filename, _stamp(start), stamp))
        else:
            file_wrapper.write(
                "AUDIOFILE \"%s\" %s\r\n" % (filename, _stamp(start)))
        file_wrapper.write("\r\n")


def _stamp(offset):
    frames = int(offset * 75)
    return "%d:%02d:%02d" % (frames // 75 // 60,
                             (frames // 75) % 60,
                             frames % 75)
