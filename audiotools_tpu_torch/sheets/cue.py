"""Cue sheets (.cue): read into a ``Sheet`` and written from one.

A copy of the reference's ``audiotools_tpu/sheets/cue.py``: a line
tokenizer that keeps quoted strings whole, ``read_cuesheet`` (CATALOG,
TRACK, INDEX and ISRC; the text and the other commands skipped) and
``write_cuesheet``.
"""

from __future__ import annotations

import re
from fractions import Fraction

from ..audiofile import (Sheet, SheetTrack, SheetIndex, SheetException)


class CueException(SheetException):
    """raised by cuesheet parsing errors"""


def _tokenize(line):
    """splits a cuesheet line into tokens, respecting quotes"""
    tokens = []
    pos = 0
    line = line.strip()
    while pos < len(line):
        if line[pos].isspace():
            pos += 1
        elif line[pos] == '"':
            end = line.find('"', pos + 1)
            if end == -1:
                raise CueException("unterminated quoted string")
            tokens.append(line[pos + 1:end])
            pos = end + 1
        else:
            match = re.match(r'\S+', line[pos:])
            tokens.append(match.group(0))
            pos += len(match.group(0))
    return tokens


def _parse_timestamp(stamp):
    """MM:SS:FF -> seconds as a Fraction"""
    match = re.match(r'^(\d+):(\d+):(\d+)$', stamp)
    if match is None:
        raise CueException("invalid timestamp %r" % (stamp,))
    (m, s, f) = map(int, match.groups())
    return Fraction((m * 60 + s) * 75 + f, 75)


def read_cuesheet(filename):
    """returns a Sheet from a .cue filename

    raises CueException if a parsing error occurs"""
    with open(filename, "r", encoding="utf-8", errors="replace") as f:
        return read_cuesheet_string(f.read())


def read_cuesheet_string(cuesheet):
    """returns a Sheet from a cuesheet string"""
    catalog = None
    tracks = []
    current_track = None      # (number, audio, ISRC, indexes, metadata)
    sheet_metadata = {}

    for line in cuesheet.splitlines():
        tokens = _tokenize(line)
        if not tokens:
            continue
        keyword = tokens[0].upper()

        if keyword == "CATALOG" and len(tokens) >= 2:
            catalog = tokens[1]
        elif keyword == "FILE":
            pass
        elif keyword == "TRACK" and len(tokens) >= 3:
            if current_track is not None:
                tracks.append(current_track)
            current_track = {
                "number": int(tokens[1]),
                "audio": tokens[2].upper() == "AUDIO",
                "ISRC": None,
                "indexes": []}
        elif keyword == "INDEX" and len(tokens) >= 3:
            if current_track is None:
                raise CueException("INDEX outside of TRACK")
            current_track["indexes"].append(
                SheetIndex(int(tokens[1]),
                           _parse_timestamp(tokens[2])))
        elif keyword == "ISRC" and len(tokens) >= 2:
            if current_track is not None:
                current_track["ISRC"] = tokens[1]
        elif keyword in ("TITLE", "PERFORMER", "SONGWRITER"):
            target = (current_track if current_track is not None
                      else sheet_metadata)
            if isinstance(target, dict) and len(tokens) >= 2:
                target[keyword] = tokens[1]
        elif keyword in ("REM", "FLAGS", "PREGAP", "POSTGAP",
                         "CDTEXTFILE"):
            pass

    if current_track is not None:
        tracks.append(current_track)

    if len(tracks) == 0:
        raise CueException("no tracks in cuesheet")

    return Sheet([SheetTrack(t["number"],
                             t["indexes"],
                             t["audio"],
                             t["ISRC"]) for t in tracks],
                 catalog_number=catalog)


def write_cuesheet(sheet, filename, file_wrapper):
    """writes a Sheet object to an output file object as a cuesheet

    filename names the FILE entry"""
    if sheet.catalog() is not None:
        file_wrapper.write("CATALOG %s\r\n" % (sheet.catalog(),))
    file_wrapper.write("FILE \"%s\" WAVE\r\n" % (filename,))
    for track in sheet.tracks():
        file_wrapper.write("  TRACK %2.2d %s\r\n" %
                           (track.number(),
                            "AUDIO" if track.audio() else "MODE1/2352"))
        if track.ISRC() is not None:
            file_wrapper.write("    ISRC %s\r\n" % (track.ISRC(),))
        for index in track.indexes():
            offset = index.offset()
            frames = int(offset * 75)
            file_wrapper.write(
                "    INDEX %2.2d %2.2d:%2.2d:%2.2d\r\n" %
                (index.number(),
                 frames // 75 // 60,
                 (frames // 75) % 60,
                 frames % 75))
