"""Opening audio files by their content.

A subset of the reference's ``audiotools_tpu/dispatch.py`` for the nine
classes the port has: WAVE (``formats.wav.WaveAudio``), AIFF
(``formats.aiff.AiffAudio``), Sun AU (``formats.au.AuAudio``), FLAC and
Ogg FLAC (``formats.flac.FlacAudio``, ``OggFlacAudio``), ALAC
(``formats.m4a.ALACAudio``), TTA (``formats.tta.TrueAudio``), Shorten
(``formats.shn.ShortenAudio``) and WavPack
(``formats.wavpack.WavPackAudio``).  ``file_type`` sniffs the magic
bytes as the reference does; ``open`` and ``open_files`` return the
class's instance, decoding on the device given (WAVE, AIFF and AU are
read on the host and take none).  Content of any other type raises
``UnknownAudioType``; an Ogg stream of Vorbis or Opus is such content.  ``TYPE_MAP``, ``open_files``,
``open_directory`` and ``sorted_tracks`` are the reference's as far as
the command line uses them; the reference's ``Filename`` only
normalises the paths ``open_files`` is given, which
``os.path.normpath`` does here.
"""

from __future__ import annotations

import builtins
import os

from ._device import resolve_device
from .audiofile import InvalidFile, UnsupportedFile
from .formats.aiff import AiffAudio
from .formats.au import AuAudio
from .formats.flac import FlacAudio, OggFlacAudio
from .formats.m4a import ALACAudio
from .formats.shn import ShortenAudio
from .formats.tta import TrueAudio
from .formats.wav import WaveAudio
from .formats.wavpack import WavPackAudio
from .ref.alac import _find, _top_level

# in the order the reference lists its classes
TYPE_MAP = {cls.NAME: cls for cls in (
    WaveAudio, AiffAudio, AuAudio, FlacAudio, OggFlacAudio, ShortenAudio,
    TrueAudio, WavPackAudio, ALACAudio)}

# the classes read and written on the host, which take no device
HOST_CLASSES = (WaveAudio, AiffAudio, AuAudio)


class UnknownAudioType(UnsupportedFile):
    """a file whose content is no audio type the port opens; its text is
    the filename, as the reference's UnsupportedFile's is"""

    def __init__(self, filename):
        super().__init__(filename)
        self.filename = filename


def _m4a_type(file):
    """ALACAudio when the stsd atom of an M4A file describes ALAC, else
    None (AAC among them)"""
    (moov, _mdat) = _top_level(file)
    try:
        stsd = _find(moov or b"", b"trak", b"mdia", b"minf", b"stbl",
                     b"stsd")
    except KeyError:
        return None
    return ALACAudio if stsd[12:16] == b"alac" else None


def file_type(file):
    """the class of a seekable binary stream's audio content (read from
    its current position, which is kept), or None if unknown"""
    start = file.tell()
    header = file.read(37)
    file.seek(start, 0)
    try:
        if header[4:8] == b"ftyp" and header[8:12] in (b"mp41", b"mp42",
                                                        b"M4A ", b"M4B "):
            return _m4a_type(file)
        if header[0:4] == b"FORM" and header[8:12] == b"AIFF":
            return AiffAudio
        if header[0:4] == b".snd":
            return AuAudio
        if header[0:4] == b"fLaC":
            return FlacAudio
        if header[0:4] == b"OggS":
            # Ogg FLAC; Vorbis and Opus streams are not ported
            return OggFlacAudio if header[0x1C:0x21] == b"\x7FFLAC" else None
        if header[0:5] == b"ajkg\x02":
            return ShortenAudio
        if header[0:4] == b"wvpk":
            return WavPackAudio
        if header[0:4] == b"RIFF" and header[8:12] == b"WAVE":
            return WaveAudio
        if len(header) >= 10 and header[0:3] == b"ID3" and \
                header[3] in (2, 3, 4):
            # an ID3v2 tag: look past it; only FLAC and TTA (of the
            # port's classes) may be wrapped so
            size = 0
            for b in header[6:10]:
                size = (size << 7) | (b & 0x7F)
            file.seek(start + 10 + size, 0)
            wrapped = file_type(file)
            return wrapped if wrapped in (FlacAudio, TrueAudio) else None
        if header[0:4] == b"TTA1":
            return TrueAudio
        return None
    finally:
        file.seek(start, 0)


def _open_class(audio_class, filename, device):
    if audio_class in HOST_CLASSES:
        return audio_class(filename)
    return audio_class(filename, device=device)


def open(filename, device="cuda"):
    """the audio file at ``filename``, decoding on ``device``

    ``device`` is resolved first, so a request for an absent card
    raises whatever the file.  Raises UnknownAudioType for other
    content, InvalidFile (a subclass of it) for a file its class
    cannot read, OSError if the file cannot be read."""
    device = resolve_device(device)
    with builtins.open(filename, "rb") as f:
        audio_class = file_type(f)
    if audio_class is None:
        raise UnknownAudioType(filename)
    return _open_class(audio_class, filename, device)


def sorted_tracks(audiofiles):
    """the files in the reference's order: those without metadata first,
    by basename; then those with, by album number and track number (a
    number that is None first), a file without a track number by
    basename"""
    def sort_key(pair):
        (track, metadata) = pair
        basename = os.path.basename(track.filename)
        if metadata is None:
            return (0, False, 0, False, 0, basename)
        album_number = metadata.album_number
        track_number = metadata.track_number
        return (1, album_number is not None, album_number or 0,
                track_number is not None, track_number or 0,
                basename if track_number is None else "")

    return [track for (track, _metadata) in sorted(
        ((f, f.get_metadata()) for f in audiofiles), key=sort_key)]


def open_files(filename_list, sorted=True, messenger=None, device="cuda"):
    """the audio files named, in sorted_tracks order when ``sorted``,
    decoding on ``device``; files of unknown type are skipped, and
    unreadable or invalid ones are reported to ``messenger`` (a
    warning or an error, as the reference does) and skipped"""
    device = resolve_device(device)
    opened = []
    for filename in map(os.path.normpath, filename_list):
        try:
            with builtins.open(filename, "rb") as f:
                audio_class = file_type(f)
            if audio_class is not None:
                opened.append(_open_class(audio_class, filename, device))
        except InvalidFile as err:
            if messenger is not None:
                messenger.error(str(err))
        except IOError:
            if messenger is not None:
                messenger.warning("unable to open \"%s\"" % (filename,))
    return sorted_tracks(opened) if sorted else opened


def open_directory(directory, sorted=True, messenger=None, device="cuda"):
    """yields the audio files under ``directory``, searched recursively,
    as ``open_files`` opens them (each directory's files sorted when
    ``sorted``)"""
    for (basedir, subdirs, filenames) in os.walk(directory):
        if sorted:
            subdirs.sort()
            filenames.sort()
        yield from open_files([os.path.join(basedir, filename)
                               for filename in filenames],
                              sorted=sorted, messenger=messenger,
                              device=device)
