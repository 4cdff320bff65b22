"""Opening audio files by their content.

A subset of the reference's ``audiotools_tpu/dispatch.py`` for the
port's classes: WAVE (``formats.wav.WaveAudio``), AIFF
(``formats.aiff.AiffAudio``), Sun AU (``formats.au.AuAudio``), FLAC and
Ogg FLAC (``formats.flac.FlacAudio``, ``OggFlacAudio``), Shorten
(``formats.shn.ShortenAudio``), TTA (``formats.tta.TrueAudio``), WavPack
(``formats.wavpack.WavPackAudio``), ALAC and AAC
(``formats.m4a.ALACAudio``, ``M4AAudio``), MP3 and MP2
(``formats.mp3.MP3Audio``, ``MP2Audio``), Ogg Vorbis
(``formats.vorbis.VorbisAudio``) and Ogg Opus
(``formats.opus.OpusAudio``).  ``file_type`` sniffs the magic bytes as
the reference does, looking past ID3v2 tags in front of FLAC, TTA, MP3
and MP2 streams; ``open`` and ``open_files`` return the class's
instance, decoding on the device given (the host classes take none).
Content of any other type raises ``UnknownAudioType``, and a class that
is not ``available()`` (a lossy one whose library, or AAC whose
programs, are not found) raises ``UnsupportedFile`` as the reference's
does.  ``TYPE_MAP`` holds the available classes in the reference's
order; ``open_files``, ``open_directory`` and ``sorted_tracks`` are the
reference's as far as the command line uses them; the reference's
``Filename`` only normalises the paths ``open_files`` is given, which
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
from .formats.m4a import ALACAudio, M4AAudio
from .formats.mp3 import MP2Audio, MP3Audio
from .formats.opus import OpusAudio
from .formats.shn import ShortenAudio
from .formats.tta import TrueAudio
from .formats.vorbis import VorbisAudio
from .formats.wav import WaveAudio
from .formats.wavpack import WavPackAudio
from .ref.alac import _find, _top_level

# in the order the reference lists its classes
AVAILABLE_TYPES = (WaveAudio, AiffAudio, AuAudio, FlacAudio, OggFlacAudio,
                   ShortenAudio, TrueAudio, WavPackAudio, ALACAudio,
                   M4AAudio, MP3Audio, MP2Audio, VorbisAudio, OpusAudio)

TYPE_MAP = {cls.NAME: cls for cls in AVAILABLE_TYPES if cls.available()}

# the classes opened on the host, which take no device
HOST_CLASSES = (WaveAudio, AiffAudio, AuAudio, M4AAudio, MP3Audio,
                MP2Audio, VorbisAudio, OpusAudio)

# the classes whose streams may follow ID3v2 tags
ID3_WRAPPABLE = (FlacAudio, TrueAudio, MP3Audio, MP2Audio)


class UnknownAudioType(UnsupportedFile):
    """a file whose content is no audio type the port opens; its text is
    the filename, as the reference's UnsupportedFile's is"""

    def __init__(self, filename):
        super().__init__(filename)
        self.filename = filename


def _m4a_type(file):
    """ALACAudio or M4AAudio as the stsd atom of an M4A file describes
    ALAC or AAC (mp4a), else None"""
    (moov, _mdat) = _top_level(file)
    try:
        stsd = _find(moov or b"", b"trak", b"mdia", b"minf", b"stbl",
                     b"stsd")
    except KeyError:
        return None
    return {b"alac": ALACAudio, b"mp4a": M4AAudio}.get(stsd[12:16])


def _mpeg_type(header):
    """MP3Audio or MP2Audio for the frame header of an MPEG-1 layer III
    or layer II stream, else None"""
    frame_sync = (header[0] << 3) | (header[1] >> 5)
    mpeg_id = (header[1] >> 3) & 0x3
    layer_description = (header[1] >> 1) & 0x3
    bitrate = (header[2] >> 4) & 0xF
    sample_rate = (header[2] >> 2) & 0x3
    emphasis = header[3] & 0x3
    if (frame_sync != 0x7FF or mpeg_id != 3 or bitrate == 0xF or
            sample_rate == 3 or emphasis == 2):
        return None
    return {1: MP3Audio, 2: MP2Audio}.get(layer_description)


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
        if len(header) >= 4 and header[0] == 0xFF:
            return _mpeg_type(header)
        if header[0:4] == b"OggS":
            if header[0x1C:0x21] == b"\x7FFLAC":
                return OggFlacAudio
            if header[0x1C:0x23] == b"\x01vorbis":
                return VorbisAudio
            if header[0x1C:0x26] == b"OpusHead\x01":
                return OpusAudio
            return None
        if header[0:5] == b"ajkg\x02":
            return ShortenAudio
        if header[0:4] == b"wvpk":
            return WavPackAudio
        if header[0:4] == b"RIFF" and header[8:12] == b"WAVE":
            return WaveAudio
        if len(header) >= 10 and header[0:3] == b"ID3" and \
                header[3] in (2, 3, 4):
            # an ID3v2 tag: look past it
            size = 0
            for b in header[6:10]:
                size = (size << 7) | (b & 0x7F)
            file.seek(start + 10 + size, 0)
            wrapped = file_type(file)
            return wrapped if wrapped in ID3_WRAPPABLE else None
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
    if not audio_class.available():
        raise UnsupportedFile(filename)
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
    decoding on ``device``; files of unknown type are skipped, files
    of a class that is not available are skipped after the programs
    it needs are told to ``messenger`` (once a class), and unreadable
    or invalid ones are reported to ``messenger`` (a warning or an
    error, as the reference does) and skipped"""
    device = resolve_device(device)
    opened = []
    unavailable = set()
    for filename in map(os.path.normpath, filename_list):
        try:
            with builtins.open(filename, "rb") as f:
                audio_class = file_type(f)
            if audio_class is None:
                continue
            if audio_class.available():
                opened.append(_open_class(audio_class, filename, device))
            elif (messenger is not None and
                  audio_class.NAME not in unavailable):
                audio_class.missing_components(messenger)
                unavailable.add(audio_class.NAME)
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
