"""Opening audio files by their content, for the formats the port has
classes for: WAVE (``formats.wav.WaveAudio``) and FLAC
(``formats.flac.FlacAudio``).

A subset of the reference's ``audiotools_tpu/dispatch.py``: ``file_type``
sniffs the magic bytes as the reference does, and ``open`` returns the
class's instance.  Any other content raises ``UnknownAudioType``.
"""

from __future__ import annotations

import builtins

from ._device import resolve_device
from .formats.flac import FlacAudio
from .formats.wav import WaveAudio


class UnknownAudioType(Exception):
    """a file whose content is no audio type the port opens"""

    def __init__(self, filename):
        super().__init__(filename)
        self.filename = filename

    def __str__(self):
        return "unsupported audio type: %s" % (self.filename,)


def file_type(file):
    """the class of a seekable binary stream's audio content (read from
    its current position, which is kept), or None if unknown"""
    start = file.tell()
    header = file.read(12)
    file.seek(start, 0)
    if header[0:4] == b"fLaC":
        return FlacAudio
    if header[0:4] == b"RIFF" and header[8:12] == b"WAVE":
        return WaveAudio
    return None


def open(filename, device="cuda"):
    """the audio file at ``filename``: a FlacAudio that decodes on
    ``device``, or a WaveAudio

    ``device`` is resolved first, so a request for an absent card
    raises whatever the file.  Raises UnknownAudioType for other
    content, OSError if the file cannot be read."""
    device = resolve_device(device)
    with builtins.open(filename, "rb") as f:
        audio_class = file_type(f)
    if audio_class is None:
        raise UnknownAudioType(filename)
    if audio_class is FlacAudio:
        return audio_class(filename, device=device)
    return audio_class(filename)
