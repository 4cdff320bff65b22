"""The AudioFile layer: the base of the port's file classes.

The port of the parts of the reference's ``audiotools_tpu/audiofile.py``
that the command line reaches: ``AudioFile`` (lengths, ``verify``,
``convert``, ``track_name`` and the ReplayGain hooks),
``WaveContainer``, and the exceptions the reference keeps in its
package root.

The reference's ``meta/`` (MetaData and the tag formats) is not
ported.  ``track_name`` fills the template as the reference does for a
file without metadata.  ``tag_names`` reports what a file holds in
its tag container, so that a conversion can refuse the tags it cannot
write instead of dropping them.
"""

from __future__ import annotations

import decimal
import os

from .pcm import FRAMELIST_SIZE, to_pcm_progress

# the reference's built-in default for the Filenames/format setting
FILENAME_FORMAT = "%(track_number)2.2d - %(track_name)s.%(suffix)s"

# the reference MetaData's text fields, the template keys track_name
# fills with ""
TEXT_FIELDS = ("track_name", "album_name", "artist_name", "performer_name",
               "composer_name", "conductor_name", "media", "ISRC",
               "catalog", "copyright", "publisher", "year", "date",
               "comment")


class InvalidFile(Exception):
    """a file whose content is invalid for its class"""


class UnsupportedFile(Exception):
    """a file that cannot be identified or opened"""


class EncodingError(IOError):
    """an audio file that cannot be created from a PCMReader"""

    def __init__(self, error_message):
        IOError.__init__(self, error_message)
        self.error_message = error_message


class UnsupportedTracknameField(Exception):
    """a track_name template field that does not exist"""

    def __init__(self, field):
        Exception.__init__(self, field)
        self.field = field

    def __str__(self):
        return "unknown field \"%s\" in file format" % (self.field,)


class InvalidFilenameFormat(Exception):
    """a track_name template that does not format"""

    def __str__(self):
        return "invalid filename format string"


def tags_not_ported(filename, tags):
    """the EncodingError of a conversion whose source holds ``tags``
    that the port cannot write"""
    return EncodingError(
        "%s: tags %s would be lost: the reference's meta/ (tag "
        "conversion between formats) is not ported"
        % (filename, ", ".join(tags)))


class AudioFile:
    """an audio file on disk

    Every class of the port is lossless.  ``device`` is the torch
    device the file decodes on, None for a class that decodes on the
    host."""

    SUFFIX = ""
    NAME = ""
    DEFAULT_COMPRESSION = ""
    COMPRESSION_MODES = ("",)

    device = None

    def __init__(self, filename):
        self.filename = filename

    def lossless(self):
        return True

    def seconds_length(self):
        """the track's length in seconds, a Decimal"""
        try:
            return (decimal.Decimal(self.total_frames()) /
                    decimal.Decimal(self.sample_rate()))
        except decimal.DivisionByZero:
            return decimal.Decimal(0)

    def tag_names(self):
        """None when the file has no tag container (where the
        reference's get_metadata() is None), else the names of the tags
        in it that the port cannot carry (empty when there are none)"""
        return None

    def write_blank_tags(self):
        """gives this newly written file what the reference's
        ``set_metadata`` writes for a MetaData with no fields set"""

    def carry_tags_to(self, dest):
        """what the reference's ``dest.set_metadata(self.get_metadata())``
        does after a conversion, where the port can write it: nothing
        without a tag container, the blank tags of ``dest``'s class for
        an empty one; tags the port cannot write raise EncodingError"""
        tags = self.tag_names()
        if tags is None:
            return
        if tags:
            raise tags_not_ported(self.filename, tags)
        dest.write_blank_tags()

    def convert(self, target_path, target_class, compression=None,
                progress=None, device=None):
        """encodes a new ``target_class`` file from this one on
        ``device`` (this file's device when None), passing the frame
        count ahead as the reference does"""
        if device is None:
            device = self.device
        return target_class.from_pcm(
            target_path, to_pcm_progress(self, progress), compression,
            total_pcm_frames=(self.total_frames() if self.lossless()
                              else None),
            device=device)

    @classmethod
    def track_name(cls, file_path, format=None, suffix=None):
        """a filename from the ``format`` template (FILENAME_FORMAT when
        None): the numbers 0 and the text fields empty, as for a track
        without metadata, plus ``suffix`` and the source's basename"""
        if format is None:
            format = FILENAME_FORMAT
        if suffix is None:
            suffix = cls.SUFFIX
        format_dict = {"track_number": 0, "album_number": 0,
                       "track_total": 0, "album_total": 0,
                       "album_track_number": "00", "suffix": suffix}
        format_dict.update(dict.fromkeys(TEXT_FIELDS, ""))
        format_dict["basename"] = os.path.splitext(
            os.path.basename(file_path))[0]
        try:
            return format % format_dict
        except KeyError as error:
            raise UnsupportedTracknameField(str(error.args[0]))
        except (TypeError, ValueError):
            raise InvalidFilenameFormat()

    @classmethod
    def supports_replay_gain(cls):
        return False

    @classmethod
    def add_replay_gain(cls, filenames, progress=None, device="cuda"):
        """adds ReplayGain values to the files named"""

    def verify(self, progress=None, sink=None):
        """decodes the whole file: raises InvalidFile on a stream error
        or when the frame count is not the header's, else returns True

        ``sink(samples)``, when given, takes each decoded int32
        [frames, channels] array in stream order."""
        decoder = None
        try:
            total_frames = self.total_frames()
            decoder = self.to_pcm()
            pcm_frame_count = 0
            framelist = decoder.read(FRAMELIST_SIZE)
            while framelist.frames > 0:
                pcm_frame_count += framelist.frames
                if sink is not None:
                    sink(framelist.samples)
                if progress is not None:
                    progress(pcm_frame_count, total_frames)
                framelist = decoder.read(FRAMELIST_SIZE)
        except (IOError, ValueError) as err:
            raise InvalidFile(str(err))
        finally:
            if decoder is not None:
                decoder.close()
        if pcm_frame_count != total_frames:
            raise InvalidFile("incorrect PCM frame count")
        return True


class WaveContainer(AudioFile):
    """an AudioFile which may hold foreign RIFF chunks

    The reference converts such a file through the target's
    ``from_wave``, which the port does not have; it refuses the
    conversion rather than drop the chunks."""

    def has_foreign_wave_chunks(self):
        """True when the file holds RIFF chunks besides fmt and data"""
        raise NotImplementedError()

    def convert(self, target_path, target_class, compression=None,
                progress=None, device=None):
        if self.has_foreign_wave_chunks():
            raise EncodingError(
                "%s: foreign RIFF chunks would be lost: the reference's "
                "from_wave is not ported" % (self.filename,))
        return AudioFile.convert(self, target_path, target_class,
                                 compression, progress, device)
