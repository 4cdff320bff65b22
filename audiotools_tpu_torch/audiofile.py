"""The AudioFile layer: MetaData, Image, ReplayGain and the base of the
port's file classes.

The port of the parts of the reference's ``audiotools_tpu/audiofile.py``
that the command line reaches: ``MetaData`` (the 18 fields, their
display, ``converted``, ``clean`` and the image list), ``Image``, the
``ReplayGain`` value object, ``AudioFile`` (lengths, ``verify``,
``convert``, ``track_name``, ``clean``, the metadata, cuesheet and
ReplayGain hooks with the reference's base behaviour),
``WaveContainer`` and ``AiffContainer`` (foreign RIFF or AIFF chunks
carried through the target's ``from_wave`` or ``from_aiff``), the CD
layout of a cue or TOC sheet (``Sheet``,
``SheetTrack``, ``SheetIndex``, ``read_sheet``, ``parse_timestamp``,
``build_timestamp``), ``AlbumMetaData``, ``DummyAudioFile``, and the
exceptions the reference keeps in its package root, which the package
root exports as they are.  The tag formats are in ``meta/``, the sheet formats in
``sheets/``, and the format classes in ``formats/``.
"""

from __future__ import annotations

import decimal
import os

from .pcm import FRAMELIST_SIZE, to_pcm_progress
# the configured Filenames/format setting, the reference's built-in
# template when none is set
from .utils.config import FILENAME_FORMAT


class InvalidFile(Exception):
    """a file whose content is invalid for its class"""


class UnsupportedFile(Exception):
    """a file that cannot be identified or opened"""


class EncodingError(IOError):
    """an audio file that cannot be created from a PCMReader"""

    def __init__(self, error_message):
        IOError.__init__(self, error_message)
        self.error_message = error_message


class UnsupportedBitsPerSample(EncodingError):
    """an audio file that cannot be created at the given bits per sample"""

    def __init__(self, filename, bits_per_sample):
        EncodingError.__init__(
            self, "unsupported bits per sample: %d" % (bits_per_sample,))
        self.bits_per_sample = bits_per_sample


class UnsupportedChannelCount(EncodingError):
    """an audio file that cannot be created with the given channel count"""

    def __init__(self, filename, channel_count):
        EncodingError.__init__(
            self, "unsupported channel count: %d" % (channel_count,))
        self.channel_count = channel_count


class UnsupportedChannelMask(EncodingError):
    """an audio file that cannot be created with the given channel mask"""

    def __init__(self, filename, mask):
        EncodingError.__init__(
            self, "unsupported channel mask: %d" % (int(mask),))
        self.mask = mask


class DecodingError(IOError):
    """a decoder's to_pcm() that fails"""

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


class MetaData:
    """the textual metadata of an AudioFile

    A field is None where the underlying format does not hold it.  The
    tag formats subclass it, mapping the fields onto their own items."""

    FIELDS = ("track_name", "track_number", "track_total", "album_name",
              "artist_name", "performer_name", "composer_name",
              "conductor_name", "media", "ISRC", "catalog", "copyright",
              "publisher", "year", "date", "album_number", "album_total",
              "comment")

    INTEGER_FIELDS = ("track_number", "track_total", "album_number",
                      "album_total")

    # the order __str__ shows them in
    FIELD_ORDER = ("track_name", "artist_name", "album_name",
                   "track_number", "track_total", "album_number",
                   "album_total", "performer_name", "composer_name",
                   "conductor_name", "catalog", "ISRC", "publisher",
                   "media", "year", "date", "copyright", "comment")

    FIELD_NAMES = {"track_name": "Track Name",
                   "track_number": "Track Number",
                   "track_total": "Track Total",
                   "album_name": "Album Name",
                   "artist_name": "Artist Name",
                   "performer_name": "Performer Name",
                   "composer_name": "Composer Name",
                   "conductor_name": "Conductor Name",
                   "media": "Media",
                   "ISRC": "ISRC",
                   "catalog": "Catalog Number",
                   "copyright": "Copyright",
                   "publisher": "Publisher",
                   "year": "Release Year",
                   "date": "Recording Date",
                   "album_number": "Album Number",
                   "album_total": "Album Total",
                   "comment": "Comment"}

    def __init__(self, track_name=None, track_number=None, track_total=None,
                 album_name=None, artist_name=None, performer_name=None,
                 composer_name=None, conductor_name=None, media=None,
                 ISRC=None, catalog=None, copyright=None, publisher=None,
                 year=None, date=None, album_number=None, album_total=None,
                 comment=None, images=None):
        # past __setattr__, which subclasses redefine
        d = self.__dict__
        d["track_name"] = track_name
        d["track_number"] = track_number
        d["track_total"] = track_total
        d["album_name"] = album_name
        d["artist_name"] = artist_name
        d["performer_name"] = performer_name
        d["composer_name"] = composer_name
        d["conductor_name"] = conductor_name
        d["media"] = media
        d["ISRC"] = ISRC
        d["catalog"] = catalog
        d["copyright"] = copyright
        d["publisher"] = publisher
        d["year"] = year
        d["date"] = date
        d["album_number"] = album_number
        d["album_total"] = album_total
        d["comment"] = comment
        d["__images__"] = list(images) if images is not None else []

    def __repr__(self):
        return "MetaData(%s)" % ",".join(
            "%s=%s" % (field, repr(getattr(self, field)))
            for field in MetaData.FIELDS)

    def __str__(self):
        lines = []
        for attr in self.FIELD_ORDER:
            if attr in ("track_total", "album_total"):
                continue
            elif attr in ("track_number", "album_number"):
                number = getattr(self, attr)
                total = getattr(self, attr.replace("number", "total"))
                if number is None and total is None:
                    continue
                elif total is None:
                    value = str(number)
                elif number is None:
                    value = "?/%d" % (total,)
                else:
                    value = "%d/%d" % (number, total)
                lines.append("%s : %s" % (self.FIELD_NAMES[attr], value))
            elif getattr(self, attr) is not None:
                lines.append("%s : %s" % (self.FIELD_NAMES[attr],
                                          getattr(self, attr)))
        for image in self.images():
            lines.append("Picture : %s" % (image,))
        return os.linesep.join(lines)

    def __delattr__(self, field):
        if field in self.FIELDS:
            self.__dict__[field] = None
        else:
            try:
                del self.__dict__[field]
            except KeyError:
                raise AttributeError(field)

    def fields(self):
        """(attr, value) for each of the 18 fields"""
        for attr in self.FIELDS:
            yield (attr, getattr(self, attr))

    def filled_fields(self):
        """(attr, value) for each field that is set"""
        for (attr, field) in self.fields():
            if field is not None:
                yield (attr, field)

    def empty_fields(self):
        """(attr, None) for each field that is not set"""
        for (attr, field) in self.fields():
            if field is None:
                yield (attr, field)

    def raw_info(self):
        """a string of the format's own items"""
        raise NotImplementedError()

    def __eq__(self, metadata):
        for attr in MetaData.FIELDS:
            if (not hasattr(metadata, attr) or
                    getattr(self, attr) != getattr(metadata, attr)):
                return False
        return True

    def __ne__(self, metadata):
        return not self.__eq__(metadata)

    @classmethod
    def converted(cls, metadata):
        """a plain MetaData of another's fields and images, or None"""
        if metadata is None:
            return None
        fields = {field: getattr(metadata, field) for field in cls.FIELDS}
        fields["images"] = metadata.images()
        return MetaData(**fields)

    @classmethod
    def supports_images(cls):
        return True

    def images(self):
        """the embedded Image objects"""
        return self.__images__[:]

    def front_covers(self):
        return [i for i in self.images() if i.type == FRONT_COVER]

    def back_covers(self):
        return [i for i in self.images() if i.type == BACK_COVER]

    def leaflet_pages(self):
        return [i for i in self.images() if i.type == LEAFLET_PAGE]

    def media_images(self):
        return [i for i in self.images() if i.type == MEDIA]

    def other_images(self):
        return [i for i in self.images() if i.type == OTHER]

    def add_image(self, image):
        """embeds an Image"""
        if not self.supports_images():
            raise ValueError("this metadata type does not support images")
        self.__images__.append(image)

    def delete_image(self, image):
        """removes an embedded Image"""
        if not self.supports_images():
            raise ValueError("this metadata type does not support images")
        self.__images__.pop(self.__images__.index(image))

    def clean(self):
        """a (MetaData, fixes performed) pair: a plain MetaData of the
        fields (no images) and no fixes, as the reference's base class
        gives; the tag formats find their own problems"""
        return (MetaData(**{field: getattr(self, field)
                            for field in MetaData.FIELDS}), [])

    def intersection(self, metadata):
        """a plain MetaData of the fields set to the same value here and
        in ``metadata``"""
        return MetaData(**{field: getattr(self, field)
                           for field in MetaData.FIELDS
                           if (getattr(self, field) is not None and
                               getattr(self, field) ==
                               getattr(metadata, field, None))})


(FRONT_COVER, BACK_COVER, LEAFLET_PAGE, MEDIA, OTHER) = range(5)


class Image:
    """an embedded image: its bytes and what they describe"""

    def __init__(self, data, mime_type, width, height, color_depth,
                 color_count, description, type):
        self.data = data
        self.mime_type = mime_type
        self.width = width
        self.height = height
        self.color_depth = color_depth
        self.color_count = color_count
        self.description = description
        self.type = type

    def suffix(self):
        """the file suffix of the image's MIME type"""
        return {"image/jpeg": "jpg", "image/png": "png", "image/gif": "gif",
                "image/tiff": "tiff",
                "image/x-ms-bmp": "bmp"}.get(self.mime_type, "bin")

    def type_string(self):
        """the image's type as a display string"""
        return {FRONT_COVER: "Front Cover", BACK_COVER: "Back Cover",
                LEAFLET_PAGE: "Leaflet Page", MEDIA: "Media",
                OTHER: "Other"}.get(self.type, "Other")

    def __repr__(self):
        return ("Image(mime_type=%s,width=%s,height=%s,type=%s,...)" %
                (repr(self.mime_type), repr(self.width), repr(self.height),
                 repr(self.type)))

    def __str__(self):
        return "%s (%d×%d,'%s')" % (self.type_string(), self.width,
                                         self.height, self.mime_type)

    @classmethod
    def new(cls, image_data, description, type):
        """an Image of raw bytes, its metrics parsed from them (raises
        meta.image.InvalidImage for bytes of no known type)"""
        from .meta.image import image_metrics
        img = image_metrics(image_data)
        return Image(data=image_data, mime_type=img.mime_type,
                     width=img.width, height=img.height,
                     color_depth=img.bits_per_pixel,
                     color_count=img.color_count, description=description,
                     type=type)

    def __eq__(self, image):
        if image is None:
            return False
        for attr in ("data", "mime_type", "width", "height", "color_depth",
                     "color_count", "description", "type"):
            if (not hasattr(image, attr) or
                    getattr(self, attr) != getattr(image, attr)):
                return False
        return True

    def __ne__(self, image):
        return not self.__eq__(image)


class AlbumMetaData(dict):
    """several tracks' MetaData, keyed by track number"""

    def __init__(self, metadata_iter):
        dict.__init__(self, {m.track_number: m for m in metadata_iter})

    def metadata(self):
        """one MetaData of the fields every track agrees on"""
        values = {}
        for field in MetaData.FIELDS:
            items = {getattr(track, field) for track in self.values()}
            if len(items) == 1:
                values[field] = items.pop()
        return MetaData(**values)


class ReplayGain:
    """a track's and its album's ReplayGain gains (dB) and peaks"""

    def __init__(self, track_gain, track_peak, album_gain, album_peak):
        self.track_gain = float(track_gain)
        self.track_peak = float(track_peak)
        self.album_gain = float(album_gain)
        self.album_peak = float(album_peak)

    def __repr__(self):
        return "ReplayGain(%s, %s, %s, %s)" % (
            self.track_gain, self.track_peak, self.album_gain,
            self.album_peak)

    def __eq__(self, rg):
        for attr in ("track_gain", "track_peak", "album_gain", "album_peak"):
            if not hasattr(rg, attr) or getattr(self, attr) != getattr(rg,
                                                                       attr):
                return False
        return True

    def __ne__(self, rg):
        return not self.__eq__(rg)


class AudioFile:
    """an audio file on disk

    A class is lossless unless it says otherwise (the lossy ones: MP3,
    MP2, Vorbis, Opus, AAC).  ``device`` is the torch device the file
    decodes on, None for a class that decodes on the host."""

    SUFFIX = ""
    NAME = ""
    DESCRIPTION = ""
    DEFAULT_COMPRESSION = ""
    COMPRESSION_MODES = ("",)
    COMPRESSION_DESCRIPTIONS = {}
    # the outside programs a class needs, and where to get them
    BINARIES = ()
    BINARY_URLS = {}
    REPLAYGAIN_BINARIES = ()

    device = None

    def __init__(self, filename):
        self.filename = filename

    @classmethod
    def available(cls, system_binaries=None):
        """True when every program of BINARIES can be run (the classes
        that need a library instead say whether it is found)"""
        if system_binaries is None:
            from .utils.config import BIN as system_binaries
        return all(system_binaries.can_execute(system_binaries[command])
                   for command in cls.BINARIES)

    @classmethod
    def missing_components(cls, messenger):
        """tells ``messenger`` which programs this class needs"""
        for binary in cls.BINARIES:
            messenger.info("program \"%s\" is required to support %s files"
                           % (binary, cls.NAME))
            if binary in cls.BINARY_URLS:
                messenger.info("available from %s" %
                               (cls.BINARY_URLS[binary],))

    def bits_per_sample(self):
        raise NotImplementedError()

    def channels(self):
        raise NotImplementedError()

    def channel_mask(self):
        """the channel layout; by default the one of the channel count
        (1 or 2 only)"""
        from .pcm import ChannelMask
        return ChannelMask.from_channels(self.channels())

    def sample_rate(self):
        raise NotImplementedError()

    def total_frames(self):
        raise NotImplementedError()

    def seekable(self):
        """True when the class's decoder can seek"""
        return False

    def to_pcm(self):
        raise NotImplementedError()

    @classmethod
    def from_pcm(cls, filename, pcmreader, compression=None,
                 total_pcm_frames=None):
        raise NotImplementedError()

    def __eq__(self, audiofile):
        """True when both files decode to the same PCM frames"""
        if not callable(getattr(audiofile, "to_pcm", None)):
            return False
        from .pcm import pcm_frame_cmp
        p1 = p2 = None
        try:
            p1 = self.to_pcm()
            p2 = audiofile.to_pcm()
            return pcm_frame_cmp(p1, p2) is None
        except (ValueError, IOError):
            return False
        finally:
            for p in (p1, p2):
                if p is not None:
                    try:
                        p.close()
                    except Exception:
                        pass

    def __ne__(self, audiofile):
        return not self.__eq__(audiofile)

    def lossless(self):
        return True

    def seconds_length(self):
        """the track's length in seconds, a Decimal"""
        try:
            return (decimal.Decimal(self.total_frames()) /
                    decimal.Decimal(self.sample_rate()))
        except decimal.DivisionByZero:
            return decimal.Decimal(0)

    def cd_frames(self):
        """the track's length in CD frames (1/75 s), rounded down"""
        try:
            return (self.total_frames() * 75) // self.sample_rate()
        except ZeroDivisionError:
            return 0

    def get_metadata(self):
        """the file's MetaData, or None for a class that holds none"""
        return None

    def set_metadata(self, metadata):
        """converts ``metadata`` to the file's own format and writes it"""

    def update_metadata(self, metadata):
        """writes back a MetaData from this file's get_metadata()"""
        if metadata is None:
            raise ValueError("metadata not from audio file")
        raise NotImplementedError()

    def delete_metadata(self):
        """removes the file's MetaData"""

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
    def track_name(cls, file_path, track_metadata=None, format=None,
                   suffix=None):
        """a filename from the ``format`` template (FILENAME_FORMAT when
        None) filled from ``track_metadata`` (the numbers 0 and the text
        fields empty where it has none), ``suffix`` (the class's when
        None) and the source's basename; "/" and NUL in a field become
        "-" and " " """
        if format is None:
            format = FILENAME_FORMAT
        if suffix is None:
            suffix = cls.SUFFIX
        try:
            numbers = {field: (getattr(track_metadata, field) or 0
                               if track_metadata is not None else 0)
                       for field in MetaData.INTEGER_FIELDS}
            format_dict = dict(numbers, suffix=suffix)
            if numbers["album_number"] == 0:
                format_dict["album_track_number"] = "%2.2d" % (
                    numbers["track_number"],)
            else:
                album_digits = len(str(numbers["album_total"]))
                format_dict["album_track_number"] = (
                    "%%%(d)d.%(d)dd%%2.2d" % {"d": album_digits}) % (
                        numbers["album_number"], numbers["track_number"])
            for field in MetaData.FIELDS:
                if field in MetaData.INTEGER_FIELDS:
                    continue
                value = (getattr(track_metadata, field)
                         if track_metadata is not None else None)
                format_dict[field] = ("" if value is None else str(
                    value).replace("/", "-").replace(chr(0), " "))
            format_dict["basename"] = os.path.splitext(
                os.path.basename(file_path))[0]
            return format % format_dict
        except KeyError as error:
            raise UnsupportedTracknameField(str(error.args[0]))
        except (TypeError, ValueError):
            raise InvalidFilenameFormat()

    @classmethod
    def supports_replay_gain(cls):
        return False

    @classmethod
    def lossless_replay_gain(cls):
        return False

    @classmethod
    def can_add_replay_gain(cls, audiofiles):
        return False

    @classmethod
    def add_replay_gain(cls, filenames, progress=None, device="cuda"):
        """adds ReplayGain values to the files named"""

    def replay_gain(self):
        """the file's ReplayGain values, or None"""
        return None

    def set_cuesheet(self, cuesheet):
        """embeds a Sheet's layout where the class holds one (FLAC)"""

    def get_cuesheet(self):
        """the embedded Sheet-like layout, or None"""
        return None

    def clean(self, output_filename=None):
        """the fixes that the file's tags need, as strings; with
        ``output_filename``, a copy of the file is written there with
        its tags cleaned (this file is left as it is)"""
        metadata = self.get_metadata()
        if output_filename is None:
            return [] if metadata is None else metadata.clean()[1]
        with open(self.filename, "rb") as src, \
                open(output_filename, "wb") as dst:
            dst.write(src.read())
        if metadata is None:
            return []
        from .dispatch import open as open_track
        (cleaned, fixes) = metadata.clean()
        open_track(output_filename,
                   device=self.device or "cpu").set_metadata(cleaned)
        return fixes

    def verify(self, progress=None, sink=None):
        """decodes the whole file: raises InvalidFile on a stream error
        or, for a lossless class, when the frame count is not the
        header's, else returns True

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
        if self.lossless() and pcm_frame_count != total_frames:
            raise InvalidFile("incorrect PCM frame count")
        return True


class WaveContainer(AudioFile):
    """an AudioFile which may hold foreign RIFF chunks

    ``convert`` carries them through the target class's ``from_wave``
    where it has one; a target without one (ALAC, TTA) gets the PCM
    alone, as the reference's does (through the next class's
    ``convert``: a class that is also an AiffContainer then offers its
    AIFF chunks)."""

    def has_foreign_wave_chunks(self):
        """True when the file holds RIFF chunks besides fmt and data"""
        raise NotImplementedError()

    def wave_header_footer(self):
        """the RIFF bytes before and after the PCM, a (header, footer)
        pair; raises ValueError when the file holds none"""
        raise NotImplementedError()

    @classmethod
    def from_wave(cls, filename, header, pcmreader, footer,
                  compression=None, device=None):
        raise NotImplementedError()

    def convert(self, target_path, target_class, compression=None,
                progress=None, device=None):
        if (self.has_foreign_wave_chunks() and
                callable(getattr(target_class, "from_wave", None))):
            try:
                (header, footer) = self.wave_header_footer()
            except (ValueError, IOError) as err:
                raise EncodingError(str(err))
            return target_class.from_wave(
                target_path, header, to_pcm_progress(self, progress), footer,
                compression, device=self.device if device is None else device)
        # the next class's convert: AiffContainer's for a class that is
        # both (FLAC, Shorten), else AudioFile's
        return super().convert(target_path, target_class, compression,
                               progress, device)


class AiffContainer(AudioFile):
    """an AudioFile which may hold foreign AIFF chunks

    ``convert`` carries them through the target class's ``from_aiff``
    where it has one (AIFF, FLAC, Shorten); any other target gets the
    PCM alone, as the reference's does."""

    def has_foreign_aiff_chunks(self):
        """True when the file holds AIFF chunks besides COMM and SSND"""
        raise NotImplementedError()

    def aiff_header_footer(self):
        """the AIFF bytes before and after the PCM, a (header, footer)
        pair; raises ValueError when the file holds none"""
        raise NotImplementedError()

    @classmethod
    def from_aiff(cls, filename, header, pcmreader, footer,
                  compression=None, device=None):
        raise NotImplementedError()

    def convert(self, target_path, target_class, compression=None,
                progress=None, device=None):
        if (self.has_foreign_aiff_chunks() and
                callable(getattr(target_class, "from_aiff", None))):
            try:
                (header, footer) = self.aiff_header_footer()
            except (ValueError, IOError) as err:
                raise EncodingError(str(err))
            return target_class.from_aiff(
                target_path, header, to_pcm_progress(self, progress), footer,
                compression, device=self.device if device is None else device)
        return super().convert(target_path, target_class, compression,
                               progress, device)


class DummyAudioFile(AudioFile):
    """a placeholder AudioFile of ``length`` CD sectors and the given
    metadata, for a disc known only by its layout"""

    def __init__(self, length, metadata):
        self.__length__ = length
        self.__metadata__ = metadata
        AudioFile.__init__(self, "")

    def get_metadata(self):
        return self.__metadata__

    def cd_frames(self):
        return self.__length__

    def sample_rate(self):
        return 44100

    def total_frames(self):
        return (self.cd_frames() * self.sample_rate()) // 75


class SheetException(ValueError):
    """a cue sheet or TOC file that does not parse"""


def read_sheet(filename):
    """the Sheet of a .toc or .cue file (a TOC file tried first, its
    CD_DA header being the easier to spot); raises SheetException"""
    from .sheets import cue, toc
    try:
        return toc.read_tocfile(filename)
    except SheetException:
        return cue.read_cuesheet(filename)


class Sheet:
    """a CD's layout: its tracks and catalog number"""

    def __init__(self, sheet_tracks, catalog_number=None):
        self.__tracks__ = list(sheet_tracks)
        self.__catalog_number__ = catalog_number

    def __repr__(self):
        return "Sheet(%s, %s)" % (repr(self.__tracks__),
                                  repr(self.__catalog_number__))

    def __eq__(self, sheet):
        if not (hasattr(sheet, "catalog") and callable(sheet.catalog) and
                self.catalog() == sheet.catalog()):
            return False
        if hasattr(sheet, "tracks") and callable(sheet.tracks):
            return list(self.tracks()) == list(sheet.tracks())
        return False

    def __len__(self):
        return len(self.__tracks__)

    def track(self, track_number):
        """the SheetTrack numbered ``track_number``; KeyError if none"""
        for track in self.tracks():
            if track_number == track.number():
                return track
        raise KeyError(track_number)

    def tracks(self):
        return iter(self.__tracks__)

    def catalog(self):
        """the catalog number, or None"""
        return self.__catalog_number__

    def image_formatted(self):
        """True when the tracks' first index points grow, as a CD
        image's do"""
        first_indexes = [min(i.offset() for i in t.indexes())
                         for t in self.tracks()]
        return all(prev < index for (prev, index) in
                   zip(first_indexes, first_indexes[1:]))

    def pcm_lengths(self, total_pcm_frames, sample_rate):
        """each track's length in PCM frames: the distance between index
        points 1, truncated to whole frames; the last track runs to
        ``total_pcm_frames``"""
        if len(self.__tracks__) == 0:
            return
        for (prev, track) in zip(self.__tracks__, self.__tracks__[1:]):
            track_pcm_frames = int((track.index(1).offset() -
                                    prev.index(1).offset()) * sample_rate)
            total_pcm_frames -= track_pcm_frames
            yield track_pcm_frames
        yield total_pcm_frames


class SheetTrack:
    """a track of a Sheet: its number, index points, audio flag, ISRC"""

    def __init__(self, number, indexes, audio=True, ISRC=None):
        self.__number__ = number
        self.__indexes__ = list(indexes)
        self.__audio__ = audio
        self.__ISRC__ = ISRC

    def __repr__(self):
        return "SheetTrack(%s, %s, %s, %s)" % (
            repr(self.__number__), repr(self.__indexes__),
            repr(self.__audio__), repr(self.__ISRC__))

    def __eq__(self, track):
        for method in ["number", "audio", "ISRC"]:
            if not (hasattr(track, method) and
                    callable(getattr(track, method)) and
                    getattr(self, method)() == getattr(track, method)()):
                return False
        if hasattr(track, "indexes") and callable(track.indexes):
            return list(self.indexes()) == list(track.indexes())
        return False

    def __len__(self):
        return len(self.__indexes__)

    def index(self, index_number):
        """the SheetIndex numbered ``index_number``; KeyError if none"""
        for index in self.indexes():
            if index_number == index.number():
                return index
        raise KeyError(index_number)

    def indexes(self):
        return iter(self.__indexes__)

    def number(self):
        return self.__number__

    def ISRC(self):
        return self.__ISRC__

    def audio(self):
        return self.__audio__


class SheetIndex:
    """an index point: its number and its offset from the stream's
    start in seconds, a Fraction"""

    def __init__(self, number, offset):
        self.__number__ = number
        self.__offset__ = offset

    def __repr__(self):
        return "SheetIndex(%s, %s)" % (repr(self.__number__),
                                       repr(self.__offset__))

    def __eq__(self, index):
        for method in ["number", "offset"]:
            if not (hasattr(index, method) and
                    callable(getattr(index, method)) and
                    getattr(self, method)() == getattr(index, method)()):
                return False
        return True

    def number(self):
        return self.__number__

    def offset(self):
        return self.__offset__


def parse_timestamp(s):
    """CD sectors of an "M:S:F" timestamp or a plain integer string"""
    if ":" in s:
        (m, sec, f) = map(int, s.split(":"))
        return (m * 60 * 75) + (sec * 75) + f
    return int(s)


def build_timestamp(i):
    """the "MM:SS:FF" timestamp of ``i`` CD sectors"""
    return "%2.2d:%2.2d:%2.2d" % ((i // 75) // 60, (i // 75) % 60, i % 75)
