"""FLAC files: metadata blocks and the ``FlacAudio`` class.

A copy of the writer and reader path of the reference's
``audiotools_tpu/formats/flac.py``: the STREAMINFO, PADDING, SEEKTABLE
and VORBIS_COMMENT blocks, the ``FlacMetaData`` container,
``seektable_from_offsets``, and ``FlacAudio`` with the reference's
compression levels "0"-"8", ``from_pcm`` (padding sized for the
seektable, a seekpoint every 10 s from the encoder's frame offsets,
the WAVEFORMATEXTENSIBLE_CHANNEL_MASK comment for more than two
channels or more than 16 bits), ``update_metadata``, ``set_metadata``
of another FLAC file's blocks, ``to_pcm``, ``verify`` and the
REPLAYGAIN_* comments (``add_replay_gain``, ``replay_gain``).
The blocks are parsed from and built into bytes with ``struct`` (FLAC
metadata is big-endian; a VORBIS_COMMENT body is little-endian).

``from_pcm`` encodes with the port's ``encode_flac_fast`` on the
file's device.  Its bytes equal the reference's ``FlacAudio.from_pcm``
under the reference's device-pack configuration: exact uploads and no
emit-stage Rice re-search (``ATPU_FLAC_QPACK=0``,
``ATPU_EMIT_EXACT_RICE=0``; its numpy backend there equals its
``ATPU_PALLAS=1`` JAX path).  The reference's default quantized upload
wire and emit-stage re-search may choose other Rice parameters, so its
default bytes can differ; the decoded PCM cannot.

Not ported: MetaData conversion to and from other formats, CUESHEET,
PICTURE and APPLICATION blocks (an unknown block is skipped when
parsed; a PICTURE block counts among the tags a conversion refuses to
drop), ID3-wrapped files, Ogg FLAC, and the rest of the reference's
class.
"""

from __future__ import annotations

import collections
import os
import struct
import tempfile

from .._device import resolve_device
from ..audiofile import AudioFile, InvalidFile
from ..pcm import CHANNEL_MASKS, BufferedPCMReader

VERSION = "0.1.0"
VENDOR_STRING = "tpu-audio-tools %s" % (VERSION,)


class InvalidFLAC(InvalidFile, ValueError):
    """a file that is not a FLAC file this module reads"""


class Flac_STREAMINFO:
    BLOCK_ID = 0

    def __init__(self, minimum_block_size, maximum_block_size,
                 minimum_frame_size, maximum_frame_size,
                 sample_rate, channels, bits_per_sample,
                 total_samples, md5sum):
        self.minimum_block_size = minimum_block_size
        self.maximum_block_size = maximum_block_size
        self.minimum_frame_size = minimum_frame_size
        self.maximum_frame_size = maximum_frame_size
        self.sample_rate = sample_rate
        self.channels = channels
        self.bits_per_sample = bits_per_sample
        self.total_samples = total_samples
        self.md5sum = md5sum

    def __eq__(self, block):
        return (isinstance(block, Flac_STREAMINFO) and
                vars(self) == vars(block))

    @classmethod
    def parse(cls, data):
        """the block from its 34-byte body"""
        (min_block, max_block) = struct.unpack(">HH", data[0:4])
        min_frame = int.from_bytes(data[4:7], "big")
        max_frame = int.from_bytes(data[7:10], "big")
        info = int.from_bytes(data[10:18], "big")
        return cls(min_block, max_block, min_frame, max_frame,
                   info >> 44, ((info >> 41) & 0x7) + 1,
                   ((info >> 36) & 0x1F) + 1, info & ((1 << 36) - 1),
                   bytes(data[18:34]))

    def build(self):
        """the block's body"""
        info = ((self.sample_rate << 44) | ((self.channels - 1) << 41) |
                ((self.bits_per_sample - 1) << 36) | self.total_samples)
        return (struct.pack(">HH", self.minimum_block_size,
                            self.maximum_block_size) +
                self.minimum_frame_size.to_bytes(3, "big") +
                self.maximum_frame_size.to_bytes(3, "big") +
                info.to_bytes(8, "big") + bytes(self.md5sum))

    def size(self):
        return 34


class Flac_PADDING:
    BLOCK_ID = 1

    def __init__(self, length):
        self.length = length

    def __eq__(self, block):
        return isinstance(block, Flac_PADDING) and block.length == self.length

    @classmethod
    def parse(cls, data):
        return cls(len(data))

    def build(self):
        return b"\x00" * self.length

    def size(self):
        return self.length


class Flac_SEEKTABLE:
    BLOCK_ID = 3

    def __init__(self, seekpoints):
        """seekpoints is a list of
        (PCM frame offset, byte offset, PCM frame count) triples"""
        self.seekpoints = [tuple(p) for p in seekpoints]

    def __eq__(self, block):
        return (isinstance(block, Flac_SEEKTABLE) and
                block.seekpoints == self.seekpoints)

    @classmethod
    def parse(cls, data):
        return cls([struct.unpack(">QQH", data[i:i + 18])
                    for i in range(0, len(data) - 17, 18)])

    def build(self):
        return b"".join(struct.pack(">QQH", *p) for p in self.seekpoints)

    def size(self):
        return len(self.seekpoints) * 18


class Flac_VORBISCOMMENT:
    """a VORBIS_COMMENT block: a vendor string and KEY=value comment
    strings; ``block[key]`` is the list of a key's values (keys match
    without regard to case)"""

    BLOCK_ID = 4

    def __init__(self, comment_strings, vendor_string):
        self.comment_strings = list(comment_strings)
        self.vendor_string = vendor_string

    def __eq__(self, block):
        return (isinstance(block, Flac_VORBISCOMMENT) and
                block.comment_strings == self.comment_strings and
                block.vendor_string == self.vendor_string)

    def _pairs(self):
        return [c.split("=", 1) for c in self.comment_strings if "=" in c]

    def __contains__(self, key):
        return any(k.upper() == key.upper() for (k, _v) in self._pairs())

    def __getitem__(self, key):
        values = [v for (k, v) in self._pairs() if k.upper() == key.upper()]
        if not values:
            raise KeyError(key)
        return values

    def __setitem__(self, key, values):
        """replaces the key's values in place, in order; drops those left
        over and appends the rest as KEY=value"""
        new_values = list(values)
        comments = []
        for comment in self.comment_strings:
            if "=" in comment:
                (c_key, _c_value) = comment.split("=", 1)
                if c_key.upper() == key.upper():
                    if new_values:
                        comments.append("%s=%s" % (c_key, new_values.pop(0)))
                    continue
            comments.append(comment)
        comments.extend("%s=%s" % (key.upper(), v) for v in new_values)
        self.comment_strings = comments

    @classmethod
    def parse(cls, data):
        """the block from its body (little-endian lengths)"""
        (vendor_length,) = struct.unpack("<I", data[0:4])
        pos = 4 + vendor_length
        vendor = bytes(data[4:pos]).decode("utf-8", "replace")
        (total,) = struct.unpack("<I", data[pos:pos + 4])
        pos += 4
        comments = []
        for _ in range(total):
            (length,) = struct.unpack("<I", data[pos:pos + 4])
            comments.append(bytes(data[pos + 4:pos + 4 + length]).decode(
                "utf-8", "replace"))
            pos += 4 + length
        return cls(comments, vendor)

    def build(self):
        vendor = self.vendor_string.encode("utf-8")
        out = [struct.pack("<I", len(vendor)), vendor,
               struct.pack("<I", len(self.comment_strings))]
        for comment in self.comment_strings:
            comment = comment.encode("utf-8")
            out.extend([struct.pack("<I", len(comment)), comment])
        return b"".join(out)

    def size(self):
        return (4 + len(self.vendor_string.encode("utf-8")) + 4 +
                sum(4 + len(c.encode("utf-8"))
                    for c in self.comment_strings))


BLOCK_CLASSES = {block.BLOCK_ID: block for block in (
    Flac_STREAMINFO, Flac_PADDING, Flac_SEEKTABLE, Flac_VORBISCOMMENT)}


class FlacMetaData:
    """a FLAC file's metadata blocks, in file order"""

    def __init__(self, blocks):
        self.block_list = list(blocks)

    def has_block(self, block_id):
        """True if a block of the given ID is present"""
        return any(b.BLOCK_ID == block_id for b in self.block_list)

    def add_block(self, block):
        """adds the block in ascending ID order, PADDING last"""
        if block.BLOCK_ID != Flac_PADDING.BLOCK_ID:
            for (i, b) in enumerate(self.block_list):
                if (b.BLOCK_ID > block.BLOCK_ID or
                        b.BLOCK_ID == Flac_PADDING.BLOCK_ID):
                    self.block_list.insert(i, block)
                    return
        self.block_list.append(block)

    def get_block(self, block_id):
        """the first block of the given ID; raises IndexError if none"""
        for block in self.block_list:
            if block.BLOCK_ID == block_id:
                return block
        raise IndexError(block_id)

    def get_blocks(self, block_id):
        """every block of the given ID, in order"""
        return [b for b in self.block_list if b.BLOCK_ID == block_id]

    def copy(self):
        """a FlacMetaData of copies of the blocks"""
        return FlacMetaData([type(b).parse(b.build())
                             for b in self.block_list])

    def replace_blocks(self, block_id, blocks):
        """replaces every block of the given ID with ``blocks``, at the
        first one's place (added in ID order if there was none)"""
        new_blocks = []
        inserted = False
        for block in self.block_list:
            if block.BLOCK_ID == block_id:
                if not inserted:
                    new_blocks.extend(blocks)
                    inserted = True
            else:
                new_blocks.append(block)
        if not inserted:
            for block in blocks:
                self.add_block(block)
            return
        self.block_list = new_blocks

    @classmethod
    def parse(cls, file, skipped=None):
        """the blocks of a binary file positioned past the 'fLaC' marker
        (left at the first frame); blocks of types not ported are
        skipped, and their IDs appended to the list ``skipped`` when
        one is given"""
        blocks = []
        last = 0
        while not last:
            header = file.read(4)
            if len(header) != 4:
                raise InvalidFLAC("truncated FLAC metadata")
            (last, block_type) = (header[0] >> 7, header[0] & 0x7F)
            length = int.from_bytes(header[1:4], "big")
            if block_type == 127:
                raise InvalidFLAC("invalid FLAC metadata block type")
            body = file.read(length)
            if len(body) != length:
                raise InvalidFLAC("truncated FLAC metadata")
            if block_type in BLOCK_CLASSES:
                blocks.append(BLOCK_CLASSES[block_type].parse(body))
            elif skipped is not None:
                skipped.append(block_type)
        return cls(blocks)

    def _sized_blocks(self):
        return [b for b in self.block_list if b.size() < (1 << 24)]

    def build(self):
        """every block with its header, the last one flagged"""
        blocks = self._sized_blocks()
        out = []
        for (i, block) in enumerate(blocks):
            last = 0x80 if i == len(blocks) - 1 else 0
            out.append(bytes([last | block.BLOCK_ID]) +
                       block.size().to_bytes(3, "big"))
            out.append(block.build())
        return b"".join(out)

    def size(self):
        """the bytes of every block, headers included"""
        return sum(4 + b.size() for b in self._sized_blocks())


def seektable_from_offsets(offsets, seekpoint_interval):
    """a Flac_SEEKTABLE from the encoder's (byte_offset, pcm_frames)
    pairs, a seekpoint at the first frame starting at or past each
    multiple of ``seekpoint_interval`` PCM frames"""
    seekpoints = []
    current_pcm_frame = 0
    next_seekpoint = 0
    for (byte_offset, pcm_frames) in offsets:
        if current_pcm_frame >= next_seekpoint:
            seekpoints.append((current_pcm_frame, byte_offset, pcm_frames))
            next_seekpoint += seekpoint_interval
        current_pcm_frame += pcm_frames
    return Flac_SEEKTABLE(seekpoints)


# the block that a conversion carries as tags besides VORBIS_COMMENT
PICTURE_BLOCK_ID = 6

# the five REPLAYGAIN_* comments' values (dB, linear peak)
ReplayGainValues = collections.namedtuple(
    "ReplayGainValues", "track_gain track_peak album_gain album_peak")


class FlacAudio(AudioFile):
    """a Free Lossless Audio Codec file, encoded and decoded on a torch
    device

    device: "cuda" (raises when no card is usable) or "cpu" (the
    kernels' plain versions, for tests); ``to_pcm`` decodes there."""

    SUFFIX = "flac"
    NAME = SUFFIX
    COMPRESSION_MODES = tuple(map(str, range(0, 9)))
    DEFAULT_COMPRESSION = "8"

    # the reference's exact per-level options
    COMPRESSION_OPTIONS = {
        "0": {"block_size": 1152, "max_lpc_order": 0,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 3},
        "1": {"block_size": 1152, "max_lpc_order": 0,
              "adaptive_mid_side": True,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 3},
        "2": {"block_size": 1152, "max_lpc_order": 0,
              "exhaustive_model_search": True,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 3},
        "3": {"block_size": 4096, "max_lpc_order": 6,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 4},
        "4": {"block_size": 4096, "max_lpc_order": 8,
              "adaptive_mid_side": True,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 4},
        "5": {"block_size": 4096, "max_lpc_order": 8,
              "mid_side": True,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 5},
        "6": {"block_size": 4096, "max_lpc_order": 8,
              "mid_side": True,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 6},
        "7": {"block_size": 4096, "max_lpc_order": 8,
              "mid_side": True, "exhaustive_model_search": True,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 6},
        "8": {"block_size": 4096, "max_lpc_order": 12,
              "mid_side": True, "exhaustive_model_search": True,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 6}}

    def __init__(self, filename, device="cuda"):
        AudioFile.__init__(self, filename)
        self.device = resolve_device(device)
        try:
            with open(filename, "rb") as f:
                if f.read(4) != b"fLaC":
                    raise InvalidFLAC("not a FLAC file (no 'fLaC' marker)")
                header = f.read(4)
                if len(header) != 4 or header[0] & 0x7F != 0:
                    raise InvalidFLAC("STREAMINFO block not found")
                self.__streaminfo = Flac_STREAMINFO.parse(f.read(34))
        except OSError as err:
            raise InvalidFLAC(str(err)) from err

    def bits_per_sample(self):
        return self.__streaminfo.bits_per_sample

    def channels(self):
        return self.__streaminfo.channels

    def sample_rate(self):
        return self.__streaminfo.sample_rate

    def total_frames(self):
        return self.__streaminfo.total_samples

    def channel_mask(self):
        """the WAVEFORMATEXTENSIBLE_CHANNEL_MASK comment's mask, else the
        default layout of the channel count (0 above 6 channels)"""
        metadata = self.get_metadata()
        try:
            vorbis = metadata.get_block(Flac_VORBISCOMMENT.BLOCK_ID)
            return int(vorbis["WAVEFORMATEXTENSIBLE_CHANNEL_MASK"][0], 16)
        except (IndexError, KeyError, ValueError):
            pass
        channels = self.channels()
        return CHANNEL_MASKS[channels] if channels <= 6 else 0

    def get_metadata(self, skipped=None):
        """the file's FlacMetaData; the IDs of the blocks not ported are
        appended to the list ``skipped`` when one is given"""
        with open(self.filename, "rb") as f:
            if f.read(4) != b"fLaC":
                raise InvalidFLAC("not a FLAC file (no 'fLaC' marker)")
            return FlacMetaData.parse(f, skipped)

    def tag_names(self):
        """the keys of the VORBIS_COMMENT comments but the channel mask,
        and "PICTURE" for each picture block"""
        skipped = []
        metadata = self.get_metadata(skipped)
        names = []
        for vorbis in metadata.get_blocks(Flac_VORBISCOMMENT.BLOCK_ID):
            for (key, _value) in vorbis._pairs():
                if key.upper() != "WAVEFORMATEXTENSIBLE_CHANNEL_MASK":
                    names.append(key)
        names.extend("PICTURE" for block_id in skipped
                     if block_id == PICTURE_BLOCK_ID)
        return names

    def carry_tags_to(self, dest):
        """FLAC to FLAC carries the VORBIS_COMMENT comments; otherwise as
        ``AudioFile.carry_tags_to``"""
        skipped = []
        metadata = self.get_metadata(skipped)
        if (isinstance(dest, FlacAudio) and
                PICTURE_BLOCK_ID not in skipped):
            dest.set_metadata(metadata)
        else:
            AudioFile.carry_tags_to(self, dest)

    def write_blank_tags(self):
        """an empty VORBIS_COMMENT block, as the reference's
        ``FlacMetaData.converted`` of a MetaData with no fields gives"""
        self.set_metadata(FlacMetaData([
            Flac_VORBISCOMMENT([], VENDOR_STRING), Flac_PADDING(4096)]))

    def set_metadata(self, metadata):
        """writes a copy of ``metadata``'s blocks (another file's
        FlacMetaData) into this file, as the reference's set_metadata
        does: this file keeps its STREAMINFO and SEEKTABLE blocks, its
        vendor string and its channel mask comment, and a PADDING block
        is added where there is none"""
        new_metadata = metadata.copy()
        old_metadata = self.get_metadata()
        for block_id in (Flac_STREAMINFO.BLOCK_ID, Flac_SEEKTABLE.BLOCK_ID):
            new_metadata.replace_blocks(block_id,
                                        old_metadata.get_blocks(block_id))
        old_vorbis = old_metadata.get_blocks(Flac_VORBISCOMMENT.BLOCK_ID)
        new_vorbis = new_metadata.get_blocks(Flac_VORBISCOMMENT.BLOCK_ID)
        if new_vorbis and old_vorbis:
            new_vorbis[0].vendor_string = old_vorbis[0].vendor_string
            if "WAVEFORMATEXTENSIBLE_CHANNEL_MASK" in old_vorbis[0]:
                new_vorbis[0]["WAVEFORMATEXTENSIBLE_CHANNEL_MASK"] = \
                    old_vorbis[0]["WAVEFORMATEXTENSIBLE_CHANNEL_MASK"]
        if not new_metadata.has_block(Flac_PADDING.BLOCK_ID):
            new_metadata.add_block(Flac_PADDING(4096))
        self.update_metadata(new_metadata)

    @classmethod
    def supports_replay_gain(cls):
        return True

    @classmethod
    def add_replay_gain(cls, filenames, progress=None, device="cuda"):
        """writes the REPLAYGAIN_* comments of the FLAC files named,
        analysed as one album on ``device``"""
        from ..dispatch import open_files
        from ..replaygain import calculate_replay_gain_values
        tracks = [t for t in open_files(filenames, device=device)
                  if isinstance(t, cls)]
        for (track, gain, peak, album_gain, album_peak) in \
                calculate_replay_gain_values(tracks, progress, device):
            metadata = track.get_metadata()
            try:
                vorbis = metadata.get_block(Flac_VORBISCOMMENT.BLOCK_ID)
            except IndexError:
                vorbis = Flac_VORBISCOMMENT([], VENDOR_STRING)
                metadata.add_block(vorbis)
            vorbis["REPLAYGAIN_TRACK_GAIN"] = ["%1.2f dB" % (gain,)]
            vorbis["REPLAYGAIN_TRACK_PEAK"] = ["%1.8f" % (peak,)]
            vorbis["REPLAYGAIN_ALBUM_GAIN"] = ["%1.2f dB" % (album_gain,)]
            vorbis["REPLAYGAIN_ALBUM_PEAK"] = ["%1.8f" % (album_peak,)]
            vorbis["REPLAYGAIN_REFERENCE_LOUDNESS"] = ["89.0 dB"]
            track.update_metadata(metadata)

    def replay_gain(self):
        """the REPLAYGAIN_* comments' ReplayGainValues, or None"""
        try:
            vorbis = self.get_metadata().get_block(
                Flac_VORBISCOMMENT.BLOCK_ID)
            return ReplayGainValues(
                float(vorbis["REPLAYGAIN_TRACK_GAIN"][0].split(" ")[0]),
                float(vorbis["REPLAYGAIN_TRACK_PEAK"][0]),
                float(vorbis["REPLAYGAIN_ALBUM_GAIN"][0].split(" ")[0]),
                float(vorbis["REPLAYGAIN_ALBUM_PEAK"][0]))
        except (IndexError, KeyError, ValueError, IOError):
            return None

    def update_metadata(self, metadata):
        """writes ``metadata``'s blocks back to the file: in place when
        they fit the old blocks' room (growing or shrinking the PADDING
        block to fill it), else the whole file is rewritten through a
        temporary file"""
        if not isinstance(metadata, FlacMetaData):
            raise ValueError("metadata not from audio file")
        with open(self.filename, "rb") as f:
            if f.read(4) != b"fLaC":
                raise InvalidFLAC("not a FLAC file (no 'fLaC' marker)")
            FlacMetaData.parse(f)
            frames_offset = f.tell()
        old_size = frames_offset - 4
        new_size = metadata.size()
        if metadata.has_block(Flac_PADDING.BLOCK_ID):
            padding = metadata.get_block(Flac_PADDING.BLOCK_ID)
            if new_size < old_size:
                padding.length += old_size - new_size
                new_size = old_size
            elif new_size > old_size and padding.length >= new_size - \
                    old_size:
                padding.length -= new_size - old_size
                new_size = old_size
        if new_size == old_size:
            with open(self.filename, "r+b") as f:
                f.seek(4, 0)
                f.write(metadata.build())
            return
        directory = os.path.dirname(self.filename) or "."
        (handle, temp) = tempfile.mkstemp(
            prefix="." + os.path.basename(self.filename) + "-",
            dir=directory)
        try:
            with os.fdopen(handle, "wb") as out, \
                    open(self.filename, "rb") as f:
                out.write(b"fLaC" + metadata.build())
                f.seek(frames_offset, 0)
                while True:
                    chunk = f.read(0x100000)
                    if not chunk:
                        break
                    out.write(chunk)
            os.chmod(temp, os.stat(self.filename).st_mode)
            os.replace(temp, self.filename)
        except BaseException:
            if os.path.exists(temp):
                os.unlink(temp)
            raise

    def to_pcm(self):
        """a TorchFlacDecoder of the file on the file's device (the
        STREAMINFO MD5 checked at the end of the stream)"""
        from ..codecs.flac_dec import TorchFlacDecoder
        return TorchFlacDecoder(self.filename, self.channel_mask(),
                                device=self.device)

    @classmethod
    def from_pcm(cls, filename, pcmreader, compression=None,
                 total_pcm_frames=None, device="cuda"):
        """encodes a new file from a PCMReader on ``device`` and returns
        it

        compression: one of COMPRESSION_MODES; None or any other value
        means DEFAULT_COMPRESSION (the reference reads the user's
        configured default first; the port has no config layer).
        total_pcm_frames: the frame count when known ahead, which sizes
        the PADDING block to hold the seektable.  On any failure the
        partial file is removed and the error raised."""
        device = resolve_device(device)
        if compression not in cls.COMPRESSION_MODES:
            compression = cls.DEFAULT_COMPRESSION
        encoding_options = cls.COMPRESSION_OPTIONS[compression]
        try:
            if pcmreader.channels > 8:
                raise ValueError("unsupported channel count %d"
                                 % (pcmreader.channels,))
            mask = int(pcmreader.channel_mask)
            if mask == 0:
                channel_mask = (CHANNEL_MASKS[pcmreader.channels]
                                if pcmreader.channels <= 6 else 0)
            elif mask not in (0x0001, 0x0004, 0x0003, 0x0007, 0x0033,
                              0x0603, 0x0037, 0x0607, 0x003F, 0x060F):
                raise ValueError("unsupported channel mask 0x%X" % (mask,))
            else:
                channel_mask = mask

            interval = pcmreader.sample_rate * 10
            if total_pcm_frames is not None:
                expected_seekpoints = -(-total_pcm_frames // interval)
                padding_size = 4096 + 4 + expected_seekpoints * 18
            else:
                padding_size = 4096

            from ..codecs.flac_enc_fast import encode_flac_fast
            offsets = encode_flac_fast(
                filename, BufferedPCMReader(pcmreader),
                padding_size=padding_size, device=device,
                **encoding_options)
            flac = cls(filename, device)
            metadata = flac.get_metadata()
            metadata.add_block(seektable_from_offsets(offsets, interval))
            # record explicit channel masks for unusual layouts
            if ((pcmreader.channels > 2 or pcmreader.bits_per_sample > 16)
                    and channel_mask != 0):
                try:
                    vorbis = metadata.get_block(Flac_VORBISCOMMENT.BLOCK_ID)
                except IndexError:
                    vorbis = Flac_VORBISCOMMENT([], VENDOR_STRING)
                    metadata.add_block(vorbis)
                vorbis["WAVEFORMATEXTENSIBLE_CHANNEL_MASK"] = [
                    "0x%.4X" % (channel_mask,)]
            flac.update_metadata(metadata)
            return flac
        except BaseException:
            try:
                os.unlink(filename)
            except OSError:
                pass
            raise
        finally:
            pcmreader.close()
