"""M4A files: the ALAC container writer, ``ALACAudio`` and ``M4AAudio``.

Port of the reference's ``ALACAudio`` (``audiotools_tpu/formats/m4a.py``)
with its atom builders over ``meta/m4a_atoms``: ftyp, then moov (mvhd,
trak with tkhd and mdia: mdhd, hdlr and minf with smhd, dinf/dref and
stbl: stsd(alac), stts, stsc, stsz, stco; udta/meta with an ilst
naming the encoder), then the mdat that ``codecs.alac.encode_mdat``
writes (``codecs.alac_fast.encode_mdat_fast`` on a device, the scalar
oracle under ATPU_ALAC_ORACLE=1).  ``ALACAudio`` reads the header from
the alac atom, decodes through ``codecs.alac.decoder_for_file``
(``codecs.alac_dec.TorchALACDecoder`` on its device), and reads and
writes its tags as the udta/meta atom (``get/set/update/delete_metadata``,
the stco chunk offsets moved when moov changes size).  ``M4AAudio`` is
the reference's AAC class as far as detection goes: its stream fields
from the mp4a and mdhd atoms, and ``available()`` True only where the
faac and faad programs are found, as the reference's; its AAC coding
through those programs is not ported.
"""

from __future__ import annotations

import contextlib
import io
import os
import struct
import time

from .. import VERSION, text
from .._device import resolve_device
from ..audiofile import AudioFile, EncodingError, InvalidFile
from ..codecs.alac import decoder_for_file, encode_mdat
from ..meta.m4a_atoms import (M4A_Leaf_Atom, M4A_META_Atom, M4A_Tree_Atom,
                              ilst_string_atom, parse_atoms)
from ..pcm import PCMReaderError
from ..ref.alac import _find, _top_level, read_m4a_header
from ..utils.files import TemporaryFile

BLOCK_SIZE = 4096
INITIAL_HISTORY = 10
HISTORY_MULTIPLIER = 40
MAXIMUM_K = 14

# channel masks ALAC can carry (0 = undefined)
SUPPORTED_CHANNEL_MASKS = (0x0001, 0x0004, 0x0003, 0x0007, 0x0107,
                           0x0037, 0x003F, 0x013F, 0x00FF, 0x0000)

# seconds from the QuickTime epoch (1904) to the Unix epoch (1970)
QUICKTIME_EPOCH_OFFSET = 2082844800


def write_m4a(file_or_path, pcmreader, block_size=BLOCK_SIZE,
              create_date=None, device="cuda", timings=None):
    """encodes an ALAC M4A file from a PCMReader on a torch device

    file_or_path: a path or a writable binary file.  create_date: the
    QuickTime creation time written into mvhd, tkhd and mdhd (default:
    now, as the reference).  device, timings: passed to
    ``codecs.alac.encode_mdat`` (encode_mdat_fast's, unused by the
    scalar oracle under ATPU_ALAC_ORACLE=1).  The reader is closed at
    the end, as the
    reference's from_pcm closes it.  Raises ValueError for bits per
    sample other than 16 or 24 or a channel mask ALAC cannot carry.

    returns (frame_byte_sizes, total_pcm_frames)"""
    try:
        if pcmreader.bits_per_sample not in (16, 24):
            raise ValueError("unsupported bits per sample %d"
                             % (pcmreader.bits_per_sample,))
        if int(pcmreader.channel_mask) not in SUPPORTED_CHANNEL_MASKS:
            raise ValueError("unsupported channel mask 0x%X"
                             % (int(pcmreader.channel_mask),))
        if create_date is None:
            create_date = int(time.time()) + QUICKTIME_EPOCH_OFFSET
        mdat = io.BytesIO()
        (frame_byte_sizes, total_pcm_frames) = encode_mdat(
            mdat, pcmreader, block_size=block_size,
            initial_history=INITIAL_HISTORY,
            history_multiplier=HISTORY_MULTIPLIER, maximum_k=MAXIMUM_K,
            device=device, timings=timings)
        mdat_size = 8 + sum(frame_byte_sizes)
        ftyp = ftyp_atom()
        # the chunk offsets depend on the moov's own size
        moov = moov_atom(pcmreader, create_date, 0, mdat_size, block_size,
                         total_pcm_frames, frame_byte_sizes)
        pre_mdat_size = len(ftyp) + 8 + moov.size()
        moov = moov_atom(pcmreader, create_date, pre_mdat_size, mdat_size,
                         block_size, total_pcm_frames, frame_byte_sizes)
        if isinstance(file_or_path, str):
            opened = open(file_or_path, "wb")
        else:
            opened = contextlib.nullcontext(file_or_path)
        with opened as f:
            f.write(ftyp)
            f.write(moov.build())
            f.write(mdat.getbuffer())
        return (frame_byte_sizes, total_pcm_frames)
    finally:
        pcmreader.close()


def ftyp_atom():
    payload = b"M4A \x00\x00\x00\x00" + b"M4A mp42isom" + b"\x00" * 4
    return struct.pack(">I", len(payload) + 8) + b"ftyp" + payload


def moov_atom(pcmreader, create_date, mdat_offset, mdat_size, block_size,
              total_pcm_frames, frame_byte_sizes):
    return M4A_Tree_Atom(b"moov", [
        mvhd_atom(pcmreader, create_date, total_pcm_frames),
        M4A_Tree_Atom(b"trak", [
            tkhd_atom(create_date, total_pcm_frames),
            M4A_Tree_Atom(b"mdia", [
                mdhd_atom(pcmreader, create_date, total_pcm_frames),
                hdlr_atom(),
                M4A_Tree_Atom(b"minf", [
                    smhd_atom(),
                    M4A_Tree_Atom(b"dinf", [dref_atom()]),
                    M4A_Tree_Atom(b"stbl", [
                        stsd_atom(pcmreader, mdat_size, block_size,
                                  total_pcm_frames, frame_byte_sizes),
                        stts_atom(total_pcm_frames, block_size),
                        stsc_atom(total_pcm_frames, block_size),
                        stsz_atom(frame_byte_sizes),
                        stco_atom(mdat_offset, frame_byte_sizes),
                    ])])])]),
        M4A_Tree_Atom(b"udta", [meta_atom()])])


def mvhd_atom(pcmreader, create_date, total_pcm_frames):
    data = struct.pack(">BxxxIIIIIH", 0, create_date, create_date,
                       pcmreader.sample_rate, total_pcm_frames, 0x10000,
                       0x100)
    data += b"\x00" * 10
    data += struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                        0x40000000)
    data += struct.pack(">6I", 0, 0, 0, 0, 0, 0)
    data += struct.pack(">I", 2)
    return M4A_Leaf_Atom(b"mvhd", data)


def tkhd_atom(create_date, total_pcm_frames):
    data = struct.pack(">B3BIIIxxxxI", 0, 0, 0, 7, create_date,
                       create_date, 1, total_pcm_frames)
    data += b"\x00" * 8
    data += struct.pack(">HHHxx", 0, 0, 0x100)
    data += struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                        0x40000000)
    data += struct.pack(">II", 0, 0)
    return M4A_Leaf_Atom(b"tkhd", data)


def mdhd_atom(pcmreader, create_date, total_pcm_frames):
    language = 0
    for c in "und":
        language = (language << 5) | (ord(c) - 0x60)
    data = struct.pack(">BxxxIIIIHH", 0, create_date, create_date,
                       pcmreader.sample_rate, total_pcm_frames, language, 0)
    return M4A_Leaf_Atom(b"mdhd", data)


def hdlr_atom():
    return M4A_Leaf_Atom(b"hdlr", b"\x00" * 8 + b"soun" + b"\x00" * 13)


def smhd_atom():
    return M4A_Leaf_Atom(b"smhd", b"\x00" * 8)


def dref_atom():
    url = struct.pack(">I", 12) + b"url " + b"\x00\x00\x00\x01"
    return M4A_Leaf_Atom(b"dref", struct.pack(">BxxxI", 0, 1) + url)


def stsd_atom(pcmreader, mdat_size, block_size, total_pcm_frames,
              frame_byte_sizes):
    sub_alac = struct.pack(
        ">IxBBBBBHIII", block_size, pcmreader.bits_per_sample,
        HISTORY_MULTIPLIER, INITIAL_HISTORY, MAXIMUM_K, pcmreader.channels,
        0x00FF, max(frame_byte_sizes) if frame_byte_sizes else 0,
        ((mdat_size * 8 * pcmreader.sample_rate) // total_pcm_frames)
        if total_pcm_frames else 0,
        pcmreader.sample_rate)
    sub_alac_atom = (struct.pack(">I", len(sub_alac) + 12) + b"alac" +
                     b"\x00" * 4 + sub_alac)
    alac = (b"\x00" * 6 +                               # reserved
            struct.pack(">H", 1) +                      # data ref index
            struct.pack(">HH", 0, 0) +                  # version/revision
            b"\x00" * 4 +                               # vendor
            struct.pack(">HH", pcmreader.channels,
                        pcmreader.bits_per_sample) +
            struct.pack(">HH", 0, 0) +                  # compression/packet
            struct.pack(">I", 0xAC440000) +             # fixed sample rate
            sub_alac_atom)
    alac_atom = struct.pack(">I", len(alac) + 8) + b"alac" + alac
    return M4A_Leaf_Atom(b"stsd", struct.pack(">BxxxI", 0, 1) + alac_atom)


def stts_atom(total_pcm_frames, block_size):
    times = [(total_pcm_frames // block_size, block_size),
             (1, total_pcm_frames % block_size)]
    times = [t for t in times if t[0] > 0 and t[1] > 0]
    data = struct.pack(">BxxxI", 0, len(times))
    for (count, duration) in times:
        data += struct.pack(">II", count, duration)
    return M4A_Leaf_Atom(b"stts", data)


def stsc_atom(total_pcm_frames, block_size):
    alac_frames = -(-total_pcm_frames // block_size)
    per_chunk = 5
    if alac_frames < per_chunk:
        blocks = [(1, alac_frames, 1)]
    else:
        blocks = [(1, per_chunk, 1)]
        if alac_frames % per_chunk:
            blocks.append((1 + alac_frames // per_chunk,
                           alac_frames % per_chunk, 1))
    data = struct.pack(">BxxxI", 0, len(blocks))
    for (first, count, desc) in blocks:
        data += struct.pack(">III", first, count, desc)
    return M4A_Leaf_Atom(b"stsc", data)


def stsz_atom(frame_byte_sizes):
    return M4A_Leaf_Atom(b"stsz", struct.pack(
        ">BxxxII%dI" % (len(frame_byte_sizes),), 0, 0,
        len(frame_byte_sizes), *frame_byte_sizes))


def stco_atom(mdat_offset, frame_byte_sizes):
    per_chunk = 5
    offsets = []
    offset = mdat_offset + 8
    for start in range(0, len(frame_byte_sizes), per_chunk):
        offsets.append(offset)
        offset += sum(frame_byte_sizes[start:start + per_chunk])
    return M4A_Leaf_Atom(b"stco", struct.pack(
        ">BxxxI%dI" % (len(offsets),), 0, len(offsets), *offsets))


def meta_atom():
    return M4A_META_Atom(0, 0, [
        M4A_Leaf_Atom(b"hdlr", b"\x00" * 8 + b"mdir" + b"appl" + b"\x00" * 9),
        M4A_Tree_Atom(b"ilst", [ilst_string_atom(
            b"\xa9too", "tpu-audio-tools %s" % (VERSION,))]),
        M4A_Leaf_Atom(b"free", b"\x00" * 1024)])


def get_m4a_atom(reader, *atoms):
    """(size, reader) of the payload of the atom at the nested path
    ``atoms`` (names as bytes) of a BitstreamReader; KeyError when the
    path is not there"""
    for (i, next_atom) in enumerate(atoms):
        try:
            (length, stream_atom) = reader.parse("32u 4b")
            while stream_atom != next_atom:
                if length < 8:
                    raise KeyError(next_atom)
                reader.skip_bytes(length - 8)
                (length, stream_atom) = reader.parse("32u 4b")
            if i == len(atoms) - 1:
                return (length - 8, reader.substream(length - 8))
            reader = reader.substream(length - 8)
        except IOError:
            raise KeyError(next_atom)


def get_m4a_atom_offset(reader, *atoms):
    """(offset, size) of the atom at the nested path ``atoms``, its
    header included, from the reader's position; KeyError when the path
    is not there"""
    offset = 0
    for (i, next_atom) in enumerate(atoms):
        try:
            (length, stream_atom) = reader.parse("32u 4b")
            while stream_atom != next_atom:
                if length < 8:
                    raise KeyError(next_atom)
                reader.skip_bytes(length - 8)
                offset += length
                (length, stream_atom) = reader.parse("32u 4b")
            if i == len(atoms) - 1:
                return (offset, length)
            offset += 8
            reader = reader.substream(length - 8)
        except IOError:
            raise KeyError(next_atom)


class InvalidALAC(InvalidFile, ValueError):
    """a file that is not an ALAC M4A file this module reads"""


class ALACAudio(AudioFile):
    """an Apple Lossless file, encoded and decoded on a torch device

    device: "cuda" (raises when no card is usable) or "cpu" (the
    kernels' plain versions, for tests); ``to_pcm`` decodes there."""

    SUFFIX = "m4a"
    NAME = "alac"
    DESCRIPTION = "Apple Lossless"
    COMPRESSION_DESCRIPTIONS = {"": text.COMP_ALAC}
    DEFAULT_COMPRESSION = ""
    COMPRESSION_MODES = ("",)

    # the encoder's frame size and its adaptive Rice coder's settings
    BLOCK_SIZE = BLOCK_SIZE
    INITIAL_HISTORY = 10
    HISTORY_MULTIPLIER = 40
    MAXIMUM_K = 14

    def __init__(self, filename, device="cuda"):
        AudioFile.__init__(self, filename)
        self.device = resolve_device(device)
        try:
            with open(filename, "rb") as f:
                self.__header = read_m4a_header(f)
        except (IOError, ValueError, KeyError) as err:
            raise InvalidALAC(str(err))

    def bits_per_sample(self):
        return self.__header["bits_per_sample"]

    def channels(self):
        return self.__header["channels"]

    def channel_mask(self):
        return self.__header["channel_mask"]

    def sample_rate(self):
        return self.__header["sample_rate"]

    def total_frames(self):
        return self.__header["total_pcm_frames"]

    def seekable(self):
        return True

    def get_metadata(self):
        """the moov/udta/meta atom, an M4A_META_Atom, or None"""
        with open(self.filename, "rb") as f:
            atoms = parse_atoms(f.read())
        for atom in atoms:
            if atom.name == b"moov":
                try:
                    meta = atom.get_child(b"udta").get_child(b"meta")
                except KeyError:
                    return None
                if isinstance(meta, M4A_META_Atom):
                    return meta
        return None

    def update_metadata(self, metadata):
        """writes an M4A_META_Atom back as moov/udta/meta, the whole file
        rewritten through a temporary file; when the moov atom changes
        size ahead of the mdat, the stco chunk offsets move with it"""
        if not isinstance(metadata, M4A_META_Atom):
            raise ValueError("metadata not from audio file")
        with open(self.filename, "rb") as f:
            atoms = parse_atoms(f.read())
        moov = None
        for atom in atoms:
            if atom.name == b"moov":
                moov = atom
        if moov is None:
            raise ValueError("moov atom not found")
        old_size = moov.size()
        try:
            moov.get_child(b"udta").replace_child(metadata)
        except KeyError:
            moov.add_child(M4A_Tree_Atom(b"udta", [metadata]))
        size_delta = moov.size() - old_size
        names = [atom.name for atom in atoms]
        if (size_delta != 0 and b"mdat" in names and
                names.index(b"mdat") > names.index(b"moov")):
            try:
                stco = (moov.get_child(b"trak").get_child(b"mdia")
                        .get_child(b"minf").get_child(b"stbl")
                        .get_child(b"stco"))
            except KeyError:
                stco = None
            if stco is not None:
                (count,) = struct.unpack(">I", stco.data[4:8])
                offsets = struct.unpack(">%dI" % (count,),
                                        stco.data[8:8 + 4 * count])
                stco.data = (stco.data[0:8] + struct.pack(
                    ">%dI" % (count,), *(o + size_delta for o in offsets)))
        with TemporaryFile(self.filename) as out:
            for atom in atoms:
                out.write(atom.build())

    def set_metadata(self, metadata):
        """converts ``metadata`` (any MetaData) and writes it"""
        if metadata is not None:
            self.update_metadata(M4A_META_Atom.converted(metadata))

    def delete_metadata(self):
        """the meta atom of a new file: the encoder's name alone"""
        self.update_metadata(meta_atom())

    def to_pcm(self):
        """a TorchALACDecoder of the file on the file's device
        (``codecs.alac.decoder_for_file``: the scalar ALACDecoder on the
        host under ATPU_ALAC_ORACLE=1)"""
        return decoder_for_file(self.filename, device=self.device)

    @classmethod
    def from_pcm(cls, filename, pcmreader, compression=None,
                 total_pcm_frames=None, device="cuda",
                 block_size=BLOCK_SIZE):
        """encodes a new file from a PCMReader on ``device`` and returns
        it; ``compression`` is ignored (ALAC has one mode).  A written
        frame count other than ``total_pcm_frames`` (when given) raises
        EncodingError, as any failure does, and no file is left."""
        device = resolve_device(device)
        if pcmreader.bits_per_sample not in (16, 24):
            pcmreader.close()
            raise EncodingError("unsupported bits per sample: %d"
                                % (pcmreader.bits_per_sample,))
        if int(pcmreader.channel_mask) not in SUPPORTED_CHANNEL_MASKS:
            pcmreader.close()
            raise EncodingError("unsupported channel mask: %d"
                                % (int(pcmreader.channel_mask),))
        try:
            (_sizes, frames) = write_m4a(filename, pcmreader,
                                         block_size=block_size,
                                         device=device)
            if total_pcm_frames is not None and frames != total_pcm_frames:
                raise EncodingError("total PCM frames mismatch")
            return cls(filename, device)
        except (IOError, ValueError) as err:
            _unlink(filename)
            raise EncodingError(str(err))


class InvalidM4A(InvalidFile, ValueError):
    """an M4A file without the AAC atoms M4AAudio reads"""


class M4AAudio(AudioFile):
    """an AAC file in an M4A container, detected but not coded: the
    reference codes it through the faac and faad programs, and is
    available only where both are found"""

    SUFFIX = "m4a"
    NAME = "m4a"
    DESCRIPTION = "Advanced Audio Coding"
    DEFAULT_COMPRESSION = "100"
    COMPRESSION_MODES = tuple(map(str, range(10, 101, 5)))
    BINARIES = ("faac", "faad")
    BINARY_URLS = {"faac": "http://www.audiocoding.com/",
                   "faad": "http://www.audiocoding.com/"}

    def __init__(self, filename):
        AudioFile.__init__(self, filename)
        try:
            with open(filename, "rb") as f:
                (moov, _mdat) = _top_level(f)
            stsd = _find(moov or b"", b"trak", b"mdia", b"minf", b"stbl",
                         b"stsd")
            mdhd = _find(moov, b"trak", b"mdia", b"mdhd")
            # the first sample description: its channels, bits per
            # sample and 16.16 sample rate
            (self.__channels__, self.__bits_per_sample__) = struct.unpack(
                ">HH", stsd[32:36])
            (self.__sample_rate__,) = struct.unpack(">I", stsd[40:44])
            self.__sample_rate__ >>= 16
            if mdhd[0] == 0:
                (self.__length__,) = struct.unpack(">I", mdhd[16:20])
            else:
                (self.__length__,) = struct.unpack(">Q", mdhd[24:32])
        except (IOError, KeyError, IndexError, struct.error) as err:
            raise InvalidM4A(str(err))

    def lossless(self):
        return False

    def bits_per_sample(self):
        return self.__bits_per_sample__

    def channels(self):
        return self.__channels__

    def sample_rate(self):
        return self.__sample_rate__

    def total_frames(self):
        return self.__length__

    def to_pcm(self):
        return PCMReaderError("AAC decoding is not ported",
                              self.__sample_rate__, self.__channels__, 0,
                              self.__bits_per_sample__)

    @classmethod
    def from_pcm(cls, filename, pcmreader, compression=None,
                 total_pcm_frames=None, device=None):
        raise EncodingError("AAC encoding is not ported")


def _unlink(filename):
    try:
        os.unlink(filename)
    except OSError:
        pass
