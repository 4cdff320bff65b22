"""DVD-Audio disc access: IFO parsing and AOB PCM and MLP decoding.

The port of the reference's ``audiotools_tpu/dvda.py``: ``DVDAudio``
parses AUDIO_TS.IFO / ATS_XX_0.IFO sector structs into
``DVDATitle``/``DVDATrack`` objects, and ``DVDATitleReader`` decodes a
title's PCM stream from the titleset's AOB files (MPEG program stream
packs, 0xBD private-stream packets, the 0xA0 PCM headers and the
byte-swap matrices per bit depth and channel count), a 2048-byte
sector a parse, as the reference reads it.  MLP (0xA1) titles decode
through ``MLPTitleReader`` on the host (``_native.MLPDecoderHandle``;
the scalar ``ref.mlp`` decoder with ``ATPU_MLP_ORACLE=1``).  A
``cppm.CPPMDecoder`` given to ``DVDAudio`` descrambles CPPM-protected
sectors; building one needs the disc's keys (``cppm``).  Everything
here runs on the host: the titles' encodes take the card.
"""

from __future__ import annotations

import os
import re

import numpy as np

from . import pcm
from .bitstream import BitstreamReader

SECTOR_SIZE = 2048
PTS_PER_SECOND = 90000

SAMPLE_RATE = [48000, 96000, 192000, 0, 0, 0, 0, 0,
               44100, 88200, 176400, 0, 0, 0, 0, 0]
CHANNELS = [1, 2, 3, 4, 3, 4, 5, 3, 4, 5, 4, 5, 6, 4, 5, 4, 5, 6, 5,
            5, 6]
CHANNEL_MASK = [0x4, 0x3, 0x103, 0x33, 0xB, 0x10B, 0x3B, 0x7,
                0x107, 0x37, 0xF, 0x10F, 0x3F, 0x107, 0x37, 0xF,
                0x10F, 0x3F, 0x3B, 0x37, 0x3F]
BITS_PER_SAMPLE = [16, 20, 24] + [0] * 13

# byte-swap matrices (reference src/decoders/aobpcm.c:63-98):
# chunk bytes arrive interleaved per 2 PCM frames; unswapped[SWAP[i]]
# = chunk[i]
AOB_BYTE_SWAP = {
    (16, 1): [1, 0, 3, 2],
    (16, 2): [1, 0, 3, 2, 5, 4, 7, 6],
    (16, 3): [1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10],
    (16, 4): [1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12, 15, 14],
    (16, 5): [1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12, 15, 14,
              17, 16, 19, 18],
    (16, 6): [1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12, 15, 14,
              17, 16, 19, 18, 21, 20, 23, 22],
    (24, 1): [2, 1, 5, 4, 0, 3],
    (24, 2): [2, 1, 5, 4, 8, 7, 11, 10, 0, 3, 6, 9],
    (24, 3): [8, 7, 17, 16, 6, 15, 2, 1, 5, 4, 11, 10, 14, 13, 0, 3,
              9, 12],
    (24, 4): [8, 7, 11, 10, 20, 19, 23, 22, 6, 9, 18, 21, 2, 1, 5, 4,
              14, 13, 17, 16, 0, 3, 12, 15],
    (24, 5): [8, 7, 11, 10, 14, 13, 23, 22, 26, 25, 29, 28, 6, 9, 12,
              21, 24, 27, 2, 1, 5, 4, 17, 16, 20, 19, 0, 3, 15, 18],
    (24, 6): [8, 7, 11, 10, 26, 25, 29, 28, 6, 9, 24, 27, 2, 1, 5, 4,
              14, 13, 17, 16, 20, 19, 23, 22, 32, 31, 35, 34, 0, 3,
              12, 15, 18, 21, 30, 33],
}


class InvalidDVDA(Exception):
    pass


class DVDAudio:
    """an entire DVD-Audio disc (reference dvda.py:21)"""

    SECTOR_SIZE = SECTOR_SIZE
    PTS_PER_SECOND = PTS_PER_SECOND

    def __init__(self, audio_ts_path, cdrom_device=None,
                 cppm_decoder=None):
        """cppm_decoder: an optional cppm.CPPMDecoder for
        CPPM-protected discs (reference aob.c routes sectors through
        cppm_decrypt when the drive reports protection; building the
        decoder needs drive authentication — see
        cppm.authenticate_drive)"""
        self.audio_ts_path = audio_ts_path
        self.cdrom_device = cdrom_device
        self.cppm_decoder = cppm_decoder
        self.files = {name.upper(): os.path.join(audio_ts_path, name)
                      for name in os.listdir(audio_ts_path)}

        titleset_numbers = list(self.__titlesets__())
        self.titlesets = [self.__titles__(ts)
                          for ts in titleset_numbers]

    def __getitem__(self, key):
        return self.titlesets[key]

    def __len__(self):
        return len(self.titlesets)

    def __titlesets__(self):
        try:
            f = open(self.files["AUDIO_TS.IFO"], "rb")
        except (KeyError, IOError):
            raise InvalidDVDA("unable to open AUDIO_TS.IFO")
        try:
            (identifier, _amg_start, _amgi_end, _version,
             _volume_count, _volume_number, _disc_side, _autoplay,
             _ts_to_sv, _video_titlesets, audio_titlesets,
             _provider) = BitstreamReader(f, False).parse(
                "12b 32u 12P 32u 16u 4P 16u 16u 8u 4P 8u 32u 10P "
                "8u 8u 40b")
            if identifier != b"DVDAUDIO-AMG":
                raise InvalidDVDA("invalid AUDIO_TS.IFO identifier")
            for titleset in range(1, audio_titlesets + 1):
                if (("ATS_%2.2d_0.IFO" % (titleset,) in self.files) and
                        ("ATS_%2.2d_1.AOB" % (titleset,) in
                         self.files)):
                    yield titleset
        finally:
            f.close()

    def __titles__(self, titleset):
        """returns a list of DVDATitle objects for a titleset
        (reference dvda.py:121)"""
        try:
            f = open(self.files["ATS_%2.2d_0.IFO" % (titleset,)],
                     "rb")
        except (KeyError, IOError):
            raise InvalidDVDA("unable to open ATS_%2.2d_0.IFO" %
                              (titleset,))
        try:
            if f.read(12) != b"DVDAUDIO-ATS":
                raise InvalidDVDA("invalid ATS identifier")

            f.seek(SECTOR_SIZE, 0)
            reader = BitstreamReader(f, False)
            (title_count, _last_byte) = reader.parse("16u 16p 32u")
            title_offsets = [reader.parse("8u 24p 32u")[1]
                             for _ in range(title_count)]

            titles = []
            for (title_number, offset) in enumerate(title_offsets):
                f.seek(SECTOR_SIZE + offset, 0)
                reader = BitstreamReader(f, False)
                (tracks, indexes, track_length,
                 sector_pointers_table) = reader.parse(
                    "16p 8u 8u 32u 4P 16u 2P")
                timestamps = [reader.parse("32p 8u 8p 32u 32u 48p")
                              for _ in range(tracks)]

                f.seek(SECTOR_SIZE + offset + sector_pointers_table,
                       0)
                reader = BitstreamReader(f, False)
                sector_pointers = [reader.parse("32u 32u 32u")
                                   for _ in range(indexes)]
                if (len(sector_pointers) > 1 and
                        {p[0] for p in sector_pointers[1:]} !=
                        {0x01000000}):
                    raise InvalidDVDA("invalid sector pointer")
                sector_pointers = [None] + sector_pointers

                title = DVDATitle(dvdaudio=self, titleset=titleset,
                                  title=title_number + 1,
                                  pts_length=track_length, tracks=[])
                for (track_number, (stamp, next_stamp)) in enumerate(
                        zip(timestamps, timestamps[1:])):
                    (index_number, first_pts, pts_length) = stamp
                    title.tracks.append(DVDATrack(
                        dvdaudio=self, titleset=titleset, title=title,
                        track=track_number + 1, first_pts=first_pts,
                        pts_length=pts_length,
                        first_sector=sector_pointers[index_number][1],
                        last_sector=sector_pointers[
                            next_stamp[0] - 1][2]))
                (index_number, first_pts, pts_length) = timestamps[-1]
                title.tracks.append(DVDATrack(
                    dvdaudio=self, titleset=titleset, title=title,
                    track=len(timestamps), first_pts=first_pts,
                    pts_length=pts_length,
                    first_sector=sector_pointers[index_number][1],
                    last_sector=sector_pointers[-1][2]))
                title.__parse_info__()
                titles.append(title)
            return titles
        finally:
            f.close()

    def titleset_aobs(self, titleset):
        """returns the sorted AOB paths of a titleset"""
        pattern = re.compile(r"ATS_%2.2d_\d\.AOB" % (titleset,))
        return [self.files[key] for key in sorted(self.files)
                if pattern.match(key)]


class DVDATitle:
    """one title of a titleset (reference dvda.py:238)"""

    def __init__(self, dvdaudio, titleset, title, pts_length,
                 tracks):
        self.dvdaudio = dvdaudio
        self.titleset = titleset
        self.title = title
        self.pts_length = pts_length
        self.tracks = tracks

    def __len__(self):
        return len(self.tracks)

    def __getitem__(self, index):
        return self.tracks[index]

    def __repr__(self):
        return ("DVDATitle(titleset=%r, title=%r, pts_length=%r, "
                "tracks=%r)" % (self.titleset, self.title,
                                self.pts_length, self.tracks))

    def __parse_info__(self):
        """caches sample_rate/channels/bps from the first track's
        first audio packet (reference dvda.py:260)"""
        if len(self.tracks) == 0:
            return
        track_sector = self[0].first_sector
        aob_paths = self.dvdaudio.titleset_aobs(self.titleset)
        for aob_path in aob_paths:
            aob_sectors = os.path.getsize(aob_path) // SECTOR_SIZE
            if track_sector >= aob_sectors:
                track_sector -= aob_sectors
            else:
                break
        else:
            raise InvalidDVDA("unable to locate track sector")

        with open(aob_path, "rb") as aob_file:
            aob_file.seek(track_sector * SECTOR_SIZE)
            reader = BitstreamReader(aob_file, False)
            (sync, m1, _pts_h, m2, _pts_m, m3, _pts_l, m4, _scr, m5,
             _rate, m6, stuffing) = reader.parse(
                "32u 2u 3u 1u 15u 1u 15u 1u 9u 1u 22u 2u 5p 3u")
            reader.skip_bytes(stuffing)
            if sync != 0x1BA:
                raise InvalidDVDA("invalid AOB sync bytes")
            if (m1, m2, m3, m4, m5, m6) != (1, 1, 1, 1, 1, 3):
                raise InvalidDVDA("invalid AOB marker bits")

            (start_code, stream_id,
             packet_length) = reader.parse("24u 8u 16u")
            if start_code != 1:
                raise InvalidDVDA("invalid AOB packet start code")
            while stream_id != 0xBD:
                reader.skip_bytes(packet_length)
                (start_code, stream_id,
                 packet_length) = reader.parse("24u 8u 16u")
                if start_code != 1:
                    raise InvalidDVDA("invalid AOB packet start code")

            (pad1_size,) = reader.parse("16p 8u")
            reader.skip_bytes(pad1_size)
            (stream_id, _crc) = reader.parse("8u 8u 8p")
            if stream_id == 0xA0:       # PCM
                (_pad2, _first_audio_frame, _padding2,
                 group1_bps, _group2_bps, group1_rate, _group2_rate,
                 _padding3, channel_assignment) = reader.parse(
                    "8u 16u 8u 4u 4u 4u 4u 8u 8u")
            else:                       # MLP
                reader.skip_bytes(reader.read(8))
                (_total_frame_size, _sync_words, _stream_type,
                 group1_bps, _group2_bps, group1_rate, _group2_rate,
                 _unknown1, channel_assignment,
                 _unknown2) = reader.parse(
                    "4p 12u 16p 24u 8u 4u 4u 4u 4u 11u 5u 48u")

            self.sample_rate = SAMPLE_RATE[group1_rate]
            self.channels = CHANNELS[channel_assignment]
            self.channel_mask = CHANNEL_MASK[channel_assignment]
            self.bits_per_sample = BITS_PER_SAMPLE[group1_bps]
            self.stream_id = stream_id

    def info(self):
        """returns (sample_rate, channels, mask, bps, stream type)"""
        return (self.sample_rate, self.channels, self.channel_mask,
                self.bits_per_sample, self.stream_id)

    def total_frames(self):
        """the title's total PCM frames (PTS-derived, rounded up)"""
        from fractions import Fraction
        frames = Fraction(self.pts_length * self.sample_rate,
                          PTS_PER_SECOND)
        return int(frames) + (1 if frames % 1 else 0)

    def to_pcm(self):
        """returns a PCMReader of the title's audio (PCM or MLP)"""
        if self.stream_id == 0xA1:
            return MLPTitleReader(self)
        return DVDATitleReader(self)


class DVDATrack:
    """one track of a title (reference dvda.py:467)"""

    def __init__(self, dvdaudio, titleset, title, track, first_pts,
                 pts_length, first_sector, last_sector):
        self.dvdaudio = dvdaudio
        self.titleset = titleset
        self.title = title
        self.track = track
        self.first_pts = first_pts
        self.pts_length = pts_length
        self.first_sector = first_sector
        self.last_sector = last_sector

    def __repr__(self):
        return ("DVDATrack(track=%r, first_pts=%r, pts_length=%r, "
                "first_sector=%r, last_sector=%r)" %
                (self.track, self.first_pts, self.pts_length,
                 self.first_sector, self.last_sector))

    def total_frames(self):
        from fractions import Fraction
        frames = Fraction(self.pts_length *
                          self.title.sample_rate, PTS_PER_SECOND)
        return int(frames)

    def sectors(self):
        """yields (aob_path, start_sector, end_sector) spans"""
        start = self.first_sector
        end = self.last_sector + 1
        position = 0
        for aob_path in self.dvdaudio.titleset_aobs(self.titleset):
            aob_len = os.path.getsize(aob_path) // SECTOR_SIZE
            span = Rangeset(position, position + aob_len) & \
                Rangeset(start, end)
            if len(span):
                yield (aob_path, span.start - position,
                       span.end - position)
            position += aob_len


class Rangeset:
    """a half-open integer range supporting intersection
    (reference dvda.py:535)"""

    def __init__(self, start, end):
        self.start = start
        self.end = end

    def __repr__(self):
        return "Rangeset(%r, %r)" % (self.start, self.end)

    def __len__(self):
        return max(self.end - self.start, 0)

    def __getitem__(self, i):
        value = (self.start + i) if i >= 0 else (self.end + i)
        if self.start <= value < self.end:
            return value
        raise IndexError(i)

    def __and__(self, other):
        return Rangeset(max(self.start, other.start),
                        min(self.end, other.end))


class DVDATitleReader:
    """a PCMReader decoding a title's PCM audio from its AOBs
    (role of reference decoders.DVDA_Title, src/decoders/aob.c)"""

    def __init__(self, title):
        if title.stream_id != 0xA0:
            raise ValueError("MLP titles are not supported in this "
                             "build (PCM only)")
        self.title = title
        self.sample_rate = title.sample_rate
        self.channels = title.channels
        self.channel_mask = title.channel_mask
        self.bits_per_sample = title.bits_per_sample
        if (self.bits_per_sample, self.channels) not in AOB_BYTE_SWAP:
            raise ValueError("unsupported PCM layout")
        self.__swap__ = np.asarray(
            AOB_BYTE_SWAP[(self.bits_per_sample, self.channels)],
            dtype=np.int64)
        self.__chunk__ = len(self.__swap__)
        self.__remaining__ = title.total_frames()
        self.__init_spans__(title)
        self.__leftover__ = b""
        self.closed = False

    def __init_spans__(self, title):
        """maps the title's sector range onto its AOB files"""
        self.__spans__ = []
        start = title.tracks[0].first_sector
        end = title.tracks[-1].last_sector + 1
        position = 0
        for aob_path in title.dvdaudio.titleset_aobs(title.titleset):
            aob_len = os.path.getsize(aob_path) // SECTOR_SIZE
            span = Rangeset(position, position + aob_len) & \
                Rangeset(start, end)
            if len(span):
                self.__spans__.append(
                    (aob_path, span.start - position,
                     span.end - position))
            position += aob_len
        self.__span_index__ = 0
        self.__sector__ = None
        self.__file__ = None

    def __next_sector__(self):
        """returns the next 2048-byte sector or None at title end"""
        while self.__span_index__ < len(self.__spans__):
            (path, start, end) = self.__spans__[self.__span_index__]
            if self.__file__ is None:
                self.__file__ = open(path, "rb")
                self.__file__.seek(start * SECTOR_SIZE)
                self.__sector__ = start
            if self.__sector__ < end:
                data = self.__file__.read(SECTOR_SIZE)
                self.__sector__ += 1
                if len(data) == SECTOR_SIZE:
                    decoder = getattr(self.title.dvdaudio,
                                      "cppm_decoder", None)
                    if decoder is not None:
                        # preserve the CCI byte: zeroing it is a
                        # player-side copy-control action (reference
                        # cppm.c:567), not part of audio extraction
                        (data, _was_encrypted) = \
                            decoder.decrypt_block(data,
                                                  preserve_cci=True)
                    return data
            self.__file__.close()
            self.__file__ = None
            self.__span_index__ += 1
        return None

    @staticmethod
    def __audio_payload__(sector):
        """extracts the 0xBD audio packet payload from one sector"""
        reader = BitstreamReader(sector, False)
        (sync, _m1, _h, _m2, _m, _m3, _l, _m4, _scr, _m5, _rate,
         _m6, stuffing) = reader.parse(
            "32u 2u 3u 1u 15u 1u 15u 1u 9u 1u 22u 2u 5p 3u")
        if sync != 0x1BA:
            raise ValueError("invalid AOB sync bytes")
        reader.skip_bytes(stuffing)
        position = 14 + stuffing
        payload = b""
        while position < SECTOR_SIZE - 6:
            (start_code, stream_id,
             packet_length) = reader.parse("24u 8u 16u")
            if start_code != 1:
                break
            position += 6
            if stream_id == 0xBD:
                (pad1_size,) = reader.parse("16p 8u")
                reader.skip_bytes(pad1_size)
                (codec_id, _crc, pad2_size) = reader.parse(
                    "8u 8u 8p 8u")
                if codec_id == 0xA0:
                    reader.parse("16u 8p 4u 4u 4u 4u 8p 8u 8p 8u")
                    reader.skip_bytes(pad2_size - 9)
                else:
                    reader.skip_bytes(pad2_size)
                data_len = packet_length - 3 - pad1_size - 4 - \
                    pad2_size
                payload += reader.read_bytes(data_len)
            else:
                reader.skip_bytes(packet_length)
            position += packet_length
        return payload

    def read(self, pcm_frames):
        if self.closed:
            raise ValueError("stream is closed")
        if self.__remaining__ <= 0:
            return pcm.empty_framelist(self.channels,
                                       self.bits_per_sample)
        want_bytes = max(pcm_frames, 1) * self.__chunk__ // 2
        # the payloads joined once: appending each to a growing bytes
        # object copies the whole request a sector, which a 1024-block
        # FLAC batch (tens of MB) turns into minutes
        pieces = [self.__leftover__]
        size = len(self.__leftover__)
        while size < want_bytes:
            sector = self.__next_sector__()
            if sector is None:
                break
            pieces.append(self.__audio_payload__(sector))
            size += len(pieces[-1])
        data = b"".join(pieces)

        usable = (len(data) // self.__chunk__) * self.__chunk__
        self.__leftover__ = data[usable:]
        if usable == 0:
            self.__remaining__ = 0
            return pcm.empty_framelist(self.channels,
                                       self.bits_per_sample)

        chunks = np.frombuffer(data[:usable],
                               dtype=np.uint8).reshape(
                                   -1, self.__chunk__)
        unswapped = np.empty_like(chunks)
        unswapped[:, self.__swap__] = chunks
        bytes_per = self.bits_per_sample // 8
        flat = unswapped.reshape(-1, bytes_per)
        if bytes_per == 2:
            samples = (flat[:, 0].astype(np.int32) |
                       (flat[:, 1].astype(np.int32) << 8))
            samples = np.where(samples >= (1 << 15),
                               samples - (1 << 16), samples)
        else:
            samples = (flat[:, 0].astype(np.int32) |
                       (flat[:, 1].astype(np.int32) << 8) |
                       (flat[:, 2].astype(np.int32) << 16))
            samples = np.where(samples >= (1 << 23),
                               samples - (1 << 24), samples)
        samples = samples.reshape(-1, self.channels)
        if samples.shape[0] > self.__remaining__:
            samples = samples[:self.__remaining__]
        self.__remaining__ -= samples.shape[0]
        return pcm.FrameList._wrap(
            np.ascontiguousarray(samples, dtype=np.int32),
            self.bits_per_sample)

    def close(self):
        self.closed = True
        if self.__file__ is not None:
            self.__file__.close()
            self.__file__ = None


class MLPTitleReader(DVDATitleReader):
    """a PCMReader decoding a title's MLP audio from its AOBs

    role of the reference MLP path in decoders.DVDA_Title
    (src/decoders/aob.c:246-300 packet feed, src/decoders/mlp.c
    frame decode); the sector/packet walk is inherited from
    DVDATitleReader and the length-prefixed MLP frames are decoded
    by the native context (oracle with ATPU_MLP_ORACLE=1)"""

    def __init__(self, title):
        if title.stream_id != 0xA1:
            raise ValueError("not an MLP title")
        self.title = title
        self.sample_rate = title.sample_rate
        self.channels = title.channels
        self.channel_mask = title.channel_mask
        self.bits_per_sample = title.bits_per_sample
        self.__remaining__ = title.total_frames()
        self.__init_spans__(title)
        self.__leftover__ = b""
        self.__pending__ = None
        self.closed = False

        if os.environ.get("ATPU_MLP_ORACLE") == "1":
            from .ref.mlp import MLPDecoder, split_frames

            class _OracleCtx:
                def __init__(self):
                    self.dec = MLPDecoder()

                def decode(self, data):
                    (frames, leftover) = split_frames(data)
                    if frames:
                        out = np.concatenate(
                            [self.dec.decode_frame(f)
                             for f in frames])
                    else:
                        out = np.zeros((0, 1), dtype=np.int32)
                    return (out, len(data) - len(leftover))

                def close(self):
                    pass

            self.__decoder__ = _OracleCtx()
        else:
            from ._native import MLPDecoderHandle
            self.__decoder__ = MLPDecoderHandle()

    def read(self, pcm_frames):
        if self.closed:
            raise ValueError("stream is closed")
        if self.__remaining__ <= 0:
            return pcm.empty_framelist(self.channels,
                                       self.bits_per_sample)

        rows = []
        got = 0
        if self.__pending__ is not None:
            rows.append(self.__pending__)
            got = len(self.__pending__)
            self.__pending__ = None
        want = max(pcm_frames, 1)
        while got < want:
            sector = self.__next_sector__()
            if sector is None:
                break
            data = self.__leftover__ + self.__audio_payload__(sector)
            (samples, consumed) = self.__decoder__.decode(data)
            self.__leftover__ = data[consumed:]
            if len(samples):
                rows.append(samples)
                got += len(samples)

        if not rows:
            self.__remaining__ = 0
            return pcm.empty_framelist(self.channels,
                                       self.bits_per_sample)
        samples = np.concatenate(rows) if len(rows) > 1 else rows[0]
        if len(samples) > self.__remaining__:
            samples = samples[:self.__remaining__]
        self.__remaining__ -= len(samples)
        return pcm.FrameList._wrap(
            np.ascontiguousarray(samples, dtype=np.int32),
            self.bits_per_sample)

    def close(self):
        DVDATitleReader.close(self)
        self.__decoder__.close()
