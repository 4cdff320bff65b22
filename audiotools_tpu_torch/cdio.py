"""Disc images read as CDs: cue/bin, toc/bin and NRG, and their tracks.

The port of the reference's ``audiotools_tpu/cdio.py``: ``CDImage``
reads a cue/bin or toc/bin image and ``NRGImage`` a Nero image, each
with the sector API a drive offers (seek, read a 2352-byte sector);
``identify_cdrom`` picks one for a path; ``CDDA`` is a disc over one,
with its FreeDB, MusicBrainz and AccurateRip disc IDs
(``services``); ``CDTrackReader`` is a PCMReader of one track (44.1
kHz, 2 channels, 16 bits), shifted by a read offset, with silence where
the shifted window reaches past either end of the disc; ``CDTrackLog``
holds a rip's read counters.  Physical drives are not read: a path
that is no image raises ValueError.  No device code.
"""

from __future__ import annotations

import os
import re

import numpy as np

from . import pcm
from .audiofile import read_sheet

SECTOR_BYTES = 2352            # raw audio sector
SECTOR_FRAMES = 588            # PCM frames per sector (44100 / 75)
SECTORS_PER_SECOND = 75


class CDImage:
    """a cue/bin or toc/bin CD image with a drive's sector API"""

    def __init__(self, image_path):
        self.sheet = read_sheet(image_path)
        bin_path = self.__find_bin__(image_path)
        self.__file__ = open(bin_path, "rb")
        self.__file__.seek(0, 2)
        total_sectors = self.__file__.tell() // SECTOR_BYTES
        self.__file__.seek(0, 0)

        # track offsets in sectors from INDEX 01 positions
        self.__offsets__ = []
        for track in self.sheet.tracks():
            offset = track.index(1).offset()
            self.__offsets__.append(
                int(offset * SECTORS_PER_SECOND))
        self.__lengths__ = []
        for (i, start) in enumerate(self.__offsets__):
            if i + 1 < len(self.__offsets__):
                self.__lengths__.append(self.__offsets__[i + 1] -
                                        start)
            else:
                self.__lengths__.append(total_sectors - start)
        self.__total_sectors__ = total_sectors
        self.__position__ = 0

    @staticmethod
    def __find_bin__(image_path):
        """locates the binary data file named by a cue/toc sheet"""
        directory = os.path.dirname(os.path.abspath(image_path))
        with open(image_path, "r", encoding="utf-8",
                  errors="replace") as f:
            text = f.read()
        match = (re.search(r'FILE\s+"([^"]+)"', text) or
                 re.search(r'FILE\s+(\S+)', text))
        candidates = []
        if match is not None:
            candidates.append(os.path.join(directory, match.group(1)))
        stem = os.path.splitext(image_path)[0]
        candidates.append(stem + ".bin")
        for candidate in candidates:
            if os.path.isfile(candidate):
                return candidate
        raise IOError("unable to locate binary image for %s" %
                      (image_path,))

    def total_tracks(self):
        return len(self.__offsets__)

    def track_offsets(self, track_number):
        """the track's first sector (1-based track numbers)"""
        return self.__offsets__[track_number - 1]

    def track_lengths(self, track_number):
        """the track's length in sectors"""
        return self.__lengths__[track_number - 1]

    def first_sector(self):
        return 0

    def last_sector(self):
        return self.__total_sectors__ - 1

    def seek(self, sector):
        """seeks to the given sector, returning the sector seeked to"""
        sector = max(min(sector, self.__total_sectors__), 0)
        self.__position__ = sector
        self.__file__.seek(sector * SECTOR_BYTES, 0)
        return sector

    def read_sector(self):
        """returns one 2352-byte sector of audio data"""
        data = self.__file__.read(SECTOR_BYTES)
        self.__position__ += 1
        return data

    def set_speed(self, speed):
        """drive read speed: a no-op for images"""

    def length_in_seconds(self):
        return self.__total_sectors__ // SECTORS_PER_SECOND

    def close(self):
        self.__file__.close()


class NRGImage:
    """a Nero NRG disc image with the same sector API as CDImage

    The NRG layout is footer-based: the file ends with ``NER5`` + a 64-bit
    big-endian chunk-area offset (v2; v1 uses ``NERO`` + 32-bit), and
    the chunk area is a sequence of (4-byte id, 32-bit BE length,
    payload) records terminated by ``END!``.  Audio DAO images carry
    the cue entries in ``CUEX``/``CUES`` and the per-track byte
    ranges + sector size in ``DAOX``/``DAOI``."""

    def __init__(self, image_path):
        self.__file__ = open(image_path, "rb")
        f = self.__file__
        f.seek(0, 2)
        file_size = f.tell()
        if file_size >= 12:
            f.seek(-12, 2)
            tail = f.read(12)
        else:
            raise ValueError("invalid NRG image (too short)")
        if tail[0:4] == b"NER5":
            chunk_offset = int.from_bytes(tail[4:12], "big")
            self.__version__ = 2
        elif tail[4:8] == b"NERO":
            chunk_offset = int.from_bytes(tail[8:12], "big")
            self.__version__ = 1
        else:
            raise ValueError("invalid NRG image (no NERO/NER5 footer)")

        chunks = []
        f.seek(chunk_offset, 0)
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            chunk_id = header[0:4]
            length = int.from_bytes(header[4:8], "big")
            if chunk_id == b"END!":
                break
            chunks.append((chunk_id, f.read(length)))

        cue_entries = []        # (track, index, lba)
        dao_tracks = []         # (sector_size, index0, index1, end)
        for (chunk_id, payload) in chunks:
            if chunk_id in (b"CUEX", b"CUES"):
                for i in range(0, len(payload) - 7, 8):
                    track_bcd = payload[i + 1]
                    index = payload[i + 2]
                    lba = int.from_bytes(payload[i + 4:i + 8], "big",
                                         signed=True)
                    if chunk_id == b"CUES":
                        # v1 stores positions relative to the
                        # session lead-in (150 sectors before 0)
                        lba -= 150
                    if track_bcd in (0x00, 0xAA):
                        continue   # lead-in / lead-out
                    track = ((track_bcd >> 4) * 10 +
                             (track_bcd & 0x0F))
                    cue_entries.append((track, index, lba))
            elif chunk_id in (b"DAOX", b"DAOI"):
                entry_size = 42 if chunk_id == b"DAOX" else 30
                word = 8 if chunk_id == b"DAOX" else 4
                pos = 22
                while pos + entry_size <= len(payload):
                    entry = payload[pos:pos + entry_size]
                    sector_size = int.from_bytes(entry[12:14], "big")
                    offs = entry[18:]
                    index0 = int.from_bytes(offs[0:word], "big")
                    index1 = int.from_bytes(offs[word:2 * word],
                                            "big")
                    end = int.from_bytes(offs[2 * word:3 * word],
                                         "big")
                    dao_tracks.append((sector_size, index0, index1,
                                       end))
                    pos += entry_size

        if not dao_tracks:
            raise ValueError("NRG image carries no DAO audio tracks")
        self.__sector_size__ = dao_tracks[0][0] or SECTOR_BYTES

        # track start LBAs from the cue (INDEX 01 entries), byte
        # ranges from the DAO table
        starts = sorted(lba for (_track, index, lba) in cue_entries
                        if index == 1)
        if len(starts) != len(dao_tracks):
            # fall back to byte offsets alone
            origin = dao_tracks[0][2]
            starts = [(index1 - origin) // self.__sector_size__
                      for (_ss, _i0, index1, _end) in dao_tracks]
        self.__offsets__ = starts
        total_bytes = dao_tracks[-1][3] - dao_tracks[0][2]
        total_sectors = (starts[0] +
                         total_bytes // self.__sector_size__)
        self.__lengths__ = []
        for (i, start) in enumerate(starts):
            if i + 1 < len(starts):
                self.__lengths__.append(starts[i + 1] - start)
            else:
                self.__lengths__.append(total_sectors - start)
        self.__total_sectors__ = total_sectors
        # byte position of disc LBA 0
        self.__origin__ = (dao_tracks[0][2] -
                           starts[0] * self.__sector_size__)
        self.__position__ = 0

    def total_tracks(self):
        return len(self.__offsets__)

    def track_offsets(self, track_number):
        return self.__offsets__[track_number - 1]

    def track_lengths(self, track_number):
        return self.__lengths__[track_number - 1]

    def first_sector(self):
        return 0

    def last_sector(self):
        return self.__total_sectors__ - 1

    def seek(self, sector):
        sector = max(min(sector, self.__total_sectors__), 0)
        self.__position__ = sector
        self.__file__.seek(self.__origin__ +
                           sector * self.__sector_size__, 0)
        return sector

    def read_sector(self):
        data = self.__file__.read(self.__sector_size__)
        self.__position__ += 1
        # 2448-byte sectors carry 96 bytes of subchannel data after
        # the audio payload
        return data[:SECTOR_BYTES]

    def set_speed(self, speed):
        """drive read speed: a no-op for images"""

    def length_in_seconds(self):
        return self.__total_sectors__ // SECTORS_PER_SECOND

    def close(self):
        self.__file__.close()


def identify_cdrom(path):
    """a CDImage or NRGImage for a cue, toc or nrg path (an NRG image is
    also known by its footer); anything else raises ValueError"""
    suffix = os.path.splitext(path)[1].lower()
    if suffix in (".cue", ".toc"):
        return CDImage(path)
    if suffix == ".nrg":
        return NRGImage(path)
    # an NRG footer, whatever the extension
    try:
        with open(path, "rb") as f:
            f.seek(-12, 2)
            tail = f.read(12)
        if tail[0:4] == b"NER5" or tail[4:8] == b"NERO":
            return NRGImage(path)
    except (IOError, OSError):
        pass
    raise ValueError(
        "physical CD-ROM devices are not supported in this build; "
        "use a cue/toc/nrg disc image")


class CDDA:
    """a CD over a CDImage or NRGImage (or the path of one)"""

    def __init__(self, image_or_path, speed=None):
        if isinstance(image_or_path, CDImage):
            self.cdda = image_or_path
        else:
            self.cdda = identify_cdrom(image_or_path)
        if speed is not None:
            self.cdda.set_speed(speed)
        self.total_tracks = self.cdda.total_tracks()

    def __len__(self):
        return self.total_tracks

    def __getitem__(self, track_number):
        """returns a CDTrackReader for the given 1-based track"""
        if not (1 <= track_number <= self.total_tracks):
            raise IndexError(track_number)
        return CDTrackReader(self.cdda, track_number)

    def __iter__(self):
        for i in range(1, self.total_tracks + 1):
            yield self[i]

    def length_in_seconds(self):
        return self.cdda.length_in_seconds()

    def track_offsets(self):
        """per-track (first_sector, length_sectors) pairs"""
        return [(self.cdda.track_offsets(i), self.cdda.track_lengths(i))
                for i in range(1, self.total_tracks + 1)]

    def freedb_disc_id(self):
        from .services.freedb import disc_id
        return disc_id(self)

    def musicbrainz_disc_id(self):
        from .services.musicbrainz import disc_id
        return disc_id(self)

    def accuraterip_disc_id(self):
        from .services.accuraterip import disc_id
        return disc_id(self)

    def close(self):
        self.cdda.close()


class CDTrackReader:
    """a PCMReader of one CD track (44.1 kHz, 2 channels, 16 bits):
    the track's frames shifted by ``sample_offset`` (a drive's read
    offset), silence where they fall outside the disc; a sector is
    sought and read at a time"""

    def __init__(self, cdda, track_number, sample_offset=0):
        self.cdda = cdda
        self.track_number = track_number
        self.sample_rate = 44100
        self.channels = 2
        self.channel_mask = 0x3
        self.bits_per_sample = 16

        start = cdda.track_offsets(track_number)
        length = cdda.track_lengths(track_number)
        self.__start_frame__ = start * SECTOR_FRAMES + sample_offset
        self.__total_frames__ = length * SECTOR_FRAMES
        self.__position__ = 0
        self.__disc_frames__ = (cdda.last_sector() + 1) * SECTOR_FRAMES
        self.closed = False

    def read(self, pcm_frames):
        if self.closed:
            raise ValueError("stream is closed")
        remaining = self.__total_frames__ - self.__position__
        if remaining <= 0:
            return pcm.empty_framelist(2, 16)
        want = min(max(pcm_frames, 1), remaining)

        abs_frame = self.__start_frame__ + self.__position__
        out = np.zeros((want, 2), dtype=np.int32)
        filled = 0
        while filled < want:
            frame = abs_frame + filled
            if frame < 0 or frame >= self.__disc_frames__:
                # out-of-disc window (read offsets): silence
                filled += 1
                continue
            sector = frame // SECTOR_FRAMES
            within = frame % SECTOR_FRAMES
            self.cdda.seek(sector)
            data = self.cdda.read_sector()
            samples = np.frombuffer(
                data, dtype="<i2").astype(np.int32).reshape(-1, 2)
            take = min(SECTOR_FRAMES - within, want - filled)
            out[filled:filled + take] = samples[within:within + take]
            filled += take
        self.__position__ += want
        return pcm.FrameList._wrap(out, 16)

    def seek(self, pcm_frame):
        """seeks within the track, returning the position seeked to"""
        self.__position__ = max(min(int(pcm_frame),
                                    self.__total_frames__), 0)
        return self.__position__

    def close(self):
        self.closed = True


class CDTrackLog(dict):
    """a rip's read counters keyed by paranoia callback code, shown as
    cdda2wav's summary line shows them.  Reads of an image never
    jitter, so an image's rips count zeroes throughout."""

    def __str__(self):
        fields = {"edge": self.get(2, 0),
                  "atom": self.get(3, 0),
                  "skip": self.get(6, 0),
                  "drift": self.get(7, 0),
                  "drop": self.get(10, 0),
                  "dup": self.get(11, 0),
                  "rderr": self.get(12, 0)}
        return ", ".join("%d %s" % (fields[name], name)
                         for name in ("rderr", "skip", "atom", "edge",
                                      "drop", "dup", "drift"))
