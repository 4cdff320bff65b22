"""AccurateRip disc IDs and database lookups (the reference's
``audiotools_tpu/services/accuraterip.py``)."""

from __future__ import annotations

import struct


class DiscID:
    """an AccurateRip disc ID"""

    def __init__(self, track_numbers, track_offsets, lead_out_offset,
                 freedb_disc_id):
        """track_offsets: each track's offset in CD frames (LSN, the
        150-frame lead-in excluded); lead_out_offset likewise"""
        assert len(track_numbers) == len(track_offsets)
        self.__track_numbers__ = list(track_numbers)
        self.__track_offsets__ = list(track_offsets)
        self.__lead_out_offset__ = lead_out_offset
        self.__freedb_disc_id__ = freedb_disc_id

    def track_numbers(self):
        return self.__track_numbers__[:]

    def id1(self):
        return sum(self.__track_offsets__) + self.__lead_out_offset__

    def id2(self):
        return (sum(n * max(o, 1) for (n, o) in
                    zip(self.__track_numbers__, self.__track_offsets__)) +
                (max(self.__track_numbers__) + 1) * self.__lead_out_offset__)

    def freedb_disc_id(self):
        return int(self.__freedb_disc_id__)

    def __str__(self):
        return ("dBAR-%(tracks)3.3d-%(id1)8.8x-%(id2)8.8x-%(freedb)8.8x.bin"
                % {"tracks": len(self.__track_numbers__),
                   "id1": self.id1(),
                   "id2": self.id2(),
                   "freedb": int(self.__freedb_disc_id__)})

    def __repr__(self):
        return "AccurateRipDiscID(%r, %r, %r, %r)" % (
            self.__track_numbers__, self.__track_offsets__,
            self.__lead_out_offset__, self.__freedb_disc_id__)


def disc_id(cdda):
    """the DiscID of a ``cdio.CDDA``"""
    from .freedb import disc_id as freedb_disc_id
    offsets = [start for (start, _length) in cdda.track_offsets()]
    return DiscID(track_numbers=list(range(1, len(cdda) + 1)),
                  track_offsets=offsets,
                  lead_out_offset=cdda.cdda.last_sector() + 1,
                  freedb_disc_id=freedb_disc_id(cdda))


def perform_lookup(disc_id, accuraterip_server="www.accuraterip.com",
                   accuraterip_port=80):
    """the database's entries for ``disc_id``:
    {track_number: [(confidence, crc, crc2), ...], ...}, each list empty
    when the disc is not found or the service cannot be reached; a
    record cut inside its track entries gives the entries read so far"""
    from urllib.error import URLError
    from urllib.request import urlopen

    matches = {n: [] for n in disc_id.track_numbers()}
    name = str(disc_id)
    url = "http://%s:%d/accuraterip/%s/%s/%s/%s" % (
        accuraterip_server, accuraterip_port,
        name[16], name[15], name[14], name)
    try:
        with urlopen(url, timeout=15) as response:
            data = response.read()
    except (URLError, OSError):
        return matches

    pos = 0
    while pos + 13 <= len(data):
        (track_count, id1, id2, freedb) = struct.unpack_from(
            "<BIII", data, pos)
        pos += 13
        if (id1 == disc_id.id1() and id2 == disc_id.id2() and
                freedb == disc_id.freedb_disc_id()):
            for track_number in range(1, track_count + 1):
                if pos + 9 > len(data):
                    return matches
                (confidence, crc, crc2) = struct.unpack_from(
                    "<BII", data, pos)
                pos += 9
                if track_number in matches:
                    matches[track_number].append((confidence, crc, crc2))
        else:
            pos += 9 * track_count
    return matches
