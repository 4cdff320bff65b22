"""MusicBrainz disc IDs and lookups (the reference's
``audiotools_tpu/services/musicbrainz.py``)."""

from __future__ import annotations

from base64 import b64encode
from hashlib import sha1


class DiscID:
    """a MusicBrainz disc ID"""

    def __init__(self, first_track_number, last_track_number,
                 lead_out_offset, offsets):
        """offsets: track offsets in CD frames (LBA, the 150-frame
        lead-in included); lead_out_offset likewise"""
        assert (last_track_number - first_track_number + 1) == len(offsets)
        self.first_track_number = first_track_number
        self.last_track_number = last_track_number
        self.lead_out_offset = lead_out_offset
        self.offsets = offsets

    def __repr__(self):
        return "DiscID(%r, %r, %r, %r)" % (
            self.first_track_number, self.last_track_number,
            self.lead_out_offset, self.offsets)

    def __str__(self):
        digest = sha1(("%2.2X%2.2X%s" % (
            self.first_track_number,
            self.last_track_number,
            "".join("%8.8X" % (offset,) for offset in
                    ([self.lead_out_offset] + self.offsets +
                     [0] * (99 - len(self.offsets)))))).encode(
                         "ascii")).digest()
        return b64encode(digest, b"._").decode("ascii").replace("=", "-")


def disc_id(cdda):
    """the DiscID of a ``cdio.CDDA``"""
    offsets = [start + 150 for (start, _length) in cdda.track_offsets()]
    return DiscID(first_track_number=1, last_track_number=len(cdda),
                  lead_out_offset=cdda.cdda.last_sector() + 150 + 1,
                  offsets=offsets)


def perform_lookup(disc_id, musicbrainz_server="musicbrainz.org",
                   musicbrainz_port=80):
    """the text of the service's XML reply for ``disc_id``; "" when the
    service cannot be reached"""
    from urllib.error import URLError
    from urllib.request import urlopen

    url = ("http://%s:%d/ws/2/discid/%s?inc=artists+recordings" %
           (musicbrainz_server, musicbrainz_port, str(disc_id)))
    try:
        with urlopen(url, timeout=15) as response:
            return response.read().decode("utf-8", "replace")
    except (URLError, OSError):
        return ""
