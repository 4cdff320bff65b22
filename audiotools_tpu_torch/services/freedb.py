"""FreeDB disc IDs and lookups (the reference's
``audiotools_tpu/services/freedb.py``)."""

from __future__ import annotations


class DiscID:
    """a FreeDB disc ID"""

    def __init__(self, offsets, total_length, track_count):
        """offsets: track offsets in CD frames (LBA, the 150-frame
        lead-in included); total_length: the disc's length in CD frames;
        track_count: the number of tracks"""
        assert len(offsets) == track_count
        self.offsets = offsets
        self.total_length = total_length
        self.track_count = track_count

    def __repr__(self):
        return "DiscID(%r, %r, %r)" % (self.offsets, self.total_length,
                                       self.track_count)

    def __str__(self):
        return "%8.8X" % (int(self),)

    def __int__(self):
        digitsum = sum(map(int, "".join(
            str(o // 75) for o in self.offsets))) % 255
        seconds_length = self.total_length // 75
        return ((digitsum << 24) |
                ((seconds_length & 0xFFFF) << 8) |
                self.track_count)


def disc_id(cdda):
    """the DiscID of a ``cdio.CDDA``"""
    offsets = [start + 150 for (start, _length) in cdda.track_offsets()]
    return DiscID(offsets=offsets, total_length=cdda.cdda.last_sector(),
                  track_count=len(cdda))


def perform_lookup(disc_id, freedb_server="us.freedb.org", freedb_port=80):
    """the text of the service's reply to a query for ``disc_id``; ""
    when the service cannot be reached"""
    from urllib.error import URLError
    from urllib.request import urlopen

    query = "cmd=cddb+query+%s&hello=user+host+audiotools+1.0&proto=6" \
        % (str(disc_id),)
    url = "http://%s:%d/~cddb/cddb.cgi?%s" % (freedb_server, freedb_port,
                                              query)
    try:
        with urlopen(url, timeout=15) as response:
            return response.read().decode("utf-8", "replace")
    except (URLError, OSError):
        return ""
