"""Shared fixtures of the port's disc and lookup tests: disc images
(cue/bin, toc/bin and NRG, built as ``tests/test_cdio.py`` builds them),
canned FreeDB, MusicBrainz and AccurateRip replies written as strings,
and a stand-in for ``urllib.request.urlopen`` that serves them and
records each URL asked for.  Nothing here opens a socket."""

import struct
import urllib.error

import numpy as np

SR = 44100
SECTOR_FRAMES = 588


def disc_samples(sectors, seed=3):
    """int32 [frames, 2] of a tone and noise, ``sectors`` CD sectors long"""
    n = sectors * SECTOR_FRAMES
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    arr = np.stack([8000 * np.sin(2 * np.pi * 440 * t / SR) +
                    rng.normal(0, 300, n),
                    7000 * np.sin(2 * np.pi * 550 * t / SR)], axis=1)
    return np.clip(arr, -32768, 32767).astype(np.int32)


def msf(sector):
    return "%2.2d:%2.2d:%2.2d" % (sector // 4500, (sector // 75) % 60,
                                  sector % 75)


def make_image(directory, lengths, seed=3, name="disc"):
    """a cue/bin image of tracks ``lengths`` sectors long: (cue path,
    the disc's int32 samples)"""
    arr = disc_samples(sum(lengths), seed)
    bin_path = "%s/%s.bin" % (directory, name)
    with open(bin_path, "wb") as f:
        f.write(arr.astype("<i2").tobytes())
    cue = 'FILE "%s.bin" BINARY\n' % (name,)
    offset = 0
    for (i, length) in enumerate(lengths, 1):
        cue += "  TRACK %2.2d AUDIO\n    INDEX 01 %s\n" % (i, msf(offset))
        offset += length
    cue_path = "%s/%s.cue" % (directory, name)
    with open(cue_path, "w") as f:
        f.write(cue)
    return (cue_path, arr)


def make_toc(directory, lengths, seed=3, name="disc"):
    """a toc/bin image of the same layout as make_image's"""
    arr = disc_samples(sum(lengths), seed)
    with open("%s/%s.bin" % (directory, name), "wb") as f:
        f.write(arr.astype("<i2").tobytes())
    toc = "CD_DA\n\n"
    offset = 0
    for length in lengths:
        toc += 'TRACK AUDIO\nFILE "%s.bin" %s %s\n\n' % (
            name, msf(offset), msf(length))
        offset += length
    toc_path = "%s/%s.toc" % (directory, name)
    with open(toc_path, "w") as f:
        f.write(toc)
    return (toc_path, arr)


def make_nrg(directory, lengths, seed=3, name="disc"):
    """a v2 (NER5) NRG image: raw audio sectors, then a CUEX, DAOX, SINF
    and END! chunk area and the 12-byte footer"""
    arr = disc_samples(sum(lengths), seed)
    audio = arr.astype("<i2").tobytes()
    total_sectors = len(audio) // 2352
    track_starts = list(np.cumsum([0] + list(lengths[:-1])))
    track_ends = track_starts[1:] + [total_sectors]

    def chunk(cid, payload):
        return cid + len(payload).to_bytes(4, "big") + payload

    def bcd(v):
        return ((v // 10) << 4) | (v % 10)

    cuex = b""
    for (i, start) in enumerate(track_starts, 1):
        cuex += bytes([0x01, bcd(i), 0x00, 0x00]) + \
            int(start).to_bytes(4, "big", signed=True)
        cuex += bytes([0x01, bcd(i), 0x01, 0x00]) + \
            int(start).to_bytes(4, "big", signed=True)
    cuex += bytes([0x01, 0xAA, 0x01, 0x00]) + \
        total_sectors.to_bytes(4, "big", signed=True)
    daox = (b"\x00" * 4 + b"\x00" * 13 + b"\x00" +
            (0x0600).to_bytes(2, "big") + bytes([1, len(lengths)]))
    for (start, end) in zip(track_starts, track_ends):
        daox += (b"\x00" * 12 + (2352).to_bytes(2, "big") +
                 (0x0700).to_bytes(2, "big") + b"\x00" * 2 +
                 int(start * 2352).to_bytes(8, "big") +
                 int(start * 2352).to_bytes(8, "big") +
                 int(end * 2352).to_bytes(8, "big"))
    chunks = (chunk(b"CUEX", cuex) + chunk(b"DAOX", daox) +
              chunk(b"SINF", (2).to_bytes(4, "big")) + chunk(b"END!", b""))
    nrg_path = "%s/%s.nrg" % (directory, name)
    with open(nrg_path, "wb") as f:
        f.write(audio)
        chunk_offset = f.tell()
        f.write(chunks)
        f.write(b"NER5" + chunk_offset.to_bytes(8, "big"))
    return (nrg_path, arr)


# ---------------------------------------------------------------------------
# canned replies

def xmcd(track_count, album="Canned Album", artist="Canned Artist",
         year="1999"):
    """a FreeDB XMCD entry: one title a track, the second by another
    artist, a title split over two lines"""
    lines = ["# xmcd", "#", "DISCID=0a0b0c0d",
             "DTITLE=%s / %s" % (artist, album), "DYEAR=%s" % (year,)]
    for i in range(track_count):
        if i == 1:
            lines.append("TTITLE%d=Guest / Song %d" % (i, i + 1))
        elif i == 2:
            lines += ["TTITLE%d=Long Song " % (i,), "TTITLE%d=Part Two" % (i,)]
        else:
            lines.append("TTITLE%d=Song %d" % (i, i + 1))
    lines += ["EXTD=", "PLAYORDER="]
    return "\n".join(lines) + "\n"


def musicbrainz_xml(disc_ids, track_count, other_disc="OTHER-DISC-ID-",
                    album="Double Album"):
    """a MusicBrainz discid reply: a release of two discs, the second
    medium carrying ``disc_ids`` (a release of one medium after it
    carrying them too, and a release whose medium carries another disc)"""
    def tracks(prefix, count, guest=None):
        out = []
        for i in range(count):
            credit = ""
            if guest is not None and i == 1:
                credit = ("<artist-credit><name-credit><artist><name>%s"
                          "</name></artist></name-credit></artist-credit>"
                          % (guest,))
            out.append("<track><position>%d</position><recording><title>"
                       "%s %d</title>%s</recording></track>"
                       % (i + 1, prefix, i + 1, credit))
        return "<track-list count=\"%d\">%s</track-list>" % (count,
                                                             "".join(out))

    def discs(ids):
        return "<disc-list>%s</disc-list>" % ("".join(
            "<disc id=\"%s\"/>" % (d,) for d in ids),)

    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<metadata xmlns="http://musicbrainz.org/ns/mmd-2.0#">'
        '<disc id="%(id)s"><release-list count="3">'
        '<release id="r1"><title>%(album)s</title>'
        '<artist-credit><name-credit joinphrase=" &amp; "><artist><name>'
        'Alpha</name></artist></name-credit><name-credit><artist><name>'
        'Beta</name></artist></name-credit></artist-credit>'
        '<date>1997-05-12</date><label-info-list><label-info>'
        '<catalog-number>CAT-123</catalog-number><label><name>Example '
        'Records</name></label></label-info></label-info-list>'
        '<medium-list count="2">'
        '<medium><position>1</position>%(other)s%(wrong)s</medium>'
        '<medium><position>2</position>%(ours)s%(right)s</medium>'
        '</medium-list></release>'
        '<release id="r2"><title>Single Disc</title><date>2004</date>'
        '<medium-list count="1"><medium><position>1</position>%(ours)s'
        '%(single)s</medium></medium-list></release>'
        '<release id="r3"><title>Elsewhere</title>'
        '<medium-list count="1"><medium>%(other)s%(wrong)s</medium>'
        '</medium-list></release>'
        '</release-list></disc></metadata>\n'
        % {"id": disc_ids[0], "album": album,
           "other": discs([other_disc]), "ours": discs(disc_ids),
           "wrong": tracks("Wrong", 1),
           "right": tracks("Track", track_count, guest="Gamma"),
           "single": tracks("Single", track_count)})


def accuraterip_record(disc_id, entries, other_first=True):
    """an AccurateRip reply: a record of another disc (skipped), then
    ``disc_id``'s with ``entries``, a (confidence, crc, crc2) a track"""
    data = b""
    if other_first:
        data += struct.pack("<BIII", 2, 1, 2, 3)
        data += struct.pack("<BII", 9, 4, 5) * 2
    data += struct.pack("<BIII", len(entries), disc_id.id1(), disc_id.id2(),
                        disc_id.freedb_disc_id())
    for entry in entries:
        data += struct.pack("<BII", *entry)
    return data


class _Reply:
    def __init__(self, body):
        self.body = body

    def read(self):
        return self.body

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False


class CannedServer:
    """a stand-in for ``urllib.request.urlopen``: the reply for a URL is
    ``replies[kind]`` (kind "freedb", "musicbrainz" or "accuraterip", by
    the URL's path), bytes or text; a kind with no reply, or None, is
    unreachable (URLError); every URL asked for is kept in ``urls``"""

    def __init__(self, replies=None):
        self.replies = dict(replies or {})
        self.urls = []

    @staticmethod
    def kind(url):
        if "/~cddb/cddb.cgi?" in url:
            return "freedb"
        if "/ws/2/discid/" in url:
            return "musicbrainz"
        if "/accuraterip/" in url:
            return "accuraterip"
        return None

    def urlopen(self, url, *args, **kwargs):
        self.urls.append(url)
        body = self.replies.get(self.kind(url))
        if body is None:
            raise urllib.error.URLError("no route to %s" % (url,))
        return _Reply(body.encode("utf-8") if isinstance(body, str)
                      else body)


def no_socket(*_args, **_kwargs):
    raise OSError("network access is disabled in the tests")


def metadata_fields(metadata):
    """a MetaData's fields as a dict, None for None (either package's)"""
    from audiotools_tpu_torch.audiofile import MetaData
    if metadata is None:
        return None
    return {field: getattr(metadata, field) for field in MetaData.FIELDS}


def choices_fields(choices):
    return [[metadata_fields(m) for m in choice] for choice in choices]


def musicbrainz_release(disc_id, track_count, album="Canned Release"):
    """a MusicBrainz discid reply of one release of one medium that
    carries ``disc_id``, a title and a recording artist a track"""
    tracks = "".join(
        "<track><position>%d</position><recording><title>Take %d</title>"
        "<artist-credit><name-credit><artist><name>Player %d</name>"
        "</artist></name-credit></artist-credit></recording></track>"
        % (i + 1, i + 1, i % 2) for i in range(track_count))
    return ('<?xml version="1.0" encoding="UTF-8"?>\n'
            '<metadata xmlns="http://musicbrainz.org/ns/mmd-2.0#">'
            '<disc id="%(id)s"><release-list count="1"><release id="r">'
            '<title>%(album)s</title><date>2011-02-03</date>'
            '<medium-list count="1"><medium><position>1</position>'
            '<disc-list><disc id="%(id)s"/></disc-list>'
            '<track-list count="%(n)d">%(tracks)s</track-list></medium>'
            '</medium-list></release></release-list></disc></metadata>\n'
            % {"id": disc_id, "album": album, "n": track_count,
               "tracks": tracks})
