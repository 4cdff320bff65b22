"""The port's lookup services against the reference's: each disc ID
(FreeDB, MusicBrainz, AccurateRip) on seeded disc layouts, the XMCD and
MusicBrainz XML parsers on canned replies, each ``perform_lookup``'s
URL and result, and the five lookup functions of ``services.lookup``
over the same disc, files and sheet.  Every lookup is answered
in-process from canned replies (``urllib.request.urlopen`` patched)
and ``socket.create_connection`` raises, so no test reaches the
network."""

import os
import socket
import struct
import urllib.request

import numpy as np
import pytest

from audiotools_tpu import cdio as ref_cdio
from audiotools_tpu.audiofile import read_sheet as ref_read_sheet
from audiotools_tpu.dispatch import open_files as ref_open_files
from audiotools_tpu.services import accuraterip as ref_accuraterip
from audiotools_tpu.services import freedb as ref_freedb
from audiotools_tpu.services import lookup as ref_lookup
from audiotools_tpu.services import musicbrainz as ref_musicbrainz
from audiotools_tpu_torch import cdio, dispatch, pcm
from audiotools_tpu_torch.audiofile import MetaData, read_sheet
from audiotools_tpu_torch.formats.flac import FlacAudio
from audiotools_tpu_torch.services import (accuraterip, freedb, lookup,
                                           musicbrainz)
from torch_disc_helpers import (CannedServer, accuraterip_record,
                                choices_fields, make_image,
                                metadata_fields, musicbrainz_xml,
                                no_socket, xmcd)

SERVICES = [(freedb, ref_freedb), (musicbrainz, ref_musicbrainz),
            (accuraterip, ref_accuraterip)]


class _Inner:
    def __init__(self, last):
        self._last = last

    def last_sector(self):
        return self._last


class FakeCDDA:
    """what a disc ID reads of a CDDA: track_offsets() and
    .cdda.last_sector()"""

    def __init__(self, lengths, lead_in=0):
        self.pairs = []
        pos = lead_in
        for length in lengths:
            self.pairs.append((pos, length))
            pos += length
        self.cdda = _Inner(pos - 1)

    def __len__(self):
        return len(self.pairs)

    def track_offsets(self):
        return list(self.pairs)


def layouts():
    """seeded layouts: 1, 2, 5, 13 and 99 tracks of 1 to 30,000 sectors,
    one of them after a gap"""
    rng = np.random.default_rng(21)
    out = []
    for (count, lead_in) in ((1, 0), (2, 0), (5, 0), (13, 33), (99, 0)):
        out.append(FakeCDDA([int(n) for n in rng.integers(1, 30000, count)],
                            lead_in))
    return out


LAYOUTS = layouts()


@pytest.fixture
def server(monkeypatch):
    served = CannedServer()
    monkeypatch.setattr(urllib.request, "urlopen", served.urlopen)
    monkeypatch.setattr(socket, "create_connection", no_socket)
    return served


@pytest.mark.parametrize("layout", range(len(LAYOUTS)))
@pytest.mark.parametrize("service", range(len(SERVICES)))
def test_disc_ids_are_the_references(layout, service):
    (port, ref) = SERVICES[service]
    cdda = LAYOUTS[layout]
    (got, want) = (port.disc_id(cdda), ref.disc_id(cdda))
    assert str(got) == str(want)
    assert repr(got) == repr(want)
    if port is freedb:
        assert int(got) == int(want)
    if port is accuraterip:
        assert (got.id1(), got.id2(), got.freedb_disc_id(),
                got.track_numbers()) == (want.id1(), want.id2(),
                                         want.freedb_disc_id(),
                                         want.track_numbers())


class _Named:
    def __init__(self, name):
        self.name = name

    def __str__(self):
        return self.name


PARSER_REPLIES = {
    "multi-disc": (musicbrainz_xml(["THE-DISC-ID"], 3), _Named("THE-DISC-ID")),
    "no-disc-id": (musicbrainz_xml(["THE-DISC-ID"], 3), None),
    "matching-medium": (musicbrainz_xml(["A-DISC", "THE-DISC-ID"], 2),
                        _Named("THE-DISC-ID")),
    "non-matching": (musicbrainz_xml(["THE-DISC-ID"], 3),
                     _Named("NO-SUCH-DISC")),
    "garbage": ("<<not xml", _Named("THE-DISC-ID")),
    "empty-release": ('<metadata xmlns="http://musicbrainz.org/ns/mmd-2.0#">'
                      '<release><title>T</title><medium-list count="1">'
                      '<medium><track-list/></medium></medium-list>'
                      '</release></metadata>', None),
}


@pytest.mark.parametrize("case", sorted(PARSER_REPLIES))
def test_parse_musicbrainz_xml_is_the_references(case):
    (reply, disc_id) = PARSER_REPLIES[case]
    for track_count in (3, 5):
        got = lookup.parse_musicbrainz_xml(reply, track_count, disc_id)
        want = ref_lookup.parse_musicbrainz_xml(reply, track_count, disc_id)
        assert choices_fields(got) == choices_fields(want)
    if case in ("multi-disc", "matching-medium"):
        assert got[0][0].album_number == 2 and got[0][0].album_total == 2
        assert got[0][1].artist_name == "Gamma"
    if case == "garbage":
        assert got == []


XMCD_REPLIES = {
    "entry": xmcd(4),
    "no-artist": xmcd(2).replace("Canned Artist / ", ""),
    "title-only": "DTITLE=A / B\nTTITLE0=x\n",
    "garbage": "200 no such entry here\n",
    "few-titles": xmcd(2),
}


@pytest.mark.parametrize("case", sorted(XMCD_REPLIES))
def test_parse_xmcd_is_the_references(case):
    reply = XMCD_REPLIES[case]
    for track_count in (1, 4):
        got = lookup.parse_xmcd(reply, track_count)
        want = ref_lookup.parse_xmcd(reply, track_count)
        if want is None:
            assert got is None
        else:
            assert [metadata_fields(m) for m in got] == \
                [metadata_fields(m) for m in want]


@pytest.mark.parametrize("case", ["match", "mismatch", "truncated",
                                  "unreachable", "other-disc-only"])
@pytest.mark.parametrize("service", range(len(SERVICES)))
def test_perform_lookup_asks_and_answers_as_the_reference(server, service,
                                                          case):
    (port, ref) = SERVICES[service]
    cdda = LAYOUTS[2]
    (port_id, ref_id) = (port.disc_id(cdda), ref.disc_id(cdda))
    kind = port.__name__.rsplit(".", 1)[-1]
    if kind == "accuraterip":
        entries = [(i + 3, 0x1000 + i, 0xABC0 + i) for i in range(5)]
        reply = {"match": accuraterip_record(port_id, entries),
                 "mismatch": accuraterip_record(port_id, [(7, 1, 2)] * 5),
                 "truncated": accuraterip_record(port_id, entries)[:-13],
                 "unreachable": None,
                 "other-disc-only": struct.pack("<BIII", 1, 4, 5, 6) +
                 struct.pack("<BII", 1, 2, 3)}[case]
    elif kind == "freedb":
        reply = {"match": xmcd(5), "mismatch": "202 No match found\n",
                 "truncated": xmcd(5)[:40], "unreachable": None,
                 "other-disc-only": "211 close matches\n"}[case]
    else:
        reply = {"match": musicbrainz_xml([str(port_id)], 5),
                 "mismatch": musicbrainz_xml(["X"], 5),
                 "truncated": musicbrainz_xml([str(port_id)], 5)[:200],
                 "unreachable": None,
                 "other-disc-only": "<metadata/>"}[case]
    server.replies[kind] = reply
    got = port.perform_lookup(port_id)
    want = ref.perform_lookup(ref_id)
    assert got == want
    assert len(server.urls) == 2 and server.urls[0] == server.urls[1]
    if kind == "accuraterip" and case == "truncated":
        # the record is cut inside its fourth entry: three read
        assert [len(got[n]) for n in range(1, 6)] == [1, 1, 1, 0, 0]
    if case == "unreachable":
        assert got in ("", {n: [] for n in range(1, 6)})


def test_perform_lookup_passes_the_server_and_port(server):
    for (port, ref) in SERVICES:
        kind = port.__name__.rsplit(".", 1)[-1]
        (port_id, ref_id) = (port.disc_id(LAYOUTS[1]),
                             ref.disc_id(LAYOUTS[1]))
        port.perform_lookup(port_id, "host.test", 8080)
        ref.perform_lookup(ref_id, "host.test", 8080)
        assert server.urls[-1] == server.urls[-2]
        assert server.urls[-1].startswith("http://host.test:8080/")
        assert CannedServer.kind(server.urls[-1]) == kind


# ---------------------------------------------------------------------------
# the five lookup functions over one disc, its rips and its sheet

LENGTHS = [40, 25, 60]


@pytest.fixture(scope="module")
def disc(tmp_path_factory):
    """a 3-track cue/bin image, each track as an untagged FLAC file and
    as one tagged with its number, written by the port on the CPU"""
    base = str(tmp_path_factory.mktemp("disc"))
    (cue, arr) = make_image(base, LENGTHS)
    paths = []
    tagged = []
    start = 0
    for (i, length) in enumerate(LENGTHS):
        frames = arr[start * 588:(start + length) * 588]
        start += length
        path = os.path.join(base, "t%d.flac" % (i,))
        FlacAudio.from_pcm(path, pcm.reader_from_array(frames, 16),
                           device="cpu")
        paths.append(path)
        path = os.path.join(base, "n%d.flac" % (i,))
        FlacAudio.from_pcm(path, pcm.reader_from_array(frames, 16),
                           device="cpu").set_metadata(
                               MetaData(track_number=3 - i))
        tagged.append(path)
    return (cue, paths, tagged)


def canned(server, port_id_mb, count):
    server.replies.update(freedb=xmcd(count),
                          musicbrainz=musicbrainz_xml([port_id_mb], count))


OPTION_SETS = [{}, {"use_musicbrainz": False}, {"use_freedb": False},
               {"use_musicbrainz": False, "use_freedb": False},
               {"musicbrainz_server": "mb.test", "musicbrainz_port": 81,
                "freedb_server": "fdb.test", "freedb_port": 82}]


@pytest.mark.parametrize("options", range(len(OPTION_SETS)))
def test_metadata_lookup_is_the_references(disc, server, options):
    (cue, _paths, _tagged) = disc
    kwargs = OPTION_SETS[options]
    (port_cdda, ref_cdda) = (cdio.CDDA(cue), ref_cdio.CDDA(cue))
    canned(server, str(musicbrainz.disc_id(port_cdda)), 3)
    got = lookup.metadata_lookup(port_cdda, **kwargs)
    urls = list(server.urls)
    want = ref_lookup.metadata_lookup(ref_cdda, **kwargs)
    assert choices_fields(got) == choices_fields(want)
    assert urls == server.urls[len(urls):]
    expected = (2 if kwargs.get("use_musicbrainz", True) else 0) + \
        (1 if kwargs.get("use_freedb", True) else 0) + 1
    assert len(got) == expected
    port_cdda.close()
    ref_cdda.close()


@pytest.mark.parametrize("files", ["untagged", "tagged"])
@pytest.mark.parametrize("options", range(len(OPTION_SETS)))
def test_track_metadata_lookup_is_the_references(disc, server, options,
                                                 files):
    (_cue, paths, tagged) = disc
    names = paths if files == "untagged" else tagged
    kwargs = OPTION_SETS[options]
    canned(server, "ANY", 3)
    got = lookup.track_metadata_lookup(
        dispatch.open_files(names, sorted=False, device="cpu"), **kwargs)
    urls = list(server.urls)
    want = ref_lookup.track_metadata_lookup(
        ref_open_files(names, sorted=False), **kwargs)
    assert choices_fields(got) == choices_fields(want)
    assert urls == server.urls[len(urls):]


@pytest.mark.parametrize("options", range(len(OPTION_SETS)))
def test_sheet_metadata_lookup_is_the_references(disc, server, options):
    (cue, _paths, _tagged) = disc
    kwargs = OPTION_SETS[options]
    canned(server, "ANY", 3)
    total = sum(LENGTHS) * 588
    got = lookup.sheet_metadata_lookup(read_sheet(cue), total, 44100,
                                       **kwargs)
    urls = list(server.urls)
    want = ref_lookup.sheet_metadata_lookup(ref_read_sheet(cue), total,
                                            44100, **kwargs)
    assert choices_fields(got) == choices_fields(want)
    assert urls == server.urls[len(urls):]


@pytest.mark.parametrize("reply", ["match", "truncated", "unreachable"])
@pytest.mark.parametrize("files", ["untagged", "tagged", "none"])
def test_accuraterip_lookup_is_the_references(disc, server, files, reply):
    (_cue, paths, tagged) = disc
    names = {"untagged": paths, "tagged": tagged, "none": []}[files]
    port_tracks = dispatch.sorted_tracks(
        dispatch.open_files(names, device="cpu"))
    ref_tracks = ref_open_files(names)
    if names:
        frames = [t.cd_frames() for t in port_tracks]
        assert frames == [t.cd_frames() for t in ref_tracks]
        offsets = list(np.cumsum([0] + frames[:-1]))
        numbers = [t.get_metadata().track_number if files == "tagged"
                   else i + 1 for (i, t) in enumerate(port_tracks)]
        ar_id = accuraterip.DiscID(
            numbers, offsets, sum(frames),
            freedb.DiscID([o + 150 for o in offsets], sum(frames),
                          len(frames)))
        record = accuraterip_record(ar_id, [(4, 10, 20), (5, 11, 21),
                                            (6, 12, 22)])
        server.replies["accuraterip"] = {
            "match": record, "truncated": record[:-5],
            "unreachable": None}[reply]
    got = lookup.accuraterip_lookup(port_tracks)
    want = ref_lookup.accuraterip_lookup(ref_tracks)
    assert got == want
    if names and reply == "match":
        assert sorted(len(v) for v in got.values()) == [1, 1, 1]
    assert len(server.urls) == (2 if names else 0)


@pytest.mark.parametrize("reply", ["match", "unreachable"])
def test_accuraterip_sheet_lookup_is_the_references(disc, server, reply):
    (cue, _paths, _tagged) = disc
    total = sum(LENGTHS) * 588
    sheet = read_sheet(cue)
    offsets = [int(t.index(1).offset() * 75) for t in sheet.tracks()]
    ar_id = accuraterip.DiscID(
        [1, 2, 3], offsets, sum(LENGTHS),
        freedb.DiscID([o + 150 for o in offsets], sum(LENGTHS), 3))
    server.replies["accuraterip"] = (
        accuraterip_record(ar_id, [(1, 2, 3)] * 3) if reply == "match"
        else None)
    got = lookup.accuraterip_sheet_lookup(sheet, total, 44100)
    want = ref_lookup.accuraterip_sheet_lookup(ref_read_sheet(cue), total,
                                               44100)
    assert got == want
    assert got == ({n: [(1, 2, 3)] for n in (1, 2, 3)} if reply == "match"
                   else {n: [] for n in (1, 2, 3)})
    assert server.urls[0] == server.urls[1]
