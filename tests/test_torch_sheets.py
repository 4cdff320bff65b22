"""Cue sheets, TOC files and FLAC cuesheets in the port against the
reference: ``audiofile.Sheet`` and its tracks and indexes,
``sheets/cue`` and ``sheets/toc`` (read and write), the CUESHEET block
``Flac_CUESHEET.converted`` builds, and ``trackcat --cue``,
``tracksplit`` (by an embedded CUESHEET or ``--cue``) and ``trackverify
--cue`` of ``audiotools_tpu_torch.cli`` with ``--devices cpu`` against
those of ``audiotools_tpu.cli``, in-process as ``tests/test_torch_cli.py``
runs them.  The album is three seeded CD titles (44.1 kHz, 0.1 s in
all), the second not a whole number of sectors (588 frames), so that
the sheets cut the joined stream off the titles' own boundaries.

Exact, but for two differences by design: ReplayGain's gains may
differ by 0.011 dB (the bound of
``test_torch_cli.py::test_replay_gain_agrees_with_the_reference``), and
``trackcat --cue`` writes a correct CUESHEET block where the
reference's counts 9 bytes an index point for the 12 it writes
(``test_torch_meta.py::test_set_metadata_keeps_a_cuesheet_with_index_points``).
"""

import io
import os
import shutil
import struct
import time
from fractions import Fraction

import numpy as np
import pytest
import torch

from audiotools_tpu import audiofile as ref_audiofile
from audiotools_tpu.bitstream import BitstreamRecorder as RefRecorder
from audiotools_tpu.formats import flac as ref_flac
from audiotools_tpu.sheets import cue as ref_cue
from audiotools_tpu.sheets import toc as ref_toc
from audiotools_tpu_torch import audiofile, dispatch, pcm
from audiotools_tpu_torch.formats import flac
from audiotools_tpu_torch.sheets import cue, toc
from test_sheets import THREE_TRACK_CUE, THREE_TRACK_TOC
from test_torch_cli import (CLOCK, REFERENCE_ENV, URWID_REQUIRED, as_port,
                            port_tool, read, ref_tool, signal, write_wave)
from test_torch_tags import apetag_and_frames
from torch_ui_helpers import canned_lookups, urwid_as

torch.set_num_threads(1)

CD = 44100
SECTOR = 588
# the titles' lengths in frames, the second off a sector boundary
TITLES = [SECTOR * 3, SECTOR * 2 + 100, SECTOR * 3]
SOURCES = ["src/t1.wav", "src/t2.wav", "src/t3.wav"]
GAIN_DB = 0.011

ALBUM_CUE = """REM GENRE "Test"
CATALOG 4006381333931
FILE "album.wav" WAVE
  TRACK 01 AUDIO
    TITLE "One"
    ISRC USRC17607839
    INDEX 01 00:00:00
  TRACK 02 AUDIO
    FLAGS DCP
    INDEX 00 00:00:02
    INDEX 01 00:00:03
  TRACK 03 AUDIO
    INDEX 01 00:00:05
    INDEX 02 00:00:06
"""

ALBUM_TOC = """CD_DA
CATALOG "4006381333931"

TRACK AUDIO
ISRC "USRC17607839"
AUDIOFILE "album.wav" 0 00:00:03

TRACK AUDIO
AUDIOFILE "album.wav" 00:00:03 00:00:02

TRACK AUDIO
START 00:00:01
AUDIOFILE "album.wav" 00:00:05
INDEX 00:00:01
"""

# its last track starts past the album's end
SHORT_CUE = """FILE "album.wav" WAVE
  TRACK 01 AUDIO
    INDEX 01 00:00:00
  TRACK 02 AUDIO
    INDEX 01 00:01:00
"""

PREGAP_CUE = """FILE "a.wav" WAVE
  TRACK 01 AUDIO
    PREGAP 00:02:00
    INDEX 01 00:00:00
  TRACK 02 MODE1/2352
    ISRC GBAYE0601477
    INDEX 00 01:02:70
    INDEX 01 01:04:00
    POSTGAP 00:01:00
"""

SHEET_TEXTS = {"three-cue": THREE_TRACK_CUE, "three-toc": THREE_TRACK_TOC,
               "album-cue": ALBUM_CUE, "album-toc": ALBUM_TOC,
               "short-cue": SHORT_CUE, "pregap-cue": PREGAP_CUE}

BAD_SHEETS = ["", "REM only a comment\n", "TRACK 01 AUDIO\n  INDEX 01 1:2\n",
              "  INDEX 01 00:00:00\n", 'TITLE "unterminated\n']


def both_sheets(name):
    """the port's and the reference's Sheet of a SHEET_TEXTS entry"""
    text = SHEET_TEXTS[name]
    if name.endswith("toc"):
        return (toc.read_tocfile_string(text),
                ref_toc.read_tocfile_string(text))
    return (cue.read_cuesheet_string(text), ref_cue.read_cuesheet_string(text))


def layout(sheet):
    """a Sheet's catalog and, for each track, its number, audio flag,
    ISRC and index points (number and offset)"""
    return (sheet.catalog(), [
        (t.number(), t.audio(), t.ISRC(),
         [(i.number(), i.offset()) for i in t.indexes()])
        for t in sheet.tracks()])


def odd_sheets():
    """a port and a reference Sheet whose offsets are not whole sectors"""
    def make(module):
        return module.Sheet([
            module.SheetTrack(1, [module.SheetIndex(1, Fraction(0))]),
            module.SheetTrack(2, [module.SheetIndex(0, Fraction(1000, CD)),
                                  module.SheetIndex(1, Fraction(1501, CD))],
                              ISRC="USRC17607839"),
            module.SheetTrack(3, [module.SheetIndex(1, Fraction(3001,
                                                                48000))])],
            catalog_number="4006381333931")
    return (make(audiofile), make(ref_audiofile))


@pytest.mark.parametrize("name", sorted(SHEET_TEXTS))
def test_sheets_read_as_the_references(name):
    (sheet, ref_sheet) = both_sheets(name)
    assert layout(sheet) == layout(ref_sheet)
    assert len(sheet) == len(ref_sheet)
    assert sheet.image_formatted() == ref_sheet.image_formatted()
    for total in (sum(TITLES), CD * 600):
        assert (list(sheet.pcm_lengths(total, CD)) ==
                list(ref_sheet.pcm_lengths(total, CD)))
    for track in ref_sheet.tracks():
        assert layout(audiofile.Sheet([sheet.track(track.number())])) == \
            layout(ref_audiofile.Sheet([track]))
    with pytest.raises(KeyError):
        sheet.track(99)
    assert sheet == both_sheets(name)[0]


@pytest.mark.parametrize("name", sorted(SHEET_TEXTS))
def test_sheets_write_as_the_references(name):
    """write_cuesheet and write_tocfile give the reference's text, which
    reads back to the same offsets"""
    (sheet, ref_sheet) = both_sheets(name)
    for (module, ref_module, write) in ((cue, ref_cue, "write_cuesheet"),
                                        (toc, ref_toc, "write_tocfile")):
        (out, ref_out) = (io.StringIO(), io.StringIO())
        getattr(module, write)(sheet, "album.wav", out)
        getattr(ref_module, write)(ref_sheet, "album.wav", ref_out)
        assert out.getvalue() == ref_out.getvalue()
    (out, ref_out) = (io.StringIO(), io.StringIO())
    cue.write_cuesheet(sheet, "album.wav", out)
    assert layout(cue.read_cuesheet_string(out.getvalue())) == layout(
        ref_cue.read_cuesheet_string(out.getvalue()))


@pytest.mark.parametrize("text", BAD_SHEETS)
def test_malformed_sheets_raise_as_the_references(text):
    """a sheet that the reference refuses, the port refuses with a
    SheetException; one it reads, the port reads alike"""
    outcomes = []
    for (module, exception) in ((cue, audiofile.SheetException),
                                (ref_cue, ref_audiofile.SheetException)):
        try:
            outcomes.append(layout(module.read_cuesheet_string(text)))
        except exception as err:
            outcomes.append(("raised", str(err)))
    assert outcomes[0] == outcomes[1]
    with pytest.raises(audiofile.SheetException):
        toc.read_tocfile_string(text)


def test_read_sheet_takes_a_toc_then_a_cue(tmp_path):
    for name in ("album-cue", "album-toc"):
        path = str(tmp_path / name)
        with open(path, "w") as f:
            f.write(SHEET_TEXTS[name])
        assert layout(audiofile.read_sheet(path)) == layout(
            ref_audiofile.read_sheet(path))
    path = str(tmp_path / "bad")
    with open(path, "w") as f:
        f.write("REM nothing\n")
    with pytest.raises(audiofile.SheetException):
        audiofile.read_sheet(path)


@pytest.mark.parametrize("stamp", ["00:00:00", "01:02:03", "79:59:74",
                                   "0", "4711"])
def test_timestamps_are_the_references(stamp):
    sectors = audiofile.parse_timestamp(stamp)
    assert sectors == ref_audiofile.parse_timestamp(stamp)
    assert (audiofile.build_timestamp(sectors) ==
            ref_audiofile.build_timestamp(sectors))


def test_sheets_off_whole_sectors_are_the_references():
    """index points off the sector grid: the lengths truncate to whole
    frames alike, and the cue text truncates to whole sectors alike"""
    (sheet, ref_sheet) = odd_sheets()
    assert layout(sheet) == layout(ref_sheet)
    for total in (sum(TITLES), 9999):
        assert (list(sheet.pcm_lengths(total, CD)) ==
                list(ref_sheet.pcm_lengths(total, CD)))
    (out, ref_out) = (io.StringIO(), io.StringIO())
    cue.write_cuesheet(sheet, "a.wav", out)
    ref_cue.write_cuesheet(ref_sheet, "a.wav", ref_out)
    assert out.getvalue() == ref_out.getvalue()


def ref_body(block):
    recorder = RefRecorder(False)
    block.build(recorder)
    return recorder.data()


@pytest.mark.parametrize("name", ["album-cue", "album-toc", "three-cue",
                                  "pregap-cue", "odd"])
def test_flac_cuesheet_converted_is_the_references_block(name):
    """the CUESHEET body of a Sheet equals the reference's byte for
    byte; its size is the body's (the reference's is 3 bytes an index
    point short); it reads back to the sheet's layout"""
    (sheet, ref_sheet) = (odd_sheets() if name == "odd"
                          else both_sheets(name))
    total = CD * 60 * 9
    block = flac.Flac_CUESHEET.converted(sheet, total, CD)
    ref_block = ref_flac.Flac_CUESHEET.converted(ref_sheet, total, CD)
    body = block.build()
    assert body == ref_body(ref_block)
    indexes = sum(len(t.index_points) for t in block.tracks)
    assert block.size() == len(body) == ref_block.size() + 3 * indexes
    again = flac.Flac_CUESHEET.parse(body)
    assert again == block
    assert (list(again.pcm_lengths(total, CD)) ==
            list(ref_block.pcm_lengths(total, CD)))
    assert [layout(audiofile.Sheet([t])) for t in again.sheet_tracks()] == [
        layout(ref_audiofile.Sheet([t])) for t in ref_block.sheet_tracks()]
    assert again.catalog() == ref_block.catalog()


def flac_headers(data):
    """{block type: (position, header word)} of a FLAC file's blocks, and
    where its frames start"""
    headers = {}
    pos = 4
    while True:
        (header,) = struct.unpack(">I", data[pos:pos + 4])
        headers[(header >> 24) & 0x7F] = (pos, header)
        pos += 4 + (header & 0xFFFFFF)
        if header >> 31:
            return (headers, pos)


def join(titles):
    return np.concatenate(titles, axis=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """every tool run, each case once by each side: a dict of case ->
    ((ref code, stdout, stderr), (port code, stdout, stderr)), the base
    directory and the titles' samples"""
    base = tmp_path_factory.mktemp("sheets")
    out = {}
    titles = [signal(k + 1, n, CD) for (k, n) in enumerate(TITLES)]
    with pytest.MonkeyPatch.context() as mp:
        for (key, value) in REFERENCE_ENV.items():
            mp.setenv(key, value)
        mp.setattr(time, "time", lambda: CLOCK)
        mp.chdir(base)
        for directory in ("src", "ref", "port"):
            os.makedirs(directory)
        for (path, title) in zip(SOURCES, titles):
            write_wave(path, title, CD)
        write_wave("src/r8k.wav", signal(4, 800, 8000), 8000)
        for (name, text) in SHEET_TEXTS.items():
            with open(name.replace("-", "."), "w") as f:
                f.write(text)
        with open("bad.cue", "w") as f:
            f.write("REM no tracks\n")

        def both(case, name, ref_args, port_args=None):
            out[case] = (ref_tool(name, *ref_args),
                         port_tool(name, *(port_args or
                                           [as_port(a) for a in ref_args])))

        both("cat", "trackcat", ["-t", "flac", "-o", "ref/cat.flac"] +
             SOURCES)
        both("cat-cue", "trackcat", ["-t", "flac", "--cue", "album.cue",
                                     "-o", "ref/cat-cue.flac"] + SOURCES)
        both("cat-toc", "trackcat", ["-t", "flac", "--cue", "album.toc",
                                     "-o", "ref/cat-toc.flac"] + SOURCES)
        both("cat-wavpack", "trackcat", ["-t", "wavpack", "--cue",
                                         "album.cue", "-o", "ref/cat.wv"] +
             SOURCES)
        both("cat-rates", "trackcat", ["-t", "flac", "-o", "ref/x.flac",
                                       "src/t1.wav", "src/r8k.wav"])
        both("cat-bad-cue", "trackcat", ["-t", "flac", "--cue", "bad.cue",
                                         "-o", "ref/bad.flac"] + SOURCES)

        # the split's sources: the port's joined file with its CUESHEET
        # and tags, the same without them, and one whose CUESHEET is off
        # the sector grid
        shutil.copy("port/cat-cue.flac", "src/album.flac")
        flac.FlacAudio("src/album.flac", "cpu").set_metadata(
            audiofile.MetaData(album_name="Àlbum", artist_name="Ärtïst",
                               year="2026", track_name="dropped"))
        shutil.copy("port/cat.flac", "src/plain.flac")
        shutil.copy("port/cat.flac", "src/odd.flac")
        flac.FlacAudio("src/odd.flac", "cpu").set_cuesheet(odd_sheets()[0])
        for name in ("flac", "wavpack"):
            for (case, extra, source) in (
                    ("split-", [], "src/album.flac"),
                    ("split-cue-", ["--cue", "album.cue"], "src/plain.flac"),
                    ("split-rg-", ["--replay-gain"], "src/album.flac")):
                both(case + name, "tracksplit",
                     ["-t", name, "-j", "1", "-d", "ref/" + case + name] +
                     extra + [source])
        both("split-toc-flac", "tracksplit",
             ["-t", "flac", "--cue", "album.toc", "-j", "1", "-d",
              "ref/split-toc-flac", "src/album.flac"])
        both("split-odd-flac", "tracksplit",
             ["-t", "flac", "-j", "1", "-d", "ref/split-odd-flac",
              "src/odd.flac"])
        both("split-numbers-flac", "tracksplit",
             ["-t", "flac", "-j", "1", "--album-number", "2",
              "--album-total", "3", "--format",
              "%(album_track_number)s %(album_name)s %(track_total)d.%(suffix)s",
              "-d", "ref/split-numbers-flac", "src/album.flac"])
        both("split-no-sheet", "tracksplit",
             ["-t", "flac", "-d", "ref/none", "src/plain.flac"])
        both("split-bad-cue", "tracksplit",
             ["-t", "flac", "--cue", "bad.cue", "-d", "ref/none",
              "src/plain.flac"])
        for (case, sheet) in (("verify-cue", "album.cue"),
                              ("verify-toc", "album.toc"),
                              ("verify-short", "short.cue"),
                              ("verify-bad", "bad.cue")):
            both(case, "trackverify",
                 ["-j", "1", "--cue", sheet, "src/plain.flac"],
                 ["-j", "1", "--cue", sheet, "src/plain.flac"])
    return (base, out, titles)


def files_of(base, side, case):
    directory = os.path.join(str(base), side, case)
    return {name: read(os.path.join(directory, name))
            for name in sorted(os.listdir(directory))}


@pytest.mark.parametrize("case", ["cat", "cat-wavpack"])
def test_trackcat_writes_the_references_file(runs, case):
    (base, out, titles) = runs
    ((ref_code, ref_out, ref_err), (code, stdout, stderr)) = out[case]
    assert (code, ref_code) == (0, 0), stderr
    assert (stdout, stderr) == (ref_out, ref_err) == ("", "")
    name = {"cat": "cat.flac", "cat-wavpack": "cat.wv"}[case]
    assert (read(os.path.join(str(base), "port", name)) ==
            read(os.path.join(str(base), "ref", name)))
    joined = dispatch.open(os.path.join(str(base), "port", name), "cpu")
    assert np.array_equal(pcm.read_all(joined.to_pcm()), join(titles))
    assert joined.get_cuesheet() is None


@pytest.mark.parametrize("case,sheet", [("cat-cue", "album-cue"),
                                        ("cat-toc", "album-toc")])
def test_trackcat_cue_embeds_the_sheet(runs, case, sheet):
    """the port's file parses back whole, its CUESHEET the sheet's block
    and its layout, and decodes to the joined titles; the reference's
    file differs from it only where its CUESHEET length fault puts it:
    the CUESHEET and PADDING headers, and the head of the first frame,
    which its in-place rewrite overwrites"""
    (base, out, titles) = runs
    ((ref_code, ref_out, ref_err), (code, stdout, stderr)) = out[case]
    assert (code, ref_code, stdout, stderr) == (0, 0, ref_out, ref_err)
    path = os.path.join(str(base), "port", case + ".flac")
    track = flac.FlacAudio(path, "cpu")
    assert np.array_equal(pcm.read_all(track.to_pcm()), join(titles))
    track.verify()
    embedded = track.get_cuesheet()
    (port_sheet, ref_sheet) = both_sheets(sheet)
    assert embedded.build() == flac.Flac_CUESHEET.converted(
        port_sheet, sum(TITLES), CD).build()
    assert embedded == port_sheet
    assert [layout(audiofile.Sheet([t])) for t in embedded.sheet_tracks()] \
        == [layout(ref_audiofile.Sheet([t])) for t in ref_sheet.tracks()]

    assert_only_the_cuesheet_fault(
        read(path), read(os.path.join(str(base), "ref", case + ".flac")))


def assert_only_the_cuesheet_fault(data, ref_data):
    """``ref_data`` is ``data`` but for the reference's CUESHEET length
    fault: the CUESHEET header 3 bytes an index point short, the PADDING
    header as much too long, and as many zeros over the first frame"""
    (headers, frames) = flac_headers(data)
    (cue_at, cue_header) = headers[flac.Flac_CUESHEET.BLOCK_ID]
    (pad_at, pad_header) = headers[flac.Flac_PADDING.BLOCK_ID]
    embedded = flac.Flac_CUESHEET.parse(
        data[cue_at + 4:cue_at + 4 + (cue_header & 0xFFFFFF)])
    assert cue_header & 0xFFFFFF == embedded.size() == len(embedded.build())
    short = 3 * sum(len(t.index_points) for t in embedded.tracks)
    assert len(ref_data) == len(data)
    assert struct.unpack(">I", ref_data[cue_at:cue_at + 4])[0] == \
        cue_header - short
    assert struct.unpack(">I", ref_data[pad_at:pad_at + 4])[0] == \
        pad_header + short
    assert ref_data[frames:frames + short] == b"\x00" * short
    differ = [i for i in range(len(data)) if data[i] != ref_data[i]]
    assert differ
    assert all(cue_at <= i < cue_at + 4 or pad_at <= i < pad_at + 4 or
               frames <= i < frames + short for i in differ)


@pytest.mark.parametrize("case", ["cat-rates", "cat-bad-cue",
                                  "split-no-sheet", "split-bad-cue"])
def test_errors_are_the_references(runs, case):
    (_base, out, _titles) = runs
    ((ref_code, ref_out, ref_err), (code, stdout, stderr)) = out[case]
    assert (code, stdout, stderr) == (ref_code, ref_out, as_port(ref_err))
    assert code == 1 and stderr.startswith("*** Error: ")


SPLITS = ["split-flac", "split-wavpack", "split-cue-flac",
          "split-cue-wavpack", "split-toc-flac", "split-odd-flac",
          "split-numbers-flac"]


@pytest.mark.parametrize("case", SPLITS)
def test_tracksplit_writes_the_references_files(runs, case):
    """the same names (the sheet's numbers, the source's album, artist
    and year, the default or given template), the same lines, the same
    bytes; the tracks join back to the source"""
    (base, out, titles) = runs
    ((ref_code, ref_out, ref_err), (code, stdout, stderr)) = out[case]
    assert (code, ref_code) == (0, 0), stderr
    assert (stdout, stderr) == (as_port(ref_out), as_port(ref_err))
    want = files_of(base, "ref", case)
    got = files_of(base, "port", case)
    assert len(want) == 3 and sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    pieces = [pcm.read_all(dispatch.open(os.path.join(
        str(base), "port", case, name), "cpu").to_pcm()) for name in sorted(
        want, key=lambda n: dispatch.open(os.path.join(
            str(base), "port", case, n), "cpu").get_metadata().track_number)]
    assert np.array_equal(join(pieces), join(titles))


@pytest.mark.parametrize("name", ["flac", "wavpack"])
def test_tracksplit_replay_gain_agrees_with_the_reference(runs, name):
    """the same audio and names; the gains within GAIN_DB of the
    reference's, the peaks equal"""
    (base, out, _titles) = runs
    case = "split-rg-" + name
    ((ref_code, ref_out, ref_err), (code, stdout, stderr)) = out[case]
    assert (code, ref_code) == (0, 0), stderr
    assert (stdout, stderr) == (as_port(ref_out), as_port(ref_err))
    assert "ReplayGain added" in stderr
    want = files_of(base, "ref", case)
    assert sorted(files_of(base, "port", case)) == sorted(want)
    for file_name in want:
        (port_path, ref_path) = (
            os.path.join(str(base), side, case, file_name)
            for side in ("port", "ref"))
        if name == "wavpack":
            (ref_items, ref_frames) = apetag_and_frames(ref_path)
            (items, frames) = apetag_and_frames(port_path)
            assert frames == ref_frames
            ref_rg = ref_audiofile.ReplayGain(
                *(ref_items["replaygain_%s" % (k,)].split(" ")[0] for k in (
                    "track_gain", "track_peak", "album_gain", "album_peak")))
        else:
            (blocks, frames) = flac_blocks_and_frames(port_path)
            (ref_blocks, ref_frames) = flac_blocks_and_frames(ref_path)
            assert frames == ref_frames
            for block_type in (0, 3, 5):  # STREAMINFO, SEEKTABLE, CUESHEET
                assert blocks.get(block_type) == ref_blocks.get(block_type)
            ref_rg = ref_flac.FlacAudio(ref_path).replay_gain()
        rg = dispatch.open(port_path, "cpu").replay_gain()
        assert abs(rg.track_gain - float(ref_rg.track_gain)) <= GAIN_DB
        assert abs(rg.album_gain - float(ref_rg.album_gain)) <= GAIN_DB
        assert rg.track_peak == float(ref_rg.track_peak)
        assert rg.album_peak == float(ref_rg.album_peak)


def flac_blocks_and_frames(path):
    """{block type: [bodies]} and the frame bytes of a FLAC file"""
    data = read(path)
    (pos, last, blocks) = (4, 0, {})
    while not last:
        (last, block_type) = (data[pos] >> 7, data[pos] & 0x7F)
        size = int.from_bytes(data[pos + 1:pos + 4], "big")
        blocks.setdefault(block_type, []).append(data[pos + 4:pos + 4 + size])
        pos += 4 + size
    return (blocks, data[pos:])


@pytest.mark.parametrize("case,want_code", [
    ("verify-cue", 0), ("verify-toc", 0), ("verify-short", 1),
    ("verify-bad", 1)])
def test_trackverify_cue_is_the_references(runs, case, want_code):
    (_base, out, _titles) = runs
    ((ref_code, ref_out, ref_err), (code, stdout, stderr)) = out[case]
    assert code == ref_code == want_code
    assert (stdout, stderr) == (ref_out, ref_err)
    if want_code:
        assert stderr.startswith("*** Error: ")


def test_pcm_cat_and_split_round_trip():
    """PCMCat joins readers of differing read sizes, pcm_split cuts the
    join at any lengths (a zero and a short last among them)"""
    titles = [signal(k, n, CD) for (k, n) in enumerate((700, 1, 3000), 1)]
    joined = pcm.PCMCat([pcm.reader_from_array(t, 16, CD) for t in titles])
    assert (joined.sample_rate, joined.channels, joined.channel_mask,
            joined.bits_per_sample) == (CD, 2, 3, 16)
    everything = pcm.read_all(joined)
    assert np.array_equal(everything, join(titles))
    with pytest.raises(ValueError):
        pcm.PCMCat([pcm.reader_from_array(titles[0], 16, CD),
                    pcm.reader_from_array(titles[1], 16, 8000)])
    lengths = [1000, 0, 2000, 5000]
    parts = [pcm.read_all(r) for r in pcm.pcm_split(
        pcm.reader_from_array(everything, 16, CD), lengths)]
    assert [p.shape[0] for p in parts] == [1000, 0, 2000, 701]
    assert np.array_equal(join(parts), everything)
    limited = pcm.LimitedPCMReader(pcm.BufferedPCMReader(
        pcm.reader_from_array(everything, 16, CD)), 1234)
    assert np.array_equal(pcm.read_all(limited), everything[:1234])


@pytest.mark.parametrize("tool,args", [
    ("trackcat", ["-t", "flac", "-o", "x.flac"]),
    ("tracksplit", ["-t", "flac", "-d", "x", "--cue", "a.cue", "-j", "1"])])
@pytest.mark.parametrize("flag", ["-I", "-M"])
def test_interactive_and_lookup_are_refused(tmp_path, monkeypatch, tool,
                                            args, flag):
    """with urwid absent, the reference's trackcat and tracksplit look at
    -I only with -M: -I alone writes the files; with -M (the lookups
    unreachable) trackcat writes its file, then both exit 1 with the
    error.  The port gives the same exit codes, lines and files"""
    for (key, value) in REFERENCE_ENV.items():
        monkeypatch.setenv(key, value)
    flags = ["-I"] if flag == "-I" else ["-M", "-I"]
    results = {}
    with urwid_as(None), canned_lookups() as server:
        for (side, run) in (("ref", ref_tool), ("port", port_tool)):
            os.makedirs(str(tmp_path / side))
            monkeypatch.chdir(tmp_path / side)
            write_wave("a.wav", signal(1, 2 * 588, CD), CD)
            with open("a.cue", "w") as f:
                f.write('FILE "a.wav" WAVE\n  TRACK 01 AUDIO\n    INDEX 01 '
                        '00:00:00\n  TRACK 02 AUDIO\n    INDEX 01 00:00:01\n')
            start = len(server.urls)
            output = run(tool, *flags, *args, "a.wav")
            files = {}
            for (base, _dirs, names) in os.walk("."):
                for name in names:
                    files[os.path.join(base, name)] = read(
                        os.path.join(base, name))
            results[side] = (output, files, server.urls[start:])
    assert results["port"] == results["ref"]
    (code, _stdout, stderr) = results["port"][0]
    written = sorted(results["port"][1])
    if flag == "-I":
        assert code == 0
        assert written == (["./a.cue", "./a.wav", "./x.flac"]
                           if tool == "trackcat" else
                           ["./a.cue", "./a.wav", "./x/01 - .flac",
                            "./x/02 - .flac"])
    else:
        assert code == 1 and stderr.endswith(URWID_REQUIRED)
        assert len(results["port"][2]) == 2
        assert written == (["./a.cue", "./a.wav", "./x.flac"]
                           if tool == "trackcat" else ["./a.cue", "./a.wav"])


def test_default_environment_writes_the_references_files(tmp_path,
                                                         monkeypatch):
    """no ATPU_* variable set: trackcat --cue and its split take both
    packages' default FLAC routes (the quantized upload wire; the
    reference's JAX backend on the CPU) to the same bytes but the
    reference's CUESHEET fault, which the split does not carry"""
    for key in list(os.environ):
        if key.startswith("ATPU_"):
            monkeypatch.delenv(key)
    monkeypatch.chdir(tmp_path)
    for directory in ("src", "ref", "port"):
        os.makedirs(directory)
    for (path, n, k) in zip(SOURCES, TITLES, (5, 6, 7)):
        write_wave(path, signal(k, n, CD), CD)
    with open("album.cue", "w") as f:
        f.write(ALBUM_CUE)
    for (tool, args) in (
            ("trackcat", ["-t", "flac", "--cue", "album.cue", "-o",
                          "ref/cat.flac"] + SOURCES),
            ("tracksplit", ["-t", "flac", "-j", "1", "-d", "ref/split",
                            "port/cat.flac"])):
        if tool == "tracksplit":
            shutil.copy("port/cat.flac", "cat.flac")
            args = args[:-1] + ["cat.flac"]
        ref = ref_tool(tool, *args)
        port = port_tool(tool, *[as_port(a) for a in args])
        assert (ref[0], port[0]) == (0, 0), port[2]
        assert port[1] == as_port(ref[1])
    assert_only_the_cuesheet_fault(read("port/cat.flac"),
                                   read("ref/cat.flac"))
    names = sorted(os.listdir("ref/split"))
    assert len(names) == 3 and sorted(os.listdir("port/split")) == names
    for name in names:
        assert read(os.path.join("port/split", name)) == read(
            os.path.join("ref/split", name)), name
