"""The port's ``cdio`` against the reference's, on cue/bin, toc/bin and
NRG images built here (as ``tests/test_cdio.py`` builds them): the
sector API, the track offsets and lengths, the disc IDs, and
``CDTrackReader``'s frames at read offsets on both sides of the
disc's edges."""

import os

import numpy as np
import pytest

from audiotools_tpu import cdio as ref_cdio
from audiotools_tpu_torch import cdio
from torch_disc_helpers import make_image, make_nrg, make_toc

LENGTHS = [40, 25, 60, 1]
BUILDERS = {"cue": make_image, "toc": make_toc, "nrg": make_nrg}
# read offsets in PCM frames; the last two reach past the disc's end
OFFSETS = [-588, -1, 0, 6, 667, 588 * 30, 588 * 200]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """each kind of image of one disc: {kind: path}, and its samples"""
    out = {}
    arr = None
    for (kind, build) in BUILDERS.items():
        base = str(tmp_path_factory.mktemp(kind))
        (out[kind], arr) = build(base, LENGTHS)
    return (out, arr)


def drain(reader, chunk):
    pieces = []
    while True:
        framelist = reader.read(chunk)
        if framelist.frames == 0:
            break
        assert framelist.bits_per_sample == 16
        pieces.append(np.asarray(framelist.samples))
    return np.concatenate(pieces) if pieces else np.zeros((0, 2), np.int32)


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_sector_api_is_the_references(images, kind):
    (paths, arr) = images
    (got, want) = (cdio.identify_cdrom(paths[kind]),
                   ref_cdio.identify_cdrom(paths[kind]))
    assert type(got).__name__ == type(want).__name__
    assert got.total_tracks() == want.total_tracks() == len(LENGTHS)
    for n in range(1, len(LENGTHS) + 1):
        assert got.track_offsets(n) == want.track_offsets(n)
        assert got.track_lengths(n) == want.track_lengths(n) == LENGTHS[n - 1]
    assert (got.first_sector(), got.last_sector(),
            got.length_in_seconds()) == (want.first_sector(),
                                         want.last_sector(),
                                         want.length_in_seconds())
    for sector in (0, 1, 39, 40, sum(LENGTHS) - 1, sum(LENGTHS),
                   sum(LENGTHS) + 5, -3):
        assert got.seek(sector) == want.seek(sector)
        data = got.read_sector()
        assert data == want.read_sector()
        if 0 <= sector < sum(LENGTHS):
            assert np.array_equal(
                np.frombuffer(data, "<i2").reshape(-1, 2),
                arr[sector * 588:(sector + 1) * 588])
    got.set_speed(4)
    got.close()
    want.close()


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_cdda_and_its_disc_ids_are_the_references(images, kind):
    (paths, _arr) = images
    (got, want) = (cdio.CDDA(paths[kind], speed=8),
                   ref_cdio.CDDA(paths[kind], speed=8))
    assert len(got) == len(want)
    assert got.track_offsets() == want.track_offsets()
    assert got.length_in_seconds() == want.length_in_seconds()
    for name in ("freedb_disc_id", "musicbrainz_disc_id",
                 "accuraterip_disc_id"):
        assert str(getattr(got, name)()) == str(getattr(want, name)())
    assert [r.track_number for r in got] == list(range(1, len(LENGTHS) + 1))
    for number in (0, len(LENGTHS) + 1):
        with pytest.raises(IndexError):
            got[number]
    got.close()
    want.close()


@pytest.mark.parametrize("chunk", [1, 4096, 65536])
@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_track_reader_frames_are_the_references(images, kind, offset,
                                                chunk):
    (paths, arr) = images
    got_cdda = cdio.CDDA(paths[kind])
    want_cdda = ref_cdio.CDDA(paths[kind])
    disc = np.concatenate([np.zeros((588 * 300, 2), np.int32), arr,
                           np.zeros((588 * 300, 2), np.int32)])
    tracks = range(1, len(LENGTHS) + 1) if chunk != 1 else (2, 4)
    for number in tracks:
        got = drain(cdio.CDTrackReader(got_cdda.cdda, number, offset), chunk)
        want = drain(ref_cdio.CDTrackReader(want_cdda.cdda, number, offset),
                     chunk)
        assert np.array_equal(got, want), number
        # the shifted window, silence past either end of the disc
        start = 588 * (sum(LENGTHS[:number - 1]) + 300) + offset
        assert np.array_equal(
            got, disc[start:start + 588 * LENGTHS[number - 1]]), number
    got_cdda.close()
    want_cdda.close()


def test_track_reader_seek_and_close(images):
    (paths, arr) = images
    cdda = cdio.CDDA(paths["cue"])
    reader = cdda[2]
    assert reader.seek(100) == 100
    assert np.array_equal(reader.read(10).samples,
                          arr[40 * 588 + 100:40 * 588 + 110])
    assert reader.seek(-5) == 0
    assert reader.seek(10 ** 9) == 25 * 588
    assert reader.read(10).frames == 0
    reader.close()
    with pytest.raises(ValueError):
        reader.read(1)
    cdda.close()


def test_an_nrg_image_is_known_by_its_footer(images, tmp_path):
    (paths, _arr) = images
    renamed = str(tmp_path / "disc.image")
    with open(paths["nrg"], "rb") as f, open(renamed, "wb") as g:
        g.write(f.read())
    image = cdio.identify_cdrom(renamed)
    assert isinstance(image, cdio.NRGImage)
    image.close()


@pytest.mark.parametrize("case", ["not-an-image", "missing-bin",
                                  "missing-file"])
def test_what_is_no_image_raises_the_references_error(tmp_path, case):
    if case == "not-an-image":
        path = str(tmp_path / "x.raw")
        with open(path, "wb") as f:
            f.write(b"\x00" * 100)
    elif case == "missing-bin":
        path = str(tmp_path / "x.cue")
        with open(path, "w") as f:
            f.write('FILE "gone.bin" BINARY\n  TRACK 01 AUDIO\n'
                    '    INDEX 01 00:00:00\n')
    else:
        path = str(tmp_path / "none.cue")
    errors = []
    for module in (cdio, ref_cdio):
        with pytest.raises((IOError, ValueError)) as err:
            module.CDDA(path)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_the_track_log_is_the_references():
    counts = {2: 1, 3: 2, 6: 3, 7: 4, 10: 5, 11: 6, 12: 7}
    assert str(cdio.CDTrackLog(counts)) == str(ref_cdio.CDTrackLog(counts))
    assert str(cdio.CDTrackLog()) == str(ref_cdio.CDTrackLog())
    assert os.sep not in str(cdio.CDTrackLog())
