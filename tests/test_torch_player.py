"""The port's playback (``audiotools_tpu_torch.player``) against the
reference's (``audiotools_tpu.player``) on the CPU.

The same file (0.5 s at 22.05 kHz, mono and stereo, 8, 16 and 24 bits
where the type takes them; TTA and WavPack written by the reference's
host encoders, which are quicker here than the port's plain loops, the
others by the port's classes on the CPU) is played through the threaded
``Player`` of both packages and, in mono, their synchronous
``AudioPlayer``, each into a capturing output of its package: the
frames, the buffer sizes, the states the players pass through and their
``progress()`` must be the same.  A buffer is what the decoder's
read(4096) returns: the reference's TTA decoder serves a whole TTA frame
a read where the port's serves the frames asked for, so TTA's buffers
are held to each decoder's own.  So must the volume
path, ``ReplayGainReader`` with ``os.urandom`` patched to the same bytes
for both, and ``CDPlayer`` over a cue/bin image.  A stop and a close in
the middle of a track must leave no thread of the player alive.
"""

import io
import threading
import time

import numpy as np
import pytest

from audiotools_tpu import dispatch as ref_dispatch
from audiotools_tpu import player as ref_player
from audiotools_tpu import replaygain as ref_replaygain
from audiotools_tpu.cdio import CDDA as RefCDDA
from audiotools_tpu.formats.tta import TrueAudio as RefTrueAudio
from audiotools_tpu.formats.wavpack import WavPackAudio as RefWavPackAudio
from audiotools_tpu.pcmstream import PCMReader as RefPCMReader
from audiotools_tpu_torch import dispatch, pcm, player, replaygain
from audiotools_tpu_torch.cdio import CDDA
from audiotools_tpu_torch.formats.flac import FlacAudio
from audiotools_tpu_torch.formats.m4a import ALACAudio
from audiotools_tpu_torch.formats.shn import ShortenAudio
from audiotools_tpu_torch.formats.tta import TrueAudio
from audiotools_tpu_torch.formats.wav import WaveAudio
from audiotools_tpu_torch.formats.wavpack import WavPackAudio
from torch_disc_helpers import make_image

RATE = 22050
FRAMES = RATE // 2
CLASSES = {"flac": FlacAudio, "alac": ALACAudio, "tta": TrueAudio,
           "wavpack": WavPackAudio, "shn": ShortenAudio, "wav": WaveAudio}
# the bits per sample each type's writer takes
WIDTHS = {"flac": (8, 16, 24), "alac": (16, 24), "tta": (8, 16, 24),
          "wavpack": (8, 16, 24), "shn": (8, 16), "wav": (8, 16, 24)}
CASES = [(name, bps, channels) for name in CLASSES for bps in WIDTHS[name]
         for channels in (1, 2)]
WAIT_S = 30
REFERENCE_WRITERS = {"tta": RefTrueAudio, "wavpack": RefWavPackAudio}
# the frame counts of each package's read(4096) of a case's file
PORT_READS = {"wavpack": [FRAMES]}
REFERENCE_READS = {"tta": [FRAMES], "wavpack": [FRAMES]}
EVEN_READS = [4096, 4096, FRAMES - 8192]


def samples(bps, channels, seed=5, frames=FRAMES):
    rng = np.random.default_rng(seed + bps + channels)
    t = np.arange(frames)[:, None]
    wave = 0.4 * np.sin(2 * np.pi * 440 * (1 + np.arange(channels)) * t /
                        RATE)
    arr = (wave + rng.normal(0, 0.05, (frames, channels))) * (
        1 << (bps - 1))
    return np.clip(arr, -(1 << (bps - 1)),
                   (1 << (bps - 1)) - 1).astype(np.int32)


def write(path, name, arr, bps):
    reader = pcm.reader_from_array(arr, bps, RATE)
    if name in REFERENCE_WRITERS:
        raw = pcm.FrameList._wrap(arr, bps).to_bytes(False, True)
        return REFERENCE_WRITERS[name].from_pcm(path, RefPCMReader(
            io.BytesIO(raw), RATE, arr.shape[1], reader.channel_mask, bps))
    if name == "wav":
        return WaveAudio.from_pcm(path, reader)
    return CLASSES[name].from_pcm(path, reader, device="cpu")


def capture_output(package, gate=None):
    """an output of ``package``'s AudioOutput that keeps each frame list
    it is given; with ``gate`` (a threading.Event), its first play waits
    until the gate opens"""

    class Capture(package.AudioOutput):
        NAME = "CAPTURE"

        def __init__(self):
            package.AudioOutput.__init__(self)
            self.frames = []
            self.formats = []
            self.entered = threading.Event()

        @classmethod
        def available(cls):
            return True

        def set_format(self, *args):
            package.AudioOutput.set_format(self, *args)
            self.formats.append(args)

        def play(self, framelist):
            self.entered.set()
            if gate is not None and not self.frames:
                gate.wait(WAIT_S)
            self.frames.append(np.array(framelist.samples))

    return Capture()


def wait_for(condition):
    deadline = time.time() + WAIT_S
    while not condition():
        assert time.time() < deadline
        time.sleep(0.002)


def threaded_run(package, track, volume=None, replay_gain=None):
    """plays ``track`` through ``package``'s Player, pausing after its
    first buffer: (states seen, progress at the pause, progress at the
    end, frames, buffer sizes, formats)"""
    gate = threading.Event()
    out = capture_output(package, gate)
    if volume is not None:
        out.set_volume(volume)
    p = package.Player(out)
    states = [p.state()]
    try:
        if replay_gain is not None:
            p.set_replay_gain(replay_gain)
        p.open(track)
        p.play()
        assert out.entered.wait(WAIT_S)
        states.append(p.state())
        p.pause()
        gate.set()
        wait_for(lambda: p.state() == package.PLAYER_PAUSED)
        states.append(p.state())
        paused = p.progress()
        p.play()
        wait_for(lambda: p.state() == package.PLAYER_STOPPED)
        states.append(p.state())
        done = p.progress()
    finally:
        p.close()
    return (states, paused, done, np.concatenate(out.frames),
            [f.shape[0] for f in out.frames], out.formats)


def sync_run(package, track, volume=None, replay_gain=None):
    """plays ``track`` through ``package``'s AudioPlayer: (the state and
    progress after each call, frames, buffer sizes, next-track calls)"""
    out = capture_output(package)
    if volume is not None:
        out.set_volume(volume)
    finished = []
    p = package.AudioPlayer(out, next_track_callback=lambda:
                            finished.append(1))
    if replay_gain is not None:
        p.set_replay_gain(replay_gain)
    p.set_audiofile(track)
    log = [(p.state(), p.progress())]
    p.play()
    log.append((p.state(), p.progress()))
    while p.state() == package.PLAYER_PLAYING:
        p.output_audio()
        log.append((p.state(), p.progress()))
        assert len(log) < 1000
    return (log, np.concatenate(out.frames), [f.shape[0] for f in out.frames],
            finished)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """each case's file, written once by the port: {case: (path,
    samples)}"""
    base = tmp_path_factory.mktemp("play")
    out = {}
    for (name, bps, channels) in CASES:
        path = str(base / ("%s-%d-%d.%s" % (name, bps, channels,
                                            CLASSES[name].SUFFIX)))
        arr = samples(bps, channels)
        write(path, name, arr, bps)
        out[(name, bps, channels)] = (path, arr)
    return out


@pytest.mark.parametrize("case", CASES, ids=["%s-%d-%d" % c for c in CASES])
def test_player_plays_the_references_frames(files, case):
    (path, arr) = files[case]
    port = threaded_run(player, dispatch.open(path, device="cpu"))
    ref = threaded_run(ref_player, ref_dispatch.open(path))
    (states, paused, done, frames, sizes, formats) = port
    assert np.array_equal(frames, arr)
    assert states == ref[0] == [player.PLAYER_STOPPED, player.PLAYER_PLAYING,
                                player.PLAYER_PAUSED, player.PLAYER_STOPPED]
    assert done == ref[2] == (FRAMES, FRAMES)
    assert np.array_equal(frames, ref[3])
    assert formats == ref[5]
    assert sizes == PORT_READS.get(case[0], EVEN_READS)
    assert ref[4] == REFERENCE_READS.get(case[0], EVEN_READS)
    assert paused == (sizes[0], FRAMES) and ref[1] == (ref[4][0], FRAMES)


MONO = [case for case in CASES if case[2] == 1]


@pytest.mark.parametrize("case", MONO, ids=["%s-%d-%d" % c for c in MONO])
def test_audio_player_plays_the_references_frames(files, case):
    (path, arr) = files[case]
    port = sync_run(player, dispatch.open(path, device="cpu"))
    ref = sync_run(ref_player, ref_dispatch.open(path))
    assert np.array_equal(port[1], arr)
    assert port[0] == ref[0]
    assert np.array_equal(port[1], ref[1])
    assert port[2] == ref[2] == [5512, 5512, 1]
    assert port[3] == ref[3] == [1]


@pytest.mark.parametrize("volume", [0.0, 0.25, 0.5, 0.999, 1.0])
@pytest.mark.parametrize("bps", [8, 16, 24])
def test_the_volume_path_is_the_references(files, bps, volume):
    (path, arr) = files[("flac", bps, 2)]
    port = threaded_run(player, dispatch.open(path, device="cpu"),
                        volume=volume)
    ref = threaded_run(ref_player, ref_dispatch.open(path), volume=volume)
    assert np.array_equal(port[3], ref[3])
    assert np.array_equal(port[3], (arr.astype(np.float64) *
                                    volume).astype(np.int32)
                          if volume < 1.0 else arr)
    sync_port = sync_run(player, dispatch.open(path, device="cpu"),
                         volume=volume)
    sync_ref = sync_run(ref_player, ref_dispatch.open(path), volume=volume)
    assert np.array_equal(sync_port[1], sync_ref[1])
    framelist = pcm.FrameList._wrap(arr, bps)
    assert np.array_equal(player._apply_volume(framelist, volume).samples,
                          ref_player._apply_volume(
                              ref_player.pcm.FrameList._wrap(arr, bps),
                              volume).samples)


def urandom_bytes(n):
    """the bytes both packages' ``os.urandom`` gives in these tests"""
    return ((np.arange(n, dtype=np.int64) * 2654435761 >> 7) &
            0xFF).astype(np.uint8).tobytes()


@pytest.mark.parametrize("gain,peak", [(-6.0, 0.5), (3.0, 0.2), (12.0, 0.9),
                                       (0.0, 0.0)])
@pytest.mark.parametrize("bps", [8, 16, 24])
def test_replay_gain_reader_is_the_references(monkeypatch, bps, gain, peak):
    monkeypatch.setattr("os.urandom", urandom_bytes)
    arr = samples(bps, 2, seed=11, frames=5000)
    port = replaygain.ReplayGainReader(pcm.reader_from_array(arr, bps, RATE),
                                       gain, peak)
    ref = ref_replaygain.ReplayGainReader(
        pcm.reader_from_array(arr, bps, RATE), gain, peak)
    assert port.multiplier == ref.multiplier
    for size in (1000, 4096, 4096):
        (a, b) = (port.read(size), ref.read(size))
        assert np.array_equal(a.samples, b.samples)
        assert a.bits_per_sample == b.bits_per_sample == bps
    assert port.read(10).frames == ref.read(10).frames == 0


@pytest.mark.parametrize("mode", ["track", "album"])
def test_players_apply_replay_gain_as_the_references(monkeypatch, tmp_path,
                                                     mode):
    monkeypatch.setattr("os.urandom", urandom_bytes)
    paths = []
    for (seed, scale) in ((1, 4), (2, 1)):
        path = str(tmp_path / ("%d.flac" % (seed,)))
        write(path, "flac", samples(16, 2, seed=seed) // scale, 16)
        paths.append(path)
    FlacAudio.add_replay_gain(paths, device="cpu")
    track = dispatch.open(paths[0], device="cpu")
    gain = track.replay_gain()
    assert gain is not None and gain.track_gain != gain.album_gain
    flag = {"track": player.RG_TRACK_GAIN, "album": player.RG_ALBUM_GAIN}[mode]
    port = threaded_run(player, track, replay_gain=flag)
    ref = threaded_run(ref_player, ref_dispatch.open(paths[0]),
                       replay_gain=flag)
    assert np.array_equal(port[3], ref[3])
    assert port[4] == ref[4] == [4096, 4096, FRAMES - 8192]
    sync_port = sync_run(player, dispatch.open(paths[0], device="cpu"),
                         replay_gain=flag)
    sync_ref = sync_run(ref_player, ref_dispatch.open(paths[0]),
                        replay_gain=flag)
    assert np.array_equal(sync_port[1], sync_ref[1])
    assert sync_port[0] == sync_ref[0]


def cd_run(package, cdda, numbers):
    out = capture_output(package)
    p = package.CDPlayer(cdda, out)
    played = []
    try:
        for number in numbers:
            p.open(number)
            p.play()
            wait_for(lambda: out.entered.is_set())
            wait_for(lambda: p.state() == package.PLAYER_STOPPED)
            played.append((p.progress(), sum(f.shape[0] for f in out.frames)))
            out.entered.clear()
    finally:
        p.close()
    return (played, np.concatenate(out.frames), [f.shape[0] for f in
                                                 out.frames])


def test_cd_player_plays_the_references_tracks(tmp_path):
    (cue, arr) = make_image(str(tmp_path), [20, 7, 13])
    port_cdda = CDDA(cue)
    ref_cdda = RefCDDA(cue)
    try:
        port = cd_run(player, port_cdda, [2, 1, 3])
        ref = cd_run(ref_player, ref_cdda, [2, 1, 3])
    finally:
        port_cdda.close()
        ref_cdda.close()
    assert port[0] == ref[0]
    assert port[2] == ref[2]
    assert np.array_equal(port[1], ref[1])
    (a, b) = (20 * 588, 27 * 588)
    assert np.array_equal(port[1], np.concatenate([arr[a:b], arr[:a],
                                                   arr[b:]]))


def player_threads():
    return {t for t in threading.enumerate()
            if t is not threading.main_thread()}


@pytest.mark.parametrize("how", ["stop", "close", "open"])
def test_stopping_mid_track_leaves_no_thread(files, monkeypatch, how):
    """after the first buffer the track is stopped (then the player
    closed), closed at once, or replaced by another track; no thread of
    the player is alive afterwards.  A queue of one frame list keeps the
    fill thread waiting in the middle of the track"""
    monkeypatch.setattr(player.ThreadedPCMReader, "QUEUE_SIZE", 1)
    (path, arr) = files[("flac", 16, 2)]
    before = player_threads()
    gate = threading.Event()
    out = capture_output(player, gate)
    p = player.Player(out)
    p.open(dispatch.open(path, device="cpu"))
    p.play()
    assert out.entered.wait(WAIT_S)
    assert len(player_threads() - before) == 2      # worker and fill thread
    if how == "stop":
        p.stop()
        gate.set()
        wait_for(lambda: p.state() == player.PLAYER_STOPPED)
        assert p.progress() == (0, FRAMES)
        assert len(player_threads() - before) == 1  # the worker alone
    elif how == "open":
        p.open(dispatch.open(path, device="cpu"))
        gate.set()
        wait_for(lambda: p.state() == player.PLAYER_STOPPED)
        assert p.progress() == (0, FRAMES)
    else:
        gate.set()
    p.close()
    assert not player_threads() - before
    assert np.array_equal(out.frames[0], arr[:4096])


def test_threaded_reader_close_joins_its_fill_thread():
    """the reader is closed only once its fill thread has returned from
    the read it was in"""
    events = []

    class SlowReader:
        sample_rate, channels, channel_mask, bits_per_sample = (8000, 1, 4,
                                                                16)

        def read(self, frames):
            events.append("read")
            time.sleep(0.01)
            events.append("read done")
            return pcm.FrameList._wrap(np.zeros((frames, 1), np.int32), 16)

        def close(self):
            events.append("close")

    reader = player.ThreadedPCMReader(SlowReader())
    assert reader.read(4096).frames == 4096
    reader.close()
    assert events[-1] == "close" and events[-2] == "read done"
    assert not reader.__thread__.is_alive()


def test_threaded_reader_passes_a_read_error_on():
    class FailingReader:
        sample_rate, channels, channel_mask, bits_per_sample = (8000, 1, 4,
                                                                16)

        def read(self, frames):
            raise ValueError("bad stream")

        def close(self):
            pass

    reader = player.ThreadedPCMReader(FailingReader())
    with pytest.raises(ValueError, match="bad stream"):
        reader.read(4096)
    assert reader.read(4096).frames == 0
    reader.close()


def test_the_outputs_are_the_references():
    assert [cls.NAME for cls in player.AUDIO_OUTPUT] == [
        cls.NAME for cls in ref_player.AUDIO_OUTPUT] == [
        "CoreAudio", "PulseAudio", "ALSA", "OSS", "NULL"]
    for (port_cls, ref_cls) in zip(player.AUDIO_OUTPUT,
                                   ref_player.AUDIO_OUTPUT):
        assert port_cls.available() == ref_cls.available()
    assert ([cls.NAME for cls in player.available_outputs()] ==
            [cls.NAME for cls in ref_player.available_outputs()])
    assert (player.open_output("NULL").NAME ==
            ref_player.open_output("NULL").NAME == "NULL")
    with pytest.raises(ValueError):
        player.open_output("NO SUCH OUTPUT")
    assert (player.PLAYER_STOPPED, player.PLAYER_PAUSED,
            player.PLAYER_PLAYING) == (ref_player.PLAYER_STOPPED,
                                       ref_player.PLAYER_PAUSED,
                                       ref_player.PLAYER_PLAYING)
    assert (player.RG_NO_REPLAYGAIN, player.RG_TRACK_GAIN,
            player.RG_ALBUM_GAIN) == (ref_player.RG_NO_REPLAYGAIN,
                                      ref_player.RG_TRACK_GAIN,
                                      ref_player.RG_ALBUM_GAIN)


def test_the_null_output_paces_unless_told_not_to():
    framelist = pcm.FrameList._wrap(np.zeros((2205, 2), np.int32), 16)
    for realtime in (True, False):
        out = player.NULLAudioOutput(realtime=realtime)
        out.set_format(22050, 2, 3, 16)
        t0 = time.perf_counter()
        out.play(framelist)
        wall = time.perf_counter() - t0
        assert (wall >= 0.1) == realtime
        assert out.frames_played == 2205


def test_player_volume_api_is_the_references():
    results = []
    for package in (player, ref_player):
        out = package.NULLAudioOutput(realtime=False)
        p = package.Player(out)
        try:
            results.append((p.get_volume(), p.change_volume(-0.25),
                            p.change_volume(2.0), p.current_output_name(),
                            p.current_output_description()))
        finally:
            p.close()
    assert results[0] == results[1]
