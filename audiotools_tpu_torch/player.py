"""Playback: the player threads and the audio outputs.

The port of the reference's ``audiotools_tpu/player.py``: ``Player``, a
worker thread driven by a command queue; ``AudioPlayer``, the same
operations run by the caller's own loop; ``CDPlayer`` over a ``cdio.CDDA``
image's tracks; ``ThreadedPCMReader``, which decodes ahead on a thread
of its own; and the outputs ``AudioOutput``, ``NULLAudioOutput`` (which
discards the samples, pacing at real time unless told not to), and OSS,
ALSA, PulseAudio and CoreAudio, each through ctypes or the standard
library behind its own ``available()``.

A track decodes where the opened file's ``device`` says: on the card
for a file opened with the default device, the port's decode kernels
among the fill thread's reads.  ``ThreadedPCMReader.close`` stops its
fill thread and joins it before it closes the decoder, so that no read
is still running (and no copy from the card still in flight) when the
decoder frees its buffers.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time

import numpy as np

from . import pcm

(PLAYER_STOPPED, PLAYER_PAUSED, PLAYER_PLAYING) = range(3)

# the ReplayGain a Player applies
(RG_NO_REPLAYGAIN, RG_TRACK_GAIN, RG_ALBUM_GAIN) = range(3)


class AudioOutput:
    """the base class for playback sinks"""

    NAME = ""

    def __init__(self):
        self.sample_rate = 0
        self.channels = 0
        self.channel_mask = 0
        self.bits_per_sample = 0

    @classmethod
    def available(cls):
        """returns True if the output can be used on this system"""
        return False

    def compatible(self, sample_rate, channels, channel_mask,
                   bits_per_sample):
        return ((self.sample_rate == sample_rate) and
                (self.channels == channels) and
                (self.channel_mask == channel_mask) and
                (self.bits_per_sample == bits_per_sample))

    def set_format(self, sample_rate, channels, channel_mask,
                   bits_per_sample):
        self.sample_rate = sample_rate
        self.channels = channels
        self.channel_mask = channel_mask
        self.bits_per_sample = bits_per_sample

    def play(self, framelist):
        """plays a FrameList"""
        raise NotImplementedError()

    def get_volume(self):
        """returns the current volume as a float in [0.0, 1.0]

        the base class keeps a software volume; Player/AudioPlayer
        scale samples by it before play() (hardware-mixer backends
        may override get/set_volume with the real control)"""
        return getattr(self, "_volume", 1.0)

    def set_volume(self, volume):
        """sets the current volume to a float in [0.0, 1.0]"""
        self._volume = min(max(float(volume), 0.0), 1.0)

    def pause(self):
        pass

    def resume(self):
        pass

    def close(self):
        pass


class NULLAudioOutput(AudioOutput):
    """a sink which discards samples while pacing at real time
    (the reference's NULLAudioOutput)"""

    NAME = "NULL"

    def __init__(self, realtime=True):
        AudioOutput.__init__(self)
        self.realtime = realtime
        self.frames_played = 0

    @classmethod
    def available(cls):
        return True

    def play(self, framelist):
        self.frames_played += framelist.frames
        if self.realtime and self.sample_rate:
            time.sleep(framelist.frames / self.sample_rate)


class OSSAudioOutput(AudioOutput):
    """a sink over the OSS /dev/dsp device (stdlib ossaudiodev)"""

    NAME = "OSS"

    def __init__(self):
        AudioOutput.__init__(self)
        self.__dsp__ = None

    @classmethod
    def available(cls):
        try:
            import ossaudiodev  # noqa: F401
            return os.path.exists("/dev/dsp")
        except ImportError:
            return False

    def set_format(self, sample_rate, channels, channel_mask,
                   bits_per_sample):
        import ossaudiodev
        AudioOutput.set_format(self, sample_rate, channels,
                               channel_mask, bits_per_sample)
        if self.__dsp__ is not None:
            self.__dsp__.close()
        self.__dsp__ = ossaudiodev.open("w")
        self.__dsp__.setfmt(ossaudiodev.AFMT_S16_LE)
        self.__dsp__.channels(channels)
        self.__dsp__.speed(sample_rate)

    def play(self, framelist):
        if self.__dsp__ is not None:
            self.__dsp__.write(framelist.to_bytes(False, True))

    def close(self):
        if self.__dsp__ is not None:
            self.__dsp__.close()
            self.__dsp__ = None


class ALSAAudioOutput(AudioOutput):
    """a sink over libasound via ctypes (role of src/output/alsa.c)"""

    NAME = "ALSA"

    @classmethod
    def available(cls):
        import ctypes.util
        return ctypes.util.find_library("asound") is not None

    def __init__(self, device="default"):
        AudioOutput.__init__(self)
        import ctypes
        import ctypes.util
        path = ctypes.util.find_library("asound")
        if path is None:
            raise ValueError("libasound unavailable")
        self.lib = ctypes.CDLL(path)
        self.device = device.encode("utf-8")
        self.handle = None

    def set_format(self, sample_rate, channels, channel_mask,
                   bits_per_sample):
        import ctypes
        AudioOutput.set_format(self, sample_rate, channels,
                               channel_mask, bits_per_sample)
        if self.handle is not None:
            self.lib.snd_pcm_close(self.handle)
        handle = ctypes.c_void_p()
        if self.lib.snd_pcm_open(ctypes.byref(handle), self.device,
                                 0, 0) < 0:
            raise ValueError("unable to open ALSA device")
        self.handle = handle
        # SND_PCM_FORMAT_S16_LE = 2
        if self.lib.snd_pcm_set_params(
                handle, 2, 3, channels, sample_rate, 1, 500000) < 0:
            raise ValueError("unable to configure ALSA device")

    def play(self, framelist):
        if self.handle is not None:
            data = framelist.to_bytes(False, True)
            self.lib.snd_pcm_writei(self.handle, data,
                                    framelist.frames)

    def close(self):
        if self.handle is not None:
            self.lib.snd_pcm_drain(self.handle)
            self.lib.snd_pcm_close(self.handle)
            self.handle = None


class PulseAudioOutput(AudioOutput):
    """a sink over libpulse-simple via ctypes (role of
    src/output/pulseaudio.c:582 — the reference drives the async
    libpulse mainloop from C; the synchronous simple API carries the
    same PCM path with the stream format re-negotiated per track)"""

    NAME = "PulseAudio"

    @classmethod
    def available(cls):
        import ctypes.util
        return ctypes.util.find_library("pulse-simple") is not None

    def __init__(self, stream_name="audiotools"):
        AudioOutput.__init__(self)
        import ctypes
        import ctypes.util
        path = ctypes.util.find_library("pulse-simple")
        if path is None:
            raise ValueError("libpulse-simple unavailable")
        self.lib = ctypes.CDLL(path)
        self.lib.pa_simple_new.restype = ctypes.c_void_p
        self.stream_name = stream_name.encode("utf-8")
        self.handle = None

    def set_format(self, sample_rate, channels, channel_mask,
                   bits_per_sample):
        import ctypes
        AudioOutput.set_format(self, sample_rate, channels,
                               channel_mask, bits_per_sample)
        self.close()

        class SampleSpec(ctypes.Structure):
            _fields_ = [("format", ctypes.c_int),
                        ("rate", ctypes.c_uint32),
                        ("channels", ctypes.c_uint8)]

        spec = SampleSpec(3, sample_rate, channels)  # PA_SAMPLE_S16LE
        error = ctypes.c_int(0)
        handle = self.lib.pa_simple_new(
            None,                              # default server
            self.stream_name,
            1,                                 # PA_STREAM_PLAYBACK
            None,                              # default device
            b"playback",
            ctypes.byref(spec),
            None,                              # default channel map
            None,                              # default buffering
            ctypes.byref(error))
        if not handle:
            raise ValueError("unable to connect to PulseAudio "
                             "(error %d)" % (error.value,))
        self.handle = ctypes.c_void_p(handle)

    def play(self, framelist):
        import ctypes
        if self.handle is not None:
            data = framelist.to_bytes(False, True)
            error = ctypes.c_int(0)
            self.lib.pa_simple_write(self.handle, data, len(data),
                                     ctypes.byref(error))

    def close(self):
        import ctypes
        if self.handle is not None:
            error = ctypes.c_int(0)
            self.lib.pa_simple_drain(self.handle, ctypes.byref(error))
            self.lib.pa_simple_free(self.handle)
            self.handle = None


class CoreAudioOutput(AudioOutput):
    """a sink over macOS AudioToolbox AudioQueues via ctypes (role of
    src/output/core_audio.c:639 — the reference drives CoreAudio's
    pull-model callback from C; this pushes with AudioQueue's
    synchronous enqueue, same S16LE PCM path).  Darwin-only, gated by
    available() exactly like the reference's OS conditional
    (setup.py:728-792)."""

    NAME = "CoreAudio"

    # AudioStreamBasicDescription flags for signed little-endian ints
    _LINEAR_PCM = b"lpcm"
    _FLAG_SIGNED_INT = 0x4
    _FLAG_PACKED = 0x8

    @classmethod
    def available(cls):
        if sys.platform != "darwin":
            return False
        import ctypes.util
        return ctypes.util.find_library("AudioToolbox") is not None

    def __init__(self, n_buffers=4):
        AudioOutput.__init__(self)
        import ctypes
        import ctypes.util
        path = ctypes.util.find_library("AudioToolbox")
        if path is None:
            raise ValueError("AudioToolbox unavailable")
        self.lib = ctypes.CDLL(path)
        self.n_buffers = n_buffers
        self.queue = None
        self._inflight = None

    def set_format(self, sample_rate, channels, channel_mask,
                   bits_per_sample):
        import ctypes
        AudioOutput.set_format(self, sample_rate, channels,
                               channel_mask, bits_per_sample)
        self.close()

        class AudioStreamBasicDescription(ctypes.Structure):
            _fields_ = [("mSampleRate", ctypes.c_double),
                        ("mFormatID", ctypes.c_uint32),
                        ("mFormatFlags", ctypes.c_uint32),
                        ("mBytesPerPacket", ctypes.c_uint32),
                        ("mFramesPerPacket", ctypes.c_uint32),
                        ("mBytesPerFrame", ctypes.c_uint32),
                        ("mChannelsPerFrame", ctypes.c_uint32),
                        ("mBitsPerChannel", ctypes.c_uint32),
                        ("mReserved", ctypes.c_uint32)]

        desc = AudioStreamBasicDescription(
            float(sample_rate),
            int.from_bytes(self._LINEAR_PCM, "big"),
            self._FLAG_SIGNED_INT | self._FLAG_PACKED,
            2 * channels, 1, 2 * channels, channels, 16, 0)
        queue = ctypes.c_void_p()
        # backpressure: at most n_buffers AudioQueueBuffers in flight;
        # the completion callback frees each finished buffer and opens a
        # slot, so play() blocks (paces to realtime) when the queue is
        # full instead of enqueueing the whole track instantly
        self._inflight = threading.Semaphore(self.n_buffers)
        callback = ctypes.CFUNCTYPE(
            None, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)

        def _buffer_done(_udata, done_queue, done_buffer):
            try:
                self.lib.AudioQueueFreeBuffer(done_queue, done_buffer)
            finally:
                self._inflight.release()

        self._callback = callback(_buffer_done)
        if self.lib.AudioQueueNewOutput(
                ctypes.byref(desc), self._callback, None, None, None,
                0, ctypes.byref(queue)) != 0:
            raise ValueError("unable to create CoreAudio queue")
        self.queue = queue
        self.lib.AudioQueueStart(queue, None)

    def play(self, framelist):
        import ctypes
        if self.queue is None:
            return
        data = framelist.to_bytes(False, True)

        class AudioQueueBuffer(ctypes.Structure):
            _fields_ = [("mAudioDataBytesCapacity", ctypes.c_uint32),
                        ("mAudioData", ctypes.c_void_p),
                        ("mAudioDataByteSize", ctypes.c_uint32)]

        self._inflight.acquire()
        buf = ctypes.POINTER(AudioQueueBuffer)()
        if self.lib.AudioQueueAllocateBuffer(
                self.queue, len(data), ctypes.byref(buf)) != 0:
            self._inflight.release()
            return
        ctypes.memmove(buf.contents.mAudioData, data, len(data))
        buf.contents.mAudioDataByteSize = len(data)
        if self.lib.AudioQueueEnqueueBuffer(self.queue, buf, 0, None) != 0:
            self.lib.AudioQueueFreeBuffer(self.queue, buf)
            self._inflight.release()

    def pause(self):
        if self.queue is not None:
            self.lib.AudioQueuePause(self.queue)

    def resume(self):
        if self.queue is not None:
            self.lib.AudioQueueStart(self.queue, None)

    def close(self):
        if self.queue is not None:
            self.lib.AudioQueueStop(self.queue, 1)
            self.lib.AudioQueueDispose(self.queue, 1)
            self.queue = None
            self._inflight = None


AUDIO_OUTPUT = (CoreAudioOutput, PulseAudioOutput, ALSAAudioOutput,
                OSSAudioOutput, NULLAudioOutput)


def available_outputs():
    """yields the AudioOutput classes usable on this system
    (reference player.py:1237)"""
    for output in AUDIO_OUTPUT:
        if output.available():
            yield output


def open_output(name=None):
    """returns a new AudioOutput instance by name (or the best one)"""
    for output in available_outputs():
        if (name is None) or (output.NAME == name):
            return output()
    raise ValueError("no available audio output")


def _apply_volume(framelist, volume):
    """a FrameList's samples scaled by a [0.0, 1.0] software volume,
    rounded toward zero; the FrameList itself at full volume"""
    if volume >= 1.0:
        return framelist
    scaled = (np.asarray(framelist.samples).astype(np.float64) *
              volume).astype(np.int32)
    return pcm.FrameList._wrap(scaled, framelist.bits_per_sample)


def _gain_reader(reader, audiofile, mode):
    """``reader`` under the file's track or album ReplayGain, as
    ``mode`` asks, where the file has ReplayGain values"""
    if mode not in (RG_TRACK_GAIN, RG_ALBUM_GAIN):
        return reader
    gain = audiofile.replay_gain()
    if gain is None:
        return reader
    from .replaygain import ReplayGainReader
    if mode == RG_TRACK_GAIN:
        return ReplayGainReader(reader, gain.track_gain, gain.track_peak)
    return ReplayGainReader(reader, gain.album_gain, gain.album_peak)


class ThreadedPCMReader:
    """a PCMReader that reads its reader 4096 frames at a time on a
    thread of its own, up to QUEUE_SIZE frame lists ahead"""

    QUEUE_SIZE = 8
    # seconds between the fill thread's looks at the stop flag while
    # the queue is full
    POLL_S = 0.05

    def __init__(self, pcmreader):
        self.sample_rate = pcmreader.sample_rate
        self.channels = pcmreader.channels
        self.channel_mask = pcmreader.channel_mask
        self.bits_per_sample = pcmreader.bits_per_sample
        self.__pcmreader__ = pcmreader
        self.__queue__ = queue.Queue(self.QUEUE_SIZE)
        self.__stopped__ = threading.Event()
        self.__finished__ = False
        self.__thread__ = threading.Thread(target=self.__fill__,
                                           daemon=True)
        self.__thread__.start()

    def __put__(self, item):
        """queues ``item``; False when the reader was stopped first"""
        while not self.__stopped__.is_set():
            try:
                self.__queue__.put(item, timeout=self.POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def __fill__(self):
        try:
            while not self.__stopped__.is_set():
                framelist = self.__pcmreader__.read(4096)
                if not self.__put__(framelist) or framelist.frames == 0:
                    return
        except Exception as err:
            # the consumer's read raises it
            self.__put__(err)

    def read(self, pcm_frames):
        if self.__finished__:
            return pcm.empty_framelist(self.channels, self.bits_per_sample)
        item = self.__queue__.get()
        if isinstance(item, Exception):
            self.__finished__ = True
            raise item
        if item.frames == 0:
            self.__finished__ = True
        return item

    def close(self):
        """stops the fill thread, waits for its read to return, then
        closes the reader"""
        self.__stopped__.set()
        self.__thread__.join()
        while True:
            try:
                self.__queue__.get_nowait()
            except queue.Empty:
                break
        self.__pcmreader__.close()


class Player:
    """a daemon-threaded audio player (reference player.py:27)

    commands flow through a queue to the worker; state is re-entrant
    (open/play/pause/stop from any thread)"""

    def __init__(self, audio_output, next_track_callback=None):
        self.__output__ = audio_output
        self.__callback__ = next_track_callback
        self.__commands__ = queue.Queue()
        self.__state__ = PLAYER_STOPPED
        self.__audiofile__ = None
        self.__pcmreader__ = None
        self.__frames_played__ = 0
        self.__total_frames__ = 0
        self.__replay_gain__ = RG_NO_REPLAYGAIN
        self.__lock__ = threading.Lock()
        self.__worker__ = threading.Thread(target=self.__run__,
                                           daemon=True)
        self.__worker__.start()

    # ---- command API ----------------------------------------------------

    def open(self, audiofile):
        """opens an AudioFile for playback (stops current playback)"""
        self.__commands__.put(("open", audiofile))

    def play(self):
        self.__commands__.put(("play", None))

    def pause(self):
        self.__commands__.put(("pause", None))

    def toggle_play_pause(self):
        self.__commands__.put(("toggle", None))

    def stop(self):
        self.__commands__.put(("stop", None))

    def close(self):
        self.__commands__.put(("quit", None))
        self.__worker__.join(timeout=10)
        self.__output__.close()

    def state(self):
        return self.__state__

    def progress(self):
        """returns (frames played, total frames)"""
        with self.__lock__:
            return (self.__frames_played__, self.__total_frames__)

    def current_output_description(self):
        return self.__output__.NAME

    def set_next_track_callback(self, callback):
        """sets the callable invoked (on the worker thread) when a
        track finishes playing naturally"""
        self.__callback__ = callback

    def current_output_name(self):
        """returns the current output's NAME string
        (reference player.py:141)"""
        return self.__output__.NAME

    def set_output(self, output):
        """switches playback to another AudioOutput object
        (reference player.py:85); stops current playback"""
        self.__commands__.put(("set_output", output))

    def set_replay_gain(self, replay_gain):
        """sets the ReplayGain mode applied at the NEXT play():
        RG_NO_REPLAYGAIN, RG_TRACK_GAIN or RG_ALBUM_GAIN
        (reference player.py:76)"""
        self.__commands__.put(("set_replay_gain", replay_gain))

    def get_volume(self):
        """returns the output's volume as a float in [0.0, 1.0]"""
        return self.__output__.get_volume()

    def set_volume(self, volume):
        """sets the output's volume to a float in [0.0, 1.0]"""
        self.__output__.set_volume(volume)

    def change_volume(self, delta):
        """adjusts the volume by delta; returns the new volume"""
        self.set_volume(self.get_volume() + delta)
        return self.get_volume()

    # ---- worker ----------------------------------------------------------

    def __handle__(self, command, payload):
        if command == "open":
            if self.__pcmreader__ is not None:
                self.__pcmreader__.close()
                self.__pcmreader__ = None
            self.__audiofile__ = payload
            with self.__lock__:
                self.__frames_played__ = 0
                self.__total_frames__ = payload.total_frames()
            self.__state__ = PLAYER_STOPPED
        elif command == "set_output":
            if self.__pcmreader__ is not None:
                self.__pcmreader__.close()
                self.__pcmreader__ = None
            self.__state__ = PLAYER_STOPPED
            self.__output__.close()
            self.__output__ = payload
        elif command == "set_replay_gain":
            self.__replay_gain__ = payload
        elif command in ("play", "toggle") and \
                self.__state__ != PLAYER_PLAYING:
            if self.__audiofile__ is None:
                return
            if self.__pcmreader__ is None:
                reader = _gain_reader(self.__audiofile__.to_pcm(),
                                      self.__audiofile__,
                                      self.__replay_gain__)
                self.__pcmreader__ = ThreadedPCMReader(reader)
                self.__output__.set_format(
                    reader.sample_rate, reader.channels,
                    int(reader.channel_mask),
                    reader.bits_per_sample)
            self.__output__.resume()
            self.__state__ = PLAYER_PLAYING
        elif command == "pause" or (command == "toggle" and
                                    self.__state__ == PLAYER_PLAYING):
            if self.__state__ == PLAYER_PLAYING:
                self.__output__.pause()
                self.__state__ = PLAYER_PAUSED
        elif command == "stop":
            if self.__pcmreader__ is not None:
                self.__pcmreader__.close()
                self.__pcmreader__ = None
            with self.__lock__:
                self.__frames_played__ = 0
            self.__state__ = PLAYER_STOPPED

    def __run__(self):
        while True:
            try:
                timeout = (0.0 if self.__state__ == PLAYER_PLAYING
                           else 0.1)
                (command, payload) = self.__commands__.get(
                    timeout=timeout)
                if command == "quit":
                    if self.__pcmreader__ is not None:
                        self.__pcmreader__.close()
                    return
                self.__handle__(command, payload)
                continue
            except queue.Empty:
                pass

            if self.__state__ != PLAYER_PLAYING:
                continue
            try:
                framelist = self.__pcmreader__.read(4096)
            except (IOError, ValueError):
                framelist = pcm.empty_framelist(1, 16)
            if framelist.frames == 0:
                self.__pcmreader__.close()
                self.__pcmreader__ = None
                self.__state__ = PLAYER_STOPPED
                if self.__callback__ is not None:
                    self.__callback__()
                continue
            self.__output__.play(
                _apply_volume(framelist,
                              self.__output__.get_volume()))
            with self.__lock__:
                self.__frames_played__ += framelist.frames


class AudioPlayer:
    """the synchronous playback core (reference player.py:167): the
    threaded Player drives the same operations through its command
    queue; this class exposes them directly for callers that run
    their own loop (output_audio() pumps one buffer at a time)."""

    def __init__(self, audio_output, next_track_callback=lambda: None):
        self.__state__ = PLAYER_STOPPED
        self.__audio_output__ = audio_output
        self.__next_track_callback__ = next_track_callback
        self.__audiofile__ = None
        self.__pcmreader__ = None
        self.__buffer_size__ = 1
        self.__replay_gain__ = RG_NO_REPLAYGAIN
        self.__current_frames__ = 0
        self.__total_frames__ = 1

    def set_audiofile(self, audiofile):
        """sets the AudioFile to play"""
        self.__audiofile__ = audiofile

    def set_replay_gain(self, replay_gain):
        """RG_NO_REPLAYGAIN, RG_TRACK_GAIN or RG_ALBUM_GAIN; takes
        effect at the next play()"""
        self.__replay_gain__ = replay_gain

    def state(self):
        return self.__state__

    def progress(self):
        """returns (current frames, total frames)"""
        return (self.__current_frames__, self.__total_frames__)

    def stop(self):
        if self.__state__ == PLAYER_STOPPED:
            return
        if self.__state__ == PLAYER_PAUSED:
            self.__audio_output__.resume()
        self.__state__ = PLAYER_STOPPED
        if self.__pcmreader__ is not None:
            self.__pcmreader__.close()
            self.__pcmreader__ = None
        self.__current_frames__ = 0
        self.__total_frames__ = 1

    def pause(self):
        if self.__state__ == PLAYER_PLAYING:
            self.__audio_output__.pause()
            self.__state__ = PLAYER_PAUSED

    def play(self):
        if self.__state__ == PLAYER_PLAYING:
            return
        elif self.__state__ == PLAYER_PAUSED:
            self.__audio_output__.resume()
            self.__state__ = PLAYER_PLAYING
        elif (self.__state__ == PLAYER_STOPPED and
              self.__audiofile__ is not None):
            pcmreader = _gain_reader(self.__audiofile__.to_pcm(),
                                     self.__audiofile__,
                                     self.__replay_gain__)
            self.__pcmreader__ = pcm.BufferedPCMReader(pcmreader)
            self.__buffer_size__ = max(
                int(round(0.25 * pcmreader.sample_rate)), 256)
            if not self.__audio_output__.compatible(
                    pcmreader.sample_rate, pcmreader.channels,
                    int(pcmreader.channel_mask),
                    pcmreader.bits_per_sample):
                self.__audio_output__.set_format(
                    pcmreader.sample_rate, pcmreader.channels,
                    int(pcmreader.channel_mask),
                    pcmreader.bits_per_sample)
            self.__current_frames__ = 0
            self.__total_frames__ = self.__audiofile__.total_frames()
            self.__state__ = PLAYER_PLAYING

    def output_audio(self):
        """while playing, pumps one buffer of audio to the output;
        calls next_track_callback and stops at end of stream"""
        if self.__state__ == PLAYER_PLAYING:
            framelist = self.__pcmreader__.read(self.__buffer_size__)
            if framelist.frames > 0:
                self.__current_frames__ += framelist.frames
                self.__audio_output__.play(_apply_volume(
                    framelist, self.__audio_output__.get_volume()))
            else:
                self.__next_track_callback__()
                self.stop()

    def run(self):
        """a minimal synchronous loop: pumps audio until stopped"""
        while self.__state__ != PLAYER_STOPPED:
            if self.__state__ == PLAYER_PLAYING:
                self.output_audio()
            else:
                time.sleep(0.05)


class CDPlayer(Player):
    """plays CDDA tracks from a disc/image (reference player.py:367)"""

    def __init__(self, cdda, audio_output,
                 next_track_callback=None):
        Player.__init__(self, audio_output, next_track_callback)
        self.__cdda__ = cdda

    def open(self, track_number):
        """opens the given 1-based track number"""
        reader = self.__cdda__[track_number]

        class _TrackFile:
            def __init__(self, r):
                self.__reader__ = r

            def total_frames(self):
                return self.__reader__.__total_frames__

            def to_pcm(self):
                return self.__reader__

        Player.open(self, _TrackFile(reader))
