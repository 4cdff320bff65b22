"""MPEG audio (MP3 and MP2) over the system's libraries.

The port's copy of the reference's ``audiotools_tpu/codecs/mpeg.py``:
libmpg123 decodes (``MP3Decoder``), libmp3lame encodes MP3 at a VBR
quality (``encode_mp3``) and libtwolame encodes MP2 at a bitrate
(``encode_mp2``), each loaded with ``ctypes`` from what
``ctypes.util.find_library`` finds.  A library that is not found is
None, and the class that needs it is not available.  All of it runs
on the host.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

from .. import pcm

_mpg123 = None
_lame = None
_twolame = None


def _load(name):
    path = ctypes.util.find_library(name)
    if path is None:
        return None
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def mpg123_lib():
    global _mpg123
    if _mpg123 is None:
        lib = _load("mpg123")
        if lib is not None:
            lib.mpg123_init()
            lib.mpg123_new.restype = ctypes.c_void_p
            lib.mpg123_new.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_int)]
            lib.mpg123_open.argtypes = [ctypes.c_void_p,
                                        ctypes.c_char_p]
            lib.mpg123_getformat.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
            lib.mpg123_format.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                ctypes.c_int]
            lib.mpg123_read.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t)]
            lib.mpg123_close.argtypes = [ctypes.c_void_p]
            lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        _mpg123 = lib if lib is not None else False
    return _mpg123 or None


def lame_lib():
    global _lame
    if _lame is None:
        lib = _load("mp3lame")
        if lib is not None:
            lib.lame_init.restype = ctypes.c_void_p
            for fn in ("lame_set_in_samplerate",
                       "lame_set_num_channels",
                       "lame_set_quality", "lame_set_VBR",
                       "lame_set_VBR_q", "lame_set_brate",
                       "lame_init_params"):
                getattr(lib, fn).argtypes = [ctypes.c_void_p] + \
                    ([ctypes.c_int] if fn != "lame_init_params"
                     else [])
            lib.lame_encode_buffer_interleaved.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int]
            lib.lame_encode_buffer.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
            lib.lame_encode_flush.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            lib.lame_close.argtypes = [ctypes.c_void_p]
        _lame = lib if lib is not None else False
    return _lame or None


def twolame_lib():
    global _twolame
    if _twolame is None:
        lib = _load("twolame")
        if lib is not None:
            lib.twolame_init.restype = ctypes.c_void_p
            for fn in ("twolame_set_in_samplerate",
                       "twolame_set_out_samplerate",
                       "twolame_set_num_channels",
                       "twolame_set_bitrate"):
                getattr(lib, fn).argtypes = [ctypes.c_void_p,
                                             ctypes.c_int]
            lib.twolame_init_params.argtypes = [ctypes.c_void_p]
            lib.twolame_encode_buffer_interleaved.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int]
            lib.twolame_encode_flush.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            lib.twolame_close.argtypes = [
                ctypes.POINTER(ctypes.c_void_p)]
        _twolame = lib if lib is not None else False
    return _twolame or None


MPG123_ENC_SIGNED_16 = 0xD0     # mpg123.h MPG123_ENC_SIGNED_16
MPG123_OK = 0
MPG123_DONE = -12


class MP3Decoder:
    """a PCMReader decoding MPEG audio via libmpg123"""

    def __init__(self, filename):
        lib = mpg123_lib()
        if lib is None:
            raise ValueError("libmpg123 unavailable")
        self.lib = lib
        err = ctypes.c_int(0)
        self.handle = lib.mpg123_new(None, ctypes.byref(err))
        if not self.handle:
            raise ValueError("mpg123_new failed")
        if lib.mpg123_open(self.handle,
                           filename.encode("utf-8")) != MPG123_OK:
            lib.mpg123_delete(self.handle)
            self.handle = None
            raise ValueError("unable to open MPEG file")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        lib.mpg123_getformat(self.handle, ctypes.byref(rate),
                             ctypes.byref(channels),
                             ctypes.byref(encoding))
        # lock the output format to signed 16-bit at the native rate
        lib.mpg123_format_none(self.handle)
        lib.mpg123_format(self.handle, rate.value, channels.value,
                          MPG123_ENC_SIGNED_16)
        self.sample_rate = int(rate.value)
        self.channels = int(channels.value)
        self.channel_mask = 0x3 if self.channels == 2 else 0x4
        self.bits_per_sample = 16
        self.closed = False

    def read(self, pcm_frames):
        if self.closed or self.handle is None:
            raise ValueError("stream is closed")
        want = max(pcm_frames, 1) * self.channels * 2
        buf = (ctypes.c_char * want)()
        done = ctypes.c_size_t(0)
        result = self.lib.mpg123_read(self.handle, buf, want,
                                      ctypes.byref(done))
        data = bytes(buf[:done.value])
        if not data and result != MPG123_OK:
            return pcm.empty_framelist(self.channels, 16)
        samples = np.frombuffer(data, dtype="<i2").astype(np.int32)
        return pcm.FrameList._wrap(
            samples.reshape(-1, self.channels), 16)

    def close(self):
        if not self.closed and self.handle is not None:
            self.lib.mpg123_close(self.handle)
            self.lib.mpg123_delete(self.handle)
            self.handle = None
        self.closed = True


def encode_mp3(filename, pcmreader, compression="2"):
    """encodes an MP3 file via libmp3lame

    pcmreader must be 16-bit, 1 or 2 channels; compression "0".."9"
    maps to LAME VBR -V levels (MP3Audio.COMPRESSION_MODES)"""
    lib = lame_lib()
    if lib is None:
        raise ValueError("libmp3lame unavailable")
    if pcmreader.bits_per_sample != 16 or pcmreader.channels > 2:
        raise ValueError("MP3 requires 16-bit mono/stereo input")

    handle = lib.lame_init()
    if not handle:
        raise ValueError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(handle, pcmreader.sample_rate)
        lib.lame_set_num_channels(handle, pcmreader.channels)
        lib.lame_set_VBR(handle, 4)     # vbr_mtrh (VBR new)
        lib.lame_set_VBR_q(handle, int(float(compression)))
        if lib.lame_init_params(handle) < 0:
            raise ValueError("lame_init_params failed")

        with open(filename, "wb") as out:
            outbuf = (ctypes.c_char * (1 << 20))()
            while True:
                framelist = pcmreader.read(65536)
                if framelist.frames == 0:
                    break
                samples = np.ascontiguousarray(
                    framelist.samples.astype(np.int16))
                if pcmreader.channels == 1:
                    # interleaved API needs stereo; duplicate mono
                    samples = np.repeat(samples, 2, axis=1)
                n = lib.lame_encode_buffer_interleaved(
                    handle, samples.ctypes.data_as(ctypes.c_void_p),
                    framelist.frames, outbuf, len(outbuf))
                if n < 0:
                    raise ValueError("lame encode error %d" % (n,))
                out.write(bytes(outbuf[:n]))
            n = lib.lame_encode_flush(handle, outbuf, len(outbuf))
            if n > 0:
                out.write(bytes(outbuf[:n]))
    finally:
        lib.lame_close(handle)


def encode_mp2(filename, pcmreader, compression="192"):
    """encodes an MP2 file via libtwolame at the given bitrate"""
    lib = twolame_lib()
    if lib is None:
        raise ValueError("libtwolame unavailable")
    if pcmreader.bits_per_sample != 16 or pcmreader.channels > 2:
        raise ValueError("MP2 requires 16-bit mono/stereo input")

    handle = lib.twolame_init()
    if not handle:
        raise ValueError("twolame_init failed")
    try:
        lib.twolame_set_in_samplerate(handle, pcmreader.sample_rate)
        lib.twolame_set_out_samplerate(handle, pcmreader.sample_rate)
        lib.twolame_set_num_channels(handle, pcmreader.channels)
        lib.twolame_set_bitrate(handle, int(compression))
        if lib.twolame_init_params(handle) != 0:
            raise ValueError("twolame_init_params failed")

        with open(filename, "wb") as out:
            outbuf = (ctypes.c_char * (1 << 20))()
            while True:
                framelist = pcmreader.read(57600)
                if framelist.frames == 0:
                    break
                samples = np.ascontiguousarray(
                    framelist.samples.astype(np.int16))
                n = lib.twolame_encode_buffer_interleaved(
                    handle, samples.ctypes.data_as(ctypes.c_void_p),
                    framelist.frames, outbuf, len(outbuf))
                if n < 0:
                    raise ValueError("twolame encode error %d" % (n,))
                out.write(bytes(outbuf[:n]))
            n = lib.twolame_encode_flush(handle, outbuf, len(outbuf))
            if n > 0:
                out.write(bytes(outbuf[:n]))
    finally:
        handle_p = ctypes.c_void_p(handle)
        lib.twolame_close(ctypes.byref(handle_p))
