"""Ogg Opus over the system's libopus and the port's Ogg pages.

The port's copy of the reference's ``audiotools_tpu/codecs/opus.py``:
libopus codes the packets (``OpusDecoder`` and ``encode_opus``, loaded
with ``ctypes`` from what ``ctypes.util.find_library`` finds), and the
port's ``ogg`` lays them out on pages (the stream serial 0x4F505553,
the granule of RFC 7845 counting the pre-skip).  Channel mapping family
0 (mono and stereo) only.  All of it runs on the host.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct

import numpy as np

from .. import pcm
from ..ogg import (Page, PacketReader, PageReader, packet_to_pages,
                   packet_to_segments)

_opus = None

OPUS_APPLICATION_AUDIO = 2049
OPUS_SET_BITRATE_REQUEST = 4002
OPUS_SET_COMPLEXITY_REQUEST = 4010
OPUS_GET_LOOKAHEAD_REQUEST = 4027
OPUS_RATE = 48000
FRAME_SAMPLES = 960           # 20 ms at 48 kHz


def _load(name):
    path = ctypes.util.find_library(name)
    if path is None:
        return None
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def opus_lib():
    global _opus
    if _opus is None:
        lib = _load("opus")
        if lib is not None:
            lib.opus_encoder_create.restype = ctypes.c_void_p
            lib.opus_encoder_create.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int)]
            lib.opus_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int]
            lib.opus_encoder_ctl.argtypes = []  # variadic
            lib.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
            lib.opus_decoder_create.restype = ctypes.c_void_p
            lib.opus_decoder_create.argtypes = [
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int)]
            lib.opus_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
        _opus = lib if lib is not None else False
    return _opus or None


def parse_opus_head(packet):
    """parses an OpusHead packet, returning
    (channels, preskip, input_rate, mapping_family)"""
    if packet[0:8] != b"OpusHead" or packet[8] != 1:
        raise ValueError("invalid OpusHead packet")
    (channels,) = struct.unpack("<B", packet[9:10])
    (preskip,) = struct.unpack("<H", packet[10:12])
    (input_rate,) = struct.unpack("<I", packet[12:16])
    mapping = packet[18]
    return (channels, preskip, input_rate, mapping)


def build_opus_head(channels, preskip, input_rate):
    return (b"OpusHead" + bytes([1, channels]) +
            struct.pack("<HIh", preskip, input_rate, 0) +
            bytes([0]))       # mapping family 0


class OpusDecoder:
    """a PCMReader decoding Ogg Opus via libopus packets"""

    def __init__(self, filename):
        lib = opus_lib()
        if lib is None:
            raise ValueError("libopus unavailable")
        self.lib = lib
        self.file = open(filename, "rb")
        self.packets = PacketReader(PageReader(self.file))
        head = self.packets.read_packet()
        (channels, preskip, _input_rate,
         mapping) = parse_opus_head(head)
        if mapping != 0:
            raise ValueError("unsupported Opus channel mapping")
        self.packets.read_packet()          # OpusTags
        self.channels = channels
        self.sample_rate = OPUS_RATE
        self.bits_per_sample = 16
        self.channel_mask = 0x3 if channels == 2 else 0x4
        self.__preskip__ = preskip
        self.__skip_remaining__ = preskip
        self.__granule__ = 0
        err = ctypes.c_int(0)
        self.dec = lib.opus_decoder_create(OPUS_RATE, channels,
                                           ctypes.byref(err))
        if err.value != 0:
            raise ValueError("opus_decoder_create failed")
        self.__buf__ = (ctypes.c_int16 * (5760 * channels))()
        self.closed = False
        self.__eos__ = False

    def read(self, pcm_frames):
        if self.closed:
            raise ValueError("stream is closed")
        out = []
        got = 0
        while got < max(pcm_frames, 1) and not self.__eos__:
            try:
                packet = self.packets.read_packet()
            except (IOError, ValueError):
                self.__eos__ = True
                break
            n = self.lib.opus_decode(
                self.dec, packet, len(packet), self.__buf__, 5760, 0)
            if n <= 0:
                continue
            samples = np.frombuffer(
                self.__buf__, dtype=np.int16,
                count=n * self.channels).astype(np.int32).reshape(
                    -1, self.channels)
            # trim to the stream's final granule position
            end_granule = self.packets.current_granule()
            if end_granule >= 0:
                overshoot = (self.__granule__ + n) - end_granule
                if (overshoot > 0 and
                        self.packets.page.stream_end and
                        self.packets.segment_index >=
                        len(self.packets.page.segments)):
                    samples = samples[:n - overshoot]
            self.__granule__ += n
            if self.__skip_remaining__ > 0:
                skip = min(self.__skip_remaining__, samples.shape[0])
                samples = samples[skip:]
                self.__skip_remaining__ -= skip
            if samples.shape[0]:
                out.append(samples)
                got += samples.shape[0]
        if not out:
            return pcm.empty_framelist(self.channels, 16)
        return pcm.FrameList._wrap(
            np.ascontiguousarray(np.concatenate(out)), 16)

    def close(self):
        if not self.closed:
            self.lib.opus_decoder_destroy(self.dec)
            self.file.close()
        self.closed = True


def encode_opus(filename, pcmreader, compression=10,
                vendor=b"audiotools-tpu"):
    """encodes an Ogg Opus file via libopus

    pcmreader must be 16-bit, 48 kHz, mono or stereo; compression
    0..10 is the Opus complexity setting (OpusAudio.COMPRESSION_MODES)"""
    lib = opus_lib()
    if lib is None:
        raise ValueError("libopus unavailable")
    if pcmreader.sample_rate != OPUS_RATE:
        raise ValueError("Opus encoding requires 48 kHz input")
    if pcmreader.channels > 2:
        raise ValueError("Opus mapping family 0 is mono/stereo only")
    if pcmreader.bits_per_sample != 16:
        raise ValueError("Opus encoding requires 16-bit input")

    channels = pcmreader.channels
    err = ctypes.c_int(0)
    enc = lib.opus_encoder_create(OPUS_RATE, channels,
                                  OPUS_APPLICATION_AUDIO,
                                  ctypes.byref(err))
    if err.value != 0:
        raise ValueError("opus_encoder_create failed")
    try:
        lib.opus_encoder_ctl(ctypes.c_void_p(enc),
                             ctypes.c_int(OPUS_SET_COMPLEXITY_REQUEST),
                             ctypes.c_int(int(compression)))
        lookahead = ctypes.c_int(0)
        lib.opus_encoder_ctl(ctypes.c_void_p(enc),
                             ctypes.c_int(OPUS_GET_LOOKAHEAD_REQUEST),
                             ctypes.byref(lookahead))
        preskip = int(lookahead.value)

        serial = 0x4F505553
        with open(filename, "wb") as out:
            # header pages: OpusHead alone, then OpusTags
            head_page = Page(False, True, False, 0, serial, 0,
                             [build_opus_head(channels, preskip,
                                              OPUS_RATE)])
            out.write(head_page.build())
            tags = (b"OpusTags" +
                    struct.pack("<I", len(vendor)) + vendor +
                    struct.pack("<I", 0))
            seq = 1
            for page in packet_to_pages(tags, serial, 1):
                out.write(page.build())
                seq += 1

            outbuf = (ctypes.c_char * 65536)()
            # RFC 7845: granule counts RAW decoded samples (players
            # subtract preskip); the final page is clamped to exactly
            # preskip + total input samples
            granule = 0
            page = Page(False, False, False, 0, serial, seq, [])
            page_packets = 0

            def flush_page(page, final=False):
                nonlocal seq
                if len(page.segments) == 0 and not final:
                    return page
                page.granule_position = granule
                page.stream_end = final
                out.write(page.build())
                seq += 1
                return Page(False, False, False, 0, serial, seq, [])

            pending = np.zeros((0, channels), dtype=np.int16)
            total_in = 0
            eof = False
            while not eof or pending.shape[0] > 0:
                while pending.shape[0] < FRAME_SAMPLES and not eof:
                    framelist = pcmreader.read(FRAME_SAMPLES * 16)
                    if framelist.frames == 0:
                        eof = True
                        break
                    total_in += framelist.frames
                    pending = np.concatenate(
                        [pending,
                         framelist.samples.astype(np.int16)])
                if pending.shape[0] == 0:
                    break
                frame = pending[:FRAME_SAMPLES]
                pending = pending[FRAME_SAMPLES:]
                if frame.shape[0] < FRAME_SAMPLES:
                    frame = np.concatenate(
                        [frame, np.zeros((FRAME_SAMPLES -
                                          frame.shape[0], channels),
                                         dtype=np.int16)])
                frame = np.ascontiguousarray(frame)
                n = lib.opus_encode(
                    enc, frame.ctypes.data_as(ctypes.c_void_p),
                    FRAME_SAMPLES, outbuf, len(outbuf))
                if n < 0:
                    raise ValueError("opus_encode error %d" % (n,))
                packet = bytes(outbuf[:n])
                granule = min(granule + FRAME_SAMPLES,
                              preskip + total_in)
                # append packet segments; flush at ~4KB or seg limit
                segments = list(packet_to_segments(packet))
                if (len(page.segments) + len(segments) > 250 or
                        page.size() > 4096):
                    page = flush_page(page)
                for seg in segments:
                    page.append(seg)
                page_packets += 1

            # encoder delay padding: keep encoding silence until the
            # granule covers preskip + total_in so the decoder can
            # output every input sample after dropping the preskip
            raw_encoded = 0
            while granule < preskip + total_in:
                silence = np.zeros((FRAME_SAMPLES, channels),
                                   dtype=np.int16)
                n = lib.opus_encode(
                    enc, silence.ctypes.data_as(ctypes.c_void_p),
                    FRAME_SAMPLES, outbuf, len(outbuf))
                if n < 0:
                    raise ValueError("opus_encode error %d" % (n,))
                packet = bytes(outbuf[:n])
                granule = min(granule + FRAME_SAMPLES,
                              preskip + total_in)
                segments = list(packet_to_segments(packet))
                if (len(page.segments) + len(segments) > 250 or
                        page.size() > 4096):
                    page = flush_page(page)
                for seg in segments:
                    page.append(seg)
                raw_encoded += FRAME_SAMPLES
                if raw_encoded > 10 * FRAME_SAMPLES:
                    break       # safety: preskip is always < 1 frame
            flush_page(page, final=True)
    finally:
        lib.opus_encoder_destroy(enc)
