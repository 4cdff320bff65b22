"""Ogg Vorbis over the system's libvorbis, libvorbisenc, libvorbisfile
and libogg.

The port's copy of the reference's ``audiotools_tpu/codecs/vorbis.py``:
libvorbisfile decodes (``VorbisDecoder``, ``ov_fopen`` and ``ov_read``),
and the libvorbis analysis pipeline with libogg's paging encodes at a
VBR quality (``encode_vorbis``, the stream serial 0x56524253), each
loaded with ``ctypes`` from what ``ctypes.util.find_library`` finds.
Only ``vorbis_info``'s head and ``ogg_packet`` and ``ogg_page`` have
their public layouts declared; the other state structures are opaque
buffers.  All of it runs on the host.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

from .. import pcm

_vorbisfile = None
_vorbis = None
_vorbisenc = None
_ogg = None


def _load(name):
    path = ctypes.util.find_library(name)
    if path is None:
        return None
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def vorbisfile_lib():
    global _vorbisfile
    if _vorbisfile is None:
        lib = _load("vorbisfile")
        if lib is not None:
            lib.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
            lib.ov_info.restype = ctypes.POINTER(VorbisInfo)
            lib.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.ov_pcm_total.restype = ctypes.c_int64
            lib.ov_pcm_total.argtypes = [ctypes.c_void_p,
                                         ctypes.c_int]
            lib.ov_read.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int)]
            lib.ov_clear.argtypes = [ctypes.c_void_p]
        _vorbisfile = lib if lib is not None else False
    return _vorbisfile or None


def vorbis_libs():
    """returns (libvorbis, libvorbisenc, libogg) or None"""
    global _vorbis, _vorbisenc, _ogg
    if _vorbis is None:
        _vorbis = _load("vorbis") or False
        _vorbisenc = _load("vorbisenc") or False
        _ogg = _load("ogg") or False
    if _vorbis and _vorbisenc and _ogg:
        return (_vorbis, _vorbisenc, _ogg)
    return None


class VorbisInfo(ctypes.Structure):
    """the public head of struct vorbis_info (vorbis/codec.h)"""
    _fields_ = [("version", ctypes.c_int),
                ("channels", ctypes.c_int),
                ("rate", ctypes.c_long),
                ("bitrate_upper", ctypes.c_long),
                ("bitrate_nominal", ctypes.c_long),
                ("bitrate_lower", ctypes.c_long),
                ("bitrate_window", ctypes.c_long),
                ("codec_setup", ctypes.c_void_p)]


class OggPacket(ctypes.Structure):
    """struct ogg_packet (ogg/ogg.h, stable public layout)"""
    _fields_ = [("packet", ctypes.POINTER(ctypes.c_ubyte)),
                ("bytes", ctypes.c_long),
                ("b_o_s", ctypes.c_long),
                ("e_o_s", ctypes.c_long),
                ("granulepos", ctypes.c_int64),
                ("packetno", ctypes.c_int64)]


class OggPage(ctypes.Structure):
    """struct ogg_page (ogg/ogg.h, stable public layout)"""
    _fields_ = [("header", ctypes.POINTER(ctypes.c_ubyte)),
                ("header_len", ctypes.c_long),
                ("body", ctypes.POINTER(ctypes.c_ubyte)),
                ("body_len", ctypes.c_long)]


# generous opaque storage for libvorbis/libogg state structs
_OPAQUE = 8192


# Vorbis decodes in 8-channel Vorbis order; map to wave order for
# common layouts (Vorbis I spec channel order)
VORBIS_TO_WAVE = {
    3: [0, 2, 1],                 # L C R -> L R C
    5: [0, 2, 1, 3, 4],           # L C R BL BR -> L R C BL BR
    6: [0, 2, 1, 5, 3, 4],        # L C R BL BR LFE -> L R C LFE BL BR
}
WAVE_TO_VORBIS = {
    n: [order.index(i) for i in range(n)]
    for (n, order) in VORBIS_TO_WAVE.items()
}


class VorbisDecoder:
    """a PCMReader decoding Ogg Vorbis via libvorbisfile"""

    def __init__(self, filename):
        lib = vorbisfile_lib()
        if lib is None:
            raise ValueError("libvorbisfile unavailable")
        self.lib = lib
        self.vf = (ctypes.c_char * _OPAQUE)()
        if lib.ov_fopen(filename.encode("utf-8"), self.vf) != 0:
            raise ValueError("unable to open Vorbis file")
        info = lib.ov_info(self.vf, -1).contents
        self.sample_rate = int(info.rate)
        self.channels = int(info.channels)
        self.channel_mask = int(
            {1: 0x4, 2: 0x3, 3: 0x7, 5: 0x37, 6: 0x3F}.get(
                self.channels, 0))
        self.bits_per_sample = 16
        self.closed = False

    def read(self, pcm_frames):
        if self.closed:
            raise ValueError("stream is closed")
        want = max(pcm_frames, 1) * self.channels * 2
        buf = (ctypes.c_char * want)()
        bitstream = ctypes.c_int(0)
        n = self.lib.ov_read(self.vf, buf, want, 0, 2, 1,
                             ctypes.byref(bitstream))
        if n <= 0:
            return pcm.empty_framelist(self.channels, 16)
        samples = np.frombuffer(bytes(buf[:n]),
                                dtype="<i2").astype(np.int32)
        samples = samples.reshape(-1, self.channels)
        order = VORBIS_TO_WAVE.get(self.channels)
        if order is not None:
            samples = samples[:, order]
        return pcm.FrameList._wrap(
            np.ascontiguousarray(samples), 16)

    def close(self):
        if not self.closed:
            self.lib.ov_clear(self.vf)
        self.closed = True


def encode_vorbis(filename, pcmreader, quality=0.3):
    """encodes an Ogg Vorbis file via libvorbisenc

    quality: VBR quality -0.1 .. 1.0 (VorbisAudio's modes over 10)"""
    libs = vorbis_libs()
    if libs is None:
        raise ValueError("libvorbis unavailable")
    (vorbis, vorbisenc, ogg) = libs

    vorbis.vorbis_analysis_buffer.restype = \
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float))

    vi = (ctypes.c_char * _OPAQUE)()
    vc = (ctypes.c_char * _OPAQUE)()
    vd = (ctypes.c_char * _OPAQUE)()
    vb = (ctypes.c_char * _OPAQUE)()
    os_state = (ctypes.c_char * _OPAQUE)()

    vorbis.vorbis_info_init(vi)
    if vorbisenc.vorbis_encode_init_vbr(
            vi, ctypes.c_long(pcmreader.channels),
            ctypes.c_long(pcmreader.sample_rate),
            ctypes.c_float(quality)) != 0:
        vorbis.vorbis_info_clear(vi)
        raise ValueError("unsupported Vorbis encoding parameters")
    vorbis.vorbis_comment_init(vc)
    vorbis.vorbis_analysis_init(vd, vi)
    vorbis.vorbis_block_init(vd, vb)
    ogg.ogg_stream_init(os_state, 0x56524253)

    header = OggPacket()
    header_comm = OggPacket()
    header_code = OggPacket()
    op = OggPacket()
    og = OggPage()

    reorder = WAVE_TO_VORBIS.get(pcmreader.channels)

    try:
        with open(filename, "wb") as out:
            def write_pages(force):
                while True:
                    fn = (ogg.ogg_stream_flush if force
                          else ogg.ogg_stream_pageout)
                    if fn(os_state, ctypes.byref(og)) == 0:
                        break
                    out.write(ctypes.string_at(og.header,
                                               og.header_len))
                    out.write(ctypes.string_at(og.body, og.body_len))

            vorbis.vorbis_analysis_headerout(
                vd, vc, ctypes.byref(header),
                ctypes.byref(header_comm), ctypes.byref(header_code))
            ogg.ogg_stream_packetin(os_state, ctypes.byref(header))
            ogg.ogg_stream_packetin(os_state,
                                    ctypes.byref(header_comm))
            ogg.ogg_stream_packetin(os_state,
                                    ctypes.byref(header_code))
            write_pages(force=True)

            eos = False
            while not eos:
                framelist = pcmreader.read(4096)
                n = framelist.frames
                if n == 0:
                    vorbis.vorbis_analysis_wrote(vd, 0)
                else:
                    buffer = vorbis.vorbis_analysis_buffer(vd, n)
                    scale = float(1 << (pcmreader.bits_per_sample -
                                        1))
                    samples = framelist.samples
                    if reorder is not None:
                        samples = samples[:, reorder]
                    floats = (samples.astype(np.float32) /
                              np.float32(scale))
                    for c in range(pcmreader.channels):
                        col = np.ascontiguousarray(floats[:, c])
                        ctypes.memmove(
                            buffer[c],
                            col.ctypes.data_as(ctypes.c_void_p),
                            n * 4)
                    vorbis.vorbis_analysis_wrote(vd, n)

                while vorbis.vorbis_analysis_blockout(vd, vb) == 1:
                    vorbis.vorbis_analysis(vb, None)
                    vorbis.vorbis_bitrate_addblock(vb)
                    while vorbis.vorbis_bitrate_flushpacket(
                            vd, ctypes.byref(op)) == 1:
                        ogg.ogg_stream_packetin(os_state,
                                                ctypes.byref(op))
                        if op.e_o_s:
                            eos = True
                        write_pages(force=False)
                if n == 0:
                    break
            write_pages(force=True)
    finally:
        ogg.ogg_stream_clear(os_state)
        vorbis.vorbis_block_clear(vb)
        vorbis.vorbis_dsp_clear(vd)
        vorbis.vorbis_comment_clear(vc)
        vorbis.vorbis_info_clear(vi)
