"""What the port's ALAC paths need of the reference's ALAC oracle
(``audiotools_tpu/ref/alac.py``): the frameset channel layouts, and
the M4A header parse of its ``ALACDecoder`` together with the stsz
frame-size table of ``FastALACDecoder._read_frame_sizes``.

The reference walks the atoms with its bitstream reader; here the
walk reads the atom headers with ``struct``: the top-level atoms by
seeking over them (the mdat is never read), and ``moov`` whole.
"""

from __future__ import annotations

import struct

# frameset channel-pair groupings per channel count, as (offset,
# width) in ALAC channel order
FRAMESET_LAYOUT = {
    1: [(0, 1)],
    2: [(0, 2)],
    3: [(2, 1), (0, 2)],
    4: [(2, 1), (0, 2), (3, 1)],
    5: [(2, 1), (0, 2), (3, 2)],
    6: [(2, 1), (0, 2), (4, 2), (3, 1)],
    7: [(2, 1), (0, 2), (4, 2), (6, 1), (3, 1)],
    8: [(2, 1), (6, 2), (0, 2), (4, 2), (3, 1)],
}

# decoder side: ALAC frameset channel order -> wave channel order
WAVE_ORDER = {
    1: [0], 2: [0, 1],
    3: [1, 2, 0],
    4: [1, 2, 0, 3],
    5: [1, 2, 0, 3, 4],
    6: [1, 2, 0, 5, 3, 4],
    7: [1, 2, 0, 6, 3, 4, 5],
    8: [3, 4, 0, 7, 5, 6, 1, 2],
}

CHANNEL_MASKS = {1: 0x0004, 2: 0x0003, 3: 0x0007, 4: 0x0107,
                 5: 0x0037, 6: 0x003F, 7: 0x013F, 8: 0x00FF}


def _atoms(data):
    """(name, payload) of each atom in ``data``, in order; stops at a
    size below 8 or an atom running past the end"""
    pos = 0
    while pos + 8 <= len(data):
        (size, name) = struct.unpack(">I4s", data[pos:pos + 8])
        if size < 8 or pos + size > len(data):
            return
        yield (name, data[pos + 8:pos + size])
        pos += size


def _find(data, *names):
    """the payload of the nested atom ``names`` in ``data``; raises
    KeyError with the first name not found"""
    for name in names:
        for (atom, payload) in _atoms(data):
            if atom == name:
                data = payload
                break
        else:
            raise KeyError(name)
    return data


def _top_level(file):
    """the top-level atoms of ``file`` from its current position:
    returns (moov payload or None, offset of the mdat payload or
    None), reading nothing of the mdat"""
    (moov, mdat) = (None, None)
    pos = file.tell()
    while moov is None or mdat is None:
        file.seek(pos)
        header = file.read(8)
        if len(header) < 8:
            break
        (size, name) = struct.unpack(">I4s", header)
        if size < 8:
            break
        if name == b"mdat":
            mdat = pos + 8
        elif name == b"moov":
            moov = file.read(size - 8)
        pos += size
    return (moov, mdat)


def read_m4a_header(file):
    """parses an ALAC M4A file's atoms from a seekable binary file at
    its start

    Returns a dict of the reference ALACDecoder's attributes
    (samples_per_frame, bits_per_sample, history_multiplier,
    initial_history, maximum_k, channels, sample_rate, channel_mask,
    total_pcm_frames), ``mdat_offset``, the file offset of the first
    frameset, and ``frame_sizes``, the stsz table (empty when it cannot
    be read, as in the reference).  Raises ValueError where the
    reference's parse fails."""
    (moov, mdat) = _top_level(file)
    if moov is None:
        raise ValueError("required stsd atom not found")
    try:
        stsd = _find(moov, b"trak", b"mdia", b"minf", b"stbl", b"stsd")
    except KeyError:
        raise ValueError("required stsd atom not found")
    if len(stsd) < 80:
        raise ValueError("invalid alac atom")
    # version/flags, entry count, then the alac sample entry and its
    # alac sub-atom (ALACAudio's layout)
    if stsd[12:16] != b"alac" or stsd[48:52] != b"alac":
        raise ValueError("invalid alac atom")
    (samples_per_frame,) = struct.unpack(">I", stsd[56:60])
    (bits_per_sample, history_multiplier, initial_history, maximum_k,
     channels) = struct.unpack(">5B", stsd[61:66])
    (sample_rate,) = struct.unpack(">I", stsd[76:80])

    try:
        mdhd = _find(moov, b"trak", b"mdia", b"mdhd")
    except KeyError:
        raise ValueError("required mdhd atom not found")
    version = mdhd[0] if mdhd else -1
    if version == 0 and len(mdhd) >= 20:
        (total_pcm_frames,) = struct.unpack(">I", mdhd[16:20])
    elif version == 1 and len(mdhd) >= 32:
        (total_pcm_frames,) = struct.unpack(">Q", mdhd[24:32])
    else:
        raise ValueError("invalid mdhd version")
    if mdat is None:
        raise ValueError("mdat atom not found")

    try:
        stsz = _find(moov, b"trak", b"mdia", b"minf", b"stbl", b"stsz")
        (fixed_size, count) = struct.unpack(">II", stsz[4:12])
        if fixed_size:
            frame_sizes = [fixed_size] * count
        else:
            frame_sizes = list(struct.unpack(">%dI" % (count,),
                                             stsz[12:12 + 4 * count]))
    except (KeyError, struct.error):
        frame_sizes = []

    return dict(samples_per_frame=samples_per_frame,
                bits_per_sample=bits_per_sample,
                history_multiplier=history_multiplier,
                initial_history=initial_history,
                maximum_k=maximum_k, channels=channels,
                sample_rate=sample_rate,
                channel_mask=CHANNEL_MASKS.get(channels, 0),
                total_pcm_frames=total_pcm_frames,
                mdat_offset=mdat, frame_sizes=frame_sizes)
