"""What the port's ALAC paths need of the reference's ALAC oracle
(``audiotools_tpu/ref/alac.py``): the frameset channel layouts, the
ALAC half of the quantized-analysis spec (``qpack_enabled``,
``plan_t``, ``quantize_channel``, ``pick_candidate``,
``group_score``, ``floor_limited``, ``analysis_channels``), and the
M4A header parse of its ``ALACDecoder`` together with the stsz
frame-size table of ``FastALACDecoder._read_frame_sizes``.

The spec functions are scalar, one channel or group at a time; the
batched encode (``codecs/alac_fast.py``) applies the same rules to a
batch, and the tests hold the two to each other.

The reference walks the atoms with its bitstream reader; here the
walk reads the atom headers with ``struct``: the top-level atoms by
seeking over them (the mdat is never read), and ``moov`` whole.
"""

from __future__ import annotations

import os
import struct

import numpy as np

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


# ---------------------------------------------------------------------
# quantized-analysis spec: the candidate analysis runs on (x >> t) << t
# per channel while the emitter's residual recurrences always read the
# exact samples, so any candidate table gives a lossless stream
# ---------------------------------------------------------------------

def qpack_enabled():
    """whether the ALAC quantized analysis is on (ATPU_ALAC_QPACK,
    default on)"""
    return os.environ.get("ATPU_ALAC_QPACK", "1") != "0"


def qpack_guard():
    return int(os.environ.get("ATPU_QPACK_GUARD", "0"))


def qpack_cap_margin():
    return int(os.environ.get("ATPU_QPACK_CAP", "6"))


def qpack_noise_extra():
    return int(os.environ.get("ATPU_QPACK_NOISE_EXTRA", "2"))


def plan_t(channel, bps_eff, block_size):
    """the quantization shift t of one (LSB-shifted) channel, over the
    channel zero-padded to block_size: the FLAC plan's spec
    (ops/qpack.plan_t), noise-adaptive coarsening included"""
    n = block_size
    if n <= 2:
        return 0
    x = np.zeros(n, dtype=np.int64)
    x[:len(channel)] = channel
    sum1 = int(np.abs(x[1:] - x[:-1]).sum())
    sum2 = int(np.abs(x[2:] - 2 * x[1:-1] + x[:-2]).sum())
    m = sum2 // (n - 2)
    s = max(0, int(bps_eff) - 26)
    extra = qpack_noise_extra()
    e = 0
    marg = qpack_cap_margin()
    if (extra > 0 and m > 0 and
            5 * (sum2 >> s) * (n - 1) >= 8 * (sum1 >> s) * (n - 2)):
        e = extra
        marg = max(marg - 2, 0)
    cap = max(int(bps_eff) - marg, 0)
    return min(max(m.bit_length() - 1 - qpack_guard() + e, 0), cap)


def quantize_channel(channel, t):
    """the analysis input (x >> t) << t"""
    if t == 0:
        return list(channel)
    return [(int(s) >> t) << t for s in channel]


def analysis_channels(channels, bps_eff, block_size):
    """(t_group, the channels the candidate analysis reads): quantized
    at their planned shifts when the spec is on and the group's largest
    shift is positive, else the channels as given"""
    if not qpack_enabled():
        return (0, channels)
    ts = [plan_t(c, bps_eff, block_size) for c in channels]
    t_group = max(ts)
    if t_group <= 0:
        return (0, channels)
    return (t_group, [quantize_channel(c, t) for (c, t) in zip(channels, ts)])


def pick_candidate(cand):
    """(order, qlp, est) of a (qlp4, qlp8, degenerate, est4, est8)
    candidate: order 4 when degenerate or est4 <= est8"""
    (qlp4, qlp8, degenerate, est4, est8) = cand
    if degenerate or est4 <= est8:
        return (4, qlp4, est4)
    return (8, qlp8, est8)


def group_score(cands):
    """a group's summed estimate over its chosen candidates"""
    return sum(pick_candidate(c)[2] for c in cands)


def floor_limited(cands, t_group, block_size, bps_eff):
    """the quantization-floor retry rule: a group whose chosen
    candidate's estimated mean |residual| has a bit length of at least
    t_group + 2 is re-analysed exactly (the quantization hurt its
    fit); a group at the plan's cap (bps_eff - cap margin) or with
    t_group 0 never is"""
    if t_group <= 0:
        return False
    if t_group >= max(int(bps_eff) - qpack_cap_margin(), 0):
        return False
    for cand in cands:
        (order, _qlp, est) = pick_candidate(cand)
        count = block_size - 1 - order
        if count <= 0:
            continue
        if ((int(est) * 64) // count).bit_length() >= t_group + 2:
            return True
    return False


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
