"""Synthetic DVD-Audio discs for the port's tests and its smoke run.

An AUDIO_TS directory is written from numpy arrays: AUDIO_TS.IFO, an
ATS_XX_0.IFO a titleset (its titles, their tracks' PTS lengths and
sector spans) and the titleset's AOB files, split into ATS_XX_1.AOB,
ATS_XX_2.AOB, ... at a sector boundary when asked.  A title's sectors
are MPEG program stream packs, each holding one 0xBD private-stream
packet: PCM (0xA0, the byte-swap matrices of ``dvda.AOB_BYTE_SWAP``)
or MLP (0xA1, frames from ``ref.mlp.MLPEncoder`` or
``MLPEncoderMulti``).  ``cppm_scramble`` encrypts a disc's packs with
a synthetic C2 cipher as a CPPM disc holds them.  The sectors are
built with numpy, a title at a time, so that a title of minutes is
written in seconds.  Nothing here imports the reference package."""

import os

import numpy as np

from audiotools_tpu_torch import cppm
from audiotools_tpu_torch.bitstream import BitstreamRecorder
from audiotools_tpu_torch.dvda import AOB_BYTE_SWAP
from audiotools_tpu_torch.ref.mlp import MLPEncoder, MLPEncoderMulti

SECTOR = 2048
PTS_PER_SECOND = 90000
RATE_FIELD = {48000: 0, 96000: 1, 192000: 2, 44100: 8, 88200: 9,
              176400: 10}
BPS_FIELD = {16: 0, 20: 1, 24: 2}
# the channel-assignment field of each channel count's default layout
ASSIGNMENT = {1: 0x00, 2: 0x01, 3: 0x02, 4: 0x03, 5: 0x06, 6: 0x0C}


def build(format_string, values):
    writer = BitstreamRecorder()
    writer.build(format_string, values)
    return writer.data()


def pack_header():
    """the 14-byte program stream pack header (no stuffing)"""
    return build("32u 2u 3u 1u 15u 1u 15u 1u 9u 1u 22u 2u 5u 3u",
                 [0x1BA, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 3, 0, 0])


def audio_ts_ifo(titlesets):
    """AUDIO_TS.IFO naming ``titlesets`` audio titlesets"""
    head = build("96u 32u 96u 32u 16u 32u 16u 16u 8u 32u 8u 32u 80u 8u 8u "
                 "320u",
                 [int.from_bytes(b"DVDAUDIO-AMG", "big"), 0, 0, 0, 0x12, 0,
                  1, 1, 0, 0, 0, 0, 0, 0, titlesets, 0])
    return head.ljust(SECTOR * 2, b"\x00")


def ats_ifo(titles):
    """ATS_XX_0.IFO of ``titles``, each a list of its tracks as
    (pts_length, first_sector, last_sector)"""
    tables = []
    for tracks in titles:
        n = len(tracks)
        table = build("16u 8u 8u 32u 32u 16u 16u",
                      [0, n, n, sum(t[0] for t in tracks), 0, 16 + 20 * n,
                       0])
        first_pts = 0
        for (i, (pts, _first, _last)) in enumerate(tracks):
            table += build("32u 8u 8u 32u 32u 48u",
                           [0, i + 1, 0, first_pts, pts, 0])
            first_pts += pts
        for (_pts, first, last) in tracks:
            table += build("32u 32u 32u", [0x01000000, first, last])
        tables.append(table)
    head = build("16u 16u 32u", [len(titles), 0, 0])
    offset = 8 + 8 * len(titles)
    for (number, table) in enumerate(tables, 1):
        head += build("8u 24u 32u", [number, 0, offset])
        offset += len(table)
    return (b"DVDAUDIO-ATS".ljust(SECTOR, b"\x00") +
            (head + b"".join(tables)).ljust(SECTOR, b"\x00"))


def sectors_of(payload, body_header, room):
    """``payload`` cut into packs of ``room`` bytes, each in one 0xBD
    packet after ``body_header``; the sector's tail padded with 0xFF:
    bytes of whole sectors"""
    payload = np.frombuffer(payload, dtype=np.uint8)
    count = -(-len(payload) // room)
    prefix = np.frombuffer(pack_header() + b"\x00\x00\x01\xBD", np.uint8)
    sectors = np.full((count, SECTOR), 0xFF, dtype=np.uint8)
    sectors[:, :len(prefix)] = prefix
    lengths = np.full(count, room)
    lengths[-1] = len(payload) - room * (count - 1)
    packet_lengths = lengths + len(body_header)
    sectors[:, 18] = packet_lengths >> 8
    sectors[:, 19] = packet_lengths & 0xFF
    start = 20 + len(body_header)
    sectors[:, 20:start] = np.frombuffer(body_header, np.uint8)
    full = np.zeros(count * room, dtype=np.uint8)
    full[:len(payload)] = payload
    sectors[:, start:start + room] = full.reshape(count, room)
    last = lengths[-1]
    sectors[-1, start + last:start + room] = 0xFF
    return sectors.tobytes()


def pcm_sectors(samples, bits_per_sample, sample_rate):
    """the AOB sectors of int [frames, channels] ``samples`` as a PCM
    (0xA0) stream; frames must be even (the matrices swap 2 at a time)"""
    samples = np.asarray(samples, dtype=np.int64)
    (frames, channels) = samples.shape
    swap = AOB_BYTE_SWAP[(bits_per_sample, channels)]
    width = bits_per_sample // 8
    flat = samples.reshape(-1) & ((1 << bits_per_sample) - 1)
    little = np.stack([(flat >> (8 * b)) & 0xFF for b in range(width)],
                      axis=1).astype(np.uint8)
    chunks = little.reshape(-1, len(swap))
    payload = chunks[:, swap].tobytes()
    body = build("16u 8u 8u 8u 8u 8u 16u 8u 4u 4u 4u 4u 8u 8u 8u 8u",
                 [0, 0, 0xA0, 0, 0, 9, 0, 0, BPS_FIELD[bits_per_sample], 0,
                  RATE_FIELD[sample_rate], 0, 0, ASSIGNMENT[channels], 0,
                  0])
    room = SECTOR - 20 - len(body)
    return sectors_of(payload, body, room - room % len(swap))


def mlp_stream(samples, bits_per_sample=16, sample_rate=48000, frame=160,
               **encoder):
    """an MLP stream of int [frames, channels] ``samples`` (a multiple of
    ``frame`` long): MLPEncoder for 1-2 channels, MLPEncoderMulti for
    3-6, with the codebook, filters and matrices ``encoder`` gives"""
    samples = np.asarray(samples, dtype=np.int64)
    channels = samples.shape[1]
    options = dict(codebook=1, huffman_lsbs=min(bits_per_sample + 1, 22),
                   block_size=40)
    options.update(encoder)
    cls = MLPEncoder if channels <= 2 else MLPEncoderMulti
    enc = cls(sample_rate=sample_rate, bits_per_sample=bits_per_sample,
              channels=channels, **options)
    return b"".join(enc.encode_frame(samples[i:i + frame])
                    for i in range(0, len(samples), frame))


def mlp_sectors(stream):
    """the AOB sectors of an MLP (0xA1) stream"""
    body = build("16u 8u 8u 8u 8u 8u", [0, 0, 0xA1, 0, 0, 0])
    return sectors_of(stream, body, SECTOR - 20 - len(body))


def pts_of(frames, sample_rate):
    """the PTS length of ``frames`` (exact where the rate allows)"""
    return frames * PTS_PER_SECOND // sample_rate


def title_tracks(sectors, track_frames, sample_rate):
    """a title's tracks as (pts_length, first, last) over ``sectors``
    sectors split evenly between them (a sector shared where the title
    has fewer sectors than tracks)"""
    n = len(track_frames)
    per = max(sectors // n, 1)
    return [(pts_of(f, sample_rate), min(i * per, sectors - 1),
             sectors - 1 if i == n - 1 else min((i + 1) * per, sectors) - 1)
            for (i, f) in enumerate(track_frames)]


def write_audio_ts(directory, titlesets, aob_sectors=None):
    """writes AUDIO_TS under ``directory``: ``titlesets`` a list of
    titlesets, each a list of titles (sector bytes, track frame counts,
    sample rate); each titleset's AOB split every ``aob_sectors``
    sectors when given; returns the AUDIO_TS path"""
    path = os.path.join(directory, "AUDIO_TS")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "AUDIO_TS.IFO"), "wb") as f:
        f.write(audio_ts_ifo(len(titlesets)))
    for (ts, titles) in enumerate(titlesets, 1):
        aob = b""
        ifo_titles = []
        for (data, track_frames, sample_rate) in titles:
            base = len(aob) // SECTOR
            ifo_titles.append([(pts, base + first, base + last)
                               for (pts, first, last) in title_tracks(
                                   len(data) // SECTOR, track_frames,
                                   sample_rate)])
            aob += data
        with open(os.path.join(path, "ATS_%2.2d_0.IFO" % (ts,)), "wb") as f:
            f.write(ats_ifo(ifo_titles))
        step = (aob_sectors or len(aob) // SECTOR) * SECTOR
        for (k, start) in enumerate(range(0, len(aob), step), 1):
            with open(os.path.join(path, "ATS_%2.2d_%d.AOB" % (ts, k)),
                      "wb") as f:
                f.write(aob[start:start + step])
    return path


def signal(frames, channels, bits_per_sample, seed=5):
    """int32 [frames, channels]: a tone a channel and noise, within
    ``bits_per_sample``"""
    rng = np.random.default_rng(seed)
    t = np.arange(frames)
    peak = (1 << (bits_per_sample - 1)) - 1
    columns = [0.3 * peak * np.sin(2 * np.pi * (0.004 + 0.0013 * c) * t) +
               rng.normal(0, peak * 0.01, frames) for c in range(channels)]
    return np.clip(np.stack(columns, axis=1), -peak - 1,
                   peak).astype(np.int32)


def synthetic_cipher(seed=5):
    """a C2 cipher over random S-boxes (the real ones are licensed)"""
    rng = np.random.default_rng(seed)
    sbox = [int(v) for v in rng.integers(0, 256, 256)]
    sbox_f = [int(v) for v in rng.integers(0, 1 << 32, 256,
                                           dtype=np.uint64)]
    return cppm.C2Cipher(sbox, sbox_f)


def cppm_scramble(audio_ts, cipher, media_key, id_album):
    """encrypts every pack of every AOB under ``audio_ts`` in place as a
    CPPM disc holds it (the payload after byte 128 D-CBC encrypted under
    the pack's content key, the scrambling bits set); returns the number
    of packs"""
    count = 0
    k_au = cipher.g(id_album, media_key) & cppm.MASK56
    start = cppm.BLOCK_SIZE - cppm.ENCRYPTED_SIZE
    for name in sorted(os.listdir(audio_ts)):
        if not name.upper().endswith(".AOB"):
            continue
        path = os.path.join(audio_ts, name)
        with open(path, "rb") as f:
            data = bytearray(f.read())
        for pos in range(0, len(data), SECTOR):
            sector = data[pos:pos + SECTOR]
            k_i = k_au
            for offset in (24, 32, 40, 48):
                k_i = cipher.g(int.from_bytes(sector[offset:offset + 8],
                                              "big"), k_i) & cppm.MASK56
            k_c = cipher.g(int.from_bytes(sector[84:92], "big"),
                           k_i) & cppm.MASK56
            sector[start:] = cipher.dcbc_enc(bytes(sector[start:]), k_c)
            sector[20] = (sector[20] & 0xCF) | 0x10
            data[pos:pos + SECTOR] = sector
            count += 1
        with open(path, "wb") as f:
            f.write(bytes(data))
    return count
