"""PCM in and out around the port's codecs.

The port's readers follow the reference's PCMReader protocol: an
object with ``sample_rate``, ``channels``, ``channel_mask`` and
``bits_per_sample`` and a ``read(pcm_frames)`` that returns a frame
list (empty at the end) whose ``samples`` are int32 [frames,
channels].  The encoder and decoder accept any such reader, the
reference's included; this module has the port's own.
"""

from __future__ import annotations

import io

import numpy as np

from . import _native

# frames a buffered read asks of the wrapped reader at least
# (the reference's FRAMELIST_SIZE)
FRAMELIST_SIZE = 0x100000 // 4

# channel masks of the WAVE/FLAC default layouts, by channel count
CHANNEL_MASKS = {1: 0x0004, 2: 0x0003, 3: 0x0007, 4: 0x0033,
                 5: 0x0037, 6: 0x003F, 7: 0x013F, 8: 0x063F}


class FrameList:
    """int32 PCM samples [frames, channels] in interleaved (WAVE)
    channel order, with their bits per sample"""

    __slots__ = ("samples", "bits_per_sample")

    def __init__(self, samples, bits_per_sample):
        self.samples = samples
        self.bits_per_sample = bits_per_sample

    @property
    def frames(self):
        return self.samples.shape[0]

    @property
    def channels(self):
        return self.samples.shape[1]

    def to_bytes(self, is_big_endian, is_signed):
        """the samples as packed PCM bytes (8, 16 or 24 bits)"""
        width = self.bits_per_sample // 8
        if width in (1, 2):
            values = np.asarray(self.samples).reshape(-1)
            if not is_signed:
                values = values + (1 << (self.bits_per_sample - 1))
            dtype = (("u1" if not is_signed else "i1") if width == 1 else
                     (">" if is_big_endian else "<") +
                     ("u2" if not is_signed else "i2"))
            return values.astype(dtype).tobytes()
        values = self.samples.astype(np.int64).reshape(-1)
        if not is_signed:
            values = values + (1 << (self.bits_per_sample - 1))
        shifts = np.arange(width, dtype=np.int64) * 8
        if is_big_endian:
            shifts = shifts[::-1]
        return ((values[:, None] >> shifts) & 0xFF).astype(
            np.uint8).tobytes()


def bytes_to_samples(data, channels, bits_per_sample, signed, big_endian):
    """packed PCM bytes of 8, 16 or 24 bits -> int32 [frames, channels]"""
    width = bits_per_sample // 8
    if width == 1:
        values = np.frombuffer(data, dtype=np.int8 if signed else np.uint8)
        values = values.astype(np.int32)
        if not signed:
            values -= 128
    elif width == 2:
        values = np.frombuffer(data, dtype=(">" if big_endian else "<") +
                               ("i2" if signed else "u2")).astype(np.int32)
        if not signed:
            values -= 1 << 15
    else:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        (low, high) = (2, 0) if big_endian else (0, 2)
        top = raw[:, high].astype(np.int8 if signed else np.uint8)
        values = (raw[:, low].astype(np.int32) |
                  (raw[:, 1].astype(np.int32) << 8) |
                  (top.astype(np.int32) << 16))
        if not signed:
            values -= 1 << 23
    return values.reshape(-1, channels)


class PCMReader:
    """a PCMReader over a binary stream of packed PCM (the reference's
    ``pcmstream.PCMReader``): ``signed`` and ``big_endian`` give the
    samples' form; a partial frame at the stream's end is dropped"""

    def __init__(self, file, sample_rate, channels, channel_mask,
                 bits_per_sample, signed=True, big_endian=False):
        self.file = file
        self.sample_rate = sample_rate
        self.channels = channels
        self.channel_mask = channel_mask
        self.bits_per_sample = bits_per_sample
        self.signed = signed
        self.big_endian = big_endian
        self.bytes_per_frame = channels * (bits_per_sample // 8)

    def read(self, pcm_frames):
        """up to max(pcm_frames, 1) frames; empty at the end"""
        data = self.file.read(max(int(pcm_frames), 1) * self.bytes_per_frame)
        data = data[:len(data) - len(data) % self.bytes_per_frame]
        return FrameList(bytes_to_samples(data, self.channels,
                                          self.bits_per_sample, self.signed,
                                          self.big_endian),
                         self.bits_per_sample)

    def close(self):
        self.file.close()


class LimitedFileReader:
    """at most ``total_bytes`` bytes of a binary file, from its position
    (the reference's ``pcmstream.LimitedFileReader``)"""

    def __init__(self, file, total_bytes):
        self.file = file
        self.remaining = total_bytes

    def read(self, size):
        data = self.file.read(max(min(size, self.remaining), 0))
        self.remaining -= len(data)
        return data

    def close(self):
        self.file.close()


def transfer_framelist_data(pcmreader, to_function, signed=True,
                            big_endian=False):
    """passes each of a PCMReader's frame lists to ``to_function`` as
    packed PCM bytes, until the reader ends (the reference's
    ``pcmstream.transfer_framelist_data``)"""
    while True:
        framelist = pcmreader.read(FRAMELIST_SIZE)
        if framelist.frames == 0:
            return
        to_function(FrameList(framelist.samples,
                              pcmreader.bits_per_sample).to_bytes(
                                  big_endian, signed))


def empty_framelist(channels, bits_per_sample):
    return FrameList(np.zeros((0, channels), dtype=np.int32),
                     bits_per_sample)


class PCMReaderError:
    """a PCMReader whose every read raises ValueError with
    ``error_message`` (the reference's ``pcmstream.PCMReaderError``):
    what a lossy class's ``to_pcm`` returns when its decoder cannot
    open the file"""

    def __init__(self, error_message, sample_rate, channels, channel_mask,
                 bits_per_sample):
        self.error_message = error_message
        self.sample_rate = sample_rate
        self.channels = channels
        self.channel_mask = channel_mask
        self.bits_per_sample = bits_per_sample

    def read(self, pcm_frames):
        raise ValueError(self.error_message)

    def close(self):
        pass


class _ArrayReader:
    """a PCMReader over an int32 sample array [frames, channels]"""

    def __init__(self, samples, bits_per_sample, sample_rate):
        self.samples = np.ascontiguousarray(samples, dtype=np.int32)
        self.sample_rate = sample_rate
        self.channels = self.samples.shape[1]
        self.channel_mask = CHANNEL_MASKS.get(self.channels, 0)
        self.bits_per_sample = bits_per_sample
        self.offset = 0

    def read(self, pcm_frames):
        """up to max(pcm_frames, 1) frames; empty at the end"""
        start = self.offset
        self.offset = min(start + max(int(pcm_frames), 1),
                          self.samples.shape[0])
        return FrameList(self.samples[start:self.offset],
                         self.bits_per_sample)

    def close(self):
        pass


def reader_from_array(samples, bits_per_sample, sample_rate=44100):
    """a PCMReader over int32 ``samples`` [frames, channels]"""
    return _ArrayReader(samples, bits_per_sample, sample_rate)


class BufferedPCMReader:
    """a PCMReader which reads exact counts of PCM frames from any
    PCMReader (the reference's ``pcmstream.BufferedPCMReader``)"""

    def __init__(self, pcmreader):
        self.pcmreader = pcmreader
        self.sample_rate = pcmreader.sample_rate
        self.channels = pcmreader.channels
        self.channel_mask = pcmreader.channel_mask
        self.bits_per_sample = pcmreader.bits_per_sample
        self.buffer = np.zeros((0, self.channels), dtype=np.int32)
        self.closed = False

    def read(self, pcm_frames):
        """exactly pcm_frames frames (fewer only at the end), never
        more; asks the wrapped reader for all that is missing in one
        call, and loops because a reader may return less"""
        if self.closed:
            raise ValueError("stream is closed")
        pieces = [self.buffer] if self.buffer.shape[0] else []
        have = self.buffer.shape[0]
        while have < pcm_frames:
            frame = self.pcmreader.read(max(pcm_frames - have,
                                            FRAMELIST_SIZE))
            if frame.frames == 0:
                break
            pieces.append(np.asarray(frame.samples, dtype=np.int32))
            have += frame.frames
        if not pieces:
            buf = self.buffer
        elif len(pieces) == 1:
            buf = pieces[0]
        else:
            buf = np.concatenate(pieces, axis=0)
        self.buffer = buf[pcm_frames:]
        return FrameList(buf[:pcm_frames], self.bits_per_sample)

    def close(self):
        self.closed = True
        self.pcmreader.close()


class CounterPCMReader:
    """a PCMReader counting the frames it passes on (the reference's
    ``pcmstream.CounterPCMReader``)"""

    def __init__(self, pcmreader):
        self.pcmreader = pcmreader
        self.sample_rate = pcmreader.sample_rate
        self.channels = pcmreader.channels
        self.channel_mask = pcmreader.channel_mask
        self.bits_per_sample = pcmreader.bits_per_sample
        self.frames_written = 0

    def bytes_written(self):
        """the PCM bytes of the frames passed on"""
        return (self.frames_written * self.channels *
                (self.bits_per_sample // 8))

    def read(self, pcm_frames):
        framelist = self.pcmreader.read(pcm_frames)
        self.frames_written += framelist.frames
        return framelist

    def close(self):
        self.pcmreader.close()


class PCMCat:
    """a PCMReader of several PCMReaders one after another (the
    reference's ``pcmstream.PCMCat``); they must share their sample
    rate, channel count and bits per sample"""

    def __init__(self, pcmreaders):
        self.pcmreaders = list(pcmreaders)
        if len(self.pcmreaders) == 0:
            raise ValueError("at least one PCMReader is required")
        for attr in ("sample_rate", "channels", "bits_per_sample"):
            if len({getattr(r, attr) for r in self.pcmreaders}) != 1:
                raise ValueError("all readers must have the same %s"
                                 % (attr.replace("_", " "),))
        first = self.pcmreaders[0]
        self.sample_rate = first.sample_rate
        self.channels = first.channels
        self.channel_mask = first.channel_mask
        self.bits_per_sample = first.bits_per_sample
        self.index = 0
        self.closed = False

    def read(self, pcm_frames):
        """the current reader's next frames, the next reader's once it
        is done; empty when the last is"""
        if self.closed:
            raise ValueError("stream is closed")
        while self.index < len(self.pcmreaders):
            framelist = self.pcmreaders[self.index].read(pcm_frames)
            if framelist.frames > 0:
                return framelist
            self.index += 1
        return empty_framelist(self.channels, self.bits_per_sample)

    def close(self):
        self.closed = True
        for reader in self.pcmreaders:
            reader.close()


class LimitedPCMReader:
    """at most ``total_pcm_frames`` frames of a BufferedPCMReader (the
    reference's ``pcmstream.LimitedPCMReader``); closing it leaves the
    wrapped reader open"""

    def __init__(self, buffered_pcmreader, total_pcm_frames):
        self.pcmreader = buffered_pcmreader
        self.total_pcm_frames = total_pcm_frames
        self.sample_rate = buffered_pcmreader.sample_rate
        self.channels = buffered_pcmreader.channels
        self.channel_mask = buffered_pcmreader.channel_mask
        self.bits_per_sample = buffered_pcmreader.bits_per_sample
        self.closed = False

    def read(self, pcm_frames):
        if self.closed:
            raise ValueError("stream is closed")
        if self.total_pcm_frames <= 0:
            return empty_framelist(self.channels, self.bits_per_sample)
        frame = self.pcmreader.read(min(pcm_frames, self.total_pcm_frames))
        self.total_pcm_frames -= frame.frames
        return frame

    def close(self):
        self.closed = True


def pcm_split(reader, pcm_lengths):
    """yields a PCMReader of each of ``pcm_lengths`` frames of
    ``reader`` in turn (the reference's ``pcmstream.pcm_split``): each
    track's samples are read whole before it is yielded, so that the
    readers may be consumed in any order or at once, as the reference's
    spooled copies may; the last may be short where ``reader`` is"""
    full_data = BufferedPCMReader(reader)
    try:
        for pcm_length in pcm_lengths:
            part = _ArrayReader(
                read_all(LimitedPCMReader(full_data, pcm_length)),
                reader.bits_per_sample, reader.sample_rate)
            part.channel_mask = reader.channel_mask
            yield part
    finally:
        full_data.close()


def read_all(pcmreader):
    """every frame a PCMReader has left, as int32 [frames, channels]"""
    pieces = []
    while True:
        framelist = pcmreader.read(FRAMELIST_SIZE)
        if framelist.frames == 0:
            break
        pieces.append(np.asarray(framelist.samples, dtype=np.int32))
    if not pieces:
        return np.zeros((0, pcmreader.channels), dtype=np.int32)
    return np.concatenate(pieces, axis=0)


def read_flac_metadata(file):
    """reads a FLAC stream's marker and metadata blocks from a binary
    file object, leaving it at the first frame

    returns a dict: minimum_block_size, maximum_block_size,
    sample_rate, channels, bits_per_sample, total_frames, md5sum (16
    bytes) from STREAMINFO, and seektable, a list of (sample_number,
    byte_offset, frame_count) seekpoints.  Raises ValueError when the
    stream has no FLAC marker or no STREAMINFO, or ends inside its
    metadata."""
    def read(size):
        data = file.read(size)
        if len(data) != size:
            raise ValueError("truncated FLAC metadata")
        return data

    if file.read(4) != b"fLaC":
        raise ValueError("invalid FLAC file (no 'fLaC' marker)")
    meta = None
    seektable = []
    last = 0
    while not last:
        header = read(4)
        (last, block_type) = (header[0] >> 7, header[0] & 0x7F)
        body = read(int.from_bytes(header[1:4], "big"))
        if block_type == 0 and len(body) >= 34:
            info = int.from_bytes(body[10:18], "big")
            meta = dict(
                minimum_block_size=int.from_bytes(body[0:2], "big"),
                maximum_block_size=int.from_bytes(body[2:4], "big"),
                sample_rate=info >> 44,
                channels=((info >> 41) & 0x7) + 1,
                bits_per_sample=((info >> 36) & 0x1F) + 1,
                total_frames=info & ((1 << 36) - 1),
                md5sum=bytes(body[18:34]))
        elif block_type == 3:
            seektable = [
                (int.from_bytes(body[i:i + 8], "big"),
                 int.from_bytes(body[i + 8:i + 16], "big"),
                 int.from_bytes(body[i + 16:i + 18], "big"))
                for i in range(0, len(body) - 17, 18)]
    if meta is None:
        raise ValueError("no STREAMINFO block found")
    meta["seektable"] = seektable
    return meta


def streaminfo(data):
    """(sample_rate, channels, bits_per_sample, total_frames,
    first_frame_offset) of a FLAC stream's bytes

    raises ValueError when the bytes are not a FLAC stream with a
    STREAMINFO block"""
    f = io.BytesIO(data)
    meta = read_flac_metadata(f)
    return (meta["sample_rate"], meta["channels"], meta["bits_per_sample"],
            meta["total_frames"], f.tell())


def decode_flac(data):
    """a whole FLAC stream's bytes -> int32 samples [frames, channels],
    decoded on the host by the port's C++ decoder

    every frame's CRC and the stream's MD5 are checked; raises
    ValueError when the frames hold fewer samples than STREAMINFO
    announces or their MD5 is not the one it records"""
    f = io.BytesIO(data)
    meta = read_flac_metadata(f)
    (channels, total) = (meta["channels"], meta["total_frames"])
    md5 = _native.MD5()
    (samples, _consumed) = _native.flac_decode(
        data[f.tell():], meta["bits_per_sample"], channels, total, md5=md5)
    if samples.shape[0] != total:
        raise ValueError("decoded %d of %d frames"
                         % (samples.shape[0], total))
    if md5.digest() != meta["md5sum"]:
        raise ValueError("decoded samples do not match the stream's MD5")
    return samples


# the speaker bits a channel mask can hold (the reference's
# ChannelMask.SPEAKER_TO_MASK), in stream order from the lowest
SPEAKER_BITS = 0x3FFFF


def mask_speakers(channel_mask):
    """the speaker bits set in a channel mask, in stream order"""
    return [1 << b for b in range(18) if (channel_mask >> b) & 1]


# the speakers' names, by bit from the lowest (the reference
# ChannelMask's attribute names)
SPEAKER_NAMES = ("front_left", "front_right", "front_center",
                 "low_frequency", "back_left", "back_right",
                 "front_left_of_center", "front_right_of_center",
                 "back_center", "side_left", "side_right", "top_center",
                 "top_front_left", "top_front_center", "top_front_right",
                 "top_back_left", "top_back_center", "top_back_right")


class ChannelMask(int):
    """a channel mask with the reference's ``ChannelMask.defined`` and
    ``channels`` (what ``trackinfo -C`` reads)"""

    def defined(self):
        """True when the mask names a speaker"""
        return (self & SPEAKER_BITS) != 0

    def channels(self):
        """the names of the speakers the mask holds, in stream order"""
        return [SPEAKER_NAMES[b] for b in range(len(SPEAKER_NAMES))
                if (self >> b) & 1]


def mask_channel_count(channel_mask):
    """the number of speakers a channel mask names (the reference's
    ``len(ChannelMask(mask))``)"""
    return bin(channel_mask & SPEAKER_BITS).count("1")


class PCMReaderProgress:
    """a PCMReader calling progress(current, total) after each read
    (the reference's ``pcmstream.PCMReaderProgress``)"""

    def __init__(self, pcmreader, total_frames, progress, current_frames=0):
        self.pcmreader = pcmreader
        self.sample_rate = pcmreader.sample_rate
        self.channels = pcmreader.channels
        self.channel_mask = pcmreader.channel_mask
        self.bits_per_sample = pcmreader.bits_per_sample
        self.current_frames = current_frames
        self.total_frames = total_frames
        self.progress = progress

    def read(self, pcm_frames):
        frame = self.pcmreader.read(pcm_frames)
        self.current_frames += frame.frames
        self.progress(self.current_frames, self.total_frames)
        return frame

    def close(self):
        self.pcmreader.close()


class ReorderedPCMReader:
    """a PCMReader whose channels are the wrapped reader's, taken in
    ``channel_order`` (the reference's ``pcmstream.ReorderedPCMReader``)"""

    def __init__(self, pcmreader, channel_order, channel_mask=None):
        self.pcmreader = pcmreader
        self.sample_rate = pcmreader.sample_rate
        self.channels = len(channel_order)
        self.channel_mask = (pcmreader.channel_mask if channel_mask is None
                             else channel_mask)
        if (self.channel_mask != 0 and
                mask_channel_count(self.channel_mask) != self.channels):
            raise ValueError("channel count and mask mismatch")
        self.bits_per_sample = pcmreader.bits_per_sample
        self.channel_order = list(channel_order)

    def read(self, pcm_frames):
        frame = self.pcmreader.read(pcm_frames)
        return FrameList(frame.samples[:, self.channel_order],
                         frame.bits_per_sample)

    def close(self):
        self.pcmreader.close()


class RemaskedPCMReader:
    """a PCMReader with another channel count and mask: each speaker of
    the new mask takes the wrapped reader's channel for that speaker,
    or silence (the reference's ``pcmstream.RemaskedPCMReader``)"""

    def __init__(self, pcmreader, channel_count, channel_mask):
        self.pcmreader = pcmreader
        self.sample_rate = pcmreader.sample_rate
        self.channels = channel_count
        self.channel_mask = channel_mask
        self.bits_per_sample = pcmreader.bits_per_sample
        if pcmreader.channel_mask != 0 and channel_mask != 0:
            if mask_channel_count(channel_mask) != channel_count:
                raise ValueError("channel count and mask mismatch")
            have = mask_speakers(pcmreader.channel_mask)
            self.sources = [have.index(s) if s in have else None
                            for s in mask_speakers(channel_mask)]
        elif channel_count <= pcmreader.channels:
            self.sources = list(range(channel_count))
        else:
            self.sources = (list(range(pcmreader.channels)) +
                            [None] * (channel_count - pcmreader.channels))

    def read(self, pcm_frames):
        frame = self.pcmreader.read(pcm_frames)
        out = np.zeros((frame.frames, self.channels), dtype=np.int32)
        for (i, c) in enumerate(self.sources):
            if c is not None:
                out[:, i] = frame.samples[:, c]
        return FrameList(out, frame.bits_per_sample)

    def close(self):
        self.pcmreader.close()


def PCMConverter(pcmreader, sample_rate, channels, channel_mask,
                 bits_per_sample, device="cuda"):
    """a PCMReader converting ``pcmreader`` to the given rate, channels,
    mask and bits per sample (the reference's ``pcmstream.PCMConverter``):
    channels by averaging, downmixing, remasking or reordering, the rate
    by ``pcmconverter.Resampler`` on ``device``, the bits per sample by
    ``pcmconverter.BPSConverter``

    ``device`` is resolved even where no resampling is needed, so a
    request for an absent card always raises"""
    from . import pcmconverter
    from ._device import resolve_device
    device = resolve_device(device)
    if sample_rate <= 0:
        raise ValueError("invalid sample rate")
    elif channels <= 0:
        raise ValueError("invalid channel count")
    elif bits_per_sample not in (8, 16, 24):
        raise ValueError("invalid bits per sample")
    if channel_mask != 0 and mask_channel_count(channel_mask) != channels:
        raise ValueError("channel count and mask mismatch")

    if pcmreader.channels > channels:
        if channels == 1 and channel_mask in (0, 0x4):
            if pcmreader.channels > 2:
                pcmreader = pcmconverter.Downmixer(pcmreader)
            pcmreader = pcmconverter.Averager(pcmreader)
        elif channels == 2 and channel_mask in (0, 0x3):
            pcmreader = pcmconverter.Downmixer(pcmreader)
        else:
            pcmreader = RemaskedPCMReader(pcmreader, channels, channel_mask)
    elif pcmreader.channels < channels:
        pcmreader = ReorderedPCMReader(
            pcmreader, list(range(pcmreader.channels)) +
            [0] * (channels - pcmreader.channels), channel_mask)

    if pcmreader.sample_rate != sample_rate:
        pcmreader = pcmconverter.Resampler(pcmreader, sample_rate, device)
    if pcmreader.bits_per_sample != bits_per_sample:
        pcmreader = pcmconverter.BPSConverter(pcmreader, bits_per_sample)
    return pcmreader


def resampled_frame_count(initial_frame_count, initial_sample_rate,
                          new_sample_rate):
    """the PCM frame count after resampling, rounded down"""
    if initial_sample_rate == new_sample_rate:
        return initial_frame_count
    return initial_frame_count * new_sample_rate // initial_sample_rate


def to_pcm_progress(audiofile, progress):
    """``audiofile.to_pcm()``, wrapped in a PCMReaderProgress when a
    ``progress(current, total)`` callback is given (the reference's
    ``pcmstream.to_pcm_progress``)"""
    if progress is None:
        return audiofile.to_pcm()
    return PCMReaderProgress(audiofile.to_pcm(), audiofile.total_frames(),
                             progress)


def pcm_frame_cmp(pcmreader1, pcmreader2):
    """the PCM frame number of the first mismatch between two readers,
    or None when they hold the same frames (the reference's
    ``pcmstream.pcm_frame_cmp``): 0 when their rates, channel counts,
    bits per sample or defined channel masks differ; the length of the
    shorter one when one ends first"""
    if ((pcmreader1.sample_rate != pcmreader2.sample_rate) or
            (pcmreader1.channels != pcmreader2.channels) or
            (pcmreader1.bits_per_sample != pcmreader2.bits_per_sample)):
        return 0
    if ((pcmreader1.channel_mask != 0) and
            (pcmreader2.channel_mask != 0) and
            (pcmreader1.channel_mask != pcmreader2.channel_mask)):
        return 0

    frame_number = 0
    reader1 = BufferedPCMReader(pcmreader1)
    reader2 = BufferedPCMReader(pcmreader2)
    a = reader1.read(FRAMELIST_SIZE).samples
    b = reader2.read(FRAMELIST_SIZE).samples
    while a.shape[0] > 0 and b.shape[0] > 0:
        if a.shape != b.shape or not np.array_equal(a, b):
            n = min(a.shape[0], b.shape[0])
            mismatch = np.nonzero((a[:n] != b[:n]).any(axis=1))[0]
            if len(mismatch):
                return frame_number + int(mismatch[0])
            return frame_number + n - 1
        frame_number += a.shape[0]
        a = reader1.read(FRAMELIST_SIZE).samples
        b = reader2.read(FRAMELIST_SIZE).samples
    if a.shape[0] > 0 or b.shape[0] > 0:
        return frame_number
    return None
