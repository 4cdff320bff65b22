"""The port's converter suite on the CPU, held to the reference.

The host twins in the port's ``_native`` (``iir``, ``resample_fir``,
``accuraterip_update``) equal the reference's; ``rg_combined_fir`` and
the Resampler's bank equal the reference's; the device programs of
``ops/converters`` agree with the reference's jitted ones (on JAX's CPU
backend); and the entry points ``AccurateRipCRC`` /
``accuraterip_checksums``, ``ReplayGain`` /
``calculate_replay_gain_values``, ``Resampler`` and ``PCMConverter``
agree with the reference's classes on their host route and on their
``ATPU_*_BACKEND=jax`` route.  On a card the port's results equal its
CPU results at the same bounds.

Bounds, where a test asserts them:
* AccurateRip: equal, bit for bit (exact integer sums on every route).
* Resampler: at most 1 LSB after the conversion to integers, on fewer
  than 1e-4 of the samples: every route sums the same float64 products,
  but in its own order (the host C++ alone has two orders, AVX-512 and
  scalar), so an output within a rounding of a truncation boundary
  may land on either side of it.
* ReplayGain: peaks equal (the host computes them on every route);
  against the host route at most one window moved between bins
  (``diff.sum() <= 2``) and gains within 0.011 dB, since the port's FIR
  is the IIR truncated at 1e-13 of its peak and sums in another order,
  so a window within a rounding of a 0.01 dB bin boundary may cross it;
  against the JAX route the reference's own bound (``diff.sum() <= 4``,
  0.011 dB), since that route convolves in float32.
"""

import io
import os

import numpy as np
import pytest
import torch

from audiotools_tpu import _native as ref_native
from audiotools_tpu import accuraterip_checksum as ref_ar
from audiotools_tpu import pcm as ref_pcm
from audiotools_tpu import pcmconverter as ref_pc
from audiotools_tpu import replaygain as ref_rg
from audiotools_tpu.ops import converters as ref_conv
from audiotools_tpu.ops import replaygain_coeffs as ref_coeffs
from audiotools_tpu.pcmstream import PCMConverter as RefPCMConverter
from audiotools_tpu.pcmstream import PCMReader
from audiotools_tpu_torch import _native, pcm, pcmconverter, replaygain
from audiotools_tpu_torch import accuraterip_checksum
from audiotools_tpu_torch.ops import converters, replaygain_coeffs

torch.set_num_threads(1)


def signal(n, rate, seed, ch=2, bps=16, amp=0.28):
    """two tones and noise at ``amp`` of full scale, int32 [n, ch]"""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    full = 1 << (bps - 1)
    base = amp * full * (np.sin(2 * np.pi * 441 * t / rate) +
                         np.sin(2 * np.pi * 1321 * t / rate) / 3)
    out = np.stack([base * (0.8 + 0.2 * c) for c in range(ch)], axis=1)
    out += rng.normal(0, amp * full / 20, out.shape)
    return np.clip(out, -full, full - 1).astype(np.int32)


def ref_reader(arr, rate, bps=16):
    data = ref_pcm.FrameList._wrap(arr, bps).to_bytes(False, True)
    return PCMReader(io.BytesIO(data), rate, arr.shape[1],
                     pcm.CHANNEL_MASKS[arr.shape[1]], bps)


def drain(reader, size):
    pieces = []
    while True:
        frame = reader.read(size)
        if frame.frames == 0:
            break
        pieces.append(np.array(frame.samples))
    return np.concatenate(
        pieces or [np.zeros((0, reader.channels), dtype=np.int32)])


def assert_within_one_lsb(got, want):
    """at most 1 LSB apart, on fewer than 1e-4 of the samples (see the
    module's docstring)"""
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-4


# ---------------------------------------------------------------------------
# host twins, tables, FIR and bank


@pytest.mark.parametrize("twin", ["iir", "resample_fir",
                                  "accuraterip_update"])
def test_host_twins_match_the_reference(twin):
    rng = np.random.default_rng(3)
    if twin == "iir":
        for (b, a) in (ref_coeffs.YULE[44100], ref_coeffs.BUTTER[8000]):
            x = rng.normal(0, 5000, 7000)
            zi = rng.normal(0, 1, len(b) - 1)
            (y, z) = _native.iir(b, a, x, zi)
            (ry, rz) = ref_rg._lfilter(np.asarray(b), np.asarray(a), x, zi)
            assert np.array_equal(y, ry) and np.array_equal(z, rz)
    elif twin == "resample_fir":
        for ch in (1, 2, 3):
            hist = rng.normal(0, 0.3, (4000, ch))
            bank = rng.normal(0, 0.1, (147, 512))
            starts = rng.integers(0, 4000 - 512, 900)
            q = rng.integers(0, 147, 900).astype(np.int32)
            assert np.array_equal(
                _native.resample_fir(hist, starts, q, bank),
                ref_native.resample_fir(hist, starts, q, bank))
    else:
        arr = rng.integers(-32768, 32768, (5000, 2)).astype(np.int32)
        for (first, start, end) in ((1, 2940, 5000), (1, 0, 4000),
                                    (700, 1000, 2000), (1 << 28, 0, 1 << 30),
                                    (9000, 0, 100)):
            for (v1, v2) in ((0, 0), (0xFFFFFFFF, 12345)):
                assert (_native.accuraterip_update(arr, first, start, end,
                                                   v1, v2) ==
                        ref_native.accuraterip_update(arr, first, start,
                                                      end, v1, v2))


def test_coefficient_tables_match_the_reference():
    assert replaygain_coeffs.SAMPLE_RATES == ref_coeffs.SAMPLE_RATES
    assert replaygain_coeffs.YULE == ref_coeffs.YULE
    assert replaygain_coeffs.BUTTER == ref_coeffs.BUTTER


@pytest.mark.parametrize("rate", ref_coeffs.SAMPLE_RATES)
def test_rg_combined_fir_matches_the_reference(rate):
    """the same C++ IIR, built with the same flags: bit for bit"""
    assert np.array_equal(converters.rg_combined_fir(rate),
                          ref_conv.rg_combined_fir(rate))


# decimation, interpolation by 160/147 and by 2, the quantised 8192-phase
# bank (den 44,099), and an exact bank whose banded form would pass
# BAND_BYTES (44,056 Hz: den 6000, num 5507), so gathers
PAIRS = [(96000, 44100), (44100, 48000), (22050, 44100), (44100, 44099),
         (44056, 48000)]
GATHERED = [(44100, 44099), (44056, 48000)]


@pytest.mark.parametrize("pair", PAIRS)
def test_resampler_bank_matches_the_reference(pair):
    (src, dst) = pair
    arr = signal(100, src, 1)
    port = pcmconverter.Resampler(pcm.reader_from_array(arr, 16, src), dst,
                                  device="cpu")
    ref = ref_pc.Resampler(ref_reader(arr, src), dst)
    assert np.array_equal(port.__bank__, ref.__bank__)
    assert (port.band is None) == (pair in GATHERED)


# ---------------------------------------------------------------------------
# the device programs against the reference's jitted ones


@pytest.mark.parametrize("first,start,end", [
    (1, 2940, 40000), (1, 0, 30000), (20001, 0, 1 << 30), (5, 100, 200)])
def test_accuraterip_sums_match_jax(first, start, end):
    arr = np.random.default_rng(first).integers(
        -32768, 32768, (30000, 2)).astype(np.int32)
    (low, high) = converters.accuraterip_sums(torch.from_numpy(arr), first,
                                              start, end)
    want = ref_conv.accuraterip_update_device(arr, first, start, end, 7, 9)
    assert ((7 + int(low)) & 0xFFFFFFFF,
            (9 + int(low) + int(high)) & 0xFFFFFFFF) == want


def test_accuraterip_sums_refuse_an_index_past_int31():
    arr = np.zeros((10, 2), dtype=np.int32)
    converters.accuraterip_sums(torch.from_numpy(arr), (1 << 31) - 10, 0,
                                1 << 40)
    with pytest.raises(ValueError, match="2\\^31"):
        converters.accuraterip_sums(torch.from_numpy(arr), (1 << 31) - 9,
                                    0, 1 << 40)


@pytest.mark.parametrize("ch", [1, 2])
def test_resample_fir_matches_jax(ch):
    rng = np.random.default_rng(ch)
    hist = rng.normal(0, 0.3, (6000, ch))
    bank = ref_pc._kaiser_sinc_kernel(np.arange(147) / 147, 512, 0.87)
    starts = np.sort(rng.integers(0, 6000 - 512, 3000))
    q = rng.integers(0, 147, 3000)
    got = converters.resample_fir(torch.from_numpy(hist),
                                  torch.from_numpy(starts),
                                  torch.from_numpy(q),
                                  torch.from_numpy(bank))
    want = ref_conv.resample_fir_device(hist, starts, q.astype(np.int32),
                                        bank)
    # the same float64 products summed in another order: 1 LSB
    for bps in (16, 24):
        assert_within_one_lsb(converters.to_int(got, bps).numpy(),
                              ref_pcm.FloatFrameList._wrap(want).to_int(bps)
                              .samples)


@pytest.mark.parametrize("num,den", [(147, 160), (320, 147), (1, 2)])
def test_banded_product_matches_the_gather(num, den):
    """the banded product's outputs are the gathered windows' sums, block
    for block, with the phase and start of the reference's arithmetic"""
    rng = np.random.default_rng(num)
    hist = torch.from_numpy(rng.normal(0, 0.3, (5000, 2)))
    bank = torch.from_numpy(ref_pc._kaiser_sinc_kernel(
        np.arange(den) / den, 512, 0.9))
    group = converters.band_group(512, num)
    band = converters.polyphase_band(bank, num, den, group)
    (rows, stride) = (group * den, group * num)
    blocks = (5000 - band.shape[1]) // stride + 1
    got = converters.resample_banded(hist, blocks, band, stride)
    m = np.arange(blocks * rows)
    want = converters.resample_fir(hist, torch.from_numpy(m * num // den),
                                   torch.from_numpy(m * num % den), bank)
    # a matmul's order against the gather's sum: 1 LSB at 24 bits
    assert_within_one_lsb(converters.to_int(got, 24).numpy(),
                          converters.to_int(want, 24).numpy())


@pytest.mark.parametrize("rate", [44100, 8000])
def test_rg_window_sums_match_jax_and_host(rate):
    arr = signal(rate * 2 + 777, rate, 5).astype(np.float64)
    win = int(np.ceil(rate * replaygain.RMS_WINDOW_TIME))
    h = torch.from_numpy(converters.rg_combined_fir(rate).copy())
    # a short segment too, so that several segments carry their overlap
    for segment in (1 << 20, 1 << 13):
        got = converters.rg_window_sums(torch.from_numpy(arr[:, 0]),
                                        torch.from_numpy(arr[:, 1]), h,
                                        win, segment=segment).numpy()
        host = converters.rg_window_sums_host(arr[:, 0], arr[:, 1], rate,
                                              win)
        jax_sums = ref_conv.rg_window_sums(arr[:, 0], arr[:, 1], rate, win)
        assert got.shape == host.shape == jax_sums.shape == (
            len(arr) // win,)
        # one window may cross a bin boundary against the host IIR (the
        # FIR is truncated and sums in another order); two against the
        # float32 JAX route, the reference's own device bound
        assert np.abs(bins(got, win) - bins(host, win)).sum() <= 2
        assert np.abs(bins(got, win) - bins(jax_sums, win)).sum() <= 4


def bins(sums, win):
    """the histogram of window sums, by the reference's expression"""
    values = 1000.0 * np.log10(sums / win * 0.5 + 1e-37)
    hist = np.zeros(12000, dtype=np.int64)
    np.add.at(hist, np.clip(values.astype(np.int64), 0, 11999), 1)
    return hist


# ---------------------------------------------------------------------------
# entry points: AccurateRip


def chunks_of(n, sizes):
    """[start, stop) pairs cutting n frames into the sizes, cycled"""
    out = []
    (start, i) = (0, 0)
    while start < n:
        out.append((start, min(n, start + sizes[i % len(sizes)])))
        start = out[-1][1]
        i += 1
    return out


AR_CASES = {
    "first_and_last": (True, True, 2 * 44100 + 1234, [65536]),
    "middle": (False, False, 44100, [65536]),
    "first_by_single_frames": (True, False, 3100, [1]),
    "last_odd_chunks": (False, True, 9000, [1, 7, 333, 2940, 1001]),
    "straddling_the_skip": (True, False, 9000, [2900, 100, 3000]),
}


@pytest.mark.parametrize("case", sorted(AR_CASES))
def test_accuraterip_matches_every_reference_route(case, monkeypatch):
    (is_first, is_last, n, sizes) = AR_CASES[case]
    arr = signal(n, 44100, n, amp=0.9)
    cuts = chunks_of(n, sizes)
    port = accuraterip_checksum.AccurateRipCRC(is_first, is_last, 44100, n,
                                               device="cpu")
    for (a, b) in cuts:
        port.update_array(arr[a:b])
    got = port.checksums()

    for backend in ("", "jax"):
        monkeypatch.setenv("ATPU_AR_BACKEND", backend)
        ref = ref_ar.AccurateRipCRC(is_first, is_last, 44100, n)
        for (a, b) in cuts:
            ref.update_array(arr[a:b])
        assert ref.checksums() == got, backend
    v1 = ref_ar.ChecksumV1(is_first, is_last, 44100, n)
    v2 = ref_ar.ChecksumV2(is_first, is_last, 44100, n)
    v1.update(ref_pcm.FrameList._wrap(arr, 16))
    v2.update(ref_pcm.FrameList._wrap(arr, 16))
    assert (v1.checksum(), v2.checksum()) == got
    assert accuraterip_checksum.accuraterip_checksums(
        pcm.reader_from_array(arr, 16), n, is_first, is_last,
        device="cpu") == ref_ar.accuraterip_checksums(
            ref_reader(arr, 44100), n, is_first, is_last)


def test_accuraterip_refuses_what_is_not_cd_audio():
    with pytest.raises(ValueError, match="2 channels"):
        accuraterip_checksum.accuraterip_checksums(
            pcm.reader_from_array(np.zeros((10, 1), np.int32), 16), 10,
            device="cpu")
    with pytest.raises(ValueError, match="16 bits"):
        accuraterip_checksum.accuraterip_checksums(
            pcm.reader_from_array(np.zeros((10, 2), np.int32), 24), 10,
            device="cpu")
    crc = accuraterip_checksum.AccurateRipCRC(False, False, 44100, 10,
                                              device="cpu")
    with pytest.raises(ValueError, match="\\[n, 2\\]"):
        crc.update_array(np.zeros((10, 3), np.int32))


# ---------------------------------------------------------------------------
# entry points: ReplayGain


def rg_titles(rates_bps_ch, seconds=1.0):
    return [signal(int(rate * seconds) + 101 * i, rate, 40 + i, ch=ch,
                   bps=bps, amp=0.05 + 0.1 * i)
            for (i, (rate, bps, ch)) in enumerate(rates_bps_ch)]


def compare_replaygain(rate, bps, titles, monkeypatch):
    """the port's ReplayGain against the reference's host and JAX
    routes, title by title and for the album"""
    port = replaygain.ReplayGain(rate, device="cpu")
    got = [port.title_gain(pcm.reader_from_array(t, bps, rate))
           for t in titles]
    # windows moved a title: one against the host IIR, two against the
    # float32 JAX route (the reference's own bound); gains within one
    # 0.01 dB bin; peaks are host arithmetic on every route, so equal
    for (backend, max_moved) in (("", 2), ("jax", 4)):
        monkeypatch.setenv("ATPU_RG_BACKEND", backend)
        ref = ref_rg.ReplayGain(rate)
        want = [ref.title_gain(ref_reader(t, rate, bps)) for t in titles]
        for ((gain, peak), (ref_gain, ref_peak)) in zip(got, want):
            assert peak == ref_peak
            assert abs(gain - ref_gain) <= 0.011, (backend, gain, ref_gain)
        assert np.abs(port.album_histogram -
                      ref.album_histogram).sum() <= max_moved * len(titles)
        (gain, peak) = port.album_gain()
        (ref_gain, ref_peak) = ref.album_gain()
        assert peak == ref_peak and abs(gain - ref_gain) <= 0.011


@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("bps", [8, 16, 24])
@pytest.mark.parametrize("rate", [44100, 48000, 8000])
def test_replaygain_title_matches_the_reference(rate, bps, ch, monkeypatch):
    compare_replaygain(rate, bps, rg_titles([(rate, bps, ch)]),
                       monkeypatch)


def test_replaygain_album_matches_the_reference(monkeypatch):
    compare_replaygain(44100, 16, rg_titles([(44100, 16, 2),
                                             (44100, 16, 1)]), monkeypatch)


def test_replaygain_short_title_and_refusals():
    rg = replaygain.ReplayGain(44100, device="cpu")
    # shorter than a window: no window, the reference's fallback gain
    (gain, peak) = rg.title_gain(pcm.reader_from_array(
        signal(100, 44100, 2), 16))
    assert gain == replaygain.PINK_REF and 0 < peak < 1
    with pytest.raises(ValueError, match="sample rate"):
        rg.title_gain(pcm.reader_from_array(signal(100, 48000, 2), 16,
                                            48000))
    with pytest.raises(ValueError, match="channel count"):
        rg.title_gain(pcm.reader_from_array(signal(100, 44100, 2, ch=3),
                                            16))
    with pytest.raises(ValueError, match="unsupported"):
        replaygain.ReplayGain(44101, device="cpu")


class Track:
    """a duck-typed audio file over an int32 array"""

    def __init__(self, arr, rate, bps, port):
        (self.arr, self.rate, self.bps, self.port) = (arr, rate, bps, port)

    def sample_rate(self):
        return self.rate

    def total_frames(self):
        return self.arr.shape[0]

    def to_pcm(self):
        if self.port:
            return pcm.reader_from_array(self.arr, self.bps, self.rate)
        return ref_reader(self.arr, self.rate, self.bps)


def test_calculate_replay_gain_values_matches_the_reference():
    """mixed rates: the 48 kHz track is resampled to the album's 44.1 kHz
    on the port's Resampler; mono and 6-channel tracks are averaged and
    downmixed"""
    specs = [(44100, 16, 2), (48000, 24, 2), (44100, 16, 1),
             (44100, 16, 6)]
    arrays = rg_titles(specs, seconds=0.7)
    calls = ([], [])

    def progress(which):
        return lambda done, total: calls[which].append((done, total))

    got = list(replaygain.calculate_replay_gain_values(
        [Track(a, r, b, True) for (a, (r, b, _c)) in zip(arrays, specs)],
        progress(0), device="cpu"))
    want = list(ref_rg.calculate_replay_gain_values(
        [Track(a, r, b, False) for (a, (r, b, _c)) in zip(arrays, specs)],
        progress(1)))
    assert len(got) == len(want) == len(specs)
    for (g, w) in zip(got, want):
        assert g[0].arr is w[0].arr
        (gain, peak, album_gain, album_peak) = g[1:]
        (ref_gain, ref_peak, ref_album_gain, ref_album_peak) = w[1:]
        # as compare_replaygain: peaks equal, gains within one bin
        assert peak == ref_peak and album_peak == ref_album_peak
        assert abs(gain - ref_gain) <= 0.011
        assert abs(album_gain - ref_album_gain) <= 0.011
    assert calls[0] == calls[1]


# ---------------------------------------------------------------------------
# entry points: Resampler and PCMConverter


@pytest.mark.parametrize("bps", [16, 24])
@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("pair", PAIRS)
def test_resampler_matches_every_reference_route(pair, ch, bps,
                                                 monkeypatch):
    (src, dst) = pair
    arr = signal(src // 3 + 17, src, src % 97, ch=ch, bps=bps, amp=0.45)
    got = {size: drain(pcmconverter.Resampler(
        pcm.reader_from_array(arr, bps, src), dst, device="cpu"), size)
        for size in (4096, 65536)}
    # the output does not depend on how the stream was read
    assert np.array_equal(got[4096], got[65536])
    # float64 sums in another order than each reference route's: 1 LSB
    for backend in ("", "jax"):
        monkeypatch.setenv("ATPU_RESAMPLE_BACKEND", backend)
        want = drain(ref_pc.Resampler(ref_reader(arr, src, bps), dst), 4096)
        assert_within_one_lsb(got[4096], want)


def test_resampler_reads_of_any_size():
    """the reference's streaming case: reads of 1, 17, 443, 4096 and
    65536 frames, then 777, give the one-shot output"""
    arr = signal(96000, 96000, 11, bps=24, amp=0.4)
    one = drain(pcmconverter.Resampler(
        pcm.reader_from_array(arr, 24, 96000), 44100, device="cpu"), 65536)
    r = pcmconverter.Resampler(pcm.reader_from_array(arr, 24, 96000), 44100,
                               device="cpu")
    pieces = [r.read(size).samples
              for size in (1, 17, 443, 4096, 65536, 65536, 65536)]
    assert np.array_equal(one, np.concatenate(pieces + [drain(r, 777)]))
    assert r.read(4096).frames == 0


def urandom_stand_in(n):
    """os.urandom's stand-in: the same bytes for the same calls"""
    return bytes((i * 37 + n) % 251 for i in range(n))


CHAINS = {
    # (input channels, bps, rate) -> (rate, channels, mask, bps)
    "downmix_6_to_2": ((6, 16, 44100), (44100, 2, 0x3, 16)),
    "average_2_to_1": ((2, 16, 44100), (44100, 1, 0x4, 16)),
    "downmix_and_average_6_to_1": ((6, 24, 44100), (44100, 1, 0, 24)),
    "remask_2_to_1": ((2, 16, 44100), (44100, 1, 0x2, 16)),
    "reorder_1_to_2": ((1, 16, 44100), (44100, 2, 0x3, 16)),
    "bps_24_to_16_dithered": ((2, 24, 44100), (44100, 2, 0x3, 16)),
    "bps_8_to_16": ((2, 8, 44100), (44100, 2, 0x3, 16)),
    "resample_and_bps_24_to_16": ((2, 24, 96000), (48000, 2, 0x3, 16)),
    "resample_and_average": ((2, 16, 44100), (22050, 1, 0x4, 8)),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_pcm_converter_chains_match_the_reference(chain, monkeypatch):
    ((ch, bps, rate), target) = CHAINS[chain]
    monkeypatch.setattr(os, "urandom", urandom_stand_in)
    arr = signal(9000, rate, ch, ch=ch, bps=bps, amp=0.4)
    got = pcm.PCMConverter(pcm.reader_from_array(arr, bps, rate), *target,
                           device="cpu")
    want = RefPCMConverter(ref_reader(arr, rate, bps), *target)
    assert ((got.sample_rate, got.channels, got.channel_mask,
             got.bits_per_sample) ==
            (want.sample_rate, want.channels, want.channel_mask,
             want.bits_per_sample))
    (got, want) = (drain(got, 4096), drain(want, 4096))
    if rate == target[0]:
        assert np.array_equal(got, want)
    else:
        # the resampler's float64 sums in another order: 1 LSB
        assert_within_one_lsb(got, want)


def test_pcm_converter_refusals():
    reader = pcm.reader_from_array(np.zeros((10, 2), np.int32), 16)
    for (args, match) in (((0, 2, 0x3, 16), "sample rate"),
                          ((44100, 0, 0x3, 16), "channel count"),
                          ((44100, 2, 0x3, 12), "bits per sample"),
                          ((44100, 2, 0x7, 16), "mismatch")):
        with pytest.raises(ValueError, match=match):
            pcm.PCMConverter(reader, *args, device="cpu")


@pytest.mark.parametrize("frames", [0, 1, 999, 44100, 10 ** 9 + 7])
def test_resampled_frame_count_matches_the_reference(frames):
    from audiotools_tpu.pcmstream import resampled_frame_count
    for (a, b) in ((44100, 48000), (96000, 44100), (44100, 44100),
                   (8000, 192000), (44100, 44099)):
        assert (pcm.resampled_frame_count(frames, a, b) ==
                resampled_frame_count(frames, a, b))


# ---------------------------------------------------------------------------
# devices


def test_cuda_request_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr = signal(5000, 44100, 1)
    calls = (
        lambda: replaygain.ReplayGain(44100),
        lambda: list(replaygain.calculate_replay_gain_values(
            [Track(arr, 44100, 16, True)])),
        lambda: accuraterip_checksum.AccurateRipCRC(False, False, 44100, 9),
        lambda: accuraterip_checksum.accuraterip_checksums(
            pcm.reader_from_array(arr, 16), 5000),
        lambda: pcmconverter.Resampler(pcm.reader_from_array(arr, 16),
                                       48000),
        lambda: pcm.PCMConverter(pcm.reader_from_array(arr, 16), 44100, 2,
                                 0x3, 16))
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    with pytest.raises(ValueError, match="unsupported device"):
        replaygain.ReplayGain(44100, device="meta")


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS)
def test_cuda_converters_match_the_cpu(pair):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    (src, dst) = pair
    arr = signal(src + 4321, src, 8, bps=24, amp=0.45)
    out = {}
    for device in ("cpu", "cuda"):
        for size in (4096, 1 << 20):
            out[device, size] = drain(pcmconverter.Resampler(
                pcm.reader_from_array(arr, 24, src), dst, device=device),
                size)
    assert np.array_equal(out["cuda", 4096], out["cuda", 1 << 20])
    # cuBLAS and the CPU's BLAS sum in their own orders: 1 LSB
    assert_within_one_lsb(out["cuda", 4096], out["cpu", 4096])

    if src in (44100, 48000, 96000, 22050):
        titles = rg_titles([(src, 16, 2), (src, 24, 1), (src, 8, 2)])
        rgs = {}
        for device in ("cpu", "cuda"):
            rgs[device] = replaygain.ReplayGain(src, device=device)
            rgs[device].gains = [rgs[device].title_gain(
                pcm.reader_from_array(t, b, src))
                for (t, b) in zip(titles, (16, 24, 8))]
        # cuFFT against the CPU's FFT: one window a title, one bin
        for ((gain, peak), (cpu_gain, cpu_peak)) in zip(rgs["cuda"].gains,
                                                        rgs["cpu"].gains):
            assert peak == cpu_peak and abs(gain - cpu_gain) <= 0.011
        assert np.abs(rgs["cuda"].album_histogram -
                      rgs["cpu"].album_histogram).sum() <= 2 * len(titles)

    cd = signal(2 * 44100 + 2, 44100, 9, amp=0.9)
    for (is_first, is_last) in ((True, True), (False, False)):
        sums = [accuraterip_checksum.accuraterip_checksums(
            pcm.reader_from_array(cd, 16), cd.shape[0], is_first, is_last,
            device=device) for device in ("cpu", "cuda")]
        assert sums[0] == sums[1]
