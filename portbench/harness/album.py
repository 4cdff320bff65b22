"""The album a cell works on, made from the seed.

Track lengths are log-normal quantiles of the configuration's album
shape, in one fixed running order, the same for every seed: every seed
asks for the same work in the same order, so that which tracks are in
flight when a window closes does not change with the seed.  The seed
draws the program material.  The material is made on the device in a few large calls
(a ``torch.Generator`` on the card for the noise, NumPy for the small
per-segment tables) and copied to host memory as int32.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

# every seed is reduced to this many bits for the generators
SEED_BITS = 63
# the generator seed of the album's running order, fixed for all seeds
ORDER_SEED = 2718


def seed_bits(seed, stream):
    """a non-negative seed for the generator of ``stream`` (an int) from
    any whole-number ``seed``"""
    return (int(seed) * 1000003 + int(stream)) % (1 << SEED_BITS)


def track_frames(album, sample_rate, block_size):
    """the album's track lengths in frames, longest last: log-normal
    quantiles (i + 0.5) / tracks around ``median_s`` with ``sigma``,
    clipped to [min_s, max_s]; a length that is a whole number of blocks
    gets one frame more, so that every track ends in a short block"""
    n = album["tracks"]
    dist = NormalDist()
    out = []
    for i in range(n):
        z = dist.inv_cdf((i + 0.5) / n)
        secs = album["median_s"] * math.exp(album["sigma"] * z)
        secs = min(max(secs, album["min_s"]), album["max_s"])
        frames = int(round(secs * sample_rate))
        if frames % block_size == 0:
            frames += 1
        out.append(frames)
    return out


def track_order(n):
    """the album's running order: a fixed shuffle of its lengths"""
    return np.random.default_rng(ORDER_SEED).permutation(n)


def segment_table(rng, frames, sample_rate, signal):
    """the per-segment parameters of one track: segments of
    signal["segment_s"] seconds, each a kind (tone, tone with
    transients, quiet, near-silent), a pitch with a glide, partial
    amplitudes and phases per channel, a level and a transient onset"""
    (lo, hi) = signal["segment_s"]
    lengths = []
    left = frames
    while left > 0:
        n = int(rng.uniform(lo, hi) * sample_rate)
        n = max(min(n, left), 1)
        lengths.append(n)
        left -= n
    S = len(lengths)
    kinds = rng.choice(4, size=S, p=signal["kind_shares"])
    (f_lo, f_hi) = signal["pitch_hz"]
    f0 = np.exp(rng.uniform(np.log(f_lo), np.log(f_hi), S))
    glide = rng.uniform(-signal["glide"], signal["glide"], S)
    P = signal["partials"]
    amps = rng.uniform(0.2, 1.0, (S, P, 2)) / np.arange(1, P + 1)[None, :,
                                                                   None]
    phases = rng.uniform(0, 2 * np.pi, (S, P, 2))
    (l_lo, l_hi) = signal["level_db"]
    (q_lo, q_hi) = signal["quiet_db"]
    level_db = np.where(kinds == 2, rng.uniform(q_lo, q_hi, S),
                        rng.uniform(l_lo, l_hi, S))
    level = np.where(kinds == 3, 0.0, 10.0 ** (level_db / 20.0))
    burst = np.where(kinds == 1, 10.0 ** (rng.uniform(
        *signal["transient_db"], S) / 20.0), 0.0)
    onset = rng.uniform(0.0, 0.8, S)
    return dict(lengths=np.asarray(lengths, dtype=np.int64), f0=f0,
                glide=glide, amps=amps, phases=phases, level=level,
                burst=burst, onset=onset)


def synth_track(torch, table, frames, sample_rate, bits, signal, gen,
                device):
    """one track's int32 samples [frames, 2] on ``device`` from its
    segment table; the noise from ``gen``"""
    f32 = torch.float32
    lengths = torch.as_tensor(table["lengths"], device=device)
    S = lengths.shape[0]
    starts = torch.cumsum(lengths, 0) - lengths
    seg = torch.repeat_interleave(torch.arange(S, device=device), lengths)
    t = (torch.arange(frames, device=device) - starts[seg]).to(f32)
    frac = t / lengths[seg].to(f32)

    def per(name):
        return torch.as_tensor(table[name], dtype=f32, device=device)

    f0 = per("f0")[seg] * (1.0 + per("glide")[seg] * frac)
    amps = per("amps")                           # [S, P, 2]
    phases = per("phases")
    out = torch.zeros((frames, 2), dtype=f32, device=device)
    for k in range(amps.shape[1]):
        arg = (2.0 * math.pi / sample_rate) * (k + 1) * f0 * t
        for c in range(2):
            out[:, c] += amps[:, k, c][seg] * torch.sin(
                arg + phases[:, k, c][seg])
    norm = amps.sum(dim=1).amax(dim=1)[seg]      # peak bound
    full = float((1 << (bits - 1)) - 1)
    out *= (per("level")[seg] / norm * full)[:, None]
    tau = signal["transient_tau_s"] * sample_rate
    since = t - per("onset")[seg] * lengths[seg].to(f32)
    env = torch.where(since >= 0, torch.exp(-since.clamp(min=0) / tau),
                      torch.zeros((), dtype=f32, device=device))
    noise = torch.randn((frames, 2), generator=gen, dtype=f32,
                        device=device)
    out += noise * (per("burst")[seg] * env * full)[:, None]
    floor = signal["floor_lsb"][str(bits)]
    out += torch.randn((frames, 2), generator=gen, dtype=f32,
                       device=device) * floor
    return out.round().clamp(-full - 1.0, full).to(torch.int32)


class Album:
    """the album of a configuration for one seed: ``samples`` int32
    [total frames, 2] in host memory, ``bounds`` the tracks' (start,
    end) frames in play order"""

    def __init__(self, samples, bounds, bits, sample_rate):
        self.samples = samples
        self.bounds = bounds
        self.bits = bits
        self.sample_rate = sample_rate

    def track(self, i):
        (a, b) = self.bounds[i]
        return self.samples[a:b]

    def __len__(self):
        return len(self.bounds)


def make_album(torch, config, seed, device, album=None):
    """the configuration's album for ``seed`` on ``device``, copied to
    host memory; ``album`` overrides the configuration's album shape
    (the traffic's, or a test's)"""
    shape = album or config["assumed"]["album"]
    signal = config["assumed"]["signal"]
    rate = config["sample_rate"]
    bits = config["bits_per_sample"]
    frames = track_frames(shape, rate, config["encode"]["block_size"])
    order = track_order(len(frames))
    rng = np.random.default_rng(seed_bits(seed, 2))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_bits(seed, 3))
    total = sum(frames)
    host = np.empty((total, 2), dtype=np.int32)
    bounds = []
    at = 0
    for i in order:
        n = frames[i]
        table = segment_table(rng, n, rate, signal)
        x = synth_track(torch, table, n, rate, bits, signal, gen, device)
        host[at:at + n] = x.cpu().numpy()
        del x
        bounds.append((at, at + n))
        at += n
    return Album(host, bounds, bits, rate)
