"""Whole runs on the CPU at the tiny size (the harness's look for a card
skipped, everything else as a run drives it): sound, each comes out
correct; with the timed path broken underneath, once for each fault the
cell can have, ``correct`` comes out false."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.tests import tiny


@pytest.mark.parametrize("workload", tiny.WORKLOADS)
def test_a_sound_run_is_correct(workload):
    (result, notes) = tiny.run(workload)
    assert result["correct"], (result, notes)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(c["value"] == 0 for c in result["checks"].values())


def altered_emit(monkeypatch):
    """an answer altered where it is produced: one bit of every frame
    the C++ emitter writes is flipped"""
    from audiotools_tpu_torch import _native
    emit = _native.flac_emit_frames2

    def broken(*args, **kwargs):
        (frame_bytes, lens) = emit(*args, **kwargs)
        data = bytearray(bytes(frame_bytes))
        at = 0
        for n in np.asarray(lens).tolist():
            data[at + n // 2] ^= 0x04
            at += n
        return (bytes(data), lens)
    monkeypatch.setattr(_native, "flac_emit_frames2", broken)


def half_analysis(monkeypatch):
    """half of the batch left out: the analysis runs on the first half
    of the blocks, whose decisions stand in for the rest"""
    from audiotools_tpu_torch.ops import flac_frames
    analyze = flac_frames.analyze_frames_packed

    def broken(blocks, *args, **kwargs):
        half = max(blocks.shape[0] // 2, 1)
        kw = dict(kwargs)
        for key in ("or_vals", "const_flags"):
            if kw.get(key) is not None:
                kw[key] = kw[key][:half]
        out = analyze(blocks[:half], *args, **kw)
        packed = out[0] if isinstance(out, tuple) else out
        idx = np.arange(blocks.shape[0]) % half
        return packed[idx]
    monkeypatch.setattr(flac_frames, "analyze_frames_packed", broken)


def altered_synthesis(monkeypatch):
    """an answer altered where it is produced: one sample of every
    synthesized row is off by one"""
    from audiotools_tpu_torch.ops import flac_synth
    synth = flac_synth.synthesize

    def broken(*args, **kwargs):
        out = synth(*args, **kwargs).clone()
        out[:, out.shape[1] // 2] += 1
        return out
    monkeypatch.setattr(flac_synth, "synthesize", broken)


def half_synthesis(monkeypatch):
    """half of the batch left out: every other row of the batch (each a
    frame's channel) is never synthesized, so that every read of two
    rows or more meets one"""
    from audiotools_tpu_torch.ops import flac_synth
    synth = flac_synth.synthesize

    def broken(*args, **kwargs):
        out = synth(*args, **kwargs).clone()
        out[1::2] = 0
        return out
    monkeypatch.setattr(flac_synth, "synthesize", broken)


def unmoved_seek(monkeypatch):
    """a step that returns its state unchanged: a seek that leaves the
    decoder where it was"""
    from audiotools_tpu_torch.codecs.flac_dec import TorchFlacDecoder
    monkeypatch.setattr(TorchFlacDecoder, "seek",
                        lambda self, pcm_frame: self.decoded_frames)


@pytest.mark.parametrize("workload,fault", [
    ("flac8_cd16.album_encode", altered_emit),
    ("flac8_cd16.album_encode", half_analysis),
    ("flac8_hires24.album_encode", altered_emit),
    ("flac8_hires24.album_encode", half_analysis),
    ("flac8_cd16.album_decode", altered_synthesis),
    ("flac8_cd16.album_decode", half_synthesis),
    ("flac8_cd16.seek", altered_synthesis),
    ("flac8_cd16.seek", half_synthesis),
    ("flac8_cd16.seek", unmoved_seek),
], ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    # the seek cell's one client makes a request at a time: a longer
    # window gives it several
    (result, notes) = tiny.run(workload,
                               seconds=2.0 if "seek" in workload else 0.3)
    assert not result["correct"], (result, notes)
