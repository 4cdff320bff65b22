"""The user's configuration in the port (``utils/config``) against the
reference's: both packages read ~/.audiotools.cfg when they are
imported, so each case runs both tools in fresh interpreters with HOME
pointing at a temporary directory that holds the case's file: the
reference's ``tools/<tool>`` and the port's ``python -m
audiotools_tpu_torch.cli.<tool> --devices cpu``.  Their files, names,
lines and exit codes must be equal.  The settings that change what a
tool writes: ``[Quality] flac`` and ``wavpack`` (the default
compression), ``[System] default_type`` (the default -t, "wav" for a
type the package does not have), ``[Filenames] format`` (the default
name template) and ``[System] maximum_jobs`` (the default -j, which
changes no byte).  The signals are seeded, 2 s at 8 kHz, and 0.1 s at
44.1 kHz for the CD sheet of tracksplit's case; the encoders run pinned
(``REFERENCE_ENV``), and one case with no ATPU_* variable set (the
default routes, the reference's a JAX compile on the CPU).  Each case
starts two interpreters, so the cases are few.
"""

import os
import subprocess
import sys

import pytest
import torch

from audiotools_tpu_torch import dispatch, pcm
from audiotools_tpu_torch.formats.flac import FlacAudio
from test_torch_cli import REFERENCE_ENV, as_port, port_tool, read, signal, \
    write_wave

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 8000
CD = 44100
SOURCE = "src/a.wav"

# case -> (the configuration file, track2track's arguments, pinned)
CASES = {
    "flac-quality": ("[Quality]\nflac = 5\n", ["-t", "flac"], True),
    "flac-quality-defaults": ("[Quality]\nflac = 5\n", ["-t", "flac"],
                              False),
    "wavpack-quality": ("[Quality]\nwavpack = fast\n", ["-t", "wavpack"],
                        True),
    "default-type": ("[System]\ndefault_type = wavpack\n", [], True),
    "unknown-type": ("[System]\ndefault_type = nosuch\n", [], True),
    "filename-format": ("[Filenames]\nformat = %(track_number)2.2d-"
                        "%(basename)s-%(album_name)s.%(suffix)s\n",
                        ["-t", "flac"], True),
    # the lossy types' qualities (where their libraries are found)
    "mp3-quality": ("[Quality]\nmp3 = 0\n", ["-t", "mp3"], True),
    "opus-quality": ("[Quality]\nopus = 0\n", ["-t", "opus"], True),
}


# the one file each case writes
NAMES = {"flac-quality": "00 - .flac", "flac-quality-defaults": "00 - .flac",
         "wavpack-quality": "00 - .wv", "default-type": "00 - .wv",
         "unknown-type": "00 - .wav", "filename-format": "00-a-.flac",
         "mp3-quality": "00 - .mp3", "opus-quality": "00 - .opus"}
# the configured level, then the class's default
LEVELS = {"flac-quality": ("5", "8"), "flac-quality-defaults": ("5", "8"),
          "wavpack-quality": ("fast", "standard"),
          "mp3-quality": ("0", "2"), "opus-quality": ("0", "10")}


def environment(home, pinned):
    """the tools' environment: HOME, no ATPU_* variable but
    REFERENCE_ENV's when ``pinned`` and the reference's host library
    cache of this process (which a fresh HOME would otherwise rebuild),
    the repository on the path"""
    env = {key: value for (key, value) in os.environ.items()
           if not key.startswith("ATPU_")}
    if pinned:
        env.update(REFERENCE_ENV)
    env["ATPU_CACHE_DIR"] = os.environ.get(
        "ATPU_CACHE_DIR", os.path.join(os.path.expanduser("~"), ".cache",
                                       "atpu"))
    env["HOME"] = str(home)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def run(side, tool, args, home, pinned=True):
    """runs the reference's (``side`` "ref") or the port's tool in a fresh
    interpreter from the current directory: (exit code, stdout, stderr)"""
    if side == "ref":
        command = [sys.executable, os.path.join(REPO, "tools", tool)]
    else:
        module = {"audiotools-config": "config_tool"}.get(tool, tool)
        command = [sys.executable, "-m", "audiotools_tpu_torch.cli." + module]
        if tool != "audiotools-config":
            args = list(args) + ["--devices", "cpu"]
    out = subprocess.run(command + list(args), capture_output=True,
                         text=True, timeout=600,
                         env=environment(home, pinned))
    return (out.returncode, out.stdout, out.stderr)


def configured(tmp_path, text):
    """tmp_path/home holding ``text`` as its .audiotools.cfg, the cwd
    holding the source"""
    home = tmp_path / "home"
    home.mkdir()
    (home / ".audiotools.cfg").write_text(text)
    os.makedirs("src")
    write_wave(SOURCE, signal(1, 2 * SR, SR), SR)
    return home


def files_in(directory):
    return {name: read(os.path.join(directory, name))
            for name in sorted(os.listdir(directory))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_track2track_reads_the_configuration(tmp_path, monkeypatch, case):
    (text, args, pinned) = CASES[case]
    if args[1:] and args[1] not in dispatch.TYPE_MAP:
        pytest.skip("the libraries of %s are not found" % (args[1],))
    monkeypatch.chdir(tmp_path)
    home = configured(tmp_path, text)
    ref = run("ref", "track2track", args + ["-j", "1", "-d", "ref", SOURCE],
              home, pinned)
    port = run("port", "track2track", args + ["-j", "1", "-d", "port",
                                              SOURCE], home, pinned)
    assert ref[0] == 0, ref[2]
    assert (port[0], port[1], port[2]) == (0, as_port(ref[1]), ref[2])
    want = files_in("ref")
    assert files_in("port") == want and len(want) == 1
    [(name, data)] = want.items()
    assert name == NAMES[case]
    if case in LEVELS:
        # the configured level's bytes, not the default level's
        cls = dispatch.TYPE_MAP[CASES[case][1][1]]
        for (level, same) in zip(LEVELS[case], (True, False)):
            path = str(tmp_path / ("level-" + level))
            with monkeypatch.context() as mp:
                for key in list(os.environ):
                    if key.startswith("ATPU_"):
                        mp.delenv(key)
                for (key, value) in (REFERENCE_ENV.items() if pinned
                                     else ()):
                    mp.setenv(key, value)
                cls.from_pcm(path, pcm.reader_from_array(
                    signal(1, 2 * SR, SR), 16, SR), level,
                    total_pcm_frames=2 * SR, device="cpu")
            assert (read(path) == data) == same


@pytest.mark.parametrize("form", ["-d", "-o"])
def test_an_invalid_configured_quality_fails_as_the_references(
        tmp_path, monkeypatch, form):
    """``[Quality] flac = 99``: both exit 1 and write nothing; with -o
    both print the same error line, with -d the reference's serial job
    raises (a traceback ending in KeyError) where the port prints the
    error's text as its line"""
    monkeypatch.chdir(tmp_path)
    home = configured(tmp_path, "[Quality]\nflac = 99\n")
    out = {}
    for side in ("ref", "port"):
        where = (["-d", side] if form == "-d" else
                 ["-o", side + ".flac"])
        out[side] = run(side, "track2track", ["-t", "flac", "-j", "1"] +
                        where + [SOURCE], home)
    assert out["ref"][:2] == out["port"][:2] == (1, "")
    assert not os.path.exists("ref.flac") and not os.path.exists(
        "port.flac")
    assert not os.listdir("port") if os.path.exists("port") else True
    assert not os.listdir("ref") if os.path.exists("ref") else True
    assert out["port"][2] == "*** Error: '99'\n"
    if form == "-o":
        assert out["ref"][2] == out["port"][2]
    else:
        assert out["ref"][2].splitlines()[-1] == "KeyError: '99'"


def test_tracksplit_names_its_tracks_by_the_configured_format(tmp_path,
                                                              monkeypatch):
    """a FLAC with an embedded CUESHEET split by both tools under a
    configured [Filenames] format: the same names, lines and bytes"""
    from test_torch_sheets import ALBUM_CUE
    monkeypatch.chdir(tmp_path)
    home = configured(tmp_path, "[Filenames]\nformat = %(album_track_number)s"
                      " %(basename)s %(track_total)d.%(suffix)s\n")
    for (key, value) in REFERENCE_ENV.items():
        monkeypatch.setenv(key, value)
    titles = []
    for (k, n) in enumerate((588 * 3, 588 * 2 + 100, 588 * 3)):
        titles.append("src/t%d.wav" % (k,))
        write_wave(titles[-1], signal(k + 2, n, CD), CD)
    with open("album.cue", "w") as f:
        f.write(ALBUM_CUE)
    assert port_tool("trackcat", "-t", "flac", "--cue", "album.cue", "-o",
                     "cat.flac", *titles)[0] == 0
    ref = run("ref", "tracksplit", ["-t", "flac", "-d", "ref", "cat.flac"],
              home)
    port = run("port", "tracksplit", ["-t", "flac", "-j", "1", "-d", "port",
                                      "cat.flac"], home)
    assert ref[0] == 0, ref[2]
    assert port == (0, as_port(ref[1]), ref[2])
    want = files_in("ref")
    assert sorted(want) == ["01 cat 3.flac", "02 cat 3.flac", "03 cat 3.flac"]
    assert files_in("port") == want


def test_config_tool_writes_what_the_next_run_reads(tmp_path, monkeypatch):
    """audiotools-config -t flac -q 5 writes the reference's file and
    lines; the port's next track2track, given neither -t nor -q, writes
    -5 FLAC"""
    monkeypatch.chdir(tmp_path)
    homes = {side: tmp_path / ("home-" + side) for side in ("ref", "port")}
    out = {}
    for (side, home) in homes.items():
        home.mkdir()
        out[side] = run(side, "audiotools-config", ["-t", "flac", "-q", "5",
                                                    "-j", "3"], home)
    assert out["port"] == out["ref"]
    assert out["port"][0] == 0 and "set Quality.flac = 5" in out["port"][2]
    assert ((homes["port"] / ".audiotools.cfg").read_text() ==
            (homes["ref"] / ".audiotools.cfg").read_text())
    os.makedirs("src")
    write_wave(SOURCE, signal(1, 2 * SR, SR), SR)
    assert run("port", "track2track", ["-d", "port", SOURCE],
               homes["port"])[0] == 0
    for (key, value) in REFERENCE_ENV.items():
        monkeypatch.setenv(key, value)
    FlacAudio.from_pcm("want.flac", pcm.reader_from_array(
        signal(1, 2 * SR, SR), 16, SR), "5", total_pcm_frames=2 * SR,
        device="cpu")
    assert files_in("port") == {"00 - .flac": read("want.flac")}


@pytest.mark.parametrize("jobs", ["set", "unset"])
def test_config_tool_lists_the_configuration(tmp_path, jobs):
    """the default type and job count the reference lists (the port's
    job count where none is set: parallel.farm.DEFAULT_WORKERS, 2, where
    the reference counts the CPUs), and each of the port's formats and
    quality modes as the reference lists it"""
    home = tmp_path / "home"
    home.mkdir()
    (home / ".audiotools.cfg").write_text(
        "[System]\ndefault_type = wavpack\n" +
        ("maximum_jobs = 3\n" if jobs == "set" else ""))
    (ref, port) = (run(side, "audiotools-config", [], home)
                   for side in ("ref", "port"))
    assert ref[0] == port[0] == 0 and ref[2] == port[2] == ""
    (ref_lines, lines) = (ref[1].splitlines(), port[1].splitlines())
    assert lines[:2] == ref_lines[:2] == ["System:",
                                          "  default type : wavpack"]
    assert lines[2] == "  maximum jobs : %d" % (3 if jobs == "set" else 2)
    if jobs == "set":
        assert lines[2] == ref_lines[2]
    # every class, available or not, as the reference lists them
    assert lines[3:] == ref_lines[3:]
