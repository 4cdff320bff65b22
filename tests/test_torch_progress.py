"""The port's progress rows against the reference's.

The tools that draw rows in the reference (``track2track``,
``trackverify``, ``trackcmp``, ``cd2track`` a ``ProgressDisplay``,
``trackcat`` a ``SingleProgressDisplay``) run in-process through both
packages with stdout on a pseudo-terminal (``pty.openpty()``, 24 x 60);
each side's bytes go through a small screen model (cursor up, clear
down, clear line) and the final screens, completion lines included,
must be equal, each drawn row in the reference's ``"%3d%% %s"`` form
cut to the terminal's width.  Raw byte streams are not compared: when
a row is redrawn depends on timing.  With stdout on a pipe the bytes
are the reference's, byte for byte.  The display classes themselves
give the reference's bytes for the same calls, and ``run_jobs`` draws
from the calling thread alone."""

import contextlib
import fcntl
import importlib
import io
import os
import pty
import re
import shutil
import struct
import sys
import termios
import threading
import time

import numpy as np
import pytest
import torch

from audiotools_tpu.utils import messenger as ref_messenger
from audiotools_tpu_torch import cli, pcm
from audiotools_tpu_torch.formats.wav import WaveAudio
from audiotools_tpu_torch.parallel import farm
from audiotools_tpu_torch.utils import messenger
from test_torch_disc_cli import REFERENCE_ENV
from torch_disc_helpers import make_image

torch.set_num_threads(1)

ROWS = 24
COLS = 60
# long enough that a row is cut to the terminal's width
LONG_DIR = "a-directory-with-a-rather-long-name-to-cut-the-rows"
ROW = re.compile(r"^( {0,2}\d{1,3})% (.*)$")
DONE = "<<end of run>>"


class Terminal:
    """a pseudo-terminal of ROWS x COLS: ``file`` writes to its slave
    side, a thread keeps what its master side reads in ``data``"""

    def __init__(self):
        (self.master, self.slave) = pty.openpty()
        fcntl.ioctl(self.slave, termios.TIOCSWINSZ,
                    struct.pack("HHHH", ROWS, COLS, 0, 0))
        self.file = io.TextIOWrapper(io.FileIO(self.slave, "w",
                                               closefd=False),
                                     encoding="utf-8", write_through=True)
        self.data = bytearray()
        self.thread = threading.Thread(target=self.drain, daemon=True)
        self.thread.start()

    def drain(self):
        while True:
            try:
                chunk = os.read(self.master, 65536)
            except OSError:
                return
            if not chunk:
                return
            self.data += chunk

    def close(self):
        """waits for everything written to be read, then closes"""
        self.file.write(DONE)
        self.file.flush()
        deadline = time.time() + 30
        while DONE.encode() not in self.data and time.time() < deadline:
            time.sleep(0.01)
        os.close(self.slave)
        self.thread.join(5)
        os.close(self.master)
        return bytes(self.data).split(DONE.encode())[0]


def screen(data):
    """the lines a terminal shows after ``data``: printable characters at
    the cursor, \\r and \\n, ESC[nA (cursor up), ESC[0J (clear from the
    cursor down) and ESC[0K (clear to the line's end)"""
    lines = [[]]
    (row, col) = (0, 0)
    text = data.decode("utf-8")
    i = 0
    while i < len(text):
        c = text[i]
        if c == "\x1b":
            m = re.match(r"\x1b\[(\d*)([A-Za-z])", text[i:])
            assert m is not None, text[i:i + 8]
            (n, command) = (int(m.group(1) or 0), m.group(2))
            if command == "A":
                row = max(row - max(n, 1), 0)
            elif command == "J":
                del lines[row][col:]
                del lines[row + 1:]
            elif command == "K":
                del lines[row][col:]
            else:
                raise AssertionError("unexpected sequence %r" % (m.group(0),))
            i += len(m.group(0))
            continue
        if c == "\r":
            col = 0
        elif c == "\n":
            (row, col) = (row + 1, 0)
        else:
            line = lines[row]
            line.extend(" " * (col + 1 - len(line)))
            line[col] = c
            col += 1
        while len(lines) <= row:
            lines.append([])
        i += 1
    out = ["".join(line).rstrip() for line in lines]
    while out and not out[-1]:
        out.pop()
    return out


def drawn_rows(data):
    """every progress row the bytes drew: the text between line ends and
    sequences that reads as one"""
    pieces = re.split(r"\x1b\[\d*[A-Za-z]|\r|\n", data.decode("utf-8"))
    return [p for p in pieces if ROW.match(p)]


def run_main(module_name, args, stdout):
    """a tool's main(args) with stdout on ``stdout`` and stderr kept:
    (exit code, stderr)"""
    module = importlib.import_module(module_name)
    err = io.StringIO()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(err):
        try:
            code = module.main(list(args))
        except SystemExit as exit_err:
            code = exit_err.code
    stdout.flush()
    return (code or 0, err.getvalue())


def remove_outputs():
    """empties the two sides' output directories"""
    for path in ("ref", "port"):
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.makedirs(path)


def as_port(text):
    return re.sub(r"(?<![\w/])ref/", "port/", text)


class FakeClock:
    """time.time that advances a second a call: every throttled update
    draws"""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        self.now += 1.0
        return self.now


# tool: (arguments with "SIDE" for ref or port, the rows' labels)
TOOLS = {
    "track2track": (["-j", "1", "-t", "wav", "-d", "SIDE/" + LONG_DIR,
                     "--format", "%(basename)s.%(suffix)s", "src/a.wav",
                     "src/b.wav", "src/c.wav"],
                    ["SIDE/%s/%s.wav" % (LONG_DIR, n) for n in "abc"]),
    "trackverify": (["-j", "1", "src/a.wav", "src/b.wav", "src/c.wav"],
                    ["src/%s.wav" % (n,) for n in "abc"]),
    "trackcmp": (["-j", "1", "src/a.wav", "src/b.wav", "src/c.wav",
                  "src/a.wav"],
                 ["src/a.wav <> src/b.wav", "src/c.wav <> src/a.wav"]),
    "cd2track": (["-j", "1", "-c", "src/disc.cue", "-t", "wav", "-d",
                  "SIDE/rips", "--format", "%(track_number)2.2d.%(suffix)s"],
                 ["track 1", "track 2"]),
    "trackcat": (["-t", "wav", "-o", "SIDE/joined.wav", "src/a.wav",
                  "src/b.wav", "src/c.wav"], ["SIDE/joined.wav"]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("progress")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for (key, value) in REFERENCE_ENV.items():
            mp.setenv(key, value)
        mp.chdir(base)
        os.makedirs("src")
        rng = np.random.default_rng(3)
        for (name, frames) in (("a", 30000), ("b", 5000), ("c", 70001)):
            WaveAudio.from_pcm("src/%s.wav" % (name,), pcm.reader_from_array(
                rng.integers(-3000, 3000, (frames, 2)).astype(np.int32), 16))
        make_image("src", [40, 25])
        remove_outputs()
        for (tool, (args, _labels)) in TOOLS.items():
            for side in ("ref", "port"):
                package = ("audiotools_tpu.cli." if side == "ref" else
                           "audiotools_tpu_torch.cli.")
                side_args = [a.replace("SIDE", side) for a in args]
                if side == "port":
                    side_args += ["--devices", "cpu"]
                # a clock a second on each call: trackcat draws each read
                with pytest.MonkeyPatch.context() as clock:
                    clock.setattr(time, "time", FakeClock())
                    terminal = Terminal()
                    (code, err) = run_main(package + tool, side_args,
                                           terminal.file)
                    tty_bytes = terminal.close()
                remove_outputs()
                (read_fd, write_fd) = os.pipe()
                pipe = os.fdopen(write_fd, "w", encoding="utf-8")
                (pipe_code, pipe_err) = run_main(package + tool, side_args,
                                                 pipe)
                pipe.close()
                with os.fdopen(read_fd, "rb") as f:
                    pipe_bytes = f.read()
                out[(tool, side)] = (code, err, tty_bytes, pipe_code,
                                     pipe_err, pipe_bytes)
                remove_outputs()
    return out


@pytest.mark.parametrize("tool", list(TOOLS))
def test_the_final_screen_is_the_references(runs, tool):
    (code, err, data, *_pipe) = runs[(tool, "port")]
    (ref_code, ref_err, ref_data, *_ref_pipe) = runs[(tool, "ref")]
    assert (code, err) == (ref_code, as_port(ref_err))
    assert code == (1 if tool == "trackcmp" else 0)    # a <> b differ
    port_screen = screen(data)
    assert port_screen == [as_port(line) for line in screen(ref_data)]
    assert port_screen
    if tool == "trackcat":
        # the row is left on the screen, drawn at the last read
        assert port_screen == ["100% port/joined.wav"]
    else:
        # every row cleared: the completion lines alone
        assert not any(ROW.match(line) for line in port_screen)


@pytest.mark.parametrize("tool", list(TOOLS))
def test_each_drawn_row_is_in_the_references_form(runs, tool):
    (_args, labels) = TOOLS[tool]
    for side in ("ref", "port"):
        data = runs[(tool, side)][2]
        rows = drawn_rows(data)
        # the port draws a job's row as it starts, the reference's serial
        # queue at the job's first progress call, which a WAVE's verify
        # never makes
        assert rows or (side, tool) == ("ref", "trackverify")
        wanted = [label.replace("SIDE", side) for label in labels]
        for row in rows:
            assert len(row) <= COLS - 1
            (percent, label) = ROW.match(row).groups()
            assert 0 <= int(percent) <= 100
            assert "%3d%% %s" % (int(percent), label) == row
            assert any(("%3d%% %s" % (int(percent), w))[:COLS - 1] == row
                       for w in wanted), row
    if tool == "track2track":
        # the long destinations were cut to the width
        assert any(len(row) == COLS - 1
                   for row in drawn_rows(runs[(tool, "port")][2]))


@pytest.mark.parametrize("tool", list(TOOLS))
def test_on_a_pipe_the_bytes_are_the_references(runs, tool):
    (*_tty, code, err, data) = runs[(tool, "port")]
    (*_ref_tty, ref_code, ref_err, ref_data) = runs[(tool, "ref")]
    assert (code, err) == (ref_code, as_port(ref_err))
    assert data == as_port(ref_data.decode("utf-8")).encode("utf-8")
    assert b"\x1b" not in data and b"%" not in data


class FakeTty(io.StringIO):
    def isatty(self):
        return True


class NoTty(io.StringIO):
    def isatty(self):
        return False


def scripted(package, messenger_class, stdout_class, monkeypatch):
    """the bytes each display class writes for one script of calls"""
    out = stdout_class()
    err = io.StringIO()
    monkeypatch.setattr(time, "time", FakeClock())
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        msg = messenger_class()
        display = package.ProgressDisplay(msg)
        rows = [display.add_row("first row " + "x" * 90),
                display.add_row("second")]
        rows[0].update(10, 40)
        rows[1].update(3, 0)
        display.output_line("a line above")
        rows[0].finish()
        third = display.add_row("third takes the first's slot")
        third.update(7, 7)
        rows[1].update(250, 100)
        third.finish()
        rows[1].finish()
        display.output_line("done")
        single = package.SingleProgressDisplay(msg, "joined.flac")
        for current in (0, 10, 20, 30):
            single.update(current, 30)
        for lossless in (True, False):
            rg = package.ReplayGainProgressDisplay(msg, lossless)
            rg.initial_message()
            rg.update(5, 10)
            rg.update(10, 10)
            rg.final_message()
        out.write("|".join(package.output_progress("line", c, t)
                           for (c, t) in ((1, 1), (2, 12), (12, 12),
                                          (3, 100))))
    monkeypatch.undo()
    return (out.getvalue(), err.getvalue())


@pytest.mark.parametrize("stdout_class", [FakeTty, NoTty])
def test_the_display_classes_write_the_references_bytes(monkeypatch,
                                                        stdout_class):
    port = scripted(messenger, cli.Messenger, stdout_class, monkeypatch)
    ref = scripted(ref_messenger, ref_messenger.Messenger, stdout_class,
                   monkeypatch)
    assert port == ref
    if stdout_class is FakeTty:
        assert "\x1b[2A\x1b[0J" in port[0]
        assert " 25% first row" in port[0]
    else:
        assert "\x1b" not in port[0] and "%" not in port[0]


def test_the_ansi_helpers_are_the_references(monkeypatch):
    for stdout_class in (FakeTty, NoTty):
        outs = []
        for msg in (cli.Messenger(), ref_messenger.Messenger()):
            out = stdout_class()
            with contextlib.redirect_stdout(out):
                msg.ansi_clearline()
                msg.ansi_uplines(3)
                msg.ansi_cleardown()
                size = msg.terminal_size()
            outs.append((out.getvalue(), size))
        assert outs[0] == outs[1]
    (master, slave) = pty.openpty()
    fcntl.ioctl(slave, termios.TIOCSWINSZ, struct.pack("HHHH", 31, 97, 0, 0))
    assert cli.Messenger().terminal_size(slave) == \
        ref_messenger.Messenger().terminal_size(slave) == (31, 97)
    os.close(slave)
    os.close(master)


class RecordingDisplay:
    """a ProgressDisplay stand-in that records its calls and the thread
    each came from"""

    def __init__(self):
        self.calls = []
        self.threads = set()

    def note(self, *call):
        self.calls.append(call)
        self.threads.add(threading.get_ident())

    def add_row(self, label):
        self.note("add", label)
        display = self

        class Row:
            current = 0
            total = 1

            def finish(self):
                display.note("finish", label)
        return Row()

    def display_rows(self):
        self.note("draw")


@pytest.mark.parametrize("workers", [1, 3])
def test_run_jobs_draws_from_the_calling_thread_alone(workers):
    display = RecordingDisplay()
    seen = []

    def run(job, device, progress):
        for step in range(1, 4):
            progress(step * job, 3 * job)
            time.sleep(0.05)
        return job * 10

    def done(index, result, error):
        display.note("done", index, result, error)
        seen.append(threading.get_ident())

    outcomes = farm.run_jobs([1, 2, 3, 4, 5], run, workers=workers,
                             devices=["cpu"], done=done, display=display,
                             label=lambda job: "job %d" % (job,))
    assert outcomes == [(10 * j, None) for j in (1, 2, 3, 4, 5)]
    assert display.threads == {threading.get_ident()}
    assert set(seen) == {threading.get_ident()}
    for job in range(1, 6):
        calls = [c for c in display.calls if c[0] != "draw"]
        adds = calls.index(("add", "job %d" % (job,)))
        finish = calls.index(("finish", "job %d" % (job,)))
        assert adds < finish
        assert calls[finish + 1][:2] == ("done", job - 1)
    assert ("draw",) in display.calls


def test_run_jobs_without_a_display_calls_run_as_before():
    seen = []
    outcomes = farm.run_jobs(
        ["a", "bb", "ccc"], lambda job, device: len(job), workers=2,
        devices=["cpu"], done=lambda i, r, e: seen.append((i, r, e)))
    assert outcomes == [(1, None), (2, None), (3, None)]
    assert sorted(seen) == [(0, 1, None), (1, 2, None), (2, 3, None)]


def test_a_failed_job_finishes_its_row_before_the_error_is_reported():
    display = RecordingDisplay()

    def run(job, device, progress):
        progress(1, 2)
        if job == "bad":
            raise ValueError("broken")
        return job

    outcomes = farm.run_jobs(["good", "bad", "never"], run, workers=1,
                             devices=["cpu"], stop_on_error=True,
                             display=display,
                             done=lambda i, r, e: display.note("done", i))
    assert outcomes[0] == ("good", None)
    assert str(outcomes[1][1]) == "broken"
    assert outcomes[2] == (None, None)
    calls = [c for c in display.calls if c[0] != "draw"]
    assert calls == [("add", "good"), ("finish", "good"), ("done", 0),
                     ("add", "bad"), ("finish", "bad"), ("done", 1)]


def test_run_jobs_loses_no_row_or_outcome_under_contention():
    """more workers than cores and a short switch interval: every job
    runs once, its row is added and finished once, in that order, before
    its done, and every row the calling thread reads from a slot is a
    pair some job wrote"""
    display = RecordingDisplay()
    drawn = []
    rows = {}

    def add_row(label):
        row = RecordingDisplay.add_row(display, label)
        rows[label] = row
        return row

    def display_rows():
        display.note("draw")
        drawn.extend((row.current, row.total) for row in rows.values())

    display.add_row = add_row
    display.display_rows = display_rows

    def run(job, device, progress):
        for step in range(1, 51):
            progress(step, 50)
        return job

    done = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outcomes = farm.run_jobs(
            list(range(64)), run, workers=3 * (os.cpu_count() or 1),
            devices=["cpu"], done=lambda i, r, e: done.append(i),
            display=display, label=lambda job: "job %d" % (job,))
    finally:
        sys.setswitchinterval(interval)
    assert outcomes == [(j, None) for j in range(64)]
    assert sorted(done) == list(range(64))
    calls = [c for c in display.calls if c[0] != "draw"]
    for job in range(64):
        label = "job %d" % (job,)
        assert calls.count(("add", label)) == 1
        assert calls.count(("finish", label)) == 1
        assert calls.index(("add", label)) < calls.index(("finish", label))
    assert display.threads == {threading.get_ident()}
    assert all(total in (1, 50) and 0 <= current <= 50
               for (current, total) in drawn)
