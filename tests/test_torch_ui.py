"""The port's ``ui`` against the reference's.

Without urwid (its import forced to fail in both packages): the path
helpers, the format and quality listings, ``not_available_message``,
``xargs_suggestion``, ``PlayerTTY.progress_line``, and the line-oriented
``select_metadata`` and ``process_output_options`` with stdin piped.
Under ``tests/urwid_shim.py`` (installed for a test and taken out after
it, with both ``ui`` modules reloaded): the widget suite driven as
``tests/test_ui_widgets.py`` drives it, each scenario run on both
packages' widgets with their own MetaData, Filename and format classes,
giving the same results.  The shim's ``MainLoop.run`` raises, so the
widgets are driven directly.
"""

import contextlib
import io
import os
import sys

import pytest

import audiotools_tpu.audiofile as ref_audiofile
import audiotools_tpu.dispatch as ref_dispatch
import audiotools_tpu.formats.flac as ref_flac
import audiotools_tpu.formats.wav as ref_wav
import audiotools_tpu.utils.messenger as ref_messenger
import audiotools_tpu_torch.audiofile as port_audiofile
import audiotools_tpu_torch.dispatch as port_dispatch
import audiotools_tpu_torch.formats.flac as port_flac
import audiotools_tpu_torch.formats.wav as port_wav
import audiotools_tpu_torch.utils.messenger as port_messenger
import urwid_shim
from torch_ui_helpers import urwid_as


class Env:
    """one package's names a scenario uses"""

    def __init__(self, ui, audiofile, dispatch, flac, wav, messenger):
        self.ui = ui
        self.MetaData = audiofile.MetaData
        self.Filename = dispatch.Filename
        self.TYPE_MAP = dispatch.TYPE_MAP
        self.FlacAudio = flac.FlacAudio
        self.WaveAudio = wav.WaveAudio
        self.Messenger = messenger.Messenger


def envs(uis):
    (ref_ui, port_ui) = uis
    return (Env(ref_ui, ref_audiofile, ref_dispatch, ref_flac, ref_wav,
                ref_messenger),
            Env(port_ui, port_audiofile, port_dispatch, port_flac, port_wav,
                port_messenger))


@pytest.fixture
def no_urwid():
    with urwid_as(None) as uis:
        assert not uis[0].AVAILABLE and not uis[1].AVAILABLE
        yield envs(uis)


@pytest.fixture
def shim():
    with urwid_as(urwid_shim) as uis:
        assert uis[0].AVAILABLE and uis[1].AVAILABLE
        yield envs(uis)


def captured(fn, stdin=""):
    """fn()'s result, stdout and stderr, with ``stdin`` as its input"""
    (out, err) = (io.StringIO(), io.StringIO())
    saved = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            result = fn()
    finally:
        sys.stdin = saved
    return (result, out.getvalue(), err.getvalue())


def fields(metadata):
    return None if metadata is None else tuple(
        getattr(metadata, f) for f in metadata.FIELDS)


@pytest.fixture
def tree(tmp_path):
    for name in ("alpha", "alps", "beta", "songs"):
        (tmp_path / name).mkdir()
    (tmp_path / "song.flac").write_bytes(b"")
    (tmp_path / "beta" / "x.wav").write_bytes(b"")
    return str(tmp_path) + os.sep


PATHS = ["b", "a", "al", "alp", "zz", "song", "song.", "s", "beta/", "beta/x",
         "nowhere/x", ""]


@pytest.mark.parametrize("helper", ["tab_complete", "tab_complete_file"])
@pytest.mark.parametrize("path", PATHS)
def test_tab_completion_is_the_references(no_urwid, tree, helper, path):
    (ref, port) = no_urwid
    assert (getattr(port.ui, helper)(tree + path) ==
            getattr(ref.ui, helper)(tree + path))


@pytest.mark.parametrize("path", ["/a/b/c/", "/a/b/c", "/a/", "/a", "a/b",
                                  "a", "", "/", "a/b/c//"])
def test_pop_directory_is_the_references(no_urwid, path):
    (ref, port) = no_urwid
    assert port.ui.pop_directory(path) == ref.ui.pop_directory(path)


def test_format_listing_is_the_references(no_urwid):
    (ref, port) = no_urwid
    assert (captured(lambda: port.ui.show_available_formats(
        port.Messenger("x"))) ==
        captured(lambda: ref.ui.show_available_formats(ref.Messenger("x"))))


@pytest.mark.parametrize("name", ["flac", "alac", "tta", "wavpack", "shn",
                                  "wav"])
def test_quality_listing_is_the_references(no_urwid, name):
    (ref, port) = no_urwid
    assert (captured(lambda: port.ui.show_available_qualities(
        port.Messenger("x"), port.TYPE_MAP[name])) ==
        captured(lambda: ref.ui.show_available_qualities(
            ref.Messenger("x"), ref.TYPE_MAP[name])))


def test_not_available_message_is_the_references(no_urwid):
    (ref, port) = no_urwid
    result = captured(lambda: port.ui.not_available_message(
        port.Messenger("x")))
    assert result == captured(lambda: ref.ui.not_available_message(
        ref.Messenger("x")))
    assert result[2] == ("*** Error: urwid is required for interactive "
                         "mode; run without -I or install urwid\n")


@pytest.mark.parametrize("args", [["track2track", "-t", "flac", "a.wav"],
                                  ["/usr/bin/tracktag", "--name=x", "-V",
                                   "quiet", "b.flac"], ["cd2track"]])
def test_xargs_suggestion_is_the_references(no_urwid, args):
    (ref, port) = no_urwid
    assert port.ui.xargs_suggestion(args) == ref.ui.xargs_suggestion(args)


@pytest.mark.parametrize("sent,total,rate", [(0, 0, 0), (44100 * 30,
                                                          44100 * 60, 44100),
                                             (96000 * 61, 96000 * 3601,
                                              96000)])
def test_player_tty_progress_line_is_the_references(no_urwid, sent, total,
                                                    rate):
    (ref, port) = no_urwid
    lines = []
    for env in (ref, port):
        tty = env.ui.PlayerTTY(object())
        tty.set_metadata(2, 9, 2, rate, 16)
        lines.append(tty.progress_line(sent, total))
    assert lines[0] == lines[1]


def choices(env, count=2):
    """``count`` metadata choices for two tracks"""
    md = env.MetaData
    return [[md(track_name="Alpha %d" % (c,), album_name="Album %d" % (c,),
                artist_name="Artist" if c else None, track_number=1),
             md(track_name="Beta %d" % (c,), album_name="Album %d" % (c,),
                track_number=2)] for c in range(count)]


@pytest.mark.parametrize("answer", ["", "2\n", "1\n", "9\n", "x\n", "0\n"])
@pytest.mark.parametrize("count", [1, 3])
@pytest.mark.parametrize("use_default", [False, True])
def test_select_metadata_prompt_is_the_references(no_urwid, answer, count,
                                                  use_default):
    results = []
    for env in no_urwid:
        (chosen, stdout, stderr) = captured(
            lambda: env.ui.select_metadata(choices(env, count),
                                           env.Messenger("x"), use_default),
            stdin=answer)
        results.append(([fields(m) for m in chosen], stdout, stderr))
    assert results[0] == results[1]


@pytest.mark.parametrize("answer", ["", "2\n"])
def test_process_output_options_is_the_references(no_urwid, tmp_path,
                                                  answer):
    results = []
    for env in no_urwid:
        inputs = [env.Filename(str(tmp_path / "a.wav")),
                  env.Filename(str(tmp_path / "b.wav"))]
        (outputs, stdout, stderr) = captured(
            lambda: list(env.ui.process_output_options(
                choices(env, 3), inputs, str(tmp_path / "out"),
                "%(track_number)2.2d - %(track_name)s.%(suffix)s",
                env.FlacAudio, "8", env.Messenger("x"))), stdin=answer)
        results.append(([(cls.NAME, name, quality, fields(m))
                         for (cls, name, quality, m) in outputs],
                        stdout, stderr))
    assert results[0] == results[1]


# ---- the widget suite under the shim ----------------------------------

def editor_roundtrip(env, _tmp):
    md = env.MetaData
    editor = env.ui.MetaDataEditor(
        [(0, "track 1", md(track_name="One", track_number=1, album_name="LP")),
         (1, "track 2", md(track_name="Two", track_number=2,
                           album_name="LP"))])
    return [(k, fields(m)) for (k, m) in editor.metadata()]


def editor_linked(env, _tmp):
    md = env.MetaData
    editor = env.ui.MetaDataEditor(
        [(0, "track 1", md(track_name="One", album_name="LP")),
         (1, "track 2", md(track_name="Two", album_name="LP"))])
    cell = editor.metadata_edits[0].album_name
    linked = cell.checkbox.get_state()
    cell.linked_widget.set_edit_text("Renamed LP")
    return (linked, editor.metadata_edits[0].track_name.checkbox.get_state(),
            [(k, fields(m)) for (k, m) in editor.metadata()])


def editor_unlink(env, _tmp):
    md = env.MetaData
    editor = env.ui.MetaDataEditor(
        [(0, "track 1", md(track_name="One", album_name="LP")),
         (1, "track 2", md(track_name="Two", album_name="LP"))])
    cell = editor.metadata_edits[1].album_name
    cell.checkbox.set_state(False)
    cell.unlinked_widget.set_edit_text("Solo Album")
    relinked = editor.metadata_edits[0].album_name
    relinked.checkbox.set_state(False)
    relinked.checkbox.set_state(True)
    return [(k, fields(m)) for (k, m) in editor.metadata()]


def editor_swivel(env, _tmp):
    md = env.MetaData
    editor = env.ui.MetaDataEditor(
        [(0, "track 1", md(track_name="One")),
         (1, "track 2", md(track_name="Two"))])
    labels = [editor.selected_radio._label.get_text()[0]]
    for step in ("next", "next", "previous", "previous", "previous"):
        getattr(editor, "select_%s_item" % (step,))()
        labels.append(editor.selected_radio._label.get_text()[0])
    return labels


def filler_choices(env, _tmp):
    status = urwid_shim.Text("")
    filler = env.ui.MetaDataFiller(["track 1", "track 2"], choices(env),
                                   status)
    first = [fields(m) for m in filler.populated_metadata()]
    filler.select_match(None, True, 1)
    second = [fields(m) for m in filler.populated_metadata()]
    filler.select_next_item()
    filler.select_next_item()
    return (first, second, status._markup)


def output_filler_flow(env, tmp):
    inputs = [env.Filename(os.path.join(tmp, "a.wav")),
              env.Filename(os.path.join(tmp, "b.wav"))]
    filler = env.ui.OutputFiller(
        track_labels=["track 1", "track 2"],
        metadata_choices=choices(env),
        input_filenames=inputs,
        output_directory=os.path.join(tmp, "out"),
        format_string="%(track_number)2.2d - %(track_name)s.%(suffix)s",
        output_class=env.FlacAudio, quality="8")
    filler.wizard.next_page()
    (cls, quality, filenames) = filler.options.selected_options()
    try:
        filler.complete()
        exited = False
    except urwid_shim.ExitMainLoop:
        exited = True
    return (cls.NAME, quality, [str(f) for f in filenames], exited,
            filler.cancelled(),
            [(c.NAME, str(f), q, fields(m))
             for (c, f, q, m) in filler.output_tracks()])


def output_filler_refusals(env, tmp):
    out = []
    for (labels, metadatas, fmt, cls) in (
            (["track 1", "track 2"],
             [env.MetaData(album_name="LP"), env.MetaData(album_name="LP")],
             "same.%(suffix)s", env.FlacAudio),
            (["track 1"], [env.MetaData(track_name="A")], "a.%(suffix)s",
             env.WaveAudio),
            (["track 1"], [env.MetaData(track_name="A")], "%(nosuch)s",
             env.FlacAudio)):
        inputs = [env.Filename(os.path.join(tmp, name))
                  for name in ("a.wav", "b.wav")[:len(labels)]]
        filler = env.ui.OutputFiller(
            track_labels=labels, metadata_choices=[metadatas],
            input_filenames=inputs, output_directory=tmp, format_string=fmt,
            output_class=cls, quality="")
        filler.wizard.next_page()
        filler.complete()
        out.append((filler.options.has_duplicates,
                    filler.options.has_collisions, filler.options.has_errors,
                    filler.cancelled(), filler.options_status._markup))
    return out


def output_filler_cancel(env, tmp):
    filler = env.ui.OutputFiller(
        track_labels=["track 1"],
        metadata_choices=[[env.MetaData(track_name="A")]],
        input_filenames=[env.Filename(os.path.join(tmp, "a.wav"))],
        output_directory=os.path.join(tmp, "out"),
        format_string="%(track_name)s.%(suffix)s",
        output_class=env.FlacAudio, quality="8")
    try:
        filler.exit()
        exited = False
    except urwid_shim.ExitMainLoop:
        exited = True
    return (exited, filler.cancelled())


def single_output_filler(env, tmp):
    name = env.Filename(os.path.join(tmp, "in.wav"))
    filler = env.ui.SingleOutputFiller(
        track_label="track 1",
        metadata_choices=[env.MetaData(track_name="Solo"),
                          env.MetaData(track_name="Other")],
        input_filenames=[name], output_file=os.path.join(tmp, "in.wav"),
        output_class=env.FlacAudio, quality="8")
    filler.complete()
    refused = (filler.cancelled(), filler.status._markup)
    filler.options.output_filename.set_edit_text(
        os.path.join(tmp, "out.flac"))
    try:
        filler.complete()
        exited = False
    except urwid_shim.ExitMainLoop:
        exited = True
    (cls, filename, quality, metadata) = filler.output_track()
    return (refused, exited, filler.cancelled(), cls.NAME, str(filename),
            quality, fields(metadata))


def output_options_class(env, tmp):
    options = env.ui.OutputOptions(
        output_dir=tmp, format_string="%(basename)s.%(suffix)s",
        audio_class=env.FlacAudio, quality="8",
        input_filenames=[env.Filename(os.path.join(tmp, "x.wav"))],
        metadatas=[None])
    before = options.selected_options()
    options.audio_class.set_selection(env.WaveAudio)
    after = options.selected_options()
    return [(cls.NAME, quality, [str(f) for f in names])
            for (cls, quality, names) in (before, after)]


def select_one(env, _tmp):
    changed = []
    sel = env.ui.SelectOne([("first", 1), ("second", 2), ("third", 3)], 2,
                           on_change=changed.append)
    first = sel.selection()
    sel.set_selection(3)
    edit = env.ui.DownEdit(edit_text="abc")
    return (first, sel.selection(), changed,
            edit.keypress((10,), "enter"))


class FakePlayer:
    """records its commands; a Player-compatible stand-in"""

    def __init__(self):
        self.calls = []
        self.progress_value = (0, 100)
        self.state_value = 0

    def open(self, track):
        self.calls.append(("open", track))

    def play(self):
        self.calls.append(("play", None))
        self.state_value = 2

    def toggle_play_pause(self):
        self.calls.append(("toggle", None))
        self.state_value = 2 if self.state_value != 2 else 1

    def stop(self):
        self.calls.append(("stop", None))
        self.state_value = 0

    def progress(self):
        return self.progress_value

    def state(self):
        return self.state_value


def player_gui(env, _tmp):
    player = FakePlayer()
    gui = env.ui.PlayerGUI(player, [("one", 10, "t1"), ("two", 20, "t2"),
                                    ("three", 5, "t3")], 35)
    log = []
    gui.play_pause()
    log.append((gui.track_index, gui.track_number.get_text()[0]))
    gui.track_buttons[1].set_state(True)
    player.progress_value = (50, 100)
    gui.update_status()
    log.append((gui.track_index, gui.progress.current,
                gui.play_pause_button.label))
    player.progress_value = (100, 100)
    gui.update_status()
    log.append(gui.track_index)
    gui.on_track_finished()
    player.progress_value = (0, 100)
    gui.update_status()
    gui.next_track()
    gui.previous_track()
    gui.stop()
    log.append((gui.track_index, gui.track_name.get_text()[0]))
    return (player.calls, log)


SCENARIOS = [editor_roundtrip, editor_linked, editor_unlink, editor_swivel,
             filler_choices, output_filler_flow, output_filler_refusals,
             output_filler_cancel, single_output_filler, output_options_class,
             select_one, player_gui]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_widgets_give_the_references_results(shim, tmp_path, scenario):
    (ref, port) = shim
    ref_result = scenario(ref, str(tmp_path))
    port_result = scenario(port, str(tmp_path))
    assert port_result == ref_result


def test_the_palette_is_the_references(shim):
    (ref, port) = shim
    assert port.ui.urwid_style() == ref.ui.urwid_style()


@pytest.mark.parametrize("module", [None, urwid_shim],
                         ids=["absent", "shim"])
def test_urwid_as_puts_the_modules_back(module):
    """inside ``urwid_as`` both ui modules see ``module`` as urwid; after
    it ``sys.modules`` is as it was and both modules' AVAILABLE follow it
    (urwid itself is not installed here)"""
    import audiotools_tpu.ui as ref_ui
    import audiotools_tpu_torch.ui as port_ui
    missing = object()
    saved = sys.modules.get("urwid", missing)
    with urwid_as(module) as uis:
        assert sys.modules["urwid"] is module
        assert [ui.AVAILABLE for ui in uis] == [module is not None] * 2
    assert sys.modules.get("urwid", missing) is saved
    assert ([ref_ui.AVAILABLE, port_ui.AVAILABLE] ==
            [saved not in (missing, None)] * 2)
