"""trackplay: play audio files.

The port of the reference's ``audiotools_tpu/cli/trackplay.py``: each
file played in turn through ``player.Player`` to the output ``-o``
names (the first available one by default; ``NULL`` discards the
samples at real-time pace), ``--shuffle`` and ``--repeat`` over the
list, ``-T``/``-A`` the tracks' or the album's ReplayGain.  The files
open on the ``--devices`` card (the current one by default), so each
decodes there on the player's fill thread; with no usable card the tool
exits 1.  -I runs the urwid player (``ui.PlayerGUI``) and, without
urwid, exits 1 with ``ui.not_available_message``'s line, as the
reference's does; on a terminal with urwid the player runs too.

    python -m audiotools_tpu_torch.cli.trackplay -o NULL a.flac b.flac
"""

from __future__ import annotations

import argparse
import sys
import time

from . import (Messenger, add_common_arguments, add_device_argument,
               first_device, text)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="trackplay",
                                     description=text.DESC_TRACKPLAY)
    add_common_arguments(parser)
    parser.add_argument("-o", "--output", dest="output", default=None,
                        help=text.HELP_PLAY_OUTPUT)
    parser.add_argument("--shuffle", action="store_true", default=False,
                        help=text.HELP_PLAY_SHUFFLE)
    parser.add_argument("--repeat", action="store_true", default=False,
                        help=text.HELP_PLAY_REPEAT)
    parser.add_argument("-I", "--interactive", action="store_true",
                        default=False, dest="interactive")
    parser.add_argument("-T", "--track-replaygain", action="store_true",
                        default=False, dest="track_replaygain")
    parser.add_argument("-A", "--album-replaygain", action="store_true",
                        default=False, dest="album_replaygain")
    add_device_argument(parser)
    parser.add_argument("filenames", nargs="+")
    options = parser.parse_args(argv)
    msg = Messenger(options)

    from .. import ui
    from ..dispatch import open_files
    from ..player import RG_ALBUM_GAIN, RG_TRACK_GAIN, Player, open_output

    device = first_device(msg, options)
    if device is None:
        return 1
    tracks = open_files(options.filenames, messenger=msg, device=device)
    if len(tracks) == 0:
        msg.error(text.ERR_1_FILE_REQUIRED)
        return 1
    if options.shuffle:
        import random
        random.shuffle(tracks)

    try:
        output = open_output(options.output)
    except ValueError as err:
        msg.error(str(err))
        return 1

    player = Player(output)
    if options.track_replaygain or options.album_replaygain:
        player.set_replay_gain(RG_TRACK_GAIN if options.track_replaygain
                               else RG_ALBUM_GAIN)

    if options.interactive and not ui.AVAILABLE:
        ui.not_available_message(msg)
        player.close()
        return 1
    if ui.AVAILABLE and (options.interactive or
                         (sys.stdout.isatty() and sys.stdin.isatty())):
        return _run_gui(ui, player, tracks)

    try:
        while True:
            for track in tracks:
                msg.info(text.LAB_PLAYING % {"filename": track.filename})
                _play_through(player, track)
            if not options.repeat:
                break
    except KeyboardInterrupt:
        msg.info(text.LAB_STOPPED)
    finally:
        player.close()
    return 0


def _play_through(player, item):
    """opens ``item`` and waits for the player's worker to start it (its
    command queue is asynchronous), then for it to stop at the end"""
    player.open(item)
    player.play()
    deadline = time.time() + 10
    while player.state() == 0 and time.time() < deadline:
        time.sleep(0.05)
    while player.state() != 0:
        time.sleep(0.1)


def _run_gui(ui, player, tracks):
    """the urwid player over ``tracks`` (the reference's TrackplayGUI)"""
    import urwid

    entries = []
    for track in tracks:
        meta = track.get_metadata()
        label = (meta.track_name if (meta is not None and meta.track_name)
                 else track.filename)
        entries.append((label, track.seconds_length(), track))
    gui = ui.PlayerGUI(player, entries,
                       sum(t.seconds_length() for t in tracks))
    # the worker thread only sets a flag that the alarm tick reads:
    # urwid's widgets are not thread-safe
    player.set_next_track_callback(gui.on_track_finished)
    loop = urwid.MainLoop(gui, ui.urwid_style(),
                          unhandled_input=lambda key: _gui_keys(gui, key))

    def tick(loop_, _data):
        gui.update_status()
        loop_.set_alarm_in(0.25, tick)

    loop.set_alarm_in(0.25, tick)
    try:
        loop.run()
    finally:
        player.close()
    return 0


def _gui_keys(gui, key):
    """the urwid player's global keys"""
    import urwid
    if key in ("q", "Q", "esc"):
        raise urwid.ExitMainLoop()
    elif key == " ":
        gui.play_pause()
    elif key in ("n", "N"):
        gui.next_track()
    elif key in ("p", "P"):
        gui.previous_track()
    elif key in ("s", "S"):
        gui.stop()


if __name__ == "__main__":
    sys.exit(main())
