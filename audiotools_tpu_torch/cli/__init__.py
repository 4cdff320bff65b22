"""The port's command line: track2track, trackverify, trackcmp,
trackinfo, tracklength, tracktag, tracklint, trackrename, coverdump,
covertag, audiotools-config (``config_tool``), trackcat, tracksplit,
the disc tools cdinfo, cd2track and track2cd, and the DVD-Audio tools
dvdainfo and dvda2track, the players trackplay and cdplay, and
coverview.

Each tool is a module with a ``main(argv)`` entry point, run as
``python -m audiotools_tpu_torch.cli.<tool>``, with the reference's
options and output lines (``audiotools_tpu/cli``).  Jobs run in the
farm's worker threads (``parallel.farm.run_jobs``), never in forked
processes: a child forked after the parent made a CUDA context cannot
use the card.  ``--devices`` names the torch devices they run on, the
current card by default.  The user's configuration is read as the
reference reads it (``utils.config``): its default type, filename
template, qualities and job count.  On a terminal, track2track,
trackverify, trackcmp and cd2track draw a progress row a running job
and trackcat one row (``utils.messenger``), as the reference's do: the
workers write their progress into a slot a job and the thread that
runs the farm draws the rows; with stdout not a terminal nothing is
drawn, and each tool prints the lines a job prints when it ends.  -M
looks the album up in FreeDB and MusicBrainz (``services.lookup``),
with the reference's option family (``add_lookup_arguments``).  -I
(``add_interactive_argument``) runs the reference's interactive flows:
trackrename and audiotools-config prompt on stdin; track2track,
tracktag and cd2track edit in ``ui``'s urwid widgets, and dvda2track,
trackcat and tracksplit choose a lookup's match with
``ui.select_metadata``.  Without urwid, the widget flows exit 1 with
``ui.not_available_message``'s line, at the point the reference's do.
"""

from __future__ import annotations

import os
import sys

from .. import VERSION
from ..utils import messenger
from . import text

# restore default SIGPIPE handling so tools piped into head/grep
# exit quietly instead of tracebacking on BrokenPipeError
try:
    import signal
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
except (ImportError, AttributeError, ValueError):
    pass        # non-POSIX or non-main-thread import

class Messenger(messenger.Messenger):
    """the reference tools' ``utils.messenger.Messenger``, made from the
    parsed options alone"""

    def __init__(self, options=None):
        messenger.Messenger.__init__(self, "audiotools", options)


def output_filename(track, destination_dir, output_format, suffix,
                    metadata):
    """the path of a converted track: ``track_name`` of its source's
    filename, ``metadata``, ``output_format`` and ``suffix``, in
    ``destination_dir``"""
    from ..audiofile import AudioFile
    return os.path.join(destination_dir, AudioFile.track_name(
        track.filename, metadata, output_format, suffix=suffix))


def audiofile_type(messenger, type_name):
    """the class a -t/--type argument names, or None after an error"""
    from ..dispatch import TYPE_MAP
    if type_name in TYPE_MAP:
        return TYPE_MAP[type_name]
    messenger.error(text.ERR_UNSUPPORTED_AUDIO_TYPE % {"type": type_name})
    messenger.info(text.ERR_SUPPORTED_TYPES %
                   {"types": ", ".join(sorted(TYPE_MAP.keys()))})
    return None


def default_type():
    """the configured default type, "wav" when the port has no such type"""
    from ..dispatch import TYPE_MAP
    from ..utils.config import DEFAULT_TYPE
    return DEFAULT_TYPE if DEFAULT_TYPE in TYPE_MAP else "wav"


def default_jobs():
    """the default -j: [System] maximum_jobs when it is set, else the
    farm's DEFAULT_WORKERS (the reference's default is the CPU count;
    the job count changes no output byte)"""
    from ..parallel.farm import DEFAULT_WORKERS
    from ..utils.config import config
    configured = config.getint_default("System", "maximum_jobs", -1)
    return configured if configured > 0 else DEFAULT_WORKERS


def add_interactive_argument(parser):
    """-I (the tools' interactive modes)"""
    parser.add_argument("-I", "--interactive", action="store_true",
                        default=False, dest="interactive",
                        help=text.HELP_INTERACTIVE)


def add_lookup_arguments(parser):
    """-M and the options of its lookups (the reference's
    ``add_lookup_arguments``)"""
    parser.add_argument("-M", "--metadata-lookup", action="store_true",
                        default=False, dest="metadata_lookup",
                        help=text.HELP_METADATA_LOOKUP)
    parser.add_argument("--musicbrainz-server", dest="musicbrainz_server",
                        default="musicbrainz.org",
                        help=text.HELP_MUSICBRAINZ_SERVER)
    parser.add_argument("--musicbrainz-port", type=int,
                        dest="musicbrainz_port", default=80)
    parser.add_argument("--no-musicbrainz", dest="use_musicbrainz",
                        action="store_false", default=True,
                        help=text.HELP_NO_MUSICBRAINZ)
    parser.add_argument("--freedb-server", dest="freedb_server",
                        default="us.freedb.org", help=text.HELP_FREEDB_SERVER)
    parser.add_argument("--freedb-port", type=int, dest="freedb_port",
                        default=80)
    parser.add_argument("--no-freedb", dest="use_freedb",
                        action="store_false", default=True,
                        help=text.HELP_NO_FREEDB)
    parser.add_argument("-D", "--default", dest="use_default",
                        action="store_true", default=False,
                        help=text.HELP_USE_DEFAULT)


def urwid_missing(msg):
    """True after ``ui.not_available_message``'s line where urwid does
    not import (the widget flows of -I need it)"""
    from .. import ui
    if ui.AVAILABLE:
        return False
    ui.not_available_message(msg)
    return True


def edit_metadata(labels, choices):
    """-I's metadata editor: ``ui.MetaDataFiller`` over ``choices`` (a
    list of MetaData a track each), F1 and F2 moving through the swivel;
    the edited MetaData a track when the user leaves with enter, None
    with esc"""
    import urwid
    from .. import ui
    status = urwid.Text("")
    filler = ui.MetaDataFiller(labels, choices, status)
    accepted = []

    def unhandled(key):
        if key == "f1":
            filler.select_previous_item()
        elif key == "f2":
            filler.select_next_item()
        elif key == "enter":
            accepted.append(True)
            raise urwid.ExitMainLoop()
        elif key == "esc":
            raise urwid.ExitMainLoop()

    urwid.MainLoop(urwid.Frame(body=filler, footer=status),
                   ui.urwid_style(), unhandled_input=unhandled).run()
    return list(filler.populated_metadata()) if accepted else None


def chosen_metadata(msg, options, choices):
    """the lookup choice a tool takes: with -I the one
    ``ui.select_metadata`` returns (None after ``ui.not_available_message``'s
    line where urwid is absent), else the first (-D: the last, the
    default)"""
    if options.interactive:
        if urwid_missing(msg):
            return None
        from .. import ui
        return ui.select_metadata(choices, msg)
    return choices[-1] if options.use_default else choices[0]


def lookup_options(options):
    """the keyword arguments of a ``services.lookup`` call from the
    lookup options"""
    return dict(musicbrainz_server=options.musicbrainz_server,
                musicbrainz_port=options.musicbrainz_port,
                freedb_server=options.freedb_server,
                freedb_port=options.freedb_port,
                use_musicbrainz=options.use_musicbrainz,
                use_freedb=options.use_freedb)


def output_table(rows):
    """the lines of the reference's ``output_table``: each row's cells
    left-justified to their column's widest cell, the line's right end
    stripped"""
    widths = [max(len(row[i]) for row in rows if len(row) > i)
              for i in range(max(len(row) for row in rows))]
    return ["".join(cell.ljust(width)
                    for (cell, width) in zip(row, widths)).rstrip()
            for row in rows]


def add_common_arguments(parser):
    parser.add_argument("-V", "--verbose", dest="verbosity",
                        default="normal",
                        choices=("normal", "quiet", "silent", "debug"),
                        help=text.HELP_VERBOSITY)
    parser.add_argument("--version", action="version",
                        version="Python Audio Tools (TPU) %s" % (VERSION,),
                        help=text.HELP_VERSION)


def add_device_argument(parser):
    """--devices (job_devices reads it)"""
    parser.add_argument("--devices", default=None, help=text.HELP_DEVICES)


def first_device(msg, options):
    """the first of job_devices(options.devices), or None after an error
    line"""
    try:
        return job_devices(options.devices)[0]
    except (RuntimeError, ValueError) as err:
        msg.error(str(err))
        return None


def add_job_arguments(parser):
    """-j (farm workers, default_jobs() when not given) and --devices"""
    parser.add_argument("-j", "--joint", dest="max_processes", type=int,
                        default=default_jobs(), help=text.HELP_JOINT)
    add_device_argument(parser)


def job_devices(value):
    """the torch devices of a --devices value (resolved: an absent card
    raises): None is the current card, a count N cuda:0 .. cuda:N-1,
    anything else a comma list of devices"""
    from .._device import resolve_devices
    if value is None:
        return resolve_devices(["cuda"])
    if value.strip().isdigit():
        return resolve_devices(["cuda:%d" % (i,)
                                for i in range(int(value))])
    return resolve_devices([d.strip() for d in value.split(",")])
