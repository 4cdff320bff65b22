"""The port's command line: track2track, trackverify, trackcmp,
trackinfo, tracklength, tracktag, tracklint, trackrename, coverdump,
covertag, audiotools-config (``config_tool``), trackcat and tracksplit.

Each tool is a module with a ``main(argv)`` entry point, run as
``python -m audiotools_tpu_torch.cli.<tool>``, with the reference's
options and output lines (``audiotools_tpu/cli``).  Jobs run in the
farm's worker threads (``parallel.farm.run_jobs``), never in forked
processes: a child forked after the parent made a CUDA context cannot
use the card.  ``--devices`` names the torch devices they run on, the
current card by default.  The user's configuration is read as the
reference reads it (``utils.config``): its default type, filename
template, qualities and job count.  Progress rows are not drawn; the
lines a job prints when it ends are.  -I (interactive editing) and -M
(metadata lookup over the network) are not ported: a tool given one
exits 1 (``refuse_unported``).
"""

from __future__ import annotations

import os
import sys

from .. import VERSION
from . import text

# restore default SIGPIPE handling so tools piped into head/grep
# exit quietly instead of tracebacking on BrokenPipeError
try:
    import signal
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
except (ImportError, AttributeError, ValueError):
    pass        # non-POSIX or non-main-thread import

class Messenger:
    """output to stdout, info, warnings and errors to stderr, as the
    reference's ``utils.messenger.Messenger`` writes them"""

    def __init__(self, options=None):
        self.verbosity = getattr(options, "verbosity", None) or "normal"

    def output(self, s):
        if self.verbosity != "silent":
            sys.stdout.write("%s%s" % (s, os.linesep))
            sys.stdout.flush()

    def info(self, s):
        if self.verbosity not in ("quiet", "silent"):
            sys.stderr.write("%s%s" % (s, os.linesep))

    def warning(self, s):
        if self.verbosity != "silent":
            sys.stderr.write("*** Warning: %s%s" % (s, os.linesep))

    def error(self, s):
        sys.stderr.write("*** Error: %s%s" % (s, os.linesep))


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


def refuse_unported(msg, options):
    """True after an error line when -I or -M was asked for"""
    if getattr(options, "interactive", False):
        msg.error("-I (interactive mode) is not ported to "
                  "audiotools_tpu_torch")
        return True
    if getattr(options, "metadata_lookup", False):
        msg.error("-M (metadata lookup) is not ported to "
                  "audiotools_tpu_torch")
        return True
    return False


def add_unported_arguments(parser, lookup=True):
    """-I and (with ``lookup``) -M, which refuse_unported turns away"""
    parser.add_argument("-I", "--interactive", action="store_true",
                        default=False, dest="interactive",
                        help=text.HELP_INTERACTIVE)
    if lookup:
        parser.add_argument("-M", "--metadata-lookup", action="store_true",
                            default=False, dest="metadata_lookup",
                            help=text.HELP_METADATA_LOOKUP)


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
