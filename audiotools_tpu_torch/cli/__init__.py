"""The port's command line: track2track, trackverify, trackcmp,
trackinfo and tracklength.

Each tool is a module with a ``main(argv)`` entry point, run as
``python -m audiotools_tpu_torch.cli.<tool>``, with the reference's
options and output lines (``audiotools_tpu/cli``).  Jobs run in the
farm's worker threads (``parallel.farm.run_jobs``), never in forked
processes: a child forked after the parent made a CUDA context cannot
use the card.  ``--devices`` names the torch devices they run on, the
current card by default.  The reference's configuration files are not
read: its built-in defaults stand.  Progress rows are not drawn; the
lines a job prints when it ends are.
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

# the reference's built-in default for the System/default_type setting
DEFAULT_TYPE = "flac"


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
    return DEFAULT_TYPE


def add_common_arguments(parser):
    parser.add_argument("-V", "--verbose", dest="verbosity",
                        default="normal",
                        choices=("normal", "quiet", "silent", "debug"),
                        help=text.HELP_VERBOSITY)
    parser.add_argument("--version", action="version",
                        version="Python Audio Tools (TPU) %s" % (VERSION,),
                        help=text.HELP_VERSION)


def add_job_arguments(parser):
    """-j (farm workers) and --devices"""
    from ..parallel.farm import DEFAULT_WORKERS
    parser.add_argument("-j", "--joint", dest="max_processes", type=int,
                        default=DEFAULT_WORKERS, help=text.HELP_JOINT)
    parser.add_argument("--devices", default=None, help=text.HELP_DEVICES)


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
