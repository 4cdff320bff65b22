"""trackrename: rename audio files from their tags.

The port of the reference's ``audiotools_tpu/cli/trackrename.py``: each
file renamed in its directory to ``--format`` (the configured
``[Filenames] format`` by default) filled from its tags, one line a
rename; an existing target or a template that does not format ends
the run with exit 1 and an error line (where the reference's raises).  Host only;
``--devices`` names the device the files are opened on.  -I asks
``<source> -> <destination> ? [y/N]`` on stdin before each rename and
renames only on y or yes, as the reference's does.

    python -m audiotools_tpu_torch.cli.trackrename *.flac
"""

from __future__ import annotations

import argparse
import os
import sys

from . import (Messenger, add_common_arguments, add_device_argument,
               add_interactive_argument, first_device, text)


def main(argv=None):
    from ..audiofile import FILENAME_FORMAT

    parser = argparse.ArgumentParser(prog="trackrename",
                                     description=text.DESC_TRACKRENAME)
    add_common_arguments(parser)
    parser.add_argument("--format", dest="format", default=FILENAME_FORMAT,
                        help=text.HELP_FORMAT)
    add_interactive_argument(parser)
    add_device_argument(parser)
    parser.add_argument("filenames", nargs="+")

    options = parser.parse_args(argv)
    msg = Messenger(options)

    from ..audiofile import InvalidFilenameFormat, UnsupportedTracknameField
    from ..dispatch import open_files

    device = first_device(msg, options)
    if device is None:
        return 1
    audiofiles = open_files(options.filenames, sorted=False, messenger=msg,
                            device=device)
    if len(audiofiles) == 0:
        msg.error(text.ERR_1_FILE_REQUIRED)
        return 1

    for track in audiofiles:
        try:
            new_name = track.track_name(track.filename, track.get_metadata(),
                                        options.format)
            new_path = os.path.join(os.path.dirname(track.filename),
                                    new_name)
            if os.path.abspath(new_path) == os.path.abspath(track.filename):
                continue
            if os.path.exists(new_path):
                msg.error(text.ERR_TRACKRENAME_COLLISION %
                          {"source": new_path})
                return 1
            if options.interactive:
                answer = input("%s -> %s ? [y/N] " %
                               (track.filename, new_path))
                if answer.strip().lower() not in ("y", "yes"):
                    continue
            os.rename(track.filename, new_path)
            msg.output(text.LAB_TRACKRENAME_RENAMED %
                       {"source": track.filename, "destination": new_path})
        except (IOError, ValueError) as err:
            msg.error(text.ERR_FILE_MESSAGE %
                      {"filename": track.filename, "message": err})
            return 1
        except (UnsupportedTracknameField, InvalidFilenameFormat) as err:
            msg.error(str(err))
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
