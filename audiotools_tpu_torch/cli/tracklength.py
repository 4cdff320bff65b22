"""tracklength: display the total length of audio files.

The port of the reference's ``audiotools_tpu/cli/tracklength.py``: the
files named, and those under the directories named (searched
recursively), summed as hours:minutes:seconds.  The files are opened
on the device ``--devices`` names (the current card by default),
though nothing is decoded.

    python -m audiotools_tpu_torch.cli.tracklength album/
"""

from __future__ import annotations

import argparse
import os
import sys

from . import Messenger, add_common_arguments, job_devices, text


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tracklength",
                                     description=text.DESC_TRACKLENGTH)
    add_common_arguments(parser)
    parser.add_argument("--devices", default=None, help=text.HELP_DEVICES)
    parser.add_argument("filenames", nargs="+")

    options = parser.parse_args(argv)
    msg = Messenger(options)

    from ..dispatch import open_directory, open_files

    try:
        device = job_devices(options.devices)[0]
    except (RuntimeError, ValueError) as err:
        msg.error(str(err))
        return 1

    audiofiles = []
    for path in options.filenames:
        if os.path.isdir(path):
            audiofiles.extend(open_directory(path, messenger=msg,
                                             device=device))
        else:
            audiofiles.extend(open_files([path], messenger=msg,
                                         device=device))

    total_seconds = sum(float(f.seconds_length()) for f in audiofiles)
    msg.output(text.LAB_TRACKLENGTH_TOTAL % {
        "hours": int(total_seconds) // 3600,
        "minutes": (int(total_seconds) // 60) % 60,
        "seconds": int(round(total_seconds)) % 60})
    return 0


if __name__ == "__main__":
    sys.exit(main())
