"""tracklint: check and repair audio files' tags.

The port of the reference's ``audiotools_tpu/cli/tracklint.py``: each
file's tags run through their ``clean`` (whitespace, leading zeroes,
empty fields, duplicate items and blocks, misordered seekpoints), one
line a fix found; ``--fix`` writes the cleaned tags, ``--db`` records
each repair in an undo database (``delta.UndoDB``) and ``--undo`` gives
back the files' old bytes from it.  Only the tags are read and written,
on the host; ``--devices`` names the device the files are opened on.

    python -m audiotools_tpu_torch.cli.tracklint --fix --db undo.db *.flac
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

from . import (Messenger, add_common_arguments, add_device_argument,
               first_device, text)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tracklint",
                                     description=text.DESC_TRACKLINT)
    add_common_arguments(parser)
    parser.add_argument("--fix", action="store_true", default=False,
                        help=text.HELP_LINT_FIX)
    parser.add_argument("--db", dest="db", default=None,
                        help=text.HELP_LINT_DB)
    parser.add_argument("--undo", action="store_true", default=False,
                        help=text.HELP_LINT_UNDO)
    add_device_argument(parser)
    parser.add_argument("filenames", nargs="+")

    options = parser.parse_args(argv)
    msg = Messenger(options)

    if options.undo and options.db is None:
        msg.error(text.ERR_UNDO_REQUIRES_DB)
        return 1

    from ..delta import UndoDB
    from ..dispatch import open_files

    undo_db = None if options.db is None else UndoDB(options.db)
    try:
        if options.undo:
            for filename in options.filenames:
                try:
                    restored = undo_db.undo(filename)
                except IOError as err:
                    msg.error(str(err))
                    return 1
                msg.info((text.LAB_RESTORED if restored else
                          text.LAB_NO_BACKUP) % {"filename": filename})
            return 0

        device = first_device(msg, options)
        if device is None:
            return 1
        for track in open_files(options.filenames, messenger=msg,
                                device=device):
            try:
                metadata = track.get_metadata()
            except (IOError, ValueError) as err:
                msg.error(text.ERR_FILE_MESSAGE %
                          {"filename": track.filename, "message": err})
                continue
            if metadata is None:
                continue
            (cleaned, fixes) = metadata.clean()
            if not fixes:
                continue
            for fix in fixes:
                msg.info(text.LAB_LINT_MESSAGE %
                         {"filename": track.filename, "message": fix})
            if not options.fix:
                continue
            if undo_db is None:
                track.set_metadata(cleaned)
            else:
                (handle, backup) = tempfile.mkstemp()
                os.close(handle)
                try:
                    shutil.copy2(track.filename, backup)
                    track.set_metadata(cleaned)
                    undo_db.add(backup, track.filename)
                finally:
                    os.unlink(backup)
            msg.info(text.LAB_FIXED % {"filename": track.filename})
        return 0
    finally:
        if undo_db is not None:
            undo_db.close()


if __name__ == "__main__":
    sys.exit(main())
