"""cdinfo: show a CD image's table of contents.

The port of the reference's ``audiotools_tpu/cli/cdinfo.py``: the
track count and length, the FreeDB, MusicBrainz and AccurateRip disc
IDs, and each track's offset and length in sectors and its seconds, of
a cue/bin, toc/bin or NRG image (``cdio.CDDA``).  No device work.

    python -m audiotools_tpu_torch.cli.cdinfo -c disc.cue
"""

from __future__ import annotations

import argparse
import sys

from . import Messenger, add_common_arguments, text


def main(argv=None):
    parser = argparse.ArgumentParser(prog="cdinfo",
                                     description=text.DESC_CDINFO)
    add_common_arguments(parser)
    parser.add_argument("-c", "--cdrom", dest="cdrom", required=True,
                        help=text.HELP_CDROM)
    options = parser.parse_args(argv)
    msg = Messenger(options)

    from ..cdio import CDDA

    try:
        cdda = CDDA(options.cdrom)
    except (IOError, ValueError) as err:
        msg.error(str(err))
        return 1

    msg.output(text.LAB_CDINFO_TRACKS % {"count": len(cdda)})
    msg.output(text.LAB_CDINFO_LENGTH %
               {"minutes": cdda.length_in_seconds() // 60,
                "seconds": cdda.length_in_seconds() % 60})
    msg.output(text.LAB_CDINFO_FREEDB % {"id": cdda.freedb_disc_id()})
    msg.output(text.LAB_CDINFO_MUSICBRAINZ %
               {"id": cdda.musicbrainz_disc_id()})
    msg.output(text.LAB_CDINFO_ACCURATERIP %
               {"id": cdda.accuraterip_disc_id()})
    msg.output("")
    msg.output(text.LAB_CDINFO_HEADER)
    for (i, (offset, length)) in enumerate(cdda.track_offsets(), 1):
        msg.output("%2.2d %8d %8d %7.7s" %
                   (i, offset, length, "%.1f" % (length / 75.0,)))
    cdda.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
