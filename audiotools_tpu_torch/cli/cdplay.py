"""cdplay: play a CD image's tracks.

The port of the reference's ``audiotools_tpu/cli/cdplay.py``: the
tracks named (all by default) of a cue/bin, toc/bin or NRG image
(``cdio.CDDA``) played in turn through ``player.CDPlayer`` to the
output ``-o`` names.  A CD track's PCM is read from the image on the
host: no device work.

    python -m audiotools_tpu_torch.cli.cdplay -o NULL -c disc.cue
"""

from __future__ import annotations

import argparse
import sys

from . import Messenger, add_common_arguments, text
from .trackplay import _play_through


def main(argv=None):
    parser = argparse.ArgumentParser(prog="cdplay",
                                     description=text.DESC_CDPLAY)
    add_common_arguments(parser)
    parser.add_argument("-c", "--cdrom", dest="cdrom", required=True,
                        help=text.HELP_CDROM)
    parser.add_argument("-o", "--output", dest="output", default=None,
                        help=text.HELP_PLAY_OUTPUT)
    parser.add_argument("tracks", nargs="*", type=int)
    options = parser.parse_args(argv)
    msg = Messenger(options)

    from ..cdio import CDDA
    from ..player import CDPlayer, open_output

    try:
        cdda = CDDA(options.cdrom)
        output = open_output(options.output)
    except (IOError, ValueError) as err:
        msg.error(str(err))
        return 1

    player = CDPlayer(cdda, output)
    try:
        for number in (options.tracks or range(1, len(cdda) + 1)):
            msg.info(text.LAB_CDPLAY_TRACK % {"track": number})
            _play_through(player, number)
    except KeyboardInterrupt:
        msg.info(text.LAB_STOPPED)
    finally:
        player.close()
        cdda.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
