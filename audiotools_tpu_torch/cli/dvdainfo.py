"""dvdainfo: display a DVD-Audio disc's titlesets, titles and tracks.

The port of the reference's ``audiotools_tpu/cli/dvdainfo.py``: -A
names the disc's AUDIO_TS directory, parsed by ``dvda.DVDAudio``; a
line a titleset, a line a title (its tracks, length, rate, channels,
bits and stream type) and a line a track (its sectors and seconds).
It reads the IFO files and each title's first sector on the host.

    python -m audiotools_tpu_torch.cli.dvdainfo -A /media/dvd/AUDIO_TS
"""

from __future__ import annotations

import argparse
import sys

from . import Messenger, add_common_arguments, text


def main(argv=None):
    parser = argparse.ArgumentParser(prog="dvdainfo",
                                     description=text.DESC_DVDAINFO)
    add_common_arguments(parser)
    parser.add_argument("-A", "--audio-ts", dest="audio_ts", required=True,
                        help=text.HELP_AUDIO_TS)
    options = parser.parse_args(argv)
    msg = Messenger(options)

    from ..dvda import PTS_PER_SECOND, DVDAudio, InvalidDVDA

    try:
        dvda = DVDAudio(options.audio_ts)
    except (IOError, InvalidDVDA) as err:
        msg.error(str(err))
        return 1

    for (t, titles) in enumerate(dvda.titlesets, 1):
        msg.output(text.LAB_DVDA_TITLESET % {"titleset": t})
        for title in titles:
            stream = {0xA0: "PCM", 0xA1: "MLP"}.get(title.stream_id,
                                                    "unknown")
            seconds = title.pts_length // PTS_PER_SECOND
            msg.output("  Title %d: %d track(s), %d:%2.2d, %dHz %dch "
                       "%d-bit %s" %
                       (title.title, len(title), seconds // 60, seconds % 60,
                        title.sample_rate, title.channels,
                        title.bits_per_sample, stream))
            for track in title.tracks:
                msg.output("    Track %d: sectors %d-%d, %.1fs" %
                           (track.track, track.first_sector,
                            track.last_sector,
                            track.pts_length / PTS_PER_SECOND))
    return 0


if __name__ == "__main__":
    sys.exit(main())
