"""trackinfo: display audio files' attributes and metadata.

The port of the reference's ``audiotools_tpu/cli/trackinfo.py``: a
line of each file's length and stream attributes, then its tags
(``-n`` leaves them out, ``-L`` shows the format's own items), or its
bitrate alone (``-b``) or its size as a share of its PCM's (``-%``);
``-C`` adds the channel assignment.  The files are opened on the
device ``--devices`` names (the current card by default), though
nothing is decoded.

    python -m audiotools_tpu_torch.cli.trackinfo -L track.flac
"""

from __future__ import annotations

import argparse
import os
import sys

from . import Messenger, add_common_arguments, job_devices, text


def main(argv=None):
    parser = argparse.ArgumentParser(prog="trackinfo",
                                     description=text.DESC_TRACKINFO)
    add_common_arguments(parser)
    parser.add_argument("-n", "--no-metadata", action="store_true",
                        dest="no_metadata", help=text.HELP_INFO_NO_METADATA)
    parser.add_argument("-L", "--low-level", action="store_true",
                        dest="low_level", help=text.HELP_INFO_LOW_LEVEL)
    parser.add_argument("-b", "--bitrate", action="store_true",
                        help=text.HELP_INFO_BITRATE)
    parser.add_argument("-%", "--percentage", action="store_true",
                        dest="percentage", help=text.HELP_INFO_PERCENTAGE)
    parser.add_argument("-C", "--channel-assignment", action="store_true",
                        dest="channel_assignment",
                        help=text.HELP_INFO_CHANNEL_ASSIGNMENT)
    parser.add_argument("--devices", default=None, help=text.HELP_DEVICES)
    parser.add_argument("filenames", nargs="+")

    options = parser.parse_args(argv)
    msg = Messenger(options)

    from .. import dispatch
    from ..audiofile import InvalidFile, UnsupportedFile
    from ..pcm import ChannelMask

    try:
        device = job_devices(options.devices)[0]
    except (RuntimeError, ValueError) as err:
        msg.error(str(err))
        return 1

    for filename in options.filenames:
        try:
            track = dispatch.open(filename, device=device)
        except (UnsupportedFile, InvalidFile, IOError) as err:
            msg.error(text.ERR_FILE_MESSAGE % {"filename": filename,
                                               "message": err})
            continue

        seconds = float(track.seconds_length())
        if options.bitrate:
            bitrate = ((os.path.getsize(filename) * 8) / (seconds * 1000)
                       if seconds else 0)
            msg.output(text.LAB_BITRATE_LINE % {"bitrate": int(bitrate),
                                                "filename": filename})
            continue
        if options.percentage:
            raw = (track.total_frames() * track.channels() *
                   track.bits_per_sample() // 8)
            percent = os.path.getsize(filename) * 100 // raw if raw else 0
            msg.output(text.LAB_PERCENTAGE_LINE % {"percent": percent,
                                                   "filename": filename})
            continue

        msg.output(text.LAB_INFO_ATTRIBS % {
            "filename": filename, "minutes": int(seconds) // 60,
            "seconds": int(seconds) % 60, "channels": track.channels(),
            "sample_rate": track.sample_rate(),
            "bits_per_sample": track.bits_per_sample(), "name": track.NAME})

        if not options.no_metadata:
            metadata = track.get_metadata()
            if metadata is not None:
                msg.output(metadata.raw_info() if options.low_level
                           else str(metadata))
            msg.output("")

        if options.channel_assignment:
            msg.output(text.LAB_INFO_CHANNELS)
            mask = ChannelMask(track.channel_mask())
            if mask.defined():
                for (i, channel) in enumerate(mask.channels()):
                    msg.output(text.LAB_INFO_CHANNEL % {
                        "channel": i + 1, "name": channel.replace("_", " ")})
            else:
                for i in range(track.channels()):
                    msg.output(text.LAB_INFO_CHANNEL_UNDEFINED %
                               {"channel": i + 1})
    return 0


if __name__ == "__main__":
    sys.exit(main())
