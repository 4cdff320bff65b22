"""trackcat: join audio files into one.

The port of the reference's ``audiotools_tpu/cli/trackcat.py``: the
sources (which must share their sample rate, channel count and bits
per sample) decoded one after another on the card (``pcm.PCMCat``) and
encoded as one file of ``-t``'s class there, the frame count passed
ahead; ``--cue`` then embeds a cue or TOC sheet's layout where the
class holds one (FLAC's CUESHEET block).  -I and -M exit 1
(``refuse_unported``).

    python -m audiotools_tpu_torch.cli.trackcat -t flac --cue album.cue \\
        -o album.flac track*.flac
"""

from __future__ import annotations

import argparse
import sys

from . import (Messenger, add_common_arguments, add_device_argument,
               add_unported_arguments, audiofile_type, default_type,
               first_device, refuse_unported, text)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="trackcat",
                                     description=text.DESC_TRACKCAT)
    add_common_arguments(parser)
    parser.add_argument("-t", "--type", dest="type", default=None,
                        help=text.HELP_TYPE)
    parser.add_argument("-q", "--quality", dest="quality", default="",
                        help=text.HELP_QUALITY)
    parser.add_argument("-o", "--output", dest="output", required=True,
                        help=text.HELP_CAT_OUTPUT)
    parser.add_argument("--cue", dest="cuesheet", default=None,
                        help=text.HELP_CUESHEET)
    add_unported_arguments(parser)
    add_device_argument(parser)
    parser.add_argument("filenames", nargs="+")

    options = parser.parse_args(argv)
    msg = Messenger(options)

    from ..audiofile import SheetException, read_sheet
    from ..dispatch import open_files
    from ..pcm import PCMCat

    if refuse_unported(msg, options):
        return 1
    device = first_device(msg, options)
    if device is None:
        return 1
    audiofiles = open_files(options.filenames, sorted=False, messenger=msg,
                            device=device)
    if len(audiofiles) == 0:
        msg.error(text.ERR_1_FILE_REQUIRED)
        return 1
    for (attr, error) in (("sample_rate", text.ERR_TRACKCAT_SAMPLE_RATES),
                          ("channels", text.ERR_TRACKCAT_CHANNELS),
                          ("bits_per_sample", text.ERR_TRACKCAT_BPS)):
        if len({getattr(f, attr)() for f in audiofiles}) != 1:
            msg.error(error)
            return 1

    if options.type is None:
        options.type = default_type()
    output_class = audiofile_type(msg, options.type)
    if output_class is None:
        return 1

    try:
        encoded = output_class.from_pcm(
            options.output, PCMCat([f.to_pcm() for f in audiofiles]),
            options.quality or None,
            total_pcm_frames=sum(f.total_frames() for f in audiofiles),
            device=device)
    except Exception as err:  # noqa: BLE001 - reported as the reference does
        msg.error(str(err))
        return 1

    if options.cuesheet is not None:
        try:
            encoded.set_cuesheet(read_sheet(options.cuesheet))
        except SheetException as err:
            msg.error(str(err))
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
