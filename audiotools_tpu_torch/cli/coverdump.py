"""coverdump: write audio files' embedded images to image files.

The port of the reference's ``audiotools_tpu/cli/coverdump.py``: each
image of each file (in the reference's track order) written to ``-d``
as ``<prefix><basename>-<type>NN.<suffix>``, one line a file written;
exit 1 when no file held an image.  Host only; ``--devices`` names the
device the files are opened on.

    python -m audiotools_tpu_torch.cli.coverdump -d covers *.flac
"""

from __future__ import annotations

import argparse
import os
import sys

from . import (Messenger, add_common_arguments, add_device_argument,
               first_device, text)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="coverdump",
                                     description=text.DESC_COVERDUMP)
    add_common_arguments(parser)
    parser.add_argument("-d", "--dir", dest="dir", default=".",
                        help=text.HELP_DIR)
    parser.add_argument("-p", "--prefix", dest="prefix", default="",
                        help=text.HELP_COVERDUMP_PREFIX)
    add_device_argument(parser)
    parser.add_argument("filenames", nargs="+")
    options = parser.parse_args(argv)
    msg = Messenger(options)

    from ..dispatch import open_files

    device = first_device(msg, options)
    if device is None:
        return 1
    tracks = open_files(options.filenames, messenger=msg, device=device)
    if len(tracks) == 0:
        msg.error(text.ERR_1_FILE_REQUIRED)
        return 1

    os.makedirs(options.dir, exist_ok=True)
    dumped = 0
    for track in tracks:
        metadata = track.get_metadata()
        if metadata is None:
            continue
        base = os.path.splitext(os.path.basename(track.filename))[0]
        for (i, image) in enumerate(metadata.images()):
            output = os.path.join(options.dir, "%s%s-%s%2.2d.%s" % (
                options.prefix, base,
                image.type_string().replace(" ", "_").lower(), i,
                image.suffix()))
            with open(output, "wb") as f:
                f.write(image.data)
            msg.info(text.LAB_DUMPED_IMAGE % {"output": output})
            dumped += 1
    if dumped == 0:
        msg.error(text.ERR_NO_IMAGES_PLAIN)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
