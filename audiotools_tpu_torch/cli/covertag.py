"""covertag: embed images in audio files.

The port of the reference's ``audiotools_tpu/cli/covertag.py``: the
front, back, leaflet, media and other images given added to each
file's tags (after its own are dropped with ``-r`` or
``--remove-images``), one line a file tagged.  Host only;
``--devices`` names the device the files are opened on.

    python -m audiotools_tpu_torch.cli.covertag --front-cover front.png *.flac
"""

from __future__ import annotations

import argparse
import sys

from . import (Messenger, add_common_arguments, add_device_argument,
               first_device, text)

IMAGE_TYPES = {"front": 0, "back": 1, "leaflet": 2, "media": 3, "other": 4}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="covertag",
                                     description=text.DESC_COVERTAG)
    add_common_arguments(parser)
    for (flag, dest, help_text) in (
            ("--front-cover", "front", text.HELP_TAG_FRONT_COVER),
            ("--back-cover", "back", text.HELP_TAG_BACK_COVER),
            ("--leaflet", "leaflet", text.HELP_TAG_LEAFLET),
            ("--media", "media", text.HELP_TAG_MEDIA_IMAGE),
            ("--other-image", "other", text.HELP_TAG_OTHER_IMAGE)):
        parser.add_argument(flag, action="append", dest=dest, default=[],
                            help=help_text)
    parser.add_argument("-r", "--replace", action="store_true",
                        default=False, dest="replace")
    parser.add_argument("--remove-images", action="store_true",
                        default=False, help=text.HELP_TAG_REMOVE_IMAGES)
    add_device_argument(parser)
    parser.add_argument("filenames", nargs="+")
    options = parser.parse_args(argv)
    msg = Messenger(options)

    from ..audiofile import Image, MetaData
    from ..dispatch import open_files

    device = first_device(msg, options)
    if device is None:
        return 1
    tracks = open_files(options.filenames, messenger=msg, device=device)
    if len(tracks) == 0:
        msg.error(text.ERR_1_FILE_REQUIRED)
        return 1

    new_images = []
    for kind in ("front", "back", "leaflet", "media", "other"):
        for path in getattr(options, kind):
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except IOError as err:
                msg.error(str(err))
                return 1
            new_images.append(Image.new(data, "", IMAGE_TYPES[kind]))

    for track in tracks:
        metadata = track.get_metadata()
        if metadata is None:
            metadata = MetaData()
        if options.remove_images or options.replace:
            for image in list(metadata.images()):
                metadata.delete_image(image)
        for image in new_images:
            metadata.add_image(image)
        try:
            track.set_metadata(metadata)
        except (IOError, ValueError) as err:
            msg.error(text.ERR_FILE_MESSAGE %
                      {"filename": track.filename, "message": err})
            return 1
        msg.info(text.LAB_TRACKTAG_TAGGED % {"filename": track.filename})
    return 0


if __name__ == "__main__":
    sys.exit(main())
