"""coverview: show an audio file's embedded cover art.

The port of the reference's ``audiotools_tpu/cli/coverview.py``: the
first image in a Tk window where ``DISPLAY`` is set and ``tkinter``
imports, else (or when the window cannot open, after a line saying why)
a line an image: its index, type, size in pixels, MIME type and bytes.
Exit 1 when the file holds no image.  Host only; ``--devices`` names
the device the file is opened on.

    python -m audiotools_tpu_torch.cli.coverview a.flac
"""

from __future__ import annotations

import argparse
import os
import sys

from . import (Messenger, add_common_arguments, add_device_argument,
               first_device, text)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="coverview",
                                     description=text.DESC_COVERVIEW)
    add_common_arguments(parser)
    add_device_argument(parser)
    parser.add_argument("filename")
    options = parser.parse_args(argv)
    msg = Messenger(options)

    from ..dispatch import open as open_track

    device = first_device(msg, options)
    if device is None:
        return 1
    try:
        track = open_track(options.filename, device=device)
    except (IOError, ValueError) as err:
        msg.error(str(err))
        return 1
    metadata = track.get_metadata()
    images = metadata.images() if metadata is not None else []
    if not images:
        msg.error(text.ERR_NO_IMAGES % {"filename": options.filename})
        return 1

    if os.environ.get("DISPLAY"):
        try:
            import tkinter
            root = tkinter.Tk()
            root.title(options.filename)
            photo = tkinter.PhotoImage(data=images[0].data)
            tkinter.Label(root, image=photo).pack()
            root.mainloop()
            return 0
        except Exception as err:
            msg.info(text.LAB_VIEWER_UNAVAILABLE % {"error": err})

    for (i, image) in enumerate(images):
        msg.output(text.LAB_COVER_LINE %
                   {"index": i, "type": image.type_string(),
                    "width": image.width, "height": image.height,
                    "mime": image.mime_type, "size": len(image.data)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
