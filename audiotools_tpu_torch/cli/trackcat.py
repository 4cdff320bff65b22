"""trackcat: join audio files into one.

The port of the reference's ``audiotools_tpu/cli/trackcat.py``: the
sources (which must share their sample rate, channel count and bits
per sample) decoded one after another on the card (``pcm.PCMCat``) and
encoded as one file of ``-t``'s class there, the frame count passed
ahead; ``--cue`` then embeds a cue or TOC sheet's layout where the
class holds one (FLAC's CUESHEET block).  -M takes the sources as one
CD, looks it up in MusicBrainz and FreeDB
(``services.lookup.track_metadata_lookup``) and tags the new file with
the first choice's album, artist and year and its track count (-D the
default choice's).  On a terminal one progress row is drawn while it
encodes (``utils.messenger.SingleProgressDisplay``).  -I with -M
chooses the lookup's match with ``ui.select_metadata`` (urwid's editor,
or a prompt on stdin), after the file is written, as the reference's
does; without urwid it exits 1 there.

    python -m audiotools_tpu_torch.cli.trackcat -t flac --cue album.cue \\
        -o album.flac track*.flac
"""

from __future__ import annotations

import argparse
import sys

from . import (Messenger, add_common_arguments, add_device_argument,
               add_interactive_argument, add_lookup_arguments,
               audiofile_type, chosen_metadata, default_type, first_device,
               lookup_options, text)


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
    add_interactive_argument(parser)
    add_lookup_arguments(parser)
    add_device_argument(parser)
    parser.add_argument("filenames", nargs="+")

    options = parser.parse_args(argv)
    msg = Messenger(options)

    from ..audiofile import SheetException, read_sheet
    from ..dispatch import open_files
    from ..pcm import PCMCat, PCMReaderProgress
    from ..utils.messenger import SingleProgressDisplay

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

    total_frames = sum(f.total_frames() for f in audiofiles)
    progress = SingleProgressDisplay(msg, options.output)
    try:
        encoded = output_class.from_pcm(
            options.output, PCMReaderProgress(
                PCMCat([f.to_pcm() for f in audiofiles]), total_frames,
                progress.update),
            options.quality or None, total_pcm_frames=total_frames,
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

    # the album's fields of the chosen entry, the sources taken as one CD
    if options.metadata_lookup:
        from ..audiofile import MetaData
        from ..services.lookup import track_metadata_lookup
        choices = track_metadata_lookup(audiofiles, **lookup_options(options))
        chosen = chosen_metadata(msg, options, choices)
        if chosen is None:
            return 1
        if chosen:
            first = chosen[0]
            encoded.set_metadata(MetaData(album_name=first.album_name,
                                          artist_name=first.artist_name,
                                          year=first.year,
                                          track_total=len(chosen)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
