"""tracktag: update audio files' tags.

The port of the reference's ``audiotools_tpu/cli/tracktag.py``: a flag
for each of the 18 fields and a ``--remove-`` flag for each, ``-r``
(the given fields alone replace the tags), ``--comment-file``,
``--remove-images`` and ``--front-cover``, then ``--replay-gain``: the
files of each class that holds ReplayGain (FLAC, WavPack) analysed as
one album on the card (``add_replay_gain(..., device=)``, the first of
``--devices``) and the values written into their tags.  -M first takes
the files as one CD, looks it up in MusicBrainz and FreeDB
(``services.lookup.track_metadata_lookup``) and writes the first
choice's entries (-D the default one's) into them, each file's own
fields filling the entry's blanks; the command line's fields then go
over those.  -I (after -M's writes, as in the reference) edits every
file's tags, seeded with the command line's fields, in ``ui``'s
MetaDataFiller and writes them, a line a file; without urwid it exits 1
there.

    python -m audiotools_tpu_torch.cli.tracktag --album "An Album" \\
        --replay-gain *.flac
"""

from __future__ import annotations

import argparse
import sys

from . import (Messenger, add_common_arguments, add_interactive_argument,
               add_job_arguments, add_lookup_arguments, edit_metadata,
               first_device, lookup_options, text, urwid_missing)

FIELD_OPTIONS = [
    ("--name", "track_name", text.HELP_TAG_NAME),
    ("--artist", "artist_name", text.HELP_TAG_ARTIST),
    ("--performer", "performer_name", text.HELP_TAG_PERFORMER),
    ("--composer", "composer_name", text.HELP_TAG_COMPOSER),
    ("--conductor", "conductor_name", text.HELP_TAG_CONDUCTOR),
    ("--album", "album_name", text.HELP_TAG_ALBUM),
    ("--catalog", "catalog", text.HELP_TAG_CATALOG),
    ("--number", "track_number", text.HELP_TAG_NUMBER),
    ("--track-total", "track_total", text.HELP_TAG_TRACK_TOTAL),
    ("--album-number", "album_number", text.HELP_TAG_ALBUM_NUMBER),
    ("--album-total", "album_total", text.HELP_TAG_ALBUM_TOTAL),
    ("--ISRC", "ISRC", text.HELP_TAG_ISRC),
    ("--publisher", "publisher", text.HELP_TAG_PUBLISHER),
    ("--media-type", "media", text.HELP_TAG_MEDIA),
    ("--year", "year", text.HELP_TAG_YEAR),
    ("--date", "date", text.HELP_TAG_DATE),
    ("--copyright", "copyright", text.HELP_TAG_COPYRIGHT),
    ("--comment", "comment", text.HELP_TAG_COMMENT),
]

INTEGER_FIELDS = ("track_number", "track_total", "album_number",
                  "album_total")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tracktag",
                                     description=text.DESC_TRACKTAG)
    add_common_arguments(parser)
    for (flag, field, help_text) in FIELD_OPTIONS:
        parser.add_argument(flag, dest=field, default=None, help=help_text)
    parser.add_argument("-r", "--replace", action="store_true",
                        default=False, help=text.HELP_TAG_REMOVE)
    parser.add_argument("--remove-images", action="store_true",
                        default=False, help=text.HELP_TAG_REMOVE_IMAGES)
    parser.add_argument("--front-cover", dest="front_cover", default=None,
                        help=text.HELP_TAG_FRONT_COVER)
    parser.add_argument("--replay-gain", action="store_true",
                        dest="add_replay_gain", default=False,
                        help=text.HELP_REPLAY_GAIN)
    parser.add_argument("--comment-file", dest="comment_file",
                        default=None, help=text.HELP_TAG_COMMENT_FILE)
    for (flag, field, _help) in FIELD_OPTIONS:
        parser.add_argument("--remove-" + flag[2:], dest="remove_" + field,
                            action="store_true", default=False)
    add_job_arguments(parser)
    add_interactive_argument(parser)
    add_lookup_arguments(parser)
    parser.add_argument("filenames", nargs="+")

    options = parser.parse_args(argv)
    msg = Messenger(options)

    from ..audiofile import Image, MetaData
    from ..dispatch import open_files

    updates = {}
    for (_flag, field, _help) in FIELD_OPTIONS:
        value = getattr(options, field)
        if value is None:
            continue
        if field in INTEGER_FIELDS:
            try:
                value = int(value)
            except ValueError:
                msg.error(text.ERR_INVALID_FIELD_VALUE % {"field": field})
                return 1
        updates[field] = value
    removals = [field for (_flag, field, _help) in FIELD_OPTIONS
                if getattr(options, "remove_" + field)]

    if options.comment_file is not None:
        try:
            with open(options.comment_file, "rb") as f:
                comment_bytes = f.read()
        except IOError:
            msg.error(text.ERR_TRACKTAG_COMMENT_IOERROR %
                      {"filename": options.comment_file})
            return 1
        try:
            updates["comment"] = comment_bytes.decode("utf-8")
        except UnicodeDecodeError:
            msg.error(text.ERR_TRACKTAG_COMMENT_NOT_UTF8 %
                      {"filename": options.comment_file})
            return 1

    device = first_device(msg, options)
    if device is None:
        return 1
    audiofiles = open_files(options.filenames, sorted=False, messenger=msg,
                            device=device)
    if len(audiofiles) == 0:
        msg.error(text.ERR_1_FILE_REQUIRED)
        return 1

    # the looked-up entries, each file's own fields filling their blanks,
    # written before the command line's fields
    if options.metadata_lookup:
        from ..dispatch import sorted_tracks
        from ..services.lookup import track_metadata_lookup
        choices = track_metadata_lookup(audiofiles, **lookup_options(options))
        chosen = choices[-1] if options.use_default else choices[0]
        for (track, looked_up) in zip(sorted_tracks(audiofiles), chosen):
            existing = track.get_metadata()
            if existing is not None:
                for field in existing.FIELDS:
                    if getattr(looked_up, field) is None:
                        setattr(looked_up, field, getattr(existing, field))
            track.set_metadata(looked_up)

    if options.interactive:
        if urwid_missing(msg):
            return 1
        seeded = []
        for track in audiofiles:
            metadata = track.get_metadata()
            if metadata is None:
                metadata = MetaData()
            for (field, value) in updates.items():
                setattr(metadata, field, value)
            seeded.append(metadata)
        edited = edit_metadata([str(t.filename) for t in audiofiles],
                               [seeded])
        if edited is None:
            return 0
        for (track, metadata) in zip(audiofiles, edited):
            try:
                track.set_metadata(metadata)
                msg.info(text.LAB_TRACKTAG_TAGGED %
                         {"filename": track.filename})
            except (IOError, ValueError) as err:
                msg.error(text.ERR_FILE_MESSAGE %
                          {"filename": track.filename, "message": err})
                return 1
        return 0

    for track in audiofiles:
        try:
            if options.replace:
                metadata = MetaData(**updates)
            else:
                metadata = track.get_metadata()
                if metadata is None:
                    metadata = MetaData()
                for field in removals:
                    delattr(metadata, field)
                for (field, value) in updates.items():
                    setattr(metadata, field, value)
            if options.remove_images:
                for image in metadata.images():
                    metadata.delete_image(image)
            if options.front_cover is not None:
                with open(options.front_cover, "rb") as f:
                    metadata.add_image(Image.new(f.read(), "", 0))
            track.set_metadata(metadata)
        except (IOError, ValueError) as err:
            msg.error(text.ERR_FILE_MESSAGE %
                      {"filename": track.filename, "message": err})
            return 1

    if options.add_replay_gain:
        classes = sorted({type(f) for f in audiofiles
                          if f.supports_replay_gain()},
                         key=lambda cls: cls.NAME)
        if classes:
            msg.info(text.RG_ADDING_REPLAYGAIN_WAIT)
            for cls in classes:
                cls.add_replay_gain([f.filename for f in audiofiles
                                     if type(f) is cls], device=device)
            msg.info(text.RG_REPLAYGAIN_ADDED)
    return 0


if __name__ == "__main__":
    sys.exit(main())
