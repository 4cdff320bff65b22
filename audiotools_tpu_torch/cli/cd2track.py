"""cd2track: rip a CD image's tracks to files.

The port of the reference's ``audiotools_tpu/cli/cd2track.py``: each
track of a cue/bin, toc/bin or NRG image (``cdio.CDDA``) is read by a
``cdio.CDTrackReader`` (shifted by ``--offset``, a drive's read offset
in PCM frames) and encoded by ``-t``'s class (FLAC by default, as the
reference's, whatever type is configured) on its job's device, a job a
track in ``-j`` of the farm's worker threads over ``--devices``; a line
a track ripped, as it is done.  The disc's AccurateRip ID is reported
first.  -M looks the disc up in MusicBrainz and FreeDB
(``services.lookup.metadata_lookup``) and takes the first choice (-D
the default one, track numbers alone), which names and tags the files;
``--album-number`` and ``--album-total`` go into every track's tags;
``--replay-gain`` then analyses the rips as one album on the card.  On a
terminal each track being ripped has a progress row.  -I edits the
choices in ``ui``'s MetaDataFiller (match and fields) before any rip;
without urwid it exits 1 there, as the reference's does.

    python -m audiotools_tpu_torch.cli.cd2track -c disc.cue -t flac -q 8 \\
        -d rips
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

from . import (Messenger, add_common_arguments, add_interactive_argument,
               add_job_arguments, add_lookup_arguments, edit_metadata,
               job_devices, lookup_options, text, urwid_missing)

# one track's rip: the image, the track's number, the read offset, the
# output and its class and compression, and its tags
Rip = collections.namedtuple(
    "Rip", "cdrom number sample_offset dest_path dest_class compression "
    "metadata")


def rip_track(job, device, progress=None):
    """rips one track on ``device`` (the reference's ``_rip_track``) and
    returns its file's path; ``progress(current, total)`` after each
    read of the track"""
    from ..cdio import CDDA, CDTrackReader
    from ..pcm import PCMReaderProgress
    cdda = CDDA(job.cdrom)
    try:
        reader = CDTrackReader(cdda.cdda, job.number, job.sample_offset)
        if progress is not None:
            reader = PCMReaderProgress(reader, reader.__total_frames__,
                                       progress)
        track = job.dest_class.from_pcm(job.dest_path, reader,
                                        compression=job.compression,
                                        device=device)
        if job.metadata is not None:
            track.set_metadata(job.metadata)
    finally:
        cdda.close()
    return job.dest_path


def main(argv=None):
    parser = argparse.ArgumentParser(prog="cd2track",
                                     description=text.DESC_CD2TRACK)
    add_common_arguments(parser)
    parser.add_argument("-c", "--cdrom", dest="cdrom", required=True,
                        help=text.HELP_CDROM)
    parser.add_argument("-t", "--type", dest="type", default="flac",
                        help=text.HELP_TYPE)
    parser.add_argument("-q", "--quality", dest="quality", default="",
                        help=text.HELP_QUALITY)
    parser.add_argument("-d", "--dir", dest="dir", default=".",
                        help=text.HELP_DIR)
    parser.add_argument("--format", dest="format", default=None,
                        help=text.HELP_FORMAT)
    parser.add_argument("--offset", dest="sample_offset", type=int,
                        default=0, help=text.HELP_READ_OFFSET)
    add_job_arguments(parser)
    add_interactive_argument(parser)
    add_lookup_arguments(parser)
    parser.add_argument("-s", "--speed", dest="speed", type=int,
                        default=None, help=text.HELP_READ_SPEED)
    parser.add_argument("--album-number", type=int, dest="album_number",
                        default=None)
    parser.add_argument("--album-total", type=int, dest="album_total",
                        default=None)
    parser.add_argument("--replay-gain", action="store_true",
                        dest="add_replay_gain", default=False)
    parser.add_argument("--no-replay-gain", action="store_false",
                        dest="add_replay_gain")
    parser.add_argument("tracks", nargs="*", type=int,
                        help=text.HELP_CD_TRACKS)

    options = parser.parse_args(argv)
    msg = Messenger(options)

    from ..audiofile import (InvalidFilenameFormat, MetaData,
                             UnsupportedTracknameField)
    from ..cdio import CDDA
    from ..dispatch import TYPE_MAP
    from ..parallel.farm import run_jobs
    from ..services.lookup import metadata_lookup
    from ..utils.messenger import ProgressDisplay

    if options.type not in TYPE_MAP:
        msg.error(text.ERR_UNSUPPORTED_TYPE % {"type": options.type})
        return 1
    output_class = TYPE_MAP[options.type]
    quality = options.quality or None
    try:
        devices = job_devices(options.devices)
    except (RuntimeError, ValueError) as err:
        msg.error(str(err))
        return 1

    try:
        cdda = CDDA(options.cdrom)
    except (IOError, ValueError) as err:
        msg.error(str(err))
        return 1
    if options.speed is not None:
        cdda.cdda.set_speed(options.speed)

    track_numbers = options.tracks or list(range(1, len(cdda) + 1))
    for number in track_numbers:
        if not (1 <= number <= len(cdda)):
            msg.error(text.ERR_TRACK_NOT_FOUND % {"track": number})
            return 1

    msg.info(text.LAB_ACCURATERIP_DISC_ID %
             {"id": str(cdda.accuraterip_disc_id())})

    # the first choice wins (-D: the last, track numbers alone); without
    # -M that is the only choice, so -D alone changes nothing
    if options.metadata_lookup:
        choices = metadata_lookup(cdda, **lookup_options(options))
    else:
        choices = [[MetaData(track_number=i + 1, track_total=len(cdda))
                    for i in range(len(cdda))]]
    disc_metadata = choices[-1] if options.use_default else choices[0]
    if options.album_number is not None:
        for metadata in disc_metadata:
            metadata.album_number = options.album_number
    if options.album_total is not None:
        for metadata in disc_metadata:
            metadata.album_total = options.album_total
    if options.interactive:
        if urwid_missing(msg):
            return 1
        disc_metadata = edit_metadata(
            ["track %d" % (i + 1,) for i in range(len(cdda))], choices)
        if disc_metadata is None:
            return 0
    elif len(choices) > 1:
        msg.info(text.LAB_USING_METADATA %
                 {"album": disc_metadata[0].album_name or text.LAB_UNTITLED})

    os.makedirs(options.dir, exist_ok=True)
    jobs = []
    for number in track_numbers:
        try:
            track_metadata = disc_metadata[number - 1]
        except IndexError:
            track_metadata = MetaData(track_number=number,
                                      track_total=len(cdda))
        try:
            filename = output_class.track_name(
                file_path="track%2.2d" % (number,),
                track_metadata=track_metadata, format=options.format)
        except (UnsupportedTracknameField, InvalidFilenameFormat) as err:
            msg.error(str(err))
            return 1
        jobs.append(Rip(options.cdrom, number, options.sample_offset,
                        os.path.join(options.dir, filename), output_class,
                        quality, track_metadata))
    cdda.close()

    display = ProgressDisplay(msg)

    def done(index, _path, error):
        if error is None:
            display.output_line(text.LAB_RIPPED_TRACK %
                                {"track": jobs[index].number})

    outcomes = run_jobs(jobs, rip_track, workers=options.max_processes,
                        devices=devices, done=done, stop_on_error=True,
                        display=display,
                        label=lambda job: text.LAB_TRACK_PROGRESS %
                        {"track": job.number})
    errors = [error for (_path, error) in outcomes if error is not None]
    if errors:
        msg.error(str(errors[0]))
        return 1

    if options.add_replay_gain and output_class.supports_replay_gain() and \
            jobs:
        msg.info(text.RG_ADDING_REPLAYGAIN_WAIT)
        output_class.add_replay_gain([path for (path, _error) in outcomes],
                                     device=devices[0])
        msg.info(text.RG_REPLAYGAIN_ADDED)
    return 0


if __name__ == "__main__":
    sys.exit(main())
