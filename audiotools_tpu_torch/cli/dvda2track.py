"""dvda2track: extract a DVD-Audio title's tracks to files.

The port of the reference's ``audiotools_tpu/cli/dvda2track.py``: -A
names the disc's AUDIO_TS directory, --titleset and --title the title
(1 and 1 by default).  The title's PCM or MLP stream is read on the host
by one ``dvda`` title reader, and each track, a consecutive window of
it, is encoded by ``-t``'s class (FLAC by default) on the card, through
its ``from_pcm``; a line a track extracted.  A title's tracks cannot be
read apart, so the title runs as one job in the farm's threads (``-j``
and ``--devices`` as in the other tools; the job takes the first
device).  -M looks the title up in MusicBrainz and FreeDB, its tracks'
lengths standing in for a CD's (``services.lookup.
lengths_metadata_lookup``), and takes the first choice (-D the default
one); ``--replay-gain`` then analyses the files as one album on the
card.  -c names a drive for CPPM's key exchange and is accepted and
unused, as in the reference: the exchange needs the drive's hardware
(``cppm.authenticate_drive``).  -I with -M chooses the lookup's match
with ``ui.select_metadata``; without urwid it exits 1 there, as the
reference's does.

    python -m audiotools_tpu_torch.cli.dvda2track -A /media/dvd/AUDIO_TS \\
        -t flac -q 8 -d rips
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

from . import (Messenger, add_common_arguments, add_job_arguments,
               add_interactive_argument, add_lookup_arguments,
               chosen_metadata, job_devices, lookup_options, text)

# a title's extraction: its reader, the output class and compression,
# and for each of its tracks (frames, output path or None to skip, tags)
Extraction = collections.namedtuple(
    "Extraction", "reader dest_class compression tracks extracted")


def extract_title(job, device):
    """encodes the chosen tracks of one title reader on ``device``, in
    order, skipping the frames of the others; returns the new files'
    paths"""
    from ..pcm import LimitedPCMReader
    written = []
    for (position, (frames, dest_path, metadata)) in enumerate(job.tracks,
                                                               1):
        if dest_path is None:
            remaining = frames
            while remaining > 0:
                framelist = job.reader.read(min(remaining, 65536))
                if framelist.frames == 0:
                    break
                remaining -= framelist.frames
            continue
        track = job.dest_class.from_pcm(
            dest_path, LimitedPCMReader(job.reader, frames),
            compression=job.compression, device=device)
        track.set_metadata(metadata)
        written.append(dest_path)
        job.extracted(position)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(prog="dvda2track",
                                     description=text.DESC_DVDA2TRACK)
    add_common_arguments(parser)
    parser.add_argument("-A", "--audio-ts", dest="audio_ts", required=True,
                        help=text.HELP_AUDIO_TS)
    parser.add_argument("--title", dest="title", type=int, default=1,
                        help=text.HELP_DVDA_TITLE)
    parser.add_argument("--titleset", dest="titleset", type=int, default=1)
    parser.add_argument("-t", "--type", dest="type", default="flac",
                        help=text.HELP_TYPE)
    parser.add_argument("-q", "--quality", dest="quality", default="",
                        help=text.HELP_QUALITY)
    parser.add_argument("-d", "--dir", dest="dir", default=".",
                        help=text.HELP_DIR)
    parser.add_argument("--format", dest="format", default=None,
                        help=text.HELP_FORMAT)
    parser.add_argument("-c", "--cdrom", dest="cdrom", default=None)
    parser.add_argument("--track-start", dest="track_start", type=int,
                        default=1)
    parser.add_argument("--track-total", dest="track_total", type=int,
                        default=None)
    parser.add_argument("--album-number", type=int, dest="album_number",
                        default=None)
    parser.add_argument("--album-total", type=int, dest="album_total",
                        default=None)
    parser.add_argument("--replay-gain", action="store_true",
                        dest="add_replay_gain", default=False)
    parser.add_argument("--no-replay-gain", action="store_false",
                        dest="add_replay_gain")
    add_job_arguments(parser)
    add_interactive_argument(parser)
    add_lookup_arguments(parser)
    parser.add_argument("tracks", nargs="*", type=int)
    options = parser.parse_args(argv)
    msg = Messenger(options)

    from ..audiofile import MetaData
    from ..dispatch import TYPE_MAP
    from ..dvda import DVDAudio, InvalidDVDA
    from ..parallel.farm import run_jobs
    from ..pcm import BufferedPCMReader
    from ..services.lookup import lengths_metadata_lookup

    if options.type not in TYPE_MAP:
        msg.error(text.ERR_UNSUPPORTED_TYPE % {"type": options.type})
        return 1
    output_class = TYPE_MAP[options.type]
    try:
        devices = job_devices(options.devices)
    except (RuntimeError, ValueError) as err:
        msg.error(str(err))
        return 1

    try:
        title = DVDAudio(options.audio_ts)[options.titleset - 1][
            options.title - 1]
    except (IOError, IndexError, InvalidDVDA) as err:
        msg.error(str(err))
        return 1

    track_numbers = options.tracks or list(range(1, len(title) + 1))
    os.makedirs(options.dir, exist_ok=True)

    # -M: the title's tracks, in CD frames, stand in for a CD's
    lookup_metadatas = None
    if options.metadata_lookup:
        track_frames = [(t.total_frames() * 75) // title.sample_rate
                        for t in title.tracks]
        choices = lengths_metadata_lookup(track_frames,
                                          **lookup_options(options))
        lookup_metadatas = chosen_metadata(msg, options, choices)
        if lookup_metadatas is None:
            return 1

    try:
        reader = BufferedPCMReader(title.to_pcm())
    except ValueError as err:
        msg.error(str(err))
        return 1

    tracks = []
    for (position, track) in enumerate(title.tracks, 1):
        if position not in track_numbers:
            tracks.append((track.total_frames(), None, None))
            continue
        track_number = position + options.track_start - 1
        track_total = options.track_total or len(title)
        if (lookup_metadatas is not None and
                position - 1 < len(lookup_metadatas)):
            metadata = lookup_metadatas[position - 1]
            metadata.track_number = track_number
            metadata.track_total = track_total
        else:
            metadata = MetaData(track_number=track_number,
                                track_total=track_total)
        if options.album_number is not None:
            metadata.album_number = options.album_number
        if options.album_total is not None:
            metadata.album_total = options.album_total
        filename = os.path.join(options.dir, output_class.track_name(
            file_path="track%2.2d" % (position,), track_metadata=metadata,
            format=options.format))
        tracks.append((track.total_frames(), filename, metadata))

    def extracted(position):
        msg.info(text.LAB_DVDA_EXTRACTED % {"track": position})

    job = Extraction(reader, output_class, options.quality or None, tracks,
                     extracted)
    try:
        [(written, error)] = run_jobs([job], extract_title,
                                      workers=options.max_processes,
                                      devices=devices[:1])
    finally:
        reader.close()
    if error is not None:
        msg.error(str(error))
        return 1

    if options.add_replay_gain and output_class.supports_replay_gain() and \
            written:
        msg.info(text.RG_ADDING_REPLAYGAIN_WAIT)
        output_class.add_replay_gain(written, device=devices[0])
        msg.info(text.RG_REPLAYGAIN_ADDED)
    return 0


if __name__ == "__main__":
    sys.exit(main())
