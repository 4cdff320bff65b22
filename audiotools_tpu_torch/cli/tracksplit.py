"""tracksplit: split one audio file into tracks by its cue sheet.

The port of the reference's ``audiotools_tpu/cli/tracksplit.py``: the
file's embedded layout (FLAC's CUESHEET block) or ``--cue``'s sheet
gives each track's length (``pcm_lengths``); the file is decoded once
on the card and cut there (``pcm.pcm_split``), and each track encoded
as ``-t``'s class in ``-j`` of the farm's worker threads over
``--devices``, named by ``--format`` (the configured template by
default) from its number, the track total and the source's album,
artist and year, which it is tagged with; -M looks the sheet's layout
up in MusicBrainz and FreeDB (``services.lookup.sheet_metadata_lookup``)
and tags each track with the first choice's entry in their place (-D
the default choice's); ``--replay-gain`` then analyses the tracks as
one album on the card.  A line a track written, as it is done.  -I
with -M chooses the lookup's match with ``ui.select_metadata``; without
urwid it exits 1 there, before any track is written, as the reference's
does.

    python -m audiotools_tpu_torch.cli.tracksplit -t flac -d tracks album.flac
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import threading

from . import (Messenger, add_common_arguments, add_job_arguments,
               add_interactive_argument, add_lookup_arguments,
               audiofile_type, chosen_metadata, default_type, job_devices,
               lookup_options, text)

# one track: its index in the sheet, its file and frame count, its tags
Track = collections.namedtuple("Track", "index dest_path frames metadata")


class SplitReaders:
    """the readers of ``pcm.pcm_split``, handed out by index to the
    worker threads: the split is read in order under a lock, each
    reader kept only until it is taken"""

    def __init__(self, pcmreader, pcm_lengths):
        from ..pcm import pcm_split
        self.readers = pcm_split(pcmreader, pcm_lengths)
        self.ready = {}
        self.produced = 0
        self.lock = threading.Lock()

    def take(self, index):
        with self.lock:
            while self.produced <= index:
                self.ready[self.produced] = next(self.readers)
                self.produced += 1
            return self.ready.pop(index)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tracksplit",
                                     description=text.DESC_TRACKSPLIT)
    add_common_arguments(parser)
    parser.add_argument("-t", "--type", dest="type", default=None,
                        help=text.HELP_TYPE)
    parser.add_argument("-q", "--quality", dest="quality", default="",
                        help=text.HELP_QUALITY)
    parser.add_argument("-d", "--dir", dest="dir", default=".",
                        help=text.HELP_DIR)
    parser.add_argument("--format", dest="format", default=None,
                        help=text.HELP_FORMAT)
    parser.add_argument("--cue", dest="cuesheet", default=None,
                        help=text.HELP_CUESHEET)
    add_job_arguments(parser)
    parser.add_argument("--album-number", type=int, dest="album_number",
                        default=None)
    parser.add_argument("--album-total", type=int, dest="album_total",
                        default=None)
    parser.add_argument("--replay-gain", action="store_true",
                        dest="add_replay_gain", default=False,
                        help=text.HELP_REPLAY_GAIN)
    parser.add_argument("--no-replay-gain", action="store_false",
                        dest="add_replay_gain", help=text.HELP_NO_REPLAY_GAIN)
    add_interactive_argument(parser)
    add_lookup_arguments(parser)
    parser.add_argument("filename", nargs=1)

    options = parser.parse_args(argv)
    msg = Messenger(options)

    from .. import dispatch
    from ..audiofile import (FILENAME_FORMAT, InvalidFilenameFormat,
                             MetaData, SheetException,
                             UnsupportedTracknameField, read_sheet)
    from ..parallel.farm import run_jobs

    try:
        devices = job_devices(options.devices)
    except (RuntimeError, ValueError) as err:
        msg.error(str(err))
        return 1
    try:
        track = dispatch.open(options.filename[0], device=devices[0])
    except Exception as err:  # noqa: BLE001 - reported as the reference does
        msg.error(str(err))
        return 1

    if options.cuesheet is not None:
        try:
            sheet = read_sheet(options.cuesheet)
        except SheetException as err:
            msg.error(str(err))
            return 1
    else:
        sheet = track.get_cuesheet()
        if sheet is None:
            msg.error(text.ERR_TRACKSPLIT_NO_CUESHEET)
            return 1

    if options.type is None:
        options.type = default_type()
    output_class = audiofile_type(msg, options.type)
    if output_class is None:
        return 1

    pcm_lengths = list(sheet.pcm_lengths(track.total_frames(),
                                         track.sample_rate()))
    base_metadata = track.get_metadata()

    # each track's entry of the chosen lookup, the sheet's layout taken
    # as the disc's
    lookup_metadatas = None
    if options.metadata_lookup:
        from ..services.lookup import sheet_metadata_lookup
        choices = sheet_metadata_lookup(sheet, track.total_frames(),
                                        track.sample_rate(),
                                        **lookup_options(options))
        lookup_metadatas = chosen_metadata(msg, options, choices)
        if lookup_metadatas is None:
            return 1

    os.makedirs(options.dir, exist_ok=True)
    tracks = []
    for (i, frames) in enumerate(pcm_lengths):
        if lookup_metadatas is not None and i < len(lookup_metadatas):
            metadata = lookup_metadatas[i]
            metadata.track_number = i + 1
            metadata.track_total = len(pcm_lengths)
        else:
            metadata = MetaData(track_number=i + 1,
                                track_total=len(pcm_lengths))
            if base_metadata is not None:
                metadata.album_name = base_metadata.album_name
                metadata.artist_name = base_metadata.artist_name
                metadata.year = base_metadata.year
        if options.album_number is not None:
            metadata.album_number = options.album_number
        if options.album_total is not None:
            metadata.album_total = options.album_total
        try:
            filename = output_class.track_name(
                track.filename, metadata, options.format or FILENAME_FORMAT,
                suffix=output_class.SUFFIX)
        except (UnsupportedTracknameField, InvalidFilenameFormat) as err:
            msg.error(str(err))
            return 1
        tracks.append(Track(i, os.path.join(options.dir, filename), frames,
                            metadata))

    readers = SplitReaders(track.to_pcm(), pcm_lengths)
    compression = options.quality or None

    def encode(job, device):
        new_track = output_class.from_pcm(
            job.dest_path, readers.take(job.index), compression,
            total_pcm_frames=job.frames, device=device)
        new_track.set_metadata(job.metadata)

    def done(index, _result, error):
        if error is None:
            msg.output(text.LAB_T2T_CONVERTED %
                       {"source": track.filename,
                        "destination": tracks[index].dest_path})

    outcomes = run_jobs(tracks, encode, workers=options.max_processes,
                        devices=devices, done=done, stop_on_error=True)
    errors = [error for (_result, error) in outcomes if error is not None]
    if errors:
        msg.error(str(errors[0]))
        return 1

    if (options.add_replay_gain and output_class.supports_replay_gain() and
            tracks):
        msg.info(text.RG_ADDING_REPLAYGAIN_WAIT)
        output_class.add_replay_gain([t.dest_path for t in tracks],
                                     device=devices[0])
        msg.info(text.RG_REPLAYGAIN_ADDED)
    return 0


if __name__ == "__main__":
    sys.exit(main())
