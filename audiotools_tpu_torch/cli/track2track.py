"""track2track: convert audio files from one format to another.

The port of the reference's ``audiotools_tpu/cli/track2track.py``:
-t/-q output type and quality, -o one output or -d a directory with
--format templates filled from each track's tags (the configured
template by default), -j farm workers over
--devices, the sample rate, channel and bits-per-sample conversions,
and the album ReplayGain pass for the classes that add it.  Each job
converts as the reference's ``convert`` does, the source's frame count
passed ahead and its foreign RIFF or AIFF chunks carried where the
target takes them, on its worker's device, then writes the source's tags into
the new file.  -M takes the files as one CD and looks it up in
MusicBrainz and FreeDB (``services.lookup.track_metadata_lookup``):
the first choice (-D the default one) fills the fields the files'
tags leave blank.  On a terminal each running job has a progress row
(``utils.messenger.ProgressDisplay``), the destination its label.  -I
(after -M) runs ``ui``'s OutputFiller wizard, where each track's tags,
the output directory, template, type and quality are edited before
any conversion; without urwid it exits 1 there, as the reference's
does.

    python -m audiotools_tpu_torch.cli.track2track -t flac -q 8 -d out in.wav
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

from . import (Messenger, add_common_arguments, add_interactive_argument,
               add_job_arguments, add_lookup_arguments, audiofile_type,
               default_type, job_devices, lookup_options, text,
               urwid_missing)

# one track's conversion: the source's filename, the output and its
# class and compression, the source's MetaData (or None), and the
# conversions asked for (None: keep)
Conversion = collections.namedtuple(
    "Conversion", "source dest_path dest_class compression metadata "
    "sample_rate channels bits_per_sample")


def convert(job, device, progress=None):
    """converts one track on ``device`` (the reference's ``convert``),
    writes the source's tags into it and returns the new file;
    ``progress(current, total)`` after each read of the source"""
    from .. import dispatch
    from ..pcm import PCMConverter, to_pcm_progress
    source = dispatch.open(job.source, device=device)
    if (job.sample_rate is None and job.channels is None and
            job.bits_per_sample is None):
        dest = source.convert(job.dest_path, job.dest_class,
                              job.compression, progress=progress,
                              device=device)
    else:
        pcmreader = to_pcm_progress(source, progress)
        pcmreader = PCMConverter(
            pcmreader, job.sample_rate or pcmreader.sample_rate,
            job.channels or pcmreader.channels,
            pcmreader.channel_mask if job.channels is None else 0,
            job.bits_per_sample or pcmreader.bits_per_sample,
            device=device)
        dest = job.dest_class.from_pcm(job.dest_path, pcmreader,
                                       job.compression, device=device)
    if job.metadata is not None:
        dest.set_metadata(job.metadata)
    return dest


def main(argv=None):
    parser = argparse.ArgumentParser(prog="track2track",
                                     description=text.DESC_TRACK2TRACK)
    add_common_arguments(parser)
    parser.add_argument("-t", "--type", dest="type", help=text.HELP_TYPE)
    parser.add_argument("-q", "--quality", dest="quality", default="",
                        help=text.HELP_QUALITY)
    parser.add_argument("-d", "--dir", dest="dir", default=".",
                        help=text.HELP_DIR)
    parser.add_argument("--format", dest="format", default=None,
                        help=text.HELP_FORMAT)
    parser.add_argument("-o", "--output", dest="output", default=None,
                        help=text.HELP_OUTPUT)
    add_job_arguments(parser)
    add_interactive_argument(parser)
    add_lookup_arguments(parser)
    parser.add_argument("--replay-gain", action="store_true",
                        dest="add_replay_gain", default=False,
                        help=text.HELP_REPLAY_GAIN)
    parser.add_argument("--no-replay-gain", action="store_false",
                        dest="add_replay_gain",
                        help=text.HELP_NO_REPLAY_GAIN)
    parser.add_argument("--sample-rate", type=int, default=None,
                        help=text.HELP_SAMPLE_RATE)
    parser.add_argument("--channels", type=int, default=None,
                        help=text.HELP_CHANNELS)
    parser.add_argument("--bits-per-sample", type=int, default=None,
                        help=text.HELP_BITS_PER_SAMPLE)
    parser.add_argument("filenames", nargs="+")

    options = parser.parse_args(argv)
    msg = Messenger(options)

    from .. import dispatch
    from ..audiofile import (FILENAME_FORMAT, AudioFile,
                             InvalidFilenameFormat, UnsupportedTracknameField)
    from ..parallel.farm import run_jobs
    from ..utils.messenger import ProgressDisplay

    if options.type is None:
        options.type = default_type()
    destination_class = audiofile_type(msg, options.type)
    if destination_class is None:
        return 1

    if (options.quality and
            options.quality not in destination_class.COMPRESSION_MODES):
        msg.error(text.ERR_UNSUPPORTED_COMPRESSION %
                  {"quality": options.quality, "type": options.type})
        return 1
    compression = options.quality or None

    try:
        devices = job_devices(options.devices)
    except (RuntimeError, ValueError) as err:
        msg.error(str(err))
        return 1

    audiofiles = dispatch.open_files(options.filenames, messenger=msg,
                                     device=devices[0])
    if len(audiofiles) == 0:
        msg.error(text.ERR_1_FILE_REQUIRED)
        return 1

    def job(track, destination, metadata):
        return Conversion(track.filename, destination, destination_class,
                          compression, metadata, options.sample_rate,
                          options.channels, options.bits_per_sample)

    if options.output is not None:
        if len(audiofiles) != 1:
            msg.error(text.ERR_ONE_OUTPUT_FILE)
            return 1
        [(_dest, error)] = run_jobs(
            [job(audiofiles[0], options.output,
                 audiofiles[0].get_metadata())],
            convert, devices=devices[:1])
        if error is not None:
            msg.error(str(error))
            return 1
        return 0

    # the files as one CD: the first choice (-D: the default one) fills
    # the fields a file's tags leave blank
    lookup_metadata = None
    if options.metadata_lookup:
        from ..services.lookup import track_metadata_lookup
        choices = track_metadata_lookup(audiofiles, **lookup_options(options))
        chosen = choices[-1] if options.use_default else choices[0]
        lookup_metadata = dict(zip(
            (t.filename for t in dispatch.sorted_tracks(audiofiles)), chosen))
        if len(choices) > 1 and not options.use_default:
            msg.info(text.LAB_T2T_USING_METADATA %
                     {"album": chosen[0].album_name or text.LAB_UNTITLED})

    metadatas = []
    for track in audiofiles:
        metadata = track.get_metadata()
        looked_up = (lookup_metadata.get(track.filename)
                     if lookup_metadata is not None else None)
        if looked_up is not None:
            if metadata is not None:
                for field in looked_up.FIELDS:
                    if getattr(metadata, field) is None:
                        setattr(metadata, field, getattr(looked_up, field))
            else:
                metadata = looked_up
        metadatas.append(metadata)

    # -I: each track's class, output path, quality and tags from the
    # wizard
    specs = None
    if options.interactive:
        if urwid_missing(msg):
            return 1
        specs = _output_wizard(audiofiles, metadatas, options,
                               destination_class, FILENAME_FORMAT)
        if specs is None:
            return 0

    jobs = []
    for (i, track) in enumerate(audiofiles):
        if specs is not None:
            (dest_class, destination, quality, metadata) = specs[i]
            dest_compression = quality or None
        else:
            (dest_class, dest_compression, metadata) = (
                destination_class, compression, metadatas[i])
            try:
                filename = AudioFile.track_name(
                    track.filename, metadata,
                    options.format or FILENAME_FORMAT,
                    suffix=destination_class.SUFFIX)
            except (UnsupportedTracknameField, InvalidFilenameFormat) as err:
                msg.error(str(err))
                return 1
            destination = os.path.join(options.dir, filename)
        if os.path.abspath(destination) == os.path.abspath(track.filename):
            msg.error(text.ERR_OUTPUT_IS_INPUT % {"filename": destination})
            return 1
        if destination in [j.dest_path for j in jobs]:
            msg.error(text.ERR_OUTPUT_DUPLICATE_NAME)
            return 1
        try:
            os.makedirs(os.path.dirname(destination) or ".", exist_ok=True)
        except OSError as err:
            msg.error(text.ERR_MAKEDIRS % {"filename": destination,
                                           "error": err.strerror or err})
            return 1
        jobs.append(Conversion(track.filename, destination, dest_class,
                               dest_compression, metadata,
                               options.sample_rate, options.channels,
                               options.bits_per_sample))

    display = ProgressDisplay(msg)

    def done(index, _dest, error):
        if error is None:
            display.output_line(text.LAB_T2T_CONVERTED %
                                {"source": jobs[index].source,
                                 "destination": jobs[index].dest_path})

    outcomes = run_jobs(jobs, convert, workers=options.max_processes,
                        devices=devices, done=done, stop_on_error=True,
                        display=display, label=lambda job: job.dest_path)
    errors = [error for (_dest, error) in outcomes if error is not None]
    if errors:
        msg.error(str(errors[0]))
        return 1

    if options.add_replay_gain and destination_class.supports_replay_gain():
        msg.info(text.RG_ADDING_REPLAYGAIN_WAIT)
        try:
            destination_class.add_replay_gain([j.dest_path for j in jobs],
                                              device=devices[0])
        except (ValueError, IOError) as err:
            msg.error(str(err))
            return 1
        msg.info(text.RG_REPLAYGAIN_ADDED)
    return 0


def _output_wizard(audiofiles, metadatas, options, destination_class,
                   filename_format):
    """the -I wizard (``ui.OutputFiller``) over the tracks and their
    tags: (class, path, quality, MetaData) a track, None when cancelled"""
    import urwid
    from .. import ui
    from ..audiofile import MetaData
    from ..dispatch import Filename
    filler = ui.OutputFiller(
        track_labels=[str(t.filename) for t in audiofiles],
        metadata_choices=[[m if m is not None else MetaData()
                           for m in metadatas]],
        input_filenames=[Filename(t.filename) for t in audiofiles],
        output_directory=options.dir,
        format_string=options.format or filename_format,
        output_class=destination_class, quality=options.quality)
    urwid.MainLoop(filler, ui.urwid_style(),
                   unhandled_input=filler.handle_text).run()
    if filler.cancelled():
        return None
    return [(cls, str(path), quality, metadata)
            for (cls, path, quality, metadata) in filler.output_tracks()]


if __name__ == "__main__":
    sys.exit(main())
