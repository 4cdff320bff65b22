"""trackverify: verify audio files for correctness.

The port of the reference's ``audiotools_tpu/cli/trackverify.py``: each
file decoded whole by its class's ``verify`` on the job's device, one
line a file and a summary table, exit 1 if any file failed.  With
--accuraterip, CD-format tracks (44.1 kHz, stereo, 16 bits) also get
their AccurateRip V1 and V2 sums, taken on the same device in the same
decode.  ``--cue`` then checks that a cue or TOC sheet's track lengths
fit the first file (exit 1 with an error line when they do not).  The
reference's lookup of the sums in the online AccurateRip database is
not ported.

    python -m audiotools_tpu_torch.cli.trackverify out/*.flac
"""

from __future__ import annotations

import argparse
import sys

from . import (Messenger, add_common_arguments, add_job_arguments,
               job_devices, output_table, text)


def verify(filename, accuraterip, device):
    """(filename, "OK" or the error, (v1, v2) or None) of one file"""
    from .. import dispatch
    from ..accuraterip_checksum import AccurateRipCRC
    from ..audiofile import InvalidFile, UnsupportedFile
    try:
        track = dispatch.open(filename, device=device)
    except (IOError, UnsupportedFile, InvalidFile) as err:
        return (filename, str(err) or type(err).__name__, None)
    crc = None
    if (accuraterip and track.sample_rate() == 44100 and
            track.channels() == 2 and track.bits_per_sample() == 16):
        crc = AccurateRipCRC(False, False, 44100, track.total_frames(),
                             device=device)
    try:
        track.verify(sink=None if crc is None else crc.update_array)
        result = "OK"
    except InvalidFile as err:
        result = str(err)
    checksums = crc.checksums() if (crc is not None and
                                    result == "OK") else None
    return (filename, result, checksums)


def report(result):
    (filename, status, checksums) = result
    if status == "OK":
        line = text.LAB_TRACKVERIFY_OK % {"filename": filename}
    else:
        line = text.LAB_TRACKVERIFY_FAILED % {"filename": filename,
                                              "error": status}
    if checksums is not None:
        line += " (AccurateRip v1=%08X v2=%08X)" % checksums
    return line


def summary(results):
    """the lines of the reference's results table: each format (file
    suffix) with its successes and failures"""
    by_format = {}
    for (filename, status, _checksums) in results:
        suffix = filename.rsplit(".", 1)[-1].lower()
        (ok, bad) = by_format.get(suffix, (0, 0))
        by_format[suffix] = (ok + 1, bad) if status == "OK" else (ok, bad + 1)
    rows = [("format ", "success ", "failure")]
    rows.extend((suffix + " ", "%d " % (ok,), "%d" % (bad,))
                for (suffix, (ok, bad)) in sorted(by_format.items()))
    return output_table(rows)


def sheet_fits(cuesheet, filename, device):
    """None when the cue or TOC sheet's track lengths are all positive
    and add up to the file's length, else the error line's text"""
    from .. import dispatch
    from ..audiofile import SheetException, read_sheet
    try:
        sheet = read_sheet(cuesheet)
        track = dispatch.open(filename, device=device)
        lengths = list(sheet.pcm_lengths(track.total_frames(),
                                         track.sample_rate()))
    except (SheetException, IOError, ValueError) as err:
        return str(err)
    if (sum(lengths) != track.total_frames() or
            any(length <= 0 for length in lengths)):
        return "cuesheet does not match file length"
    return None


def main(argv=None):
    parser = argparse.ArgumentParser(prog="trackverify",
                                     description=text.DESC_TRACKVERIFY)
    add_common_arguments(parser)
    add_job_arguments(parser)
    parser.add_argument("--accuraterip", action="store_true",
                        default=False, help=text.HELP_VERIFY_ACCURATERIP)
    parser.add_argument("-t", "--type", action="append",
                        dest="accept_list", default=None, metavar="type")
    parser.add_argument("--cue", dest="cuesheet", default=None,
                        help=text.HELP_CUESHEET)
    parser.add_argument("-S", "--no-summary", action="store_true",
                        dest="no_summary", default=False)
    parser.add_argument("filenames", nargs="+")

    options = parser.parse_args(argv)
    msg = Messenger(options)

    from ..parallel.farm import run_jobs

    try:
        devices = job_devices(options.devices)
    except (RuntimeError, ValueError) as err:
        msg.error(str(err))
        return 1

    # -t restricts verification to the named types
    filenames = options.filenames
    if options.accept_list:
        from ..dispatch import file_type
        accept = set(options.accept_list)
        kept = []
        for filename in filenames:
            try:
                with open(filename, "rb") as f:
                    cls = file_type(f)
            except IOError:
                kept.append(filename)   # unreadable: reported below
                continue
            if cls is not None and cls.NAME in accept:
                kept.append(filename)
        filenames = kept

    def run(filename, device):
        return verify(filename, options.accuraterip, device)

    def done(_index, result, error):
        if error is None:
            msg.output(report(result))

    outcomes = run_jobs(filenames, run, workers=options.max_processes,
                        devices=devices, done=done, stop_on_error=True)
    errors = [error for (_result, error) in outcomes if error is not None]
    if errors:
        msg.error(str(errors[0]))
        return 1
    results = [result for (result, _error) in outcomes]

    if options.cuesheet is not None and results:
        error = sheet_fits(options.cuesheet, filenames[0], devices[0])
        if error is not None:
            msg.error(error)
            return 1

    if not options.no_summary and results:
        msg.output(text.LAB_TRACKVERIFY_RESULTS)
        msg.output("")
        for line in summary(results):
            msg.output(line)

    return 0 if all(r[1] == "OK" for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
