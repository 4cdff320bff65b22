"""trackcmp: compare audio files or directories pairwise.

The port of the reference's ``audiotools_tpu/cli/trackcmp.py``: each
pair decoded on the job's device and compared frame by frame
(``pcm.pcm_frame_cmp``), a line a pair naming the first frame that
differs, a summary, and exit 1 if any pair differs.

    python -m audiotools_tpu_torch.cli.trackcmp in.wav out/in.flac
"""

from __future__ import annotations

import argparse
import os
import sys

from . import Messenger, add_common_arguments, add_job_arguments, \
    job_devices, text


def compare(filename1, filename2, device):
    """(filename1, filename2, the first mismatching frame, None or an
    error's text)"""
    from .. import dispatch
    from ..audiofile import InvalidFile, UnsupportedFile
    from ..pcm import pcm_frame_cmp
    try:
        track1 = dispatch.open(filename1, device=device)
        track2 = dispatch.open(filename2, device=device)
    except (IOError, UnsupportedFile, InvalidFile) as err:
        return (filename1, filename2, str(err))
    reader1 = track1.to_pcm()
    try:
        reader2 = track2.to_pcm()
        try:
            return (filename1, filename2, pcm_frame_cmp(reader1, reader2))
        finally:
            reader2.close()
    finally:
        reader1.close()


def report(result):
    (filename1, filename2, mismatch) = result
    if mismatch is None:
        return text.LAB_TRACKCMP_OK % {"file1": filename1,
                                       "file2": filename2}
    if isinstance(mismatch, str):
        return "%s <> %s : %s" % (filename1, filename2, mismatch)
    return text.LAB_TRACKCMP_MISMATCH % {"file1": filename1,
                                         "file2": filename2,
                                         "frame": mismatch + 1}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="trackcmp",
                                     description=text.DESC_TRACKCMP)
    add_common_arguments(parser)
    add_job_arguments(parser)
    parser.add_argument("-S", "--no-summary", action="store_true",
                        dest="no_summary", default=False)
    parser.add_argument("filenames", nargs="+")

    options = parser.parse_args(argv)
    msg = Messenger(options)

    from ..parallel.farm import run_jobs

    paths = options.filenames
    pairs = []
    if (len(paths) == 2 and os.path.isdir(paths[0]) and
            os.path.isdir(paths[1])):
        for name in sorted(os.listdir(paths[0])):
            other = os.path.join(paths[1], name)
            if os.path.isfile(other):
                pairs.append((os.path.join(paths[0], name), other))
            else:
                msg.output(text.LAB_CMP_MISSING % {"filename": other})
    elif len(paths) % 2 == 0:
        pairs = [(paths[i], paths[i + 1]) for i in range(0, len(paths), 2)]
    else:
        msg.error(text.ERR_PAIRS_REQUIRED)
        return 1

    try:
        devices = job_devices(options.devices)
    except (RuntimeError, ValueError) as err:
        msg.error(str(err))
        return 1

    def run(pair, device):
        return compare(pair[0], pair[1], device)

    def done(_index, result, error):
        if error is None:
            msg.output(report(result))

    outcomes = run_jobs(pairs, run, workers=options.max_processes,
                        devices=devices, done=done, stop_on_error=True)
    errors = [error for (_result, error) in outcomes if error is not None]
    if errors:
        msg.error(str(errors[0]))
        return 1
    results = [result for (result, _error) in outcomes]

    if not options.no_summary and results:
        matches = sum(1 for r in results if r[2] is None)
        msg.output("%d/%d OK" % (matches, len(results)))

    return 0 if all(r[2] is None for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
