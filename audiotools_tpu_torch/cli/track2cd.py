"""track2cd: write audio files as a CD image, and burn it.

The port of the reference's ``audiotools_tpu/cli/track2cd.py``: the
files, in track order, decoded on the card (``to_pcm``; a source that
is not 44.1 kHz, stereo, 16 bits converted by ``pcm.PCMConverter``
there) into one bin of 2352-byte sectors, each track padded to a whole
sector, and a cue sheet of the tracks' offsets beside it; with
``--cue`` and one file, the sheet's track lengths cut that album
(``pcm.pcm_split``).  ``--image BASE`` keeps BASE.cue and BASE.bin;
otherwise the image is written to a temporary directory and burnt by
``cdrdao`` or else ``cdrecord``, and without either the tool exits 1.

    python -m audiotools_tpu_torch.cli.track2cd --image disc rips/*.flac
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

from . import (Messenger, add_common_arguments, add_device_argument,
               first_device, text)

SECTOR_BYTES = 2352


def write_track(out, reader, device):
    """writes a PCMReader's frames to ``out`` as CD audio (44.1 kHz,
    stereo, 16-bit little-endian), padded to a whole sector"""
    from ..pcm import PCMConverter
    if (reader.sample_rate != 44100 or reader.channels != 2 or
            reader.bits_per_sample != 16):
        reader = PCMConverter(reader, 44100, 2, 0x3, 16, device=device)
    framelist = reader.read(65536)
    while framelist.frames:
        out.write(framelist.to_bytes(False, True))
        framelist = reader.read(65536)
    out.write(b"\x00" * ((-out.tell()) % SECTOR_BYTES))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="track2cd",
                                     description=text.DESC_TRACK2CD)
    add_common_arguments(parser)
    parser.add_argument("-c", "--cdrom", dest="cdrom", default="/dev/cdrom",
                        help=text.HELP_CDROM)
    parser.add_argument("--image", dest="image", default=None,
                        help=text.HELP_T2CD_IMAGE)
    parser.add_argument("-s", "--speed", dest="speed", type=int, default=20,
                        help=text.HELP_SPEED)
    parser.add_argument("--cue", dest="cuesheet", default=None,
                        help=text.HELP_T2CD_CUESHEET)
    parser.add_argument("-j", "--joint", dest="max_processes", type=int,
                        default=None)
    add_device_argument(parser)
    parser.add_argument("filenames", nargs="+")
    options = parser.parse_args(argv)
    msg = Messenger(options)

    from ..audiofile import SheetException, read_sheet
    from ..dispatch import open_files
    from ..pcm import pcm_split

    device = first_device(msg, options)
    if device is None:
        return 1
    tracks = open_files(options.filenames, messenger=msg, device=device)
    if len(tracks) == 0:
        msg.error(text.ERR_1_FILE_REQUIRED)
        return 1

    cuesheet = None
    if options.cuesheet is not None:
        try:
            cuesheet = read_sheet(options.cuesheet)
        except (SheetException, IOError) as err:
            msg.error(str(err))
            return 1

    # without --image the image is staged in a temporary directory,
    # removed after the burn, never in the working directory
    staging_dir = None
    if options.image is not None:
        base = options.image
    else:
        import tempfile
        staging_dir = tempfile.mkdtemp(prefix="track2cd-")
        base = os.path.join(staging_dir, "track2cd_image")
    bin_path = base + ".bin"
    cue_path = base + ".cue"

    offsets = []
    with open(bin_path, "wb") as out:
        if cuesheet is not None and len(tracks) == 1:
            album = tracks[0]
            lengths = list(cuesheet.pcm_lengths(album.total_frames(),
                                                album.sample_rate()))
            for sub_reader in pcm_split(album.to_pcm(), lengths):
                offsets.append(out.tell() // SECTOR_BYTES)
                write_track(out, sub_reader, device)
        else:
            for track in tracks:
                offsets.append(out.tell() // SECTOR_BYTES)
                reader = track.to_pcm()
                write_track(out, reader, device)
                reader.close()

    with open(cue_path, "w") as cue:
        cue.write('FILE "%s" BINARY\n' % (os.path.basename(bin_path),))
        for (i, sector) in enumerate(offsets, 1):
            cue.write("  TRACK %2.2d AUDIO\n" % (i,))
            cue.write("    INDEX 01 %2.2d:%2.2d:%2.2d\n" %
                      (sector // (75 * 60), (sector // 75) % 60, sector % 75))
    msg.info(text.LAB_T2CD_WROTE % {"cue": cue_path, "bin": bin_path})

    if options.image is not None:
        return 0

    try:
        if shutil.which("cdrdao") is not None:
            return subprocess.run(
                ["cdrdao", "write", "--device", options.cdrom, "--speed",
                 str(options.speed), cue_path]).returncode
        elif shutil.which("cdrecord") is not None:
            return subprocess.run(
                ["cdrecord", "-audio", "dev=%s" % (options.cdrom,),
                 "speed=%d" % (options.speed,), bin_path]).returncode
        else:
            msg.error(text.ERR_T2CD_NO_BURNER_IMAGE % {"cue": cue_path})
            return 1
    finally:
        if staging_dir is not None:
            shutil.rmtree(staging_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
