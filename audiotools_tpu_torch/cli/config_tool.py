"""audiotools-config: show and set the user's configuration.

The port of the reference's ``audiotools_tpu/cli/config_tool.py``.
With a setting's flag it writes that setting into ~/.audiotools.cfg
(with whatever the configuration files already held, as the reference
writes it), a line a setting; the next tool run reads it
(``utils.config``).  With none it lists the default type, the default
job count (the port's: ``cli.default_jobs``), the port's formats and
their quality modes.  The port has six formats where the reference
lists more, so a type or quality of another format is refused.  -I
exits 1 (``refuse_unported``).

    python -m audiotools_tpu_torch.cli.config_tool -t flac -q 5
"""

from __future__ import annotations

import argparse
import os
import sys

from . import (Messenger, add_common_arguments, add_unported_arguments,
               default_jobs, output_table, refuse_unported, text)

# (option, section, key) of each setting a flag writes; "quality"'s key
# is the type it is for
SETTINGS = [
    ("quality", "Quality", None),
    ("filename_format", "Filenames", "format"),
    ("maximum_jobs", "System", "maximum_jobs"),
    ("add_replaygain", "ReplayGain", "add_by_default"),
    ("use_musicbrainz", "MusicBrainz", "service"),
    ("musicbrainz_server", "MusicBrainz", "server"),
    ("musicbrainz_port", "MusicBrainz", "port"),
    ("use_freedb", "FreeDB", "service"),
    ("freedb_server", "FreeDB", "server"),
    ("freedb_port", "FreeDB", "port"),
    ("system_cdrom", "System", "cdrom"),
    ("cdrom_read_offset", "System", "cdrom_read_offset"),
    ("cdrom_write_offset", "System", "cdrom_write_offset"),
    ("fs_encoding", "System", "fs_encoding"),
    ("io_encoding", "System", "io_encoding"),
    ("id3v2_version", "ID3", "id3v2"),
    ("id3_digit_padding", "ID3", "pad"),
    ("id3v1_version", "ID3", "id3v1"),
]


def available_types():
    """every class of the port, available or not, in the order the
    reference lists them"""
    from ..dispatch import AVAILABLE_TYPES
    return list(AVAILABLE_TYPES)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="audiotools-config",
                                     description=text.DESC_CONFIG)
    add_common_arguments(parser)
    parser.add_argument("-t", "--type", dest="default_type", default=None,
                        help=text.HELP_CONFIG_TYPE)
    parser.add_argument("-q", "--quality", dest="quality", default=None)
    parser.add_argument("--format", dest="filename_format", default=None)
    parser.add_argument("-j", "--joint", dest="maximum_jobs", type=int,
                        default=None)
    parser.add_argument("--replay-gain", dest="add_replaygain",
                        choices=("yes", "no"), default=None)
    parser.add_argument("--use-musicbrainz", dest="use_musicbrainz",
                        choices=("yes", "no"), default=None)
    parser.add_argument("--musicbrainz-server", dest="musicbrainz_server",
                        default=None)
    parser.add_argument("--musicbrainz-port", type=int,
                        dest="musicbrainz_port", default=None)
    parser.add_argument("--use-freedb", dest="use_freedb",
                        choices=("yes", "no"), default=None)
    parser.add_argument("--freedb-server", dest="freedb_server",
                        default=None)
    parser.add_argument("--freedb-port", type=int, dest="freedb_port",
                        default=None)
    parser.add_argument("--cdrom", dest="system_cdrom", default=None)
    parser.add_argument("--cdrom-read-offset", type=int,
                        dest="cdrom_read_offset", default=None)
    parser.add_argument("--cdrom-write-offset", type=int,
                        dest="cdrom_write_offset", default=None)
    parser.add_argument("--fs-encoding", dest="fs_encoding", default=None)
    parser.add_argument("--io-encoding", dest="io_encoding", default=None)
    parser.add_argument("--id3v2-version", dest="id3v2_version",
                        choices=("2.2", "2.3", "2.4"), default=None)
    parser.add_argument("--id3v1-version", dest="id3v1_version",
                        choices=("1.1", "none"), default=None)
    parser.add_argument("--id3v2-pad", dest="id3_digit_padding",
                        choices=("yes", "no"), default=None)
    add_unported_arguments(parser, lookup=False)

    options = parser.parse_args(argv)
    msg = Messenger(options)

    from ..dispatch import TYPE_MAP
    from ..utils import config as cfg

    if refuse_unported(msg, options):
        return 1

    changed = False
    if options.default_type is not None:
        if options.default_type not in TYPE_MAP:
            msg.error(text.ERR_UNSUPPORTED_AUDIO_TYPE %
                      {"type": options.default_type})
            return 1
        cfg.config.set_default("System", "default_type",
                               options.default_type)
        msg.info(text.LAB_CONFIG_SET % {"section": "System",
                                        "option": "default_type",
                                        "value": options.default_type})
        changed = True
    for (dest, section, key) in SETTINGS:
        value = getattr(options, dest)
        if value is None:
            continue
        if dest == "quality":
            key = options.default_type or cfg.DEFAULT_TYPE
            if (key in TYPE_MAP and
                    value not in TYPE_MAP[key].COMPRESSION_MODES):
                msg.error(text.ERR_UNSUPPORTED_COMPRESSION %
                          {"quality": value, "type": key})
                return 1
        cfg.config.set_default(section, key, str(value))
        msg.info(text.LAB_CONFIG_SET % {"section": section, "option": key,
                                        "value": value})
        changed = True
    if changed:
        with open(os.path.expanduser("~/.audiotools.cfg"), "w") as f:
            cfg.config.write(f)
        return 0

    msg.output(text.LAB_CONFIG_SYSTEM)
    msg.output(text.LAB_CONFIG_DEFAULT_TYPE % {"type": cfg.DEFAULT_TYPE})
    msg.output(text.LAB_CONFIG_MAX_JOBS % {"jobs": default_jobs()})
    msg.output("")
    msg.output(text.LAB_CONFIG_FORMATS)
    rows = [("type ", "name ", "available ", "description")]
    rows.extend((cls.NAME + " ", cls.SUFFIX + " ",
                 ("yes" if cls.available() else "no") + " ",
                 cls.DESCRIPTION) for cls in available_types())
    for line in output_table(rows):
        msg.output(line)

    msg.output("")
    msg.output(text.LAB_CONFIG_QUALITY)
    rows = [("type ", "quality ", "description")]
    for cls in available_types():
        modes = [m for m in cls.COMPRESSION_MODES
                 if m in cls.COMPRESSION_DESCRIPTIONS or
                 m == cls.DEFAULT_COMPRESSION]
        for mode in modes:
            label = mode if mode else "(none)"
            if mode == cls.DEFAULT_COMPRESSION:
                label = text.LAB_CONFIG_QUALITY_DEFAULT % {"mode": label}
            rows.append((cls.NAME + " ", label + " ",
                         cls.COMPRESSION_DESCRIPTIONS.get(mode, "")))
    for line in output_table(rows):
        msg.output(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
