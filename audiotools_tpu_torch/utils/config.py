"""The user's configuration: /etc/audiotools.cfg, then ~/.audiotools.cfg.

A copy of the reference's ``audiotools_tpu/utils/config.py``, read at
import from the same two paths in the same order, with the same typed
helpers and defaults.  Four settings change what the port writes, as
they change what the reference writes:

- ``[Quality] <type>``: the default compression of that type's
  ``from_pcm`` and ``from_wave`` (``default_quality``; FLAC and
  WavPack);
- ``[System] default_type``: the tools' default ``-t``
  (``cli.default_type``, "wav" when the type is not one the port has);
- ``[Filenames] format``: the default output name template
  (``FILENAME_FORMAT``, through ``audiofile.FILENAME_FORMAT``);
- ``[System] maximum_jobs``: the tools' default ``-j``
  (``cli.default_jobs``).  Unset, the port keeps
  ``parallel.farm.DEFAULT_WORKERS`` where the reference takes the CPU
  count (``MAX_JOBS``): more threads on one card ran slower.  The job
  count changes no output byte.
"""

from __future__ import annotations

import configparser
import os

CONFIG_PATHS = ["/etc/audiotools.cfg",
                os.path.expanduser("~/.audiotools.cfg")]


class _Config(configparser.RawConfigParser):
    def get_default(self, section, option, default):
        try:
            return self.get(section, option)
        except (configparser.NoSectionError, configparser.NoOptionError):
            return default

    def getboolean_default(self, section, option, default):
        try:
            return self.getboolean(section, option)
        except (configparser.NoSectionError, configparser.NoOptionError,
                ValueError):
            return default

    def getint_default(self, section, option, default):
        try:
            return self.getint(section, option)
        except (configparser.NoSectionError, configparser.NoOptionError,
                ValueError):
            return default

    def set_default(self, section, option, value):
        if not self.has_section(section):
            self.add_section(section)
        self.set(section, option, value)


config = _Config()
config.read(CONFIG_PATHS)


class __system_binaries__:
    """resolves executable names through the [Binaries] config section"""

    def __init__(self, config):
        self.config = config

    def __getitem__(self, command):
        try:
            return self.config.get("Binaries", command)
        except (configparser.NoSectionError, configparser.NoOptionError):
            return command

    def can_execute(self, command):
        if os.sep in command:
            return os.access(command, os.X_OK)
        for path in os.environ.get("PATH", "").split(os.pathsep):
            if os.access(os.path.join(path, command), os.X_OK):
                return True
        return False


BIN = __system_binaries__(config)

FILENAME_FORMAT = config.get_default(
    "Filenames", "format",
    "%(track_number)2.2d - %(track_name)s.%(suffix)s")

DEFAULT_TYPE = config.get_default("System", "default_type", "flac")

DEFAULT_CDROM = config.get_default("System", "cdrom", "/dev/cdrom")

DEFAULT_CDROM_READ_OFFSET = config.getint_default(
    "System", "cdrom_read_offset", 0)

DEFAULT_VERBOSITY = config.get_default("Defaults", "verbosity", "normal")

VERBOSITY_LEVELS = ("debug", "normal", "quiet", "silent")


def MAX_JOBS():
    """the maximum number of parallel jobs (default: the CPU count), the
    reference's default -j"""
    configured = config.getint_default("System", "maximum_jobs", -1)
    if configured > 0:
        return configured
    return os.cpu_count() or 1


def default_quality(format_name):
    """the default quality string for the given format NAME ("" when
    none is configured)"""
    return config.get_default("Quality", format_name, "")
