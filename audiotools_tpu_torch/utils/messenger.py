"""Progress rows: a line a running job, redrawn in place on a terminal.

The port of the progress classes of the reference's
``audiotools_tpu/utils/messenger.py``: ``ProgressDisplay`` keeps a row a
job (``ProgressRow``, drawn as ``"%3d%% %s"``, cut to the terminal's
width), clears them with ANSI sequences and redraws them below each
line a finished job prints; ``SingleProgressDisplay`` draws one row at
most every 0.25 s; ``ReplayGainProgressDisplay`` draws one row for a
ReplayGain pass on a terminal and a wait/done message pair otherwise;
``output_progress`` prefixes a line with its place in a count.  They
draw through the ANSI helpers of ``Messenger`` (the tools' messenger,
``cli.Messenger``, is one).  When stdout is not a terminal nothing is
drawn, and a finished job's line is the messenger's plain output line.
The reference's other output classes are here too: ``SilentMessenger``,
``output_table`` and its rows, ``output_text`` and ``output_list``
(display widths, ANSI styles) and ``DummyOutput``.

The port's jobs run in ``parallel.farm.run_jobs``' worker threads: a
worker writes its job's (current, total) into a slot, and the thread
that called ``run_jobs`` adds, updates, finishes and draws the rows
(``run_jobs(..., display=...)``), so that two threads never interleave
their sequences.
"""

from __future__ import annotations

import os
import sys
import time


class Messenger:
    """output to stdout; info, warnings and errors to stderr; and the
    ANSI helpers the progress rows draw with"""

    def __init__(self, executable="audiotools", options=None):
        self.executable = executable
        verbosity = getattr(options, "verbosity", None) if options \
            else None
        self.__verbosity__ = verbosity or "normal"

    def quiet(self):
        return self.__verbosity__ in ("quiet", "silent")

    def output(self, s):
        """displays an output message to stdout"""
        if self.__verbosity__ != "silent":
            sys.stdout.write("%s%s" % (s, os.linesep))
            sys.stdout.flush()

    def partial_output(self, s):
        """displays a partial output message (no newline)"""
        if self.__verbosity__ != "silent":
            sys.stdout.write(str(s))
            sys.stdout.flush()

    def info(self, s):
        """displays an informative message to stderr"""
        if not self.quiet():
            sys.stderr.write("%s%s" % (s, os.linesep))

    def partial_info(self, s):
        if not self.quiet():
            sys.stderr.write(str(s))
            sys.stderr.flush()

    def warning(self, s):
        """displays a warning message to stderr"""
        if self.__verbosity__ != "silent":
            sys.stderr.write("*** Warning: %s%s" % (s, os.linesep))

    def error(self, s):
        """displays an error message to stderr"""
        sys.stderr.write("*** Error: %s%s" % (s, os.linesep))

    def os_error(self, oserror):
        """displays an OSError as a formatted error message"""
        self.error("[Errno %d] %s: '%s'" %
                   (oserror.errno, oserror.strerror,
                    getattr(oserror, "filename", "")))

    def usage(self, s):
        """displays a usage message to stderr"""
        sys.stderr.write("*** Usage: %s %s%s" %
                         (self.executable, s, os.linesep))

    def ansi_clearline(self):
        if sys.stdout.isatty():
            sys.stdout.write("\r\x1b[0K")
            sys.stdout.flush()

    def ansi_uplines(self, lines):
        if sys.stdout.isatty():
            sys.stdout.write("\x1b[%dA" % (lines,))

    def ansi_cleardown(self):
        if sys.stdout.isatty():
            sys.stdout.write("\x1b[0J")

    def terminal_size(self, fd=None):
        """returns the current terminal size as (height, width)"""
        try:
            size = os.get_terminal_size(
                fd if fd is not None else sys.stdout.fileno())
            return (size.lines, size.columns)
        except (OSError, ValueError):
            return (25, 80)


class SilentMessenger(Messenger):
    def __init__(self, executable="audiotools"):
        Messenger.__init__(self, executable)
        self.__verbosity__ = "silent"


class output_table:
    """a table of aligned columns for terminal output"""

    def __init__(self):
        self.__rows__ = []

    def row(self):
        """adds a row to the table and returns it"""
        row = output_table_row()
        self.__rows__.append(row)
        return row

    def blank_row(self):
        row = output_table_blank()
        self.__rows__.append(row)
        return row

    def divider_row(self, dividers=None):
        row = output_table_divider()
        self.__rows__.append(row)
        return row

    def format(self, is_tty=False):
        """yields one formatted string per row"""
        real_rows = [r for r in self.__rows__
                     if isinstance(r, output_table_row)]
        if real_rows:
            columns = max(len(r.__columns__) for r in real_rows)
            widths = [0] * columns
            for row in real_rows:
                for (i, (text, _align)) in enumerate(row.__columns__):
                    widths[i] = max(widths[i], len(text))
        else:
            widths = []

        for row in self.__rows__:
            yield row.format_row(widths)


class output_table_row:
    def __init__(self):
        self.__columns__ = []

    def add_column(self, text, alignment="left"):
        self.__columns__.append((str(text), alignment))

    def format_row(self, widths):
        out = []
        for ((text, alignment), width) in zip(self.__columns__, widths):
            if alignment == "right":
                out.append(text.rjust(width))
            elif alignment == "center":
                out.append(text.center(width))
            else:
                out.append(text.ljust(width))
        return "".join(out).rstrip()


class output_table_blank:
    def format_row(self, widths):
        return ""


class output_table_divider:
    def format_row(self, widths):
        return "-" * sum(widths)


class ProgressDisplay:
    """a class for displaying incremental progress updates"""

    def __init__(self, messenger):
        self.messenger = messenger
        self.progress_rows = []
        self.empty_slots = []
        self.displayed_rows = 0
        self.is_tty = sys.stdout.isatty()

    def add_row(self, output_line):
        """returns a ProgressRow for updating progress"""
        if self.empty_slots:
            row_index = self.empty_slots.pop(0)
            row = ProgressRow(self, row_index, output_line)
            self.progress_rows[row_index] = row
        else:
            row_index = len(self.progress_rows)
            row = ProgressRow(self, row_index, output_line)
            self.progress_rows.append(row)
        return row

    def remove_row(self, row_index):
        self.empty_slots.append(row_index)
        self.progress_rows[row_index] = None

    def display_rows(self):
        """outputs the current state of all progress rows"""
        if not self.is_tty:
            return
        self.clear_rows()
        for row in self.progress_rows:
            if row is not None:
                sys.stdout.write(row.unicode() + os.linesep)
                self.displayed_rows += 1
        sys.stdout.flush()

    def clear_rows(self):
        if self.is_tty and self.displayed_rows:
            self.messenger.ansi_uplines(self.displayed_rows)
            self.messenger.ansi_cleardown()
            self.displayed_rows = 0

    def output_line(self, line):
        """outputs a line above the progress rows"""
        self.clear_rows()
        self.messenger.output(line)
        self.display_rows()


class ProgressRow:
    """a single row of progress output"""

    def __init__(self, display, row_index, output_line):
        self.display = display
        self.row_index = row_index
        self.output_line = output_line
        self.current = 0
        self.total = 1

    def update(self, current, total):
        self.current = current
        self.total = max(total, 1)
        self.display.display_rows()

    def finish(self):
        self.display.remove_row(self.row_index)
        self.display.display_rows()

    def unicode(self):
        (_height, width) = self.display.messenger.terminal_size()
        percent = min(100, (self.current * 100) // self.total)
        label = "%3d%% %s" % (percent, self.output_line)
        return label[:width - 1]


class SingleProgressDisplay(ProgressDisplay):
    """a ProgressDisplay for a single row of output"""

    def __init__(self, messenger, progress_text):
        ProgressDisplay.__init__(self, messenger)
        self.row = self.add_row(progress_text)
        self.last_updated = 0.0

    def update(self, current, total):
        now = time.time()
        if (now - self.last_updated) > 0.25:
            self.row.update(current, total)
            self.last_updated = now


class DummyOutput:
    """a writable FILE-like object which generates no output
    """

    def isatty(self):
        return False

    def write(self, s):
        return

    def flush(self):
        return

    def close(self):
        return


_ANSI_FG = {"black": 30, "red": 31, "green": 32, "yellow": 33,
            "blue": 34, "magenta": 35, "cyan": 36, "white": 37}
_ANSI_BG = {"black": 40, "red": 41, "green": 42, "yellow": 43,
            "blue": 44, "magenta": 45, "cyan": 46, "white": 47}
_ANSI_STYLE = {"bold": 1, "underline": 4, "blink": 5, "inverse": 7}


class output_text:
    """a display-formatted text unit (reference __init__.py:487):
    knows its terminal display width (double-width CJK aware) and can
    render itself with ANSI color/style codes when the target is a
    tty"""

    def __init__(self, string, fg_color=None, bg_color=None,
                 style=None):
        import unicodedata
        self.__string__ = unicodedata.normalize("NFC", str(string))
        self.__char_widths__ = tuple(
            2 if unicodedata.east_asian_width(char) in ("W", "F")
            else 1
            for char in self.__string__)
        self.set_format(fg_color, bg_color, style)

    def __str__(self):
        return self.__string__

    def __repr__(self):
        return "output_text(%r)" % (self.__string__,)

    def __len__(self):
        """the DISPLAY width in terminal cells, not the character
        count (double-width characters count twice)"""
        return sum(self.__char_widths__)

    def set_format(self, fg_color=None, bg_color=None, style=None):
        if fg_color is not None and fg_color not in _ANSI_FG:
            raise ValueError("unsupported fg_color %r" % (fg_color,))
        if bg_color is not None and bg_color not in _ANSI_BG:
            raise ValueError("unsupported bg_color %r" % (bg_color,))
        if style is not None and style not in _ANSI_STYLE:
            raise ValueError("unsupported style %r" % (style,))
        self.__fg_color__ = fg_color
        self.__bg_color__ = bg_color
        self.__style__ = style

    def has_formatting(self):
        return (self.__fg_color__ is not None or
                self.__bg_color__ is not None or
                self.__style__ is not None)

    def __open_codes__(self):
        codes = []
        if self.__style__ is not None:
            codes.append(_ANSI_STYLE[self.__style__])
        if self.__fg_color__ is not None:
            codes.append(_ANSI_FG[self.__fg_color__])
        if self.__bg_color__ is not None:
            codes.append(_ANSI_BG[self.__bg_color__])
        return "\033[%sm" % (";".join(map(str, codes)),)

    def format(self, is_tty=False):
        """renders the text; ANSI codes only when is_tty and the
        text has formatting"""
        if is_tty and self.has_formatting():
            return "%s%s\033[0m" % (self.__open_codes__(),
                                    self.__string__)
        return self.__string__

    def head(self, display_characters):
        """a new output_text truncated to at most the given display
        width (whole characters only, so double-width characters may
        leave it one cell short)"""
        total = 0
        chars = []
        for (char, width) in zip(self.__string__,
                                 self.__char_widths__):
            if total + width > display_characters:
                break
            chars.append(char)
            total += width
        return output_text("".join(chars), self.__fg_color__,
                           self.__bg_color__, self.__style__)

    def tail(self, display_characters):
        """a new output_text truncated (from the front) to at most
        the given display width"""
        total = 0
        chars = []
        for (char, width) in zip(reversed(self.__string__),
                                 reversed(self.__char_widths__)):
            if total + width > display_characters:
                break
            chars.append(char)
            total += width
        return output_text("".join(reversed(chars)),
                           self.__fg_color__, self.__bg_color__,
                           self.__style__)


class output_list(output_text):
    """multiple output_text units formatted together
    (reference __init__.py:748)"""

    def __init__(self, output_texts, fg_color=None, bg_color=None,
                 style=None):
        self.__output_texts__ = [
            t if isinstance(t, output_text) else output_text(t)
            for t in output_texts]
        self.set_format(fg_color, bg_color, style)

    def __str__(self):
        return "".join(str(t) for t in self.__output_texts__)

    def __repr__(self):
        return "output_list(%r)" % (self.__output_texts__,)

    def __len__(self):
        return sum(len(t) for t in self.__output_texts__)

    def format(self, is_tty=False):
        if is_tty and self.has_formatting():
            return "%s%s\033[0m" % (
                self.__open_codes__(),
                "".join(t.format(False)
                        for t in self.__output_texts__))
        return "".join(t.format(is_tty)
                       for t in self.__output_texts__)


def output_progress(s, current, total):
    """returns "[current/total]  s" when total > 1, else s unchanged"""
    if total > 1:
        return "[%*d/%d]  %s" % (len(str(total)), current, total, s)
    return s


class ReplayGainProgressDisplay(ProgressDisplay):
    """ProgressDisplay specialized for ReplayGain passes: one
    auto-updating row on a tty, a wait/done message pair otherwise"""

    def __init__(self, messenger, lossless_replay_gain=True):
        from ..cli import text
        ProgressDisplay.__init__(self, messenger)
        self.lossless_replay_gain = lossless_replay_gain
        self.__last_updated__ = 0.0
        self.__tty__ = sys.stdout.isatty()
        self.row = self.add_row(text.RG_ADDING_REPLAYGAIN
                                if lossless_replay_gain
                                else text.RG_APPLYING_REPLAYGAIN)

    def initial_message(self):
        from ..cli import text
        if not self.__tty__:
            self.messenger.info(text.RG_ADDING_REPLAYGAIN_WAIT
                                if self.lossless_replay_gain
                                else text.RG_APPLYING_REPLAYGAIN_WAIT)

    def update(self, current, total):
        if self.__tty__:
            now = time.time()
            if now - self.__last_updated__ >= 0.25:
                self.row.update(current, total)
                self.display_rows()
                self.__last_updated__ = now

    def final_message(self):
        from ..cli import text
        if self.__tty__:
            self.clear_rows()
        self.messenger.info(text.RG_REPLAYGAIN_ADDED
                            if self.lossless_replay_gain
                            else text.RG_REPLAYGAIN_APPLIED)
