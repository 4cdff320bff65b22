"""Progress rows: a line a running job, redrawn in place on a terminal.

The port of the progress classes of the reference's
``audiotools_tpu/utils/messenger.py``: ``ProgressDisplay`` keeps a row a
job (``ProgressRow``, drawn as ``"%3d%% %s"``, cut to the terminal's
width), clears them with ANSI sequences and redraws them below each
line a finished job prints; ``SingleProgressDisplay`` draws one row at
most every 0.25 s; ``ReplayGainProgressDisplay`` draws one row for a
ReplayGain pass on a terminal and a wait/done message pair otherwise;
``output_progress`` prefixes a line with its place in a count.  They
draw through the ANSI helpers of the port's ``cli.Messenger``.  When
stdout is not a terminal nothing is drawn, and a finished job's line is
the messenger's plain output line.

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
