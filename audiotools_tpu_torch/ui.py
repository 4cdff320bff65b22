"""The interactive modes: urwid widgets and line-oriented prompts.

The port of the reference's ``audiotools_tpu/ui.py``.  The urwid import
is guarded as the reference guards it: where urwid imports (version 1.0
or later), ``AVAILABLE`` is True and the widget suite is defined:
``MetaDataFiller`` (the track/field "swivel" editor), ``MetaDataEditor``
with linked base-metadata fields, the ``OutputFiller`` and
``SingleOutputFiller`` wizards, ``OutputOptions`` and ``PlayerGUI``.
Without urwid, ``select_metadata`` and ``process_output_options`` fall
back to a line-oriented prompt on stdin with the same call signatures,
and the tools whose -I needs the widgets print
``not_available_message``'s line and exit 1.

The path helpers (``tab_complete``, ``tab_complete_file``,
``pop_directory``), the line-oriented player (``PlayerTTY``), the format
and quality listings and ``xargs_suggestion`` need no urwid.  Nothing
here touches a device: the tools run what the widgets choose.
"""

from __future__ import annotations

import os

from .text import (ERR_OUTPUT_IS_INPUT,
                   ERR_OUTPUT_DUPLICATE_NAME,
                   ERR_OUTPUT_INVALID_FORMAT,
                   LAB_CANCEL_BUTTON,
                   LAB_APPLY_BUTTON,
                   LAB_NEXT_BUTTON,
                   LAB_PREVIOUS_BUTTON,
                   LAB_KEY_NEXT,
                   LAB_KEY_PREVIOUS,
                   LAB_SELECT_BEST_MATCH,
                   LAB_TRACK_METADATA,
                   LAB_OUTPUT_OPTIONS,
                   LAB_AVAILABLE_FORMATS,
                   LAB_AVAILABLE_QUALITIES,
                   LAB_OPTIONS_OUTPUT_DIRECTORY,
                   LAB_OPTIONS_FILENAME_FORMAT,
                   LAB_OPTIONS_AUDIO_CLASS,
                   LAB_OPTIONS_AUDIO_QUALITY,
                   ERR_URWID_REQUIRED,
                   ERR_TERMIOS_ERROR,
                   LAB_PLAY_STATUS,
                   LAB_CHOOSE_METADATA)

try:
    import urwid

    if tuple(getattr(getattr(urwid, "version", None),
                     "VERSION", (1, 0, 0))) < (1, 0, 0):
        raise ImportError()

    AVAILABLE = True
except ImportError:
    AVAILABLE = False


# ---------------------------------------------------------------------------
# urwid-independent helpers
# ---------------------------------------------------------------------------

def tab_complete(path):
    """expands a partially-entered directory path as far as possible;
    returns (expanded path string, completed boolean) — completed is
    True when the result names exactly one directory (reference
    ui.py:873)"""
    (base, remainder) = os.path.split(path)
    if not os.path.isdir(base):
        return (path, False)
    try:
        candidates = sorted(
            d for d in os.listdir(base)
            if d.startswith(remainder) and
            os.path.isdir(os.path.join(base, d)))
    except OSError:
        return (path, False)
    if len(candidates) == 0:
        return (path, False)
    elif len(candidates) == 1:
        return (os.path.join(base, candidates[0]) + os.sep, True)
    else:
        prefix = os.path.commonprefix(candidates)
        return (os.path.join(base, prefix), False)


def tab_complete_file(path):
    """like tab_complete, but matches files as well as directories
    (reference ui.py:905); completion stops at a unique file"""
    (base, remainder) = os.path.split(path)
    if not os.path.isdir(base):
        return (path, False)
    try:
        candidates = sorted(
            d for d in os.listdir(base) if d.startswith(remainder))
    except OSError:
        return (path, False)
    if len(candidates) == 0:
        return (path, False)
    elif len(candidates) == 1:
        target = os.path.join(base, candidates[0])
        if os.path.isdir(target):
            return (target + os.sep, True)
        return (target, True)
    else:
        prefix = os.path.commonprefix(candidates)
        return (os.path.join(base, prefix), False)


def pop_directory(path):
    """removes the final directory element from a path string
    (reference ui.py:939)"""
    path = path.rstrip(os.sep)
    (base, _last) = os.path.split(path)
    if base == "":
        return path
    if base == os.sep:
        return os.sep
    return base + os.sep


def show_available_formats(msg):
    """displays the supported output formats (reference ui.py:2489)"""
    from .dispatch import TYPE_MAP

    msg.info(LAB_AVAILABLE_FORMATS)
    msg.info("")
    rows = [("type", "description")]
    rows.extend(
        (name, TYPE_MAP[name].DESCRIPTION)
        for name in sorted(TYPE_MAP.keys()))
    widths = [max(len(r[i]) for r in rows) for i in range(2)]
    for (i, (name, desc)) in enumerate(rows):
        msg.info("%s %s" % (name.rjust(widths[0]), desc))
        if i == 0:
            msg.info("%s %s" % ("-" * widths[0], "-" * widths[1]))


def show_available_qualities(msg, audiotype):
    """displays the available qualities of the given AudioFile class
    (reference ui.py:2524)"""
    msg.info(LAB_AVAILABLE_QUALITIES % (audiotype.NAME,))
    msg.info("")
    if len(audiotype.COMPRESSION_MODES) <= 1:
        from .text import LAB_NO_QUALITY_SETTINGS
        msg.info(LAB_NO_QUALITY_SETTINGS)
        return
    for mode in audiotype.COMPRESSION_MODES:
        desc = audiotype.COMPRESSION_DESCRIPTIONS.get(mode, "")
        default = (" (default)"
                   if mode == audiotype.DEFAULT_COMPRESSION else "")
        msg.info("%s %s%s" % (mode.rjust(8), desc, default))


def not_available_message(msg):
    """prints a message about the interactive mode being unavailable
    (reference ui.py:2806)"""
    msg.error(ERR_URWID_REQUIRED)


def xargs_suggestion(args):
    """returns a suggested xargs invocation for an overlong argument
    list (reference ui.py:2818): args[0] is the command, and only
    dash options are carried over — the file arguments are expected
    to arrive on xargs' stdin"""
    return ("xargs sh -c '%s %s \"$@\" < /dev/tty'" %
            (os.path.basename(args[0]),
             " ".join(arg for arg in args[1:]
                      if arg.startswith("-"))))


class PlayerTTY:
    """a line-oriented TTY interface for a Player object
    (reference ui.py:2682) — no urwid required"""

    def __init__(self, player):
        self.player = player
        self.track_number = 0
        self.track_total = 0
        self.channels = 0
        self.sample_rate = 0
        self.bits_per_sample = 0

    def previous_track(self):
        raise NotImplementedError()

    def next_track(self):
        raise NotImplementedError()

    def set_metadata(self, track_number, track_total, channels,
                     sample_rate, bits_per_sample):
        self.track_number = track_number
        self.track_total = track_total
        self.channels = channels
        self.sample_rate = sample_rate
        self.bits_per_sample = bits_per_sample

    def toggle_play_pause(self):
        self.player.toggle_play_pause()

    def stop(self):
        self.player.stop()

    def progress(self):
        """returns (frames_sent, frames_total)"""
        return self.player.progress()

    def progress_line(self, frames_sent, frames_total):
        """returns the one-line progress string"""
        if self.sample_rate > 0:
            seconds = frames_sent / self.sample_rate
            total = frames_total / self.sample_rate
        else:
            seconds = total = 0
        return (LAB_PLAY_STATUS %
                {"track_number": self.track_number,
                 "track_total": self.track_total,
                 "minutes": int(seconds) // 60,
                 "seconds": int(seconds) % 60,
                 "total_minutes": int(total) // 60,
                 "total_seconds": int(total) % 60,
                 "channels": self.channels,
                 "sample_rate": self.sample_rate,
                 "bits_per_sample": self.bits_per_sample})

    def run(self, msg, stdin):
        """runs the player loop against a raw-mode stdin until the
        quit key; returns 0 on success"""
        import select
        import time

        try:
            while True:
                (r, _w, _x) = select.select([stdin], [], [], 0.25)
                if r:
                    char = stdin.read(1)
                    if char in (b"q", b"Q", "q", "Q"):
                        self.stop()
                        return 0
                    elif char in (b" ", " "):
                        self.toggle_play_pause()
                    elif char in (b"n", b"N", "n", "N"):
                        self.next_track()
                    elif char in (b"p", b"P", "p", "P"):
                        self.previous_track()
                (sent, total) = self.progress()
                msg.ansi_clearline()
                msg.partial_output(self.progress_line(sent, total))
                if total and sent >= total:
                    try:
                        self.next_track()
                    except NotImplementedError:
                        return 0
                time.sleep(0)
        except (IOError, ValueError) as err:
            msg.error(ERR_TERMIOS_ERROR % {"error": err})
            return 1


# ---------------------------------------------------------------------------
# urwid widget suite
# ---------------------------------------------------------------------------

if AVAILABLE:

    class DownEdit(urwid.Edit):
        """an Edit field where enter moves to the next form element
        (reference ui.py:32)"""

        def keypress(self, size, key):
            return urwid.Edit.keypress(self, size,
                                       "down" if key == "enter"
                                       else key)

    class DownIntEdit(urwid.IntEdit):
        """an IntEdit field where enter moves to the next form
        element (reference ui.py:45)"""

        def keypress(self, size, key):
            return urwid.IntEdit.keypress(self, size,
                                          "down" if key == "enter"
                                          else key)

    class FocusFrame(urwid.Frame):
        """a Frame which reports focus changes (reference ui.py:58)"""

        def __init__(self, *args, **kwargs):
            urwid.Frame.__init__(self, *args, **kwargs)
            self.focus_callback = None

        def set_focus_callback(self, callback):
            self.focus_callback = callback

        def set_focus(self, part):
            urwid.Frame.set_focus(self, part)
            if self.focus_callback is not None:
                self.focus_callback(self, part)

    class OrderedRadioButton(urwid.RadioButton):
        """a RadioButton that knows its neighbors in display order
        (reference ui.py:676)"""

        def __init__(self, ordered_group, group, label, state,
                     on_state_change=None, user_data=None):
            if on_state_change is not None:
                urwid.RadioButton.__init__(self, group, label, state,
                                           on_state_change, user_data)
            else:
                urwid.RadioButton.__init__(self, group, label, state)
            ordered_group.append(self)
            self.ordered_group = ordered_group

        def previous_radio_button(self):
            index = self.ordered_group.index(self)
            return self.ordered_group[index - 1] if index > 0 else None

        def next_radio_button(self):
            index = self.ordered_group.index(self)
            return (self.ordered_group[index + 1]
                    if index + 1 < len(self.ordered_group) else None)

    class LinkedWidgets(urwid.Columns):
        """a field cell that swaps between a shared ("linked") widget
        and the track's own widget via a checkbox (reference
        ui.py:721): checking the box makes the field track the value
        shared by all tracks"""

        def __init__(self, checkbox_group, linked_widget,
                     unlinked_widget, initially_linked):
            self.linked_widget = linked_widget
            self.unlinked_widget = unlinked_widget
            self.checkbox_group = checkbox_group
            self.checkbox = urwid.CheckBox(
                "", state=initially_linked,
                on_state_change=self.swap_link)
            checkbox_group.append(self.checkbox)
            urwid.Columns.__init__(
                self,
                [("fixed", 3, urwid.Text(" : ")),
                 ("weight", 1,
                  linked_widget if initially_linked
                  else unlinked_widget),
                 ("fixed", 4, self.checkbox)])

        def swap_link(self, checkbox, linked):
            if linked:
                # adopting the shared value: if this is the only
                # linked field in the group, seed the shared widget
                # from this track's text
                others = [cb.get_state() for cb in self.checkbox_group
                          if cb is not checkbox]
                if not any(others):
                    self.linked_widget.set_edit_text(
                        self.unlinked_widget.get_edit_text())
                self.contents[1] = (
                    self.linked_widget, self.contents[1][1])
            else:
                # detaching: carry the shared text into the track's
                # own widget so nothing visibly changes
                self.unlinked_widget.set_edit_text(
                    self.linked_widget.get_edit_text())
                self.contents[1] = (
                    self.unlinked_widget, self.contents[1][1])

        def value(self):
            widget = (self.linked_widget
                      if self.checkbox.get_state()
                      else self.unlinked_widget)
            if hasattr(widget, "value") and callable(widget.value):
                return widget.value()
            return widget.get_edit_text()

    class BaseMetaData:
        """one shared edit widget per metadata field, linked into
        every track's row (reference ui.py:774)"""

        def __init__(self, metadata, on_change=None):
            self.metadata = metadata
            self.checkbox_groups = {}
            for field in metadata.FIELDS:
                value = getattr(metadata, field)
                if field in metadata.INTEGER_FIELDS:
                    widget = DownIntEdit(
                        default=value if value is not None else 0)
                else:
                    widget = DownEdit(
                        edit_text=value if value is not None else "")
                if on_change is not None:
                    urwid.connect_signal(widget, "change", on_change)
                setattr(self, field, widget)
                self.checkbox_groups[field] = []

    class TrackMetaData:
        """per-track field widgets, each linkable to the shared base
        (reference ui.py:796)"""

        NEVER_LINK = frozenset(["track_name", "track_number", "ISRC"])

        def __init__(self, metadata, base_metadata, on_change=None):
            from .audiofile import MetaData

            for field in MetaData.FIELDS:
                value = getattr(metadata, field)
                if field in MetaData.INTEGER_FIELDS:
                    widget = DownIntEdit(
                        default=value if value is not None else 0)
                else:
                    widget = DownEdit(
                        edit_text=value if value is not None else "")
                if on_change is not None:
                    urwid.connect_signal(widget, "change", on_change)
                setattr(self, field, LinkedWidgets(
                    checkbox_group=base_metadata.checkbox_groups[field],
                    linked_widget=getattr(base_metadata, field),
                    unlinked_widget=widget,
                    initially_linked=(
                        (field not in self.NEVER_LINK) and
                        (getattr(metadata, field) ==
                         getattr(base_metadata.metadata, field)))))

        def edited_metadata(self):
            """returns a freshly built MetaData from current values"""
            from .audiofile import MetaData

            values = {}
            for attr in MetaData.FIELDS:
                value = getattr(self, attr).value()
                if attr in MetaData.INTEGER_FIELDS:
                    if isinstance(value, str):
                        value = int(value) if value.isdigit() else 0
                    if value > 0:
                        values[attr] = int(value)
                elif value:
                    values[attr] = value
            return MetaData(**values)

    class Swivel:
        """the data of one swivel orientation: which radio column
        appears on the left and which edit widgets on the right
        (reference ui.py:842)"""

        def __init__(self, swivel_type,
                     left_top_widget, left_alignment, left_width,
                     left_radios, left_ids,
                     right_top_widget, right_alignment, right_width,
                     right_widgets):
            assert len(left_ids) == len(right_widgets)
            self.swivel_type = swivel_type
            self.left_top_widget = left_top_widget
            self.left_alignment = left_alignment
            self.left_width = left_width
            self.left_radios = left_radios
            self.left_ids = left_ids
            self.right_top_widget = right_top_widget
            self.right_alignment = right_alignment
            self.right_width = right_width
            self.right_widgets = right_widgets

        def rows(self):
            for (left_id, right_widget) in zip(self.left_ids,
                                               self.right_widgets):
                yield (self.left_radios[left_id], right_widget)

    class MetaDataEditor(urwid.Frame):
        """edits MetaData for a set of tracks with the track/field
        swivel (reference ui.py:473): selecting a track radio shows
        every field of that track; selecting a field radio shows that
        field across every track"""

        def __init__(self, tracks, on_text_change=None,
                     on_swivel_change=None):
            """tracks: list of (id, unicode label, MetaData-or-None)"""
            from .audiofile import MetaData

            self.track_ids = []
            track_labels = []
            field_labels = [(attr, MetaData.FIELD_NAMES[attr])
                            for attr in MetaData.FIELD_ORDER]
            self.metadata_edits = {}

            # fields equal across every track seed the shared base
            base_values = {}
            for (track_id, _label, metadata) in tracks:
                self.track_ids.append(track_id)
                for (attr, value) in (metadata if metadata is not None
                                      else MetaData()).fields():
                    base_values.setdefault(attr, set()).add(value)
            base_metadata = BaseMetaData(
                metadata=MetaData(**{
                    field: tuple(values)[0]
                    for (field, values) in base_values.items()
                    if len(values) == 1}),
                on_change=on_text_change)

            for (track_id, label, metadata) in tracks:
                if track_id in self.metadata_edits:
                    raise ValueError(
                        "same track ID cannot appear twice")
                track_labels.append((track_id, label))
                self.metadata_edits[track_id] = TrackMetaData(
                    metadata=(metadata if metadata is not None
                              else MetaData()),
                    base_metadata=base_metadata,
                    on_change=on_text_change)

            swivel_radios = []
            track_radios_order = []
            track_radios = {}
            field_radios_order = []
            field_radios = {}

            for (track_id, label) in track_labels:
                radio = OrderedRadioButton(track_radios_order,
                                           swivel_radios,
                                           label, False)
                swivel = Swivel(
                    "track",
                    urwid.Text(("label", "fields")), "fixed", 18,
                    field_radios,
                    [field_id for (field_id, _l) in field_labels],
                    urwid.Text(("label", label)), "weight", 1,
                    [getattr(self.metadata_edits[track_id], field_id)
                     for (field_id, _l) in field_labels])
                urwid.connect_signal(radio, "change",
                                     self.activate_swivel, swivel)
                if on_swivel_change is not None:
                    urwid.connect_signal(radio, "change",
                                         on_swivel_change, swivel)
                track_radios[track_id] = radio

            for (field_id, field_label) in field_labels:
                radio = OrderedRadioButton(field_radios_order,
                                           swivel_radios,
                                           field_label, False)
                swivel = Swivel(
                    "field",
                    urwid.Text(("label", "files")), "weight", 1,
                    track_radios,
                    [track_id for (track_id, _l) in track_labels],
                    urwid.Text(("label", field_label)), "weight", 2,
                    [getattr(self.metadata_edits[track_id], field_id)
                     for (track_id, _l) in track_labels])
                urwid.connect_signal(radio, "change",
                                     self.activate_swivel, swivel)
                if on_swivel_change is not None:
                    urwid.connect_signal(radio, "change",
                                         on_swivel_change, swivel)
                field_radios[field_id] = radio

            self.selected_radio = None
            urwid.Frame.__init__(
                self,
                header=urwid.Columns([("fixed", 1, urwid.Text("")),
                                      ("weight", 1, urwid.Text(""))]),
                body=urwid.ListBox(urwid.SimpleListWalker([])))

            if len(self.metadata_edits) != 1:
                field_radios["track_name"].set_state(True)
            else:
                track_radios[track_labels[0][0]].set_state(True)

        def activate_swivel(self, radio_button, selected, swivel):
            if not selected:
                return
            self.selected_radio = radio_button
            self.set_body(urwid.ListBox(urwid.SimpleListWalker(
                [urwid.Columns([(swivel.left_alignment,
                                 swivel.left_width, left),
                                (swivel.right_alignment,
                                 swivel.right_width, right)])
                 for (left, right) in swivel.rows()])))
            self.set_header(urwid.Columns(
                [(swivel.left_alignment, swivel.left_width,
                  swivel.left_top_widget),
                 (swivel.right_alignment, swivel.right_width,
                  swivel.right_top_widget)]))

        def select_previous_item(self):
            if self.selected_radio is not None:
                previous = self.selected_radio.previous_radio_button()
                if previous is not None:
                    previous.set_state(True)

        def select_next_item(self):
            if self.selected_radio is not None:
                nxt = self.selected_radio.next_radio_button()
                if nxt is not None:
                    nxt.set_state(True)

        def metadata(self):
            """yields (track_id, fresh MetaData) per track"""
            for track_id in self.track_ids:
                yield (track_id,
                       self.metadata_edits[track_id].edited_metadata())

    class MetaDataFiller(urwid.Pile):
        """selects among metadata choices and edits the winner
        (reference ui.py:353)"""

        def __init__(self, track_labels, metadata_choices, status):
            """metadata_choices[c][t]: MetaData for choice c, track t;
            all choices must carry the same track count"""
            assert len(metadata_choices) > 0
            assert min(map(len, metadata_choices)) > 0
            assert len(set(map(len, metadata_choices))) == 1

            self.metadata_choices = metadata_choices
            self.status = status

            self.edit_matches = [
                MetaDataEditor(
                    [(i, label, track) for (i, (track, label)) in
                     enumerate(zip(choice, track_labels))],
                    on_swivel_change=self.swiveled)
                for choice in metadata_choices]
            self.selected_match = self.edit_matches[0]

            if len(metadata_choices) > 1:
                matches = []
                radios = [urwid.RadioButton(
                    matches,
                    (choice[0].album_name
                     if choice[0].album_name is not None else ""),
                    on_state_change=self.select_match, user_data=i)
                    for (i, choice) in enumerate(metadata_choices)]
                select_match = urwid.LineBox(
                    urwid.ListBox(urwid.SimpleListWalker(radios)))
                if hasattr(select_match, "set_title"):
                    select_match.set_title(LAB_SELECT_BEST_MATCH)
                widgets = [("fixed", len(metadata_choices) + 2,
                            select_match)]
            else:
                widgets = []

            self.track_metadata = urwid.Frame(
                body=self.edit_matches[0])
            widgets.append(("weight", 1,
                            urwid.LineBox(self.track_metadata,
                                          title=LAB_TRACK_METADATA)))
            urwid.Pile.__init__(self, widgets)

        def select_match(self, radio, selected, match):
            if selected:
                self.selected_match = self.edit_matches[match]
                self.track_metadata.set_body(self.selected_match)

        def swiveled(self, radio_button, selected, swivel):
            if not selected:
                return
            keys = []
            if radio_button.previous_radio_button() is not None:
                keys.append(("key", "F1"))
                keys.append(LAB_KEY_PREVIOUS % (swivel.swivel_type,))
            if radio_button.next_radio_button() is not None:
                if keys:
                    keys.append("   ")
                keys.append(("key", "F2"))
                keys.append(LAB_KEY_NEXT % (swivel.swivel_type,))
            self.status.set_text(keys if keys else "")

        def select_previous_item(self):
            self.selected_match.select_previous_item()

        def select_next_item(self):
            self.selected_match.select_next_item()

        def populated_metadata(self):
            """yields a fresh MetaData per track from the current
            selection and edits"""
            for (_track_id, metadata) in self.selected_match.metadata():
                yield metadata

    class EditDirectory(urwid.Edit):
        """an output-directory field with tab completion and
        ctrl-w directory popping (reference ui.py:1139)"""

        def keypress(self, size, key):
            if key == "tab":
                (text, _done) = tab_complete(self.get_edit_text())
                self.set_edit_text(text)
                self.set_edit_pos(len(text))
                return None
            elif key == "ctrl w":
                text = pop_directory(self.get_edit_text())
                self.set_edit_text(text)
                self.set_edit_pos(len(text))
                return None
            return urwid.Edit.keypress(self, size, key)

    class EditFilename(urwid.Edit):
        """an output-filename field with file tab completion
        (reference ui.py:1420)"""

        def keypress(self, size, key):
            if key == "tab":
                (text, _done) = tab_complete_file(self.get_edit_text())
                self.set_edit_text(text)
                self.set_edit_pos(len(text))
                return None
            return urwid.Edit.keypress(self, size, key)

    class SelectOne(urwid.Pile):
        """a one-of-many selector rendered as a compact radio list
        (the reference's popup SelectOne, ui.py:1043, flattened: the
        popup machinery is a rendering nicety, the selection model is
        identical)"""

        def __init__(self, items, selected_value=None,
                     on_change=None):
            """items: list of (unicode label, value) tuples"""
            self.__select_group__ = []
            self.__radios__ = []
            self.__values__ = {}
            self.__on_change__ = on_change
            rows = []
            for (label, value) in items:
                state = (value == selected_value or
                         (selected_value is None and not rows))
                radio = urwid.RadioButton(
                    self.__select_group__, label, state,
                    on_state_change=self.__changed__,
                    user_data=value)
                self.__values__[id(radio)] = value
                self.__radios__.append(radio)
                rows.append(radio)
            urwid.Pile.__init__(self, rows)

        def __changed__(self, radio, selected, value):
            if selected and self.__on_change__ is not None:
                self.__on_change__(value)

        def selection(self):
            for radio in self.__radios__:
                if radio.get_state():
                    return self.__values__[id(radio)]
            return None

        def set_selection(self, value):
            for radio in self.__radios__:
                if self.__values__[id(radio)] == value:
                    radio.set_state(True)
                    return

    class OutputOptions(urwid.Pile):
        """edits output directory, filename format, audio class and
        quality, with a per-track filename preview that revalidates
        on every change (reference ui.py:1553)"""

        def __init__(self, output_dir, format_string, audio_class,
                     quality, input_filenames, metadatas):
            from .dispatch import TYPE_MAP, Filename

            self.input_filenames = list(input_filenames)
            self.metadatas = list(metadatas)
            self.has_collisions = False
            self.has_duplicates = False
            self.has_errors = False
            self.Filename = Filename

            self.output_directory = EditDirectory(
                edit_text=output_dir)
            urwid.connect_signal(self.output_directory, "change",
                                 self.__edited__)
            self.format_string = DownEdit(edit_text=format_string)
            urwid.connect_signal(self.format_string, "change",
                                 self.__edited__)
            self.audio_class = SelectOne(
                sorted([(cls.DESCRIPTION, cls)
                        for cls in set(TYPE_MAP.values())],
                       key=lambda pair: pair[0]),
                audio_class, on_change=self.__class_changed__)
            self.quality = SelectOne(
                [(q if q else "(default)", q)
                 for q in audio_class.COMPRESSION_MODES],
                quality)
            self.output_filenames = urwid.Pile(
                [urwid.Text("") for _ in self.input_filenames])

            urwid.Pile.__init__(self, [
                urwid.Columns([
                    ("fixed", 20,
                     urwid.Text(LAB_OPTIONS_OUTPUT_DIRECTORY)),
                    ("weight", 1, self.output_directory)]),
                urwid.Columns([
                    ("fixed", 20,
                     urwid.Text(LAB_OPTIONS_FILENAME_FORMAT)),
                    ("weight", 1, self.format_string)]),
                urwid.Columns([
                    ("fixed", 20,
                     urwid.Text(LAB_OPTIONS_AUDIO_CLASS)),
                    ("weight", 1, self.audio_class)]),
                urwid.Columns([
                    ("fixed", 20,
                     urwid.Text(LAB_OPTIONS_AUDIO_QUALITY)),
                    ("weight", 1, self.quality)]),
                self.output_filenames])
            self.__update_filenames__()

        def __class_changed__(self, new_class):
            self.quality = SelectOne(
                [(q if q else "(default)", q)
                 for q in new_class.COMPRESSION_MODES],
                new_class.DEFAULT_COMPRESSION)
            self.contents[3] = (
                urwid.Columns([
                    ("fixed", 20,
                     urwid.Text(LAB_OPTIONS_AUDIO_QUALITY)),
                    ("weight", 1, self.quality)]),
                self.contents[3][1])
            self.__update_filenames__()

        def __edited__(self, _widget=None, _text=None):
            self.__update_filenames__(
                directory=(_text if _widget is self.output_directory
                           else None),
                format_string=(_text if _widget is self.format_string
                               else None))

        def set_metadatas(self, metadatas):
            assert len(metadatas) == len(self.input_filenames)
            self.metadatas = list(metadatas)
            self.__update_filenames__()

        def __update_filenames__(self, directory=None,
                                 format_string=None):
            cls = self.audio_class.selection()
            directory = (directory if directory is not None
                         else self.output_directory.get_edit_text())
            template = (format_string if format_string is not None
                        else self.format_string.get_edit_text())
            filenames = []
            self.has_errors = False
            for (filename, metadata) in zip(self.input_filenames,
                                            self.metadatas):
                try:
                    name = cls.track_name(
                        file_path=str(filename),
                        track_metadata=metadata,
                        format=template)
                    filenames.append(self.Filename(
                        os.path.join(directory, name)))
                except (KeyError, ValueError, Exception):
                    self.has_errors = True
                    filenames.append(None)
            self.__filenames__ = filenames
            self.has_duplicates = (
                len([f for f in filenames if f is not None]) !=
                len(set(f for f in filenames if f is not None)))
            self.has_collisions = any(
                f in set(self.input_filenames)
                for f in filenames if f is not None)
            for (text_widget, f) in zip(
                    [w for (w, _o) in self.output_filenames.contents],
                    filenames):
                text_widget.set_text(str(f) if f is not None else "?")

        def selected_options(self):
            """returns (audio class, quality, list of Filenames)"""
            return (self.audio_class.selection(),
                    self.quality.selection(),
                    list(self.__filenames__))

    class SingleOutputOptions(urwid.Pile):
        """output filename, class and quality for one track
        (reference ui.py:1814)"""

        def __init__(self, output_filename, audio_class, quality):
            from .dispatch import TYPE_MAP, Filename

            self.Filename = Filename
            self.output_filename = EditFilename(
                edit_text=str(output_filename))
            self.audio_class = SelectOne(
                sorted([(cls.DESCRIPTION, cls)
                        for cls in set(TYPE_MAP.values())],
                       key=lambda pair: pair[0]),
                audio_class)
            self.quality = SelectOne(
                [(q if q else "(default)", q)
                 for q in audio_class.COMPRESSION_MODES],
                quality)
            urwid.Pile.__init__(self, [
                urwid.Columns([
                    ("fixed", 20, urwid.Text("filename")),
                    ("weight", 1, self.output_filename)]),
                urwid.Columns([
                    ("fixed", 20, urwid.Text("type")),
                    ("weight", 1, self.audio_class)]),
                urwid.Columns([
                    ("fixed", 20, urwid.Text("quality")),
                    ("weight", 1, self.quality)])])

        def selected_options(self):
            """returns (audio class, quality, Filename)"""
            return (self.audio_class.selection(),
                    self.quality.selection(),
                    self.Filename(
                        self.output_filename.get_edit_text()))

    class Wizard(urwid.Frame):
        """pages widgets with previous/next/cancel/completion buttons
        (reference ui.py:1926)"""

        def __init__(self, pages, cancel_button, completion_button,
                     page_changed=None):
            assert len(pages) > 0
            self.pages = list(pages)
            self.cancel_button = cancel_button
            self.completion_button = completion_button
            self.page_changed = page_changed
            self.__current__ = 0
            urwid.Frame.__init__(self, body=self.pages[0],
                                 footer=self.__buttons__())

        def __buttons__(self):
            buttons = [("weight", 1, self.cancel_button)]
            if self.__current__ > 0:
                buttons.append(
                    ("weight", 1,
                     urwid.Button(LAB_PREVIOUS_BUTTON,
                                  on_press=self.previous_page)))
            if self.__current__ < len(self.pages) - 1:
                buttons.append(
                    ("weight", 1,
                     urwid.Button(LAB_NEXT_BUTTON,
                                  on_press=self.next_page)))
            else:
                buttons.append(("weight", 1, self.completion_button))
            return urwid.Columns(buttons, dividechars=2)

        def __show_page__(self):
            page = self.pages[self.__current__]
            self.set_body(page)
            self.set_footer(self.__buttons__())
            if self.page_changed is not None:
                self.page_changed(page)

        def next_page(self, _button=None):
            if self.__current__ < len(self.pages) - 1:
                self.__current__ += 1
                self.__show_page__()

        def previous_page(self, _button=None):
            if self.__current__ > 0:
                self.__current__ -= 1
                self.__show_page__()

    class OutputFiller(urwid.Frame):
        """the full interactive flow for multiple tracks: metadata
        selection/editing, then output options (reference ui.py:89)"""

        def __init__(self, track_labels, metadata_choices,
                     input_filenames, output_directory, format_string,
                     output_class, quality,
                     completion_label=LAB_APPLY_BUTTON):
            assert len(track_labels) == len(input_filenames)
            assert len(metadata_choices) > 0
            assert len(metadata_choices[0]) == len(input_filenames)

            self.__cancelled__ = True

            self.metadata_status = urwid.Text("")
            self.options_status = urwid.Text("")

            self.metadata = MetaDataFiller(track_labels,
                                           metadata_choices,
                                           self.metadata_status)
            self.options = OutputOptions(
                output_dir=output_directory,
                format_string=format_string,
                audio_class=output_class,
                quality=quality,
                input_filenames=input_filenames,
                metadatas=[None for _ in input_filenames])

            self.wizard = Wizard(
                [self.metadata, self.options],
                urwid.Button(LAB_CANCEL_BUTTON, on_press=self.exit),
                urwid.Button(completion_label, on_press=self.complete),
                self.page_changed)
            urwid.Frame.__init__(self, body=self.wizard,
                                 footer=self.metadata_status)

        def page_changed(self, new_page):
            if new_page is self.metadata:
                self.set_footer(self.metadata_status)
            elif new_page is self.options:
                self.options.set_metadatas(
                    list(self.metadata.populated_metadata()))
                self.set_footer(self.options_status)

        def exit(self, _button=None):
            self.__cancelled__ = True
            raise urwid.ExitMainLoop()

        def complete(self, _button=None):
            if self.options.has_collisions:
                self.options_status.set_text(
                    ERR_OUTPUT_IS_INPUT % {"filename": ""})
            elif self.options.has_duplicates:
                self.options_status.set_text(ERR_OUTPUT_DUPLICATE_NAME)
            elif self.options.has_errors:
                self.options_status.set_text(ERR_OUTPUT_INVALID_FORMAT)
            else:
                self.__cancelled__ = False
                raise urwid.ExitMainLoop()

        def cancelled(self):
            return self.__cancelled__

        def handle_text(self, key):
            if self.get_footer() is self.metadata_status:
                if key == "f1":
                    self.metadata.select_previous_item()
                elif key == "f2":
                    self.metadata.select_next_item()

        def output_tracks(self):
            """yields (output_class, output_filename, quality,
            metadata) per input file; MetaData objects are new"""
            (cls, quality, filenames) = self.options.selected_options()
            for (metadata, filename) in zip(
                    self.metadata.populated_metadata(), filenames):
                yield (cls, filename, quality, metadata)

    class SingleOutputFiller(urwid.Frame):
        """the interactive flow for one track (reference ui.py:234)"""

        def __init__(self, track_label, metadata_choices,
                     input_filenames, output_file, output_class,
                     quality, completion_label=LAB_APPLY_BUTTON):
            assert len(metadata_choices) > 0
            self.input_filenames = set(input_filenames)
            self.__cancelled__ = True
            self.status = urwid.Text("")

            self.options = SingleOutputOptions(
                output_filename=output_file,
                audio_class=output_class,
                quality=quality)
            self.metadata = MetaDataFiller(
                track_labels=[track_label],
                metadata_choices=[[m] for m in metadata_choices],
                status=self.status)

            buttons = urwid.Columns(
                [("weight", 1,
                  urwid.Button(LAB_CANCEL_BUTTON, on_press=self.exit)),
                 ("weight", 2,
                  urwid.Button(completion_label,
                               on_press=self.complete))],
                dividechars=3)

            body = urwid.Pile(
                [("weight", 1, self.metadata),
                 ("pack", urwid.LineBox(self.options,
                                        title=LAB_OUTPUT_OPTIONS)),
                 ("pack", buttons)])
            urwid.Frame.__init__(self, body=body, footer=self.status)

        def exit(self, _button=None):
            self.__cancelled__ = True
            raise urwid.ExitMainLoop()

        def complete(self, _button=None):
            output_filename = self.options.selected_options()[2]
            if output_filename in self.input_filenames:
                self.status.set_text(
                    ERR_OUTPUT_IS_INPUT %
                    {"filename": str(output_filename)})
            else:
                self.__cancelled__ = False
                raise urwid.ExitMainLoop()

        def cancelled(self):
            return self.__cancelled__

        def handle_text(self, key):
            if key == "esc":
                self.exit()
            elif key == "f1":
                self.metadata.select_previous_item()
            elif key == "f2":
                self.metadata.select_next_item()

        def output_track(self):
            """returns (output_class, output_filename, quality,
            metadata)"""
            (cls, quality, filename) = self.options.selected_options()
            return (cls, filename, quality,
                    list(self.metadata.populated_metadata())[0])

    class PlayerGUI(urwid.Frame):
        """interactive player frame (reference ui.py:2178): metadata
        rows, a progress bar, play/pause + previous/next buttons and a
        track list of radio buttons.

        player is a Player-compatible object (open/play/
        toggle_play_pause/stop/progress/state); tracks is a list of
        (label, seconds, audiofile) tuples."""

        def __init__(self, player, tracks, total_seconds):
            from .text import (LAB_PLAY_BUTTON, LAB_PAUSE_BUTTON,
                               LAB_STOP_BUTTON, LAB_PLAY_TRACK,
                               METADATA_TRACK_NAME)
            from .player import PLAYER_PLAYING

            self._playing_state = PLAYER_PLAYING
            self._play_label = LAB_PLAY_BUTTON
            self._pause_label = LAB_PAUSE_BUTTON
            self.player = player
            self.tracks = list(tracks)
            self.track_index = -1
            self.track_name = urwid.Text("")
            self.track_number = urwid.Text("")
            self.progress = urwid.ProgressBar("pg normal",
                                              "pg complete", 0, 100)
            self.play_pause_button = urwid.Button(
                LAB_PLAY_BUTTON, on_press=self.play_pause)
            self.stop_button = urwid.Button(
                LAB_STOP_BUTTON, on_press=self.stop)
            previous_button = urwid.Button(
                LAB_PREVIOUS_BUTTON, on_press=self.previous_track)
            next_button = urwid.Button(
                LAB_NEXT_BUTTON, on_press=self.next_track)

            group = []
            self.track_buttons = [
                urwid.RadioButton(group, label, state=False,
                                  on_state_change=self.select_track,
                                  user_data=index)
                for (index, (label, _seconds, _track))
                in enumerate(self.tracks)]

            header = urwid.Pile([
                urwid.Columns([
                    ("fixed", len(METADATA_TRACK_NAME) + 3,
                     urwid.Text(("label",
                                 "%s : " % (METADATA_TRACK_NAME,)),
                                align="right")),
                    ("weight", 1, self.track_name)]),
                urwid.Columns([
                    ("fixed", len(LAB_PLAY_TRACK) + 3,
                     urwid.Text(("label", "%s : " % (LAB_PLAY_TRACK,)),
                                align="right")),
                    ("weight", 1, self.track_number)]),
                self.progress,
                urwid.Columns([previous_button,
                               self.play_pause_button,
                               self.stop_button,
                               next_button])])
            urwid.Frame.__init__(
                self,
                body=urwid.ListBox(
                    urwid.SimpleFocusListWalker(self.track_buttons)),
                header=header)

        def select_track(self, _radio, selected, index):
            if selected:
                self._open_index(index)
                self.player.play()

        def _open_index(self, index):
            (label, _seconds, track) = self.tracks[index]
            self.track_index = index
            self.track_name.set_text(label)
            self.track_number.set_text(
                "%d/%d" % (index + 1, len(self.tracks)))
            self.player.open(track)

        def play_pause(self, _button=None):
            if self.track_index < 0:
                self._open_index(0)
                self.track_buttons[0].set_state(True,
                                                do_callback=False)
            self.player.toggle_play_pause()

        def stop(self, _button=None):
            self.player.stop()

        def previous_track(self, _button=None):
            if self.track_index > 0:
                self.track_buttons[self.track_index - 1].set_state(
                    True)

        def next_track(self, _button=None):
            if 0 <= self.track_index < len(self.tracks) - 1:
                self.track_buttons[self.track_index + 1].set_state(
                    True)
            else:
                self.player.stop()

        def on_track_finished(self):
            """thread-safe end-of-track notice (wire as the Player's
            next_track_callback — it fires on the worker thread, so
            only a flag is set here; the alarm tick advances)"""
            self._advance_pending = True

        def update_status(self):
            """poll hook (run on a MainLoop alarm): progress bar +
            play/pause button label + end-of-track auto-advance"""
            (sent, total) = self.player.progress()
            if total:
                self.progress.set_completion(
                    min(100 * sent // total, 100))
            playing = (self.player.state() == self._playing_state)
            label = (self._pause_label if playing
                     else self._play_label)
            try:
                self.play_pause_button.set_label(label)
            except AttributeError:
                self.play_pause_button.label = label
            # end-of-track: the threaded Player flips to STOPPED in
            # the same worker iteration that plays the final buffer,
            # so by this tick `playing` is already False — advance on
            # the callback latch, or on a completed progress counter
            # (the worker leaves frames_played == total at natural
            # EOF; an explicit stop() resets it to 0)
            if self.track_index >= 0 and (
                    getattr(self, "_advance_pending", False) or
                    (total > 1 and sent >= total)):
                self._advance_pending = False
                self.next_track()

    def urwid_style():
        """the shared palette (reference ui.py:2470)"""
        return [("label", "default,bold", "default"),
                ("key", "white,bold", "dark blue"),
                ("reversed", "standout", "")]


# ---------------------------------------------------------------------------
# entry points shared with the line-oriented fallback
# ---------------------------------------------------------------------------

def select_metadata(metadata_choices, msg, use_default=False):
    """given a nonempty list of metadata choices (each a list of
    MetaData per track), returns the selected choice
    (reference ui.py:2571)"""
    assert len(metadata_choices) > 0
    if (len(metadata_choices) == 1) or use_default:
        return metadata_choices[0]

    if AVAILABLE:
        status = urwid.Text("")
        filler = MetaDataFiller(
            ["track %d" % (i + 1,)
             for i in range(len(metadata_choices[0]))],
            metadata_choices, status)
        result = {"choice": None}

        def unhandled(key):
            if key == "f1":
                filler.select_previous_item()
            elif key == "f2":
                filler.select_next_item()
            elif key == "enter":
                result["choice"] = list(filler.populated_metadata())
                raise urwid.ExitMainLoop()
            elif key == "esc":
                raise urwid.ExitMainLoop()

        frame = urwid.Frame(body=filler, footer=status)
        urwid.MainLoop(frame, urwid_style(),
                       unhandled_input=unhandled).run()
        if result["choice"] is not None:
            return result["choice"]
        return metadata_choices[0]

    # line-oriented fallback
    msg.output(LAB_CHOOSE_METADATA)
    for (i, choice) in enumerate(metadata_choices):
        first = choice[0]
        msg.output("%d) %s / %s" % (i + 1,
                                    first.album_name or "<untitled>",
                                    first.artist_name or "<unknown>"))
    try:
        selection = int(input("choice [1]: ") or "1") - 1
    except (ValueError, EOFError):
        selection = 0
    selection = max(min(selection, len(metadata_choices) - 1), 0)
    return metadata_choices[selection]


def process_output_options(metadata_choices, input_filenames,
                           output_directory, format_string,
                           output_class, quality, msg,
                           use_default=False):
    """yields (output_class, output_filename, quality, metadata)
    per track (reference ui.py:2602)"""
    metadatas = select_metadata(metadata_choices, msg, use_default)
    for (metadata, filename) in zip(metadatas, input_filenames):
        output_filename = os.path.join(
            output_directory,
            output_class.track_name(file_path=str(filename),
                                    track_metadata=metadata,
                                    format=format_string))
        yield (output_class, output_filename, quality, metadata)
