"""Small public helpers of the package root, copied from the
reference's ``audiotools_tpu/utils/helpers.py``: iteration utilities,
display formatting and process helpers that Python Audio Tools exports
as part of its public API."""

from __future__ import annotations

import os


def get_umask():
    """returns the current file-creation umask as an integer

    (reference __init__.py:266 — reading the umask requires setting
    it, so set-and-restore)"""
    mask = os.umask(0)
    os.umask(mask)
    return mask


def khz(hz):
    """formats an integer Hz sample rate as a kHz string
    (reference __init__.py:473): 44100 -> "44.1kHz", 48000 -> "48kHz"
    """
    (num, rem) = divmod(hz, 1000)
    tenth = rem // 100
    if tenth == 0:
        return "%dkHz" % (num,)
    return "%d.%dkHz" % (num, tenth)


def at_a_time(total, per):
    """yields "per" integers from "total" until exhausted
    (reference __init__.py:4482)

    >>> list(at_a_time(10, 3))
    [3, 3, 3, 1]
    """
    for _ in range(total // per):
        yield per
    yield total % per


def iter_first(iterator):
    """yields (is_first, item) per item; (True, None) when empty
    (reference __init__.py:4495)"""
    iterator = iter(iterator)
    try:
        item = next(iterator)
    except StopIteration:
        yield (True, None)
        return
    yield (True, item)
    for item in iterator:
        yield (False, item)


def iter_last(iterator):
    """yields (is_last, item) per item; (True, None) when empty
    (reference __init__.py:4518)"""
    iterator = iter(iterator)
    try:
        cached = next(iterator)
    except StopIteration:
        yield (True, None)
        return
    for item in iterator:
        yield (False, cached)
        cached = item
    yield (True, cached)


def most_numerous(item_list, empty_list=None, all_differ=None):
    """returns the most frequent value in the list; ``empty_list``
    for an empty list, ``all_differ`` when every item is unique
    (reference __init__.py:5012)"""
    if len(item_list) == 0:
        return empty_list
    counts = {}
    for item in item_list:
        counts[item] = counts.get(item, 0) + 1
    (item, count) = max(counts.items(), key=lambda kv: kv[1])
    if count == 1 and len(item_list) > 1:
        return all_differ
    return item


def ignore_sigint():
    """sets SIGINT to SIG_IGN (reference __init__.py:2915): child
    encoder processes ignore ^C so the parent can shut down cleanly"""
    import signal
    signal.signal(signal.SIGINT, signal.SIG_IGN)
