"""Both packages' ``ui`` modules reloaded with or without urwid.

``tests/test_ui_widgets.py`` puts ``tests/urwid_shim.py`` into
``sys.modules`` as ``urwid`` when it is collected, and reloads the
reference's ``ui``, so any later test in the same worker sees urwid.
``urwid_as(module)`` sets ``sys.modules["urwid"]`` to ``module`` (None:
urwid does not import), reloads both ``ui`` modules, and on leaving puts
``sys.modules`` back and reloads them again, whichever worker it runs in.
"""

import contextlib
import importlib
import sys

_MISSING = object()


def _reload_both():
    import audiotools_tpu.ui as ref_ui
    import audiotools_tpu_torch.ui as port_ui
    return (importlib.reload(ref_ui), importlib.reload(port_ui))


@contextlib.contextmanager
def urwid_as(module):
    saved = sys.modules.get("urwid", _MISSING)
    sys.modules["urwid"] = module
    try:
        yield _reload_both()
    finally:
        if saved is _MISSING:
            del sys.modules["urwid"]
        else:
            sys.modules["urwid"] = saved
        _reload_both()


@contextlib.contextmanager
def canned_lookups(replies=None):
    """``urllib.request.urlopen`` answered by a ``CannedServer`` of
    ``replies`` (none: every server unreachable) and sockets refused, for
    both packages' -M; yields the server"""
    import socket
    import urllib.request
    from torch_disc_helpers import CannedServer, no_socket
    server = CannedServer(replies)
    saved = (urllib.request.urlopen, socket.create_connection)
    urllib.request.urlopen = server.urlopen
    socket.create_connection = no_socket
    try:
        yield server
    finally:
        (urllib.request.urlopen, socket.create_connection) = saved
