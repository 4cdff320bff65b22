"""The strings the port's tools print: the package's ``text`` (every
string of the reference's), under the module name the tools import
them from."""

from ..text import *  # noqa: F401,F403
