"""Replacing a file's contents at once.

The port's copy of ``TemporaryFile`` and ``make_dirs`` from the
reference's ``audiotools_tpu/utils/files.py``.  ``TemporaryFile``: the new contents are written to a
temporary file in the same directory, which ``close`` renames over the
file, keeping its mode.  Used as a context manager, it is closed when
the block ends and discarded when the block raises, so a failed rewrite
leaves the file as it was.
"""

from __future__ import annotations

import os
import tempfile


class TemporaryFile:
    """a binary file that replaces ``final_filename`` when closed"""

    def __init__(self, final_filename):
        self.__final_filename__ = final_filename
        try:
            self.__final_mode__ = os.stat(final_filename).st_mode
        except OSError:
            self.__final_mode__ = None
        (handle, self.__temp_filename__) = tempfile.mkstemp(
            prefix="." + os.path.basename(final_filename) + "-",
            dir=os.path.dirname(final_filename) or ".")
        self.__file__ = os.fdopen(handle, "wb")

    def write(self, data):
        return self.__file__.write(data)

    def flush(self):
        self.__file__.flush()

    def tell(self):
        return self.__file__.tell()

    def seek(self, offset, whence=0):
        return self.__file__.seek(offset, whence)

    def close(self):
        """renames the written contents over the file"""
        self.__file__.close()
        if self.__final_mode__ is not None:
            os.chmod(self.__temp_filename__, self.__final_mode__)
        os.replace(self.__temp_filename__, self.__final_filename__)
        self.__temp_filename__ = None

    def discard(self):
        """removes the temporary file; the file is left as it was"""
        self.__file__.close()
        if self.__temp_filename__ is not None:
            if os.path.exists(self.__temp_filename__):
                os.unlink(self.__temp_filename__)
            self.__temp_filename__ = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.discard()

    def __del__(self):
        if getattr(self, "__temp_filename__", None) is not None:
            self.discard()


def make_dirs(destination_path):
    """creates the directories leading to ``destination_path``"""
    dirname = os.path.dirname(destination_path)
    if (dirname != '') and (not os.path.isdir(dirname)):
        os.makedirs(dirname, exist_ok=True)
