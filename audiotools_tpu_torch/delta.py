"""Undo database: reversible binary patches for destructive edits.

A copy of the reference's ``audiotools_tpu/delta.py``: an sqlite3
database of bz2-compressed XOR patches of whole files, stored both
ways so that a file can be rolled back (or forward) between its old
and new forms; rows are keyed by the (sha1, size) pair of either side.
``tracklint --fix --db`` records each repair in one, and ``--undo``
gives back the old bytes exactly (a file rewritten whole, as ALAC's
tags rewrite it, among them).  The two packages' databases read each
other's.
"""

from __future__ import annotations

import base64
import bz2
import sqlite3
from hashlib import sha1

import numpy as np


class UndoDB:
    """performs undo operations on files via stored binary patches"""

    def __init__(self, filename):
        """filename is the on-disk location of the database"""
        self.db = sqlite3.connect(filename)
        self.cursor = self.db.cursor()
        self.cursor.execute(
            """CREATE TABLE IF NOT EXISTS patch (
                 patch_id INTEGER PRIMARY KEY AUTOINCREMENT,
                 patch_data BLOB NOT NULL)""")
        self.cursor.execute(
            """CREATE TABLE IF NOT EXISTS source_file (
                 source_checksum CHAR(40) PRIMARY KEY,
                 source_size INTEGER NOT NULL,
                 target_size INTEGER NOT NULL,
                 patch_id INTEGER,
                 FOREIGN KEY (patch_id) REFERENCES patch (patch_id)
                   ON DELETE CASCADE)""")

    def close(self):
        self.cursor.close()
        self.db.close()

    @staticmethod
    def build_patch(data1, data2):
        """returns a bz2-compressed XOR patch between two byte strings

        the inputs are zero-padded to equal length; applying the same
        patch converts either side into the other"""
        length = max(len(data1), len(data2))
        a = np.frombuffer(data1.ljust(length, b"\x00"), dtype=np.uint8)
        b = np.frombuffer(data2.ljust(length, b"\x00"), dtype=np.uint8)
        return bz2.compress((a ^ b).tobytes())

    @staticmethod
    def apply_patch(data, patch, new_length):
        """applies a patch, returning the transformed bytes

        new_length is the target side's original size (stored
        externally from the patch)"""
        raw = bz2.decompress(patch)
        padded = data[:len(raw)].ljust(len(raw), b"\x00")
        a = np.frombuffer(padded, dtype=np.uint8)
        b = np.frombuffer(raw, dtype=np.uint8)
        return (a ^ b).tobytes()[:new_length]

    def __add_patch__(self, data1, data2):
        patch = base64.b64encode(
            self.build_patch(data1, data2)).decode("ascii")
        self.cursor.execute(
            "INSERT INTO patch (patch_id, patch_data) VALUES (?, ?)",
            [None, patch])
        patch_id = self.cursor.lastrowid
        try:
            for (src, dst) in ((data1, data2), (data2, data1)):
                self.cursor.execute(
                    """INSERT INTO source_file (source_checksum,
                       source_size, target_size, patch_id)
                       VALUES (?, ?, ?, ?)""",
                    [sha1(src).hexdigest(), len(src), len(dst),
                     patch_id])
            self.db.commit()
        except sqlite3.IntegrityError:
            self.db.rollback()

    def __lookup__(self, data):
        self.cursor.execute(
            """SELECT target_size, patch_data
               FROM source_file, patch
               WHERE ((source_checksum = ?) AND (source_size = ?) AND
                      (source_file.patch_id = patch.patch_id))""",
            [sha1(data).hexdigest(), len(data)])
        return self.cursor.fetchone()

    def add(self, old_path, new_path):
        """records a patch from the old file to the new file"""
        with open(old_path, "rb") as f:
            old_data = f.read()
        with open(new_path, "rb") as f:
            new_data = f.read()
        self.__add_patch__(old_data, new_data)

    def undo(self, path):
        """restores the file at path to its stored counterpart

        returns True if a patch was found and applied"""
        with open(path, "rb") as f:
            data = f.read()
        row = self.__lookup__(data)
        if row is None:
            return False
        (target_size, patch) = row
        restored = self.apply_patch(
            data, base64.b64decode(patch.encode("ascii")),
            target_size)
        with open(path, "wb") as f:
            f.write(restored)
        return True
