"""M4A atoms: the QuickTime atom tree and the iTunes items that hold an
M4A file's tags.

A copy of the reference's ``audiotools_tpu/meta/m4a_atoms.py``: leaf
and tree atoms that parse and build to the same bytes, ``parse_atoms``,
the ``ilst`` entry atoms and ``M4A_META_Atom``, which maps the items
(\xa9nam, \xa9alb, \xa9ART, \xa9wrt, cprt, \xa9day, \xa9cmt, trkn, disk,
covr) onto the MetaData fields.
"""

from __future__ import annotations

import struct

from .. import VERSION
from ..audiofile import Image, MetaData
from .image import InvalidImage, image_metrics

# atoms whose payloads are themselves atom sequences
CONTAINER_ATOMS = {b"moov", b"trak", b"mdia", b"minf", b"dinf",
                   b"stbl", b"udta", b"ilst"}


class M4A_Leaf_Atom:
    def __init__(self, name, data):
        self.name = name
        self.data = data

    def __repr__(self):
        return "M4A_Leaf_Atom(%r, %d bytes)" % (self.name,
                                                len(self.data))

    def __eq__(self, other):
        return (getattr(other, "name", None) == self.name and
                getattr(other, "data", None) == self.data)

    def copy(self):
        return M4A_Leaf_Atom(self.name, self.data)

    def size(self):
        return len(self.data)

    def build(self):
        return (struct.pack(">I", self.size() + 8) + self.name +
                self.data)


class M4A_Tree_Atom:
    def __init__(self, name, leaf_atoms):
        self.name = name
        self.leaf_atoms = list(leaf_atoms)

    def __repr__(self):
        return "M4A_Tree_Atom(%r, %r)" % (self.name, self.leaf_atoms)

    def __iter__(self):
        return iter(self.leaf_atoms)

    def copy(self):
        return M4A_Tree_Atom(self.name,
                             [leaf.copy() for leaf in self.leaf_atoms])

    def __getitem__(self, atom_name):
        return self.get_child(atom_name)

    def get_child(self, atom_name):
        for leaf in self.leaf_atoms:
            if leaf.name == atom_name:
                return leaf
        raise KeyError(atom_name)

    def has_child(self, atom_name):
        return any(leaf.name == atom_name for leaf in self.leaf_atoms)

    def add_child(self, atom):
        self.leaf_atoms.append(atom)

    def remove_child(self, atom_name):
        """removes the first child named ``atom_name``, if any"""
        for (i, leaf) in enumerate(self.leaf_atoms):
            if leaf.name == atom_name:
                del self.leaf_atoms[i]
                return

    def replace_child(self, atom):
        for (i, leaf) in enumerate(self.leaf_atoms):
            if leaf.name == atom.name:
                self.leaf_atoms[i] = atom
                return
        self.leaf_atoms.append(atom)

    def child_offset(self, *path):
        """the byte offset of the data of the child at ``path`` (atom
        names, outermost first) within this atom's data"""
        offset = 0
        tree = self
        for name in path:
            for leaf in tree.leaf_atoms:
                if leaf.name == name:
                    offset += 8
                    tree = leaf
                    break
                offset += 8 + leaf.size()
            else:
                raise KeyError(name)
        return offset

    def size(self):
        return sum(8 + leaf.size() for leaf in self.leaf_atoms)

    def build(self):
        payload = b"".join(leaf.build() for leaf in self.leaf_atoms)
        return struct.pack(">I", len(payload) + 8) + self.name + payload


def parse_atoms(data, in_ilst=False):
    """parses a byte string into a list of atom objects"""
    atoms = []
    pos = 0
    while pos + 8 <= len(data):
        (size, name) = struct.unpack(">I4s", data[pos:pos + 8])
        if size < 8:
            break
        payload = data[pos + 8:pos + size]
        if name == b"meta" and not in_ilst:
            (version_flags,) = struct.unpack(">I", payload[0:4])
            atoms.append(M4A_META_Atom(
                version_flags >> 24, version_flags & 0xFFFFFF,
                parse_atoms(payload[4:])))
        elif name in CONTAINER_ATOMS:
            atoms.append(M4A_Tree_Atom(
                name, parse_atoms(payload, in_ilst=(name == b"ilst"))))
        elif in_ilst:
            atoms.append(M4A_ILST_Leaf_Atom(name, parse_atoms(payload)))
        else:
            atoms.append(M4A_Leaf_Atom(name, payload))
        pos += size
    return atoms


class M4A_ILST_Leaf_Atom(M4A_Tree_Atom):
    """an ilst entry (e.g. ©nam) containing 'data' sub-atoms"""

    def copy(self):
        return M4A_ILST_Leaf_Atom(
            self.name, [leaf.copy() for leaf in self.leaf_atoms])

    def data_atom(self):
        for leaf in self.leaf_atoms:
            if leaf.name == b"data":
                return leaf
        return None

    def __str__(self):
        data = self.data_atom()
        if data is None:
            return ""
        payload = data.data[8:]
        (data_type,) = struct.unpack(">I", data.data[0:4])
        if (data_type & 0xFF) == 1:
            return payload.decode("utf-8", "replace")
        else:
            return repr(payload)


def ilst_string_atom(name, text):
    """builds an ilst text entry"""
    payload = (struct.pack(">I", 1) + b"\x00" * 4 +
               text.encode("utf-8"))
    return M4A_ILST_Leaf_Atom(name, [M4A_Leaf_Atom(b"data", payload)])


def ilst_binary_atom(name, data, data_type=0):
    payload = struct.pack(">I", data_type) + b"\x00" * 4 + data
    return M4A_ILST_Leaf_Atom(name, [M4A_Leaf_Atom(b"data", payload)])


def ilst_trkn_atom(name, number, total):
    data = struct.pack(">HHHH", 0, number or 0, total or 0, 0)
    return ilst_binary_atom(name, data)


class M4A_META_Atom(MetaData, M4A_Tree_Atom):
    """the meta atom: MetaData interface over iTunes ilst entries"""

    UNICODE_ATTRIB_TO_ILST = {"track_name": b"\xa9nam",
                              "album_name": b"\xa9alb",
                              "artist_name": b"\xa9ART",
                              "composer_name": b"\xa9wrt",
                              "copyright": b"cprt",
                              "year": b"\xa9day",
                              "comment": b"\xa9cmt"}

    INT_ATTRIB_TO_ILST = {"track_number": b"trkn",
                          "album_number": b"disk"}

    TOTAL_ATTRIB_TO_ILST = {"track_total": b"trkn",
                            "album_total": b"disk"}

    def __init__(self, version, flags, leaf_atoms):
        M4A_Tree_Atom.__init__(self, b"meta", leaf_atoms)
        self.__dict__["version"] = version
        self.__dict__["flags"] = flags

    def __repr__(self):
        return "M4A_META_Atom(%r, %r, %r)" % (self.version, self.flags,
                                              self.leaf_atoms)

    def copy(self):
        return M4A_META_Atom(self.version, self.flags,
                             [leaf.copy() for leaf in self.leaf_atoms])

    def size(self):
        return 4 + M4A_Tree_Atom.size(self)

    def build(self):
        payload = b"".join(leaf.build() for leaf in self.leaf_atoms)
        return (struct.pack(">I", len(payload) + 12) + b"meta" +
                struct.pack(">I",
                            (self.version << 24) | self.flags) +
                payload)

    def ilst_atom(self):
        for a in self.leaf_atoms:
            if a.name == b"ilst":
                return a
        return None

    def has_ilst_atom(self):
        return self.ilst_atom() is not None

    def _ilst_entry(self, name):
        ilst = self.ilst_atom()
        if ilst is None:
            return None
        for leaf in ilst.leaf_atoms:
            if leaf.name == name:
                return leaf
        return None

    def _trkn_pair(self, name):
        entry = self._ilst_entry(name)
        if entry is None or not isinstance(entry, M4A_ILST_Leaf_Atom):
            return (None, None)
        data = entry.data_atom()
        if data is None or len(data.data) < 14:
            return (None, None)
        (number, total) = struct.unpack(">HH", data.data[10:14])
        return (number if number else None, total if total else None)

    def __getattr__(self, attr):
        if attr in self.UNICODE_ATTRIB_TO_ILST:
            entry = self._ilst_entry(self.UNICODE_ATTRIB_TO_ILST[attr])
            if entry is not None and isinstance(entry,
                                               M4A_ILST_Leaf_Atom):
                text = str(entry)
                return text if text else None
            return None
        elif attr in self.INT_ATTRIB_TO_ILST:
            return self._trkn_pair(self.INT_ATTRIB_TO_ILST[attr])[0]
        elif attr in self.TOTAL_ATTRIB_TO_ILST:
            return self._trkn_pair(self.TOTAL_ATTRIB_TO_ILST[attr])[1]
        elif attr in MetaData.FIELDS:
            return None
        else:
            try:
                return self.__dict__[attr]
            except KeyError:
                raise AttributeError(attr)

    def _ensure_ilst(self):
        ilst = self.ilst_atom()
        if ilst is None:
            ilst = M4A_Tree_Atom(b"ilst", [])
            self.leaf_atoms.append(ilst)
        return ilst

    def __setattr__(self, attr, value):
        if attr in self.UNICODE_ATTRIB_TO_ILST:
            if value is None:
                delattr(self, attr)
                return
            ilst = self._ensure_ilst()
            name = self.UNICODE_ATTRIB_TO_ILST[attr]
            new_atom = ilst_string_atom(name, str(value))
            for (i, leaf) in enumerate(ilst.leaf_atoms):
                if leaf.name == name:
                    ilst.leaf_atoms[i] = new_atom
                    return
            ilst.leaf_atoms.append(new_atom)
        elif (attr in self.INT_ATTRIB_TO_ILST or
              attr in self.TOTAL_ATTRIB_TO_ILST):
            if attr in self.INT_ATTRIB_TO_ILST:
                name = self.INT_ATTRIB_TO_ILST[attr]
                (number, total) = self._trkn_pair(name)
                number = value
            else:
                name = self.TOTAL_ATTRIB_TO_ILST[attr]
                (number, total) = self._trkn_pair(name)
                total = value
            if (value is None and
                    (number is None) and (total is None)):
                delattr(self, attr)
                return
            ilst = self._ensure_ilst()
            new_atom = ilst_trkn_atom(name, number, total)
            for (i, leaf) in enumerate(ilst.leaf_atoms):
                if leaf.name == name:
                    ilst.leaf_atoms[i] = new_atom
                    return
            ilst.leaf_atoms.append(new_atom)
        else:
            self.__dict__[attr] = value

    def __delattr__(self, attr):
        ilst = self.ilst_atom()
        if ilst is None:
            if attr in MetaData.FIELDS:
                return
            try:
                del self.__dict__[attr]
            except KeyError:
                raise AttributeError(attr)
            return
        if attr in self.UNICODE_ATTRIB_TO_ILST:
            name = self.UNICODE_ATTRIB_TO_ILST[attr]
            ilst.leaf_atoms = [l for l in ilst.leaf_atoms
                               if l.name != name]
        elif attr in self.INT_ATTRIB_TO_ILST:
            name = self.INT_ATTRIB_TO_ILST[attr]
            (_number, total) = self._trkn_pair(name)
            if total is None:
                ilst.leaf_atoms = [l for l in ilst.leaf_atoms
                                   if l.name != name]
            else:
                self.replace_trkn(name, None, total)
        elif attr in self.TOTAL_ATTRIB_TO_ILST:
            name = self.TOTAL_ATTRIB_TO_ILST[attr]
            (number, _total) = self._trkn_pair(name)
            if number is None:
                ilst.leaf_atoms = [l for l in ilst.leaf_atoms
                                   if l.name != name]
            else:
                self.replace_trkn(name, number, None)
        elif attr in MetaData.FIELDS:
            pass
        else:
            try:
                del self.__dict__[attr]
            except KeyError:
                raise AttributeError(attr)

    def replace_trkn(self, name, number, total):
        ilst = self._ensure_ilst()
        new_atom = ilst_trkn_atom(name, number, total)
        for (i, leaf) in enumerate(ilst.leaf_atoms):
            if leaf.name == name:
                ilst.leaf_atoms[i] = new_atom
                return
        ilst.leaf_atoms.append(new_atom)

    def images(self):
        entry = self._ilst_entry(b"covr")
        if entry is None or not isinstance(entry, M4A_ILST_Leaf_Atom):
            return []
        data = entry.data_atom()
        if data is None:
            return []
        payload = data.data[8:]
        try:
            m = image_metrics(payload)
            return [Image(data=payload, mime_type=m.mime_type,
                          width=m.width, height=m.height,
                          color_depth=m.bits_per_pixel,
                          color_count=m.color_count,
                          description="", type=0)]
        except InvalidImage:
            return []

    def add_image(self, image):
        data_type = 13 if image.mime_type == "image/jpeg" else 14
        ilst = self._ensure_ilst()
        new_atom = ilst_binary_atom(b"covr", image.data, data_type)
        for (i, leaf) in enumerate(ilst.leaf_atoms):
            if leaf.name == b"covr":
                ilst.leaf_atoms[i] = new_atom
                return
        ilst.leaf_atoms.append(new_atom)

    def delete_image(self, image):
        ilst = self.ilst_atom()
        if ilst is not None:
            ilst.leaf_atoms = [leaf for leaf in ilst.leaf_atoms
                               if leaf.name != b"covr"]

    @classmethod
    def converted(cls, metadata):
        """converts a MetaData object to M4A_META_Atom"""
        if metadata is None:
            return None
        if isinstance(metadata, M4A_META_Atom):
            return metadata.copy()

        ilst = M4A_Tree_Atom(b"ilst", [])
        meta = cls(0, 0, [
            M4A_Leaf_Atom(b"hdlr",
                          b"\x00" * 8 + b"mdir" + b"appl" +
                          b"\x00" * 9),
            ilst,
            M4A_Leaf_Atom(b"free", b"\x00" * 1024)])
        for (attr, name) in cls.UNICODE_ATTRIB_TO_ILST.items():
            value = getattr(metadata, attr)
            if value is not None:
                ilst.leaf_atoms.append(ilst_string_atom(name,
                                                        str(value)))
        if ((metadata.track_number is not None) or
                (metadata.track_total is not None)):
            ilst.leaf_atoms.append(ilst_trkn_atom(
                b"trkn", metadata.track_number, metadata.track_total))
        if ((metadata.album_number is not None) or
                (metadata.album_total is not None)):
            ilst.leaf_atoms.append(ilst_trkn_atom(
                b"disk", metadata.album_number, metadata.album_total))
        ilst.leaf_atoms.append(ilst_string_atom(
            b"\xa9too", "tpu-audio-tools %s" % (VERSION,)))
        for image in metadata.images():
            meta.add_image(image)
        return meta

    def raw_info(self):
        from os import linesep
        lines = ["M4A meta:"]
        ilst = self.ilst_atom()
        if ilst is not None:
            for leaf in ilst.leaf_atoms:
                lines.append("%r = %s" % (leaf.name, leaf))
        return linesep.join(lines)
