"""Image metrics: the size, depth and type of an image from the header
of its bytes, without decoding pixels.

A copy of the reference's ``audiotools_tpu/meta/image.py``: parsers for
JPEG, PNG, BMP, GIF and TIFF.
"""

from __future__ import annotations

import struct


class InvalidImage(Exception):
    """raised if an image cannot be parsed correctly"""

    def __init__(self, err):
        self.err = str(err)

    def __str__(self):
        return self.err


class __ImageMetrics__:
    def __init__(self, width, height, bits_per_pixel, color_count,
                 mime_type):
        self.width = width
        self.height = height
        self.bits_per_pixel = bits_per_pixel
        self.color_count = color_count
        self.mime_type = mime_type

    def __repr__(self):
        return ("ImageMetrics(%r, %r, %r, %r, %r)" %
                (self.width, self.height, self.bits_per_pixel,
                 self.color_count, self.mime_type))


def image_metrics(data):
    """returns an ImageMetrics subclass from raw image bytes

    raises InvalidImage if the file cannot be parsed correctly"""
    header = data[0:8]

    if header[0:2] == b"\xff\xd8":
        return __JPEG__.parse(data)
    elif header == b"\x89PNG\r\n\x1a\n":
        return __PNG__.parse(data)
    elif header[0:4] == b"GIF8":
        return __GIF__.parse(data)
    elif header[0:2] == b"BM":
        return __BMP__.parse(data)
    elif header[0:4] in (b"II*\x00", b"MM\x00*"):
        return __TIFF__.parse(data)
    else:
        raise InvalidImage("unknown image type")


class __JPEG__(__ImageMetrics__):
    def __init__(self, width, height, bits_per_pixel):
        __ImageMetrics__.__init__(self, width, height, bits_per_pixel,
                                  0, "image/jpeg")

    @classmethod
    def parse(cls, data):
        try:
            pos = 2
            while pos < len(data):
                if data[pos] != 0xFF:
                    pos += 1
                    continue
                marker = data[pos + 1]
                if marker in (0xD8, 0xD9, 0x01) or 0xD0 <= marker <= 0xD7:
                    pos += 2
                    continue
                length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
                if marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7,
                              0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
                    (precision, height, width, components) = \
                        struct.unpack(">BHHB", data[pos + 4:pos + 10])
                    return cls(width, height, precision * components)
                pos += 2 + length
            raise InvalidImage("no start-of-frame found")
        except (struct.error, IndexError) as err:
            raise InvalidImage(str(err))


class __PNG__(__ImageMetrics__):
    def __init__(self, width, height, bits_per_pixel, color_count):
        __ImageMetrics__.__init__(self, width, height, bits_per_pixel,
                                  color_count, "image/png")

    @classmethod
    def parse(cls, data):
        try:
            pos = 8
            ihdr = None
            plte_size = 0
            while pos + 8 <= len(data):
                (length, chunk_type) = struct.unpack(
                    ">I4s", data[pos:pos + 8])
                if chunk_type == b"IHDR":
                    ihdr = data[pos + 8:pos + 8 + length]
                elif chunk_type == b"PLTE":
                    plte_size = length
                elif chunk_type == b"IDAT":
                    break
                pos += 8 + length + 4
            if ihdr is None:
                raise InvalidImage("no IHDR chunk found")
            (width, height, bit_depth, color_type) = struct.unpack(
                ">IIBB", ihdr[0:10])
            if color_type == 0:       # grayscale
                bits_per_pixel = bit_depth
                color_count = 0
            elif color_type == 2:     # RGB
                bits_per_pixel = bit_depth * 3
                color_count = 0
            elif color_type == 3:     # palette
                bits_per_pixel = 8
                if (plte_size % 3) != 0:
                    raise InvalidImage("invalid PLTE chunk length")
                color_count = plte_size // 3
            elif color_type == 4:     # grayscale + alpha
                bits_per_pixel = bit_depth * 2
                color_count = 0
            elif color_type == 6:     # RGB + alpha
                bits_per_pixel = bit_depth * 4
                color_count = 0
            else:
                raise InvalidImage("unknown PNG color type")
            return cls(width, height, bits_per_pixel, color_count)
        except (struct.error, IndexError) as err:
            raise InvalidImage(str(err))


class __BMP__(__ImageMetrics__):
    def __init__(self, width, height, bits_per_pixel, color_count):
        __ImageMetrics__.__init__(self, width, height, bits_per_pixel,
                                  color_count, "image/x-ms-bmp")

    @classmethod
    def parse(cls, data):
        try:
            (width, height, planes, bits_per_pixel,
             compression, image_size, x_res, y_res,
             colors_used, important) = struct.unpack(
                 "<iiHHIIiiII", data[18:54])
            return cls(abs(width), abs(height), bits_per_pixel,
                       colors_used)
        except (struct.error, IndexError) as err:
            raise InvalidImage(str(err))


class __GIF__(__ImageMetrics__):
    def __init__(self, width, height, color_count):
        __ImageMetrics__.__init__(self, width, height, 8, color_count,
                                  "image/gif")

    @classmethod
    def parse(cls, data):
        try:
            (width, height, flags) = struct.unpack("<HHB", data[6:11])
            color_count = 2 ** ((flags & 0x7) + 1)
            return cls(width, height, color_count)
        except (struct.error, IndexError) as err:
            raise InvalidImage(str(err))


class __TIFF__(__ImageMetrics__):
    def __init__(self, width, height, bits_per_pixel, color_count):
        __ImageMetrics__.__init__(self, width, height, bits_per_pixel,
                                  color_count, "image/tiff")

    @classmethod
    def parse(cls, data):
        try:
            if data[0:2] == b"II":
                endian = "<"
            else:
                endian = ">"
            offset = struct.unpack(endian + "I", data[4:8])[0]
            width = height = 0
            bits_per_pixel = 0
            color_count = 0
            while offset:
                count = struct.unpack(endian + "H",
                                      data[offset:offset + 2])[0]
                for i in range(count):
                    entry = data[offset + 2 + i * 12:
                                 offset + 2 + (i + 1) * 12]
                    (tag, ftype, n) = struct.unpack(endian + "HHI",
                                                    entry[0:8])
                    if ftype == 3:      # SHORT
                        value = struct.unpack(endian + "H",
                                              entry[8:10])[0]
                    else:
                        value = struct.unpack(endian + "I",
                                              entry[8:12])[0]
                    if tag == 0x0100:
                        width = value
                    elif tag == 0x0101:
                        height = value
                    elif tag == 0x0102:
                        bits_per_pixel = value
                    elif tag == 0x0140:
                        color_count = n // 3
                pos = offset + 2 + count * 12
                offset = struct.unpack(endian + "I",
                                       data[pos:pos + 4])[0]
            return cls(width, height, bits_per_pixel, color_count)
        except (struct.error, IndexError) as err:
            raise InvalidImage(str(err))
