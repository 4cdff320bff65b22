"""CPPM (Content Protection for Prerecorded Media) for DVD-Audio.

A copy of the reference package's ``cppm.py``: the C2 block cipher
(10-round Feistel with a 17-bit-rotating key schedule), the C2_G
one-way function, the D-CBC sector mode, DVDAUDIO.MKB media-key-block
processing, and the per-block key ladder and PES descramble.

Two classes of input are NOT shipped, by design:

* the C2 substitution boxes and player device keys are 4C
  Entity-licensed secrets; they load at run time from the files that
  ``ATPU_CPPM_SBOX`` / ``ATPU_CPPM_DEVICE_KEYS`` name, so the
  capability exists without redistributing licensed key material
* the physical drive authentication (AGID bus-key exchange +
  READ DISC KEY ioctls) requires DVD hardware and raises cleanly when
  no drive access exists (``authenticate_drive``)

The cipher structure is S-box-independent: the tests run it with
synthetic S-boxes and device keys.
"""

from __future__ import annotations

import os
import struct

BLOCK_SIZE = 2048              # one PS pack (DVDCPXM_BLOCK_SIZE)
ENCRYPTED_SIZE = 1920          # encrypted payload per pack
MASK56 = (1 << 56) - 1
MASK32 = 0xFFFFFFFF


class CPPMKeyMaterialError(Exception):
    """raised when the licensed S-boxes / device keys are absent"""


def _rol32(code, n):
    return ((code << n) | (code >> (32 - n))) & MASK32


class C2Cipher:
    """the C2 block cipher (reference cppm.c:291-332, 436-514)

    sbox: 256 ints (key-schedule substitution)
    sbox_f: 256 ints (round-function substitution, 32-bit values)"""

    def __init__(self, sbox, sbox_f):
        if len(sbox) != 256 or len(sbox_f) != 256:
            raise ValueError("C2 S-boxes must have 256 entries each")
        self.sbox = list(sbox)
        self.sbox_f = list(sbox_f)

    def _f(self, code, key):
        work = (code + key) & MASK32
        work ^= self.sbox_f[work & 0xFF]
        work ^= _rol32(work, 9) ^ _rol32(work, 22)
        return work & MASK32

    def _schedule(self, key, rounds=10):
        ka = (key >> 32) & 0x00FFFFFF
        kb = key & MASK32
        sk = []
        for rnd in range(rounds):
            ka &= 0x00FFFFFF
            sk.append((kb + (self.sbox[(ka & 0xFF) ^ rnd] << 4)) &
                      MASK32)
            kc = kb >> (32 - 17)
            kd = ka >> (24 - 17)
            ka = ((ka << 17) | kc) & MASK32
            kb = ((kb << 17) | kd) & MASK32
        return sk

    def enc(self, code, key):
        """encrypts one 64-bit block"""
        left = (code >> 32) & MASK32
        right = code & MASK32
        sk = self._schedule(key)
        for rnd in range(10):
            left = (left + self._f(right, sk[rnd])) & MASK32
            (left, right) = (right, left)
        (left, right) = (right, left)
        return (left << 32) | right

    def dec(self, code, key):
        """decrypts one 64-bit block"""
        left = (code >> 32) & MASK32
        right = code & MASK32
        sk = self._schedule(key)
        for rnd in range(9, -1, -1):
            left = (left - self._f(right, sk[rnd])) & MASK32
            (left, right) = (right, left)
        (left, right) = (right, left)
        return (left << 32) | right

    def g(self, code, key):
        """the C2 one-way function G (reference cppm.c:465)"""
        return self.enc(code, key) ^ code

    def dcbc_dec(self, data, key):
        """D-CBC decryption of a byte buffer (reference cppm.c:471):
        the first block runs all 10 key-schedule rounds, later blocks
        only 2, and the chain key is re-derived mid-block from the
        round-5 state"""
        out = bytearray(len(data))
        inkey = key
        key_round = 10
        for pos in range(0, len(data) - 7, 8):
            inout = int.from_bytes(data[pos:pos + 8], "big")
            left = (inout >> 32) & MASK32
            right = inout & MASK32
            sk = self._schedule(inkey, key_round)
            for rnd in range(9, -1, -1):
                left = (left - self._f(right, sk[rnd % key_round])) \
                    & MASK32
                (left, right) = (right, left)
                if rnd == 5:
                    inkey = key ^ (((right & 0x00FFFFFF) << 32) | left)
            (left, right) = (right, left)
            out[pos:pos + 8] = (((left << 32) | right)
                                .to_bytes(8, "big"))
            key_round = 2
        return bytes(out)

    def _chain_key(self, cipher_int, sk, key_round, key):
        """replays the decrypt recurrence far enough to sample the
        chain key exactly as dcbc_dec's round-5 hook does"""
        left = (cipher_int >> 32) & MASK32
        right = cipher_int & MASK32
        for rnd in range(9, 4, -1):
            left = (left - self._f(right, sk[rnd % key_round])) \
                & MASK32
            (left, right) = (right, left)
            if rnd == 5:
                return key ^ (((right & 0x00FFFFFF) << 32) | left)
        raise AssertionError("unreachable")

    def dcbc_enc(self, data, key):
        """D-CBC encryption (the inverse pipeline; the reference only
        decrypts, but the encryptor is what lets the test suite build
        its own protected packs)"""
        out = bytearray(len(data))
        inkey = key
        key_round = 10
        for pos in range(0, len(data) - 7, 8):
            inout = int.from_bytes(data[pos:pos + 8], "big")
            sk = self._schedule(inkey, key_round)
            # inverse of the dec loop: undo the final swap, then
            # apply the inverse rounds in 0..9 order
            left = inout & MASK32          # swapped plain halves
            right = (inout >> 32) & MASK32
            for rnd in range(10):
                (left, right) = ((right + self._f(
                    left, sk[rnd % key_round])) & MASK32, left)
            cipher_int = (left << 32) | right
            out[pos:pos + 8] = cipher_int.to_bytes(8, "big")
            inkey = self._chain_key(cipher_int, sk, key_round, key)
            key_round = 2
        return bytes(out)


def load_sbox(path=None):
    """loads the licensed C2 S-boxes from a file: 256 bytes of the
    key-schedule S-box followed by 256 big-endian 32-bit round S-box
    entries (1280 bytes total).  The path defaults to the
    ATPU_CPPM_SBOX environment variable."""
    if path is None:
        path = os.environ.get("ATPU_CPPM_SBOX")
    if path is None or not os.path.isfile(path):
        raise CPPMKeyMaterialError(
            "the C2 S-boxes are licensed key material and are not "
            "distributed with this build; point ATPU_CPPM_SBOX at a "
            "1280-byte S-box file to enable CPPM decryption")
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 256 + 1024:
        raise CPPMKeyMaterialError("S-box file too short")
    sbox = list(data[0:256])
    sbox_f = [int.from_bytes(data[256 + i * 4:260 + i * 4], "big")
              for i in range(256)]
    return (sbox, sbox_f)


def load_device_keys(path=None):
    """loads player device keys: lines of ``column row key_hex``
    (ATPU_CPPM_DEVICE_KEYS environment variable by default)"""
    if path is None:
        path = os.environ.get("ATPU_CPPM_DEVICE_KEYS")
    if path is None or not os.path.isfile(path):
        raise CPPMKeyMaterialError(
            "CPPM device keys are licensed key material and are not "
            "distributed with this build; point ATPU_CPPM_DEVICE_KEYS "
            "at a key list to enable CPPM decryption")
    keys = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            (col, row, key_hex) = line.split()
            keys.append(DeviceKey(int(col), int(row),
                                  int(key_hex, 16)))
    return keys


class DeviceKey:
    def __init__(self, col, row, key):
        self.col = col
        self.row = row
        self.key = key


def read_mkb(path):
    """reads a DVDAUDIO.MKB file's record area (reference
    cppm.c:264-290): a 12-byte signature, a 32-bit big-endian size,
    then the records"""
    with open(path, "rb") as f:
        signature = f.read(12)
        if signature != b"DVDAUDIO.MKB":
            raise ValueError("invalid MKB signature")
        (size,) = struct.unpack(">I", f.read(4))
        data = f.read(size)
        if len(data) != size:
            raise ValueError("truncated MKB")
    return data


def process_mkb(mkb, device_keys, cipher):
    """walks the MKB records to recover the media key (reference
    cppm.c:336-415): record 0x81 carries verification data, records
    0x01/0x82 carry per-column encrypted key tables, and a candidate
    media key verifies when decrypting the verification data yields
    the 0xDEADBEEF sentinel.  returns the 56-bit media key."""
    i_dev_key = 0
    media_key = 0
    verification_data = 0
    while i_dev_key < len(device_keys):
        pos = 0
        advanced = False
        while pos + 4 <= len(mkb):
            record_type = mkb[pos]
            length = int.from_bytes(mkb[pos:pos + 4], "big") \
                & 0x00FFFFFF
            if length >= 12:
                buffer = int.from_bytes(mkb[pos + 4:pos + 12], "big")
            else:
                buffer = 0
                if length < 4:
                    length = 4
            if record_type in (0x01, 0x82):
                if record_type == 0x82:
                    probe = cipher.dec(buffer, media_key)
                    if (probe >> 32) != 0xDEADBEEF:
                        pos += length
                        continue
                column = (buffer >> 24) & 0xFF
                match = None
                for i in range(i_dev_key, len(device_keys)):
                    if device_keys[i].col == column:
                        match = i
                        break
                if match is None:
                    return None
                i_dev_key = match
                dev = device_keys[i_dev_key]
                entry_off = pos + 12 + dev.row * 8
                if entry_off + 8 > pos + length:
                    pos += length
                    continue
                entry = int.from_bytes(mkb[entry_off:entry_off + 8],
                                       "big")
                if record_type == 0x82:
                    entry = cipher.dec(entry, media_key)
                media_key = ((cipher.dec(entry, dev.key) & MASK56) ^
                             ((column << 32) | dev.row))
                probe = cipher.dec(verification_data, media_key)
                if (probe >> 32) == 0xDEADBEEF:
                    return media_key
            elif record_type == 0x02:      # end of media key records
                break
            elif record_type == 0x81:      # verification data
                verification_data = buffer
            pos += length
            advanced = True
        if not advanced:
            break
        i_dev_key += 1
    return None


def pes_scrambling_control(block):
    """returns the pack's PES scrambling-control bits (reference
    cppm.c:553)"""
    if block[0:4] == b"\x00\x00\x01\xba":
        return (block[20] & 0x30) >> 4
    return 0


class CPPMDecoder:
    """decrypts CPPM-protected DVD-Audio PS packs (reference
    cppm.c:516-551)

    id_album_media and media_key come either from the hardware
    authentication path (absent here — see authenticate_drive) or
    directly, e.g. from a prior rip session's notes."""

    def __init__(self, media_key, id_album_media, cipher=None):
        if cipher is None:
            cipher = C2Cipher(*load_sbox())
        self.cipher = cipher
        self.media_key = media_key
        self.id_album_media = id_album_media

    @classmethod
    def from_files(cls, mkb_path, id_album_media, device_keys=None,
                   cipher=None):
        """builds a decoder from a DVDAUDIO.MKB file (the disc's key
        block) plus the album ID the drive reports"""
        if cipher is None:
            cipher = C2Cipher(*load_sbox())
        if device_keys is None:
            device_keys = load_device_keys()
        media_key = process_mkb(read_mkb(mkb_path), device_keys,
                                cipher)
        if media_key is None:
            raise ValueError("no device key unlocks this MKB")
        return cls(media_key, id_album_media, cipher)

    def decrypt_block(self, block, preserve_cci=False):
        """decrypts one 2048-byte pack in place semantics (returns
        the new bytes and whether it was encrypted)"""
        if len(block) != BLOCK_SIZE:
            raise ValueError("CPPM packs are %d bytes" % (BLOCK_SIZE,))
        block = bytearray(block)
        encrypted = False
        if pes_scrambling_control(block):
            # the per-block key ladder: album key from the media key,
            # folded over four 8-byte samples of the pack header plus
            # one of the payload preamble
            k_au = self.cipher.g(self.id_album_media,
                                 self.media_key) & MASK56
            k_i = k_au
            for offset in (24, 32, 40, 48):
                d_kc = int.from_bytes(block[offset:offset + 8], "big")
                k_i = self.cipher.g(d_kc, k_i) & MASK56
            d_kc = int.from_bytes(block[84:92], "big")
            k_c = self.cipher.g(d_kc, k_i) & MASK56
            start = BLOCK_SIZE - ENCRYPTED_SIZE
            block[start:] = self.cipher.dcbc_dec(
                bytes(block[start:]), k_c)
            block[20] &= 0xCF              # clear scrambling control
            encrypted = True
        if not preserve_cci:
            # reset the CCI byte like the reference (cppm.c:567)
            if block[0:4] == b"\x00\x00\x01\xba":
                block[86] = 0x00
        return (bytes(block), encrypted)

    def decrypt(self, buffer, preserve_cci=False):
        """decrypts a run of packs; returns (bytes, encrypted_count)"""
        out = bytearray()
        encrypted = 0
        for pos in range(0, len(buffer), BLOCK_SIZE):
            (block, was_encrypted) = self.decrypt_block(
                buffer[pos:pos + BLOCK_SIZE], preserve_cci)
            out += block
            encrypted += int(was_encrypted)
        return (bytes(out), encrypted)


def authenticate_drive(device_path):
    """the drive-side album-ID handshake (reference cppm.c:240-262
    over ioctl.c:2120 REPORT KEY / READ DISC KEY exchanges)

    requires a physical DVD drive and kernel MMC ioctl access, which
    the port does not implement; the reference package raises the same
    error."""
    raise NotImplementedError(
        "DVD drive authentication requires hardware MMC ioctl "
        "access; rip the disc's DVDAUDIO.MKB and album ID on a "
        "machine with a drive, then use CPPMDecoder.from_files")
