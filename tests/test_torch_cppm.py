"""The port's CPPM module against the reference's, on synthetic key
material (the C2 S-boxes and device keys are licensed and not shipped):
the C2 cipher's enc, dec, G and D-CBC forms, MKB processing and the
pack descramble give the reference's values and bytes, and the key
loaders and the drive gate raise what the reference raises."""

import struct

import numpy as np
import pytest

from audiotools_tpu import cppm as ref_cppm
from audiotools_tpu_torch import cppm
from torch_dvda_helpers import synthetic_cipher


def ciphers(seed=5):
    port = synthetic_cipher(seed)
    return (port, ref_cppm.C2Cipher(port.sbox, port.sbox_f))


@pytest.mark.parametrize("seed", [5, 17, 29])
def test_c2_block_forms_are_the_references(seed):
    (port, ref) = ciphers(seed)
    rng = np.random.default_rng(seed + 1)
    for _ in range(40):
        code = int(rng.integers(0, 1 << 63))
        key = int(rng.integers(0, 1 << 56))
        assert port.enc(code, key) == ref.enc(code, key)
        assert port.dec(code, key) == ref.dec(code, key)
        assert port.g(code, key) == ref.g(code, key)
        assert port.dec(port.enc(code, key), key) == code


@pytest.mark.parametrize("length", [8, 16, 64, 1920, 13])
def test_dcbc_is_the_references(length):
    (port, ref) = ciphers(11)
    rng = np.random.default_rng(length)
    key = int(rng.integers(0, 1 << 56))
    data = bytes(rng.integers(0, 256, length, dtype=np.uint8))
    sealed = port.dcbc_enc(data, key)
    assert sealed == ref.dcbc_enc(data, key)
    assert port.dcbc_dec(sealed, key) == ref.dcbc_dec(sealed, key)
    assert port.dcbc_dec(data, key) == ref.dcbc_dec(data, key)
    if length % 8 == 0:
        assert port.dcbc_dec(sealed, key) == data


def test_short_sboxes_are_refused_as_the_reference_refuses_them():
    with pytest.raises(ValueError) as port:
        cppm.C2Cipher([0] * 255, [0] * 256)
    with pytest.raises(ValueError) as ref:
        ref_cppm.C2Cipher([0] * 255, [0] * 256)
    assert str(port.value) == str(ref.value)


def mkb_records(cipher, media_key, dev, rng):
    def record(rtype, payload):
        return bytes([rtype]) + (len(payload) + 4).to_bytes(3, "big") + \
            payload
    verification = cipher.enc((0xDEADBEEF << 32) | 0x12345678, media_key)
    entry = cipher.enc(media_key ^ ((dev.col << 32) | dev.row), dev.key)
    rows = [int(rng.integers(0, 1 << 63)) for _ in range(4)]
    rows[dev.row] = entry
    table = ((dev.col << 24) | 1).to_bytes(8, "big") + b"".join(
        r.to_bytes(8, "big") for r in rows)
    return (record(0x81, verification.to_bytes(8, "big")) +
            record(0x01, table) + record(0x02, b"\x00" * 8))


@pytest.mark.parametrize("col,row,other", [(3, 2, 9), (0, 0, 4), (7, 3, 1)])
def test_mkb_processing_is_the_references(tmp_path, col, row, other):
    (port, ref) = ciphers(13)
    rng = np.random.default_rng(col * 10 + row)
    media_key = int(rng.integers(0, 1 << 56))
    key = int(rng.integers(0, 1 << 56))
    mkb = mkb_records(port, media_key, cppm.DeviceKey(col, row, key), rng)
    got = cppm.process_mkb(mkb, [cppm.DeviceKey(col, row, key)], port)
    assert got == media_key == ref_cppm.process_mkb(
        mkb, [ref_cppm.DeviceKey(col, row, key)], ref)
    path = str(tmp_path / "DVDAUDIO.MKB")
    with open(path, "wb") as f:
        f.write(b"DVDAUDIO.MKB" + struct.pack(">I", len(mkb)) + mkb)
    assert cppm.read_mkb(path) == ref_cppm.read_mkb(path) == mkb
    # a device of another column unlocks nothing, in both
    assert cppm.process_mkb(mkb, [cppm.DeviceKey(other, 0, 42)],
                            port) is None
    assert ref_cppm.process_mkb(mkb, [ref_cppm.DeviceKey(other, 0, 42)],
                                ref) is None
    with open(path, "wb") as f:
        f.write(b"NOTANMKBFILE" + struct.pack(">I", 4))
    with pytest.raises(ValueError) as port_err:
        cppm.read_mkb(path)
    with pytest.raises(ValueError) as ref_err:
        ref_cppm.read_mkb(path)
    assert str(port_err.value) == str(ref_err.value)


def scrambled_pack(cipher, media_key, id_album, rng):
    pack = bytearray(rng.integers(0, 256, cppm.BLOCK_SIZE, dtype=np.uint8))
    pack[0:4] = b"\x00\x00\x01\xba"
    pack[20] = (pack[20] & 0xCF) | 0x10
    k_i = cipher.g(id_album, media_key) & cppm.MASK56
    for offset in (24, 32, 40, 48):
        k_i = cipher.g(int.from_bytes(pack[offset:offset + 8], "big"),
                       k_i) & cppm.MASK56
    k_c = cipher.g(int.from_bytes(pack[84:92], "big"), k_i) & cppm.MASK56
    start = cppm.BLOCK_SIZE - cppm.ENCRYPTED_SIZE
    pack[start:] = cipher.dcbc_enc(bytes(pack[start:]), k_c)
    return bytes(pack)


@pytest.mark.parametrize("preserve_cci", [True, False])
def test_decrypt_block_is_the_references(preserve_cci):
    (port, ref) = ciphers(17)
    rng = np.random.default_rng(19)
    media_key = int(rng.integers(0, 1 << 56))
    id_album = int(rng.integers(0, 1 << 63))
    decoder = cppm.CPPMDecoder(media_key, id_album, port)
    ref_decoder = ref_cppm.CPPMDecoder(media_key, id_album, ref)
    packs = [scrambled_pack(port, media_key, id_album, rng)
             for _ in range(3)]
    clear = bytearray(packs[1])
    clear[20] &= 0xCF
    packs.append(bytes(clear))
    for pack in packs:
        got = decoder.decrypt_block(pack, preserve_cci=preserve_cci)
        assert got == ref_decoder.decrypt_block(pack,
                                                preserve_cci=preserve_cci)
        assert cppm.pes_scrambling_control(got[0]) == 0
    whole = b"".join(packs)
    assert decoder.decrypt(whole, preserve_cci) == ref_decoder.decrypt(
        whole, preserve_cci)
    assert decoder.decrypt(whole, preserve_cci)[1] == 3
    with pytest.raises(ValueError) as port_err:
        decoder.decrypt_block(packs[0][:100])
    with pytest.raises(ValueError) as ref_err:
        ref_decoder.decrypt_block(packs[0][:100])
    assert str(port_err.value) == str(ref_err.value)


def raised(fn):
    try:
        fn()
    except Exception as err:  # noqa: BLE001 - compared by the caller
        return (type(err).__name__, str(err))
    return None


def test_key_loaders_and_the_drive_gate_raise_what_the_reference_raises(
        tmp_path, monkeypatch):
    monkeypatch.delenv("ATPU_CPPM_SBOX", raising=False)
    monkeypatch.delenv("ATPU_CPPM_DEVICE_KEYS", raising=False)
    for name in ("load_sbox", "load_device_keys"):
        port = raised(getattr(cppm, name))
        assert port == raised(getattr(ref_cppm, name))
        assert port[0] == "CPPMKeyMaterialError"
    port = raised(lambda: cppm.authenticate_drive("/dev/dvd"))
    assert port == raised(lambda: ref_cppm.authenticate_drive("/dev/dvd"))
    assert port[0] == "NotImplementedError"
    # a decoder with no cipher loads the S-boxes: absent, it raises
    assert raised(lambda: cppm.CPPMDecoder(1, 2)) == raised(
        lambda: ref_cppm.CPPMDecoder(1, 2))

    short = str(tmp_path / "short.bin")
    with open(short, "wb") as f:
        f.write(b"\x00" * 1000)
    assert raised(lambda: cppm.load_sbox(short)) == raised(
        lambda: ref_cppm.load_sbox(short))
    rng = np.random.default_rng(23)
    sbox_path = str(tmp_path / "sbox.bin")
    with open(sbox_path, "wb") as f:
        f.write(bytes(rng.integers(0, 256, 1280, dtype=np.uint8)))
    monkeypatch.setenv("ATPU_CPPM_SBOX", sbox_path)
    assert cppm.load_sbox() == ref_cppm.load_sbox()
    keys_path = str(tmp_path / "keys.txt")
    with open(keys_path, "w") as f:
        f.write("# col row key\n3 2 0123456789ABCD\n\n1 0 ff\n")
    monkeypatch.setenv("ATPU_CPPM_DEVICE_KEYS", keys_path)
    assert [(k.col, k.row, k.key) for k in cppm.load_device_keys()] == [
        (k.col, k.row, k.key) for k in ref_cppm.load_device_keys()] == [
            (3, 2, 0x0123456789ABCD), (1, 0, 0xFF)]
