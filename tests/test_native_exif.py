"""Native C++ EXIF parser (native/src/ingest.cpp tsfm_exif) against a
hand-constructed EXIF blob — focal, 35mm focal, GPS, make/model
(Exif_IO_EasyExif parity: sparseBuilder.cpp:389-465, getGPS .cpp:112)."""

import struct

import numpy as np
import pytest
from PIL import Image

from tpusfm.io import native_ingest


def _build_exif_tiff() -> bytes:
    """Little-endian TIFF with IFD0 {Make, Model, ExifIFD, GPSIFD},
    Exif IFD {FocalLength 23.5mm, FocalLengthIn35mm 35}, GPS IFD
    {48°51'29.6"N, 2°17'40.2"E, alt 35.4m}."""
    def entry(tag, typ, count, value_bytes, data_area, base_len):
        if len(value_bytes) <= 4:
            val = value_bytes + b"\x00" * (4 - len(value_bytes))
        else:
            off = base_len + sum(len(d) for d in data_area)
            data_area.append(value_bytes)
            val = struct.pack("<I", off)
        return struct.pack("<HHI", tag, typ, count) + val

    def rational(num, den):
        return struct.pack("<II", num, den)

    def ifd(entries_spec, ifd_off):
        # entries_spec: list of (tag, type, count, raw_value_bytes)
        n = len(entries_spec)
        base_len = ifd_off + 2 + n * 12 + 4  # entries + next-IFD pointer
        data_area: list[bytes] = []
        body = struct.pack("<H", n)
        for tag, typ, count, vb in entries_spec:
            body += entry(tag, typ, count, vb, data_area, base_len)
        body += struct.pack("<I", 0)
        return body + b"".join(data_area), base_len + sum(len(d) for d in data_area)

    header = b"II" + struct.pack("<HI", 42, 8)

    # Build inner IFDs first to learn their offsets; two-pass for simplicity.
    make = b"SfmCam\x00"
    model = b"ModelX100\x00"
    # Pass 1: assume offsets, compute sizes.
    ifd0_entries = lambda exif_off, gps_off: [
        (0x010F, 2, len(make), make),
        (0x0110, 2, len(model), model),
        (0x8769, 4, 1, struct.pack("<I", exif_off)),
        (0x8825, 4, 1, struct.pack("<I", gps_off)),
    ]
    ifd0_probe, end0 = ifd(ifd0_entries(0, 0), 8)
    exif_off = 8 + len(ifd0_probe)
    exif_entries = [
        (0x920A, 5, 1, rational(235, 10)),   # 23.5 mm
        (0xA405, 3, 1, struct.pack("<H", 35)),
    ]
    exif_ifd, _ = ifd(exif_entries, exif_off)
    gps_off = exif_off + len(exif_ifd)
    gps_entries = [
        (1, 2, 2, b"N\x00"),
        (2, 5, 3, rational(48, 1) + rational(51, 1) + rational(296, 10)),
        (3, 2, 2, b"E\x00"),
        (4, 5, 3, rational(2, 1) + rational(17, 1) + rational(402, 10)),
        (5, 1, 1, b"\x00"),
        (6, 5, 1, rational(354, 10)),
    ]
    gps_ifd, _ = ifd(gps_entries, gps_off)
    ifd0, _ = ifd(ifd0_entries(exif_off, gps_off), 8)
    assert len(ifd0) == len(ifd0_probe)
    return header + ifd0 + exif_ifd + gps_ifd


@pytest.fixture()
def jpeg_with_exif(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)
    path = tmp_path / "exif.jpg"
    Image.fromarray(arr).save(path, "JPEG", exif=b"Exif\x00\x00" + _build_exif_tiff())
    return path


def test_native_exif(jpeg_with_exif):
    if not native_ingest.available():
        pytest.skip("native library unavailable")
    info = native_ingest.exif_info(jpeg_with_exif)
    assert info is not None
    assert info["focal_mm"] == pytest.approx(23.5)
    assert info["focal_35mm"] == 35
    lat, lon, alt = info["gps"]
    assert lat == pytest.approx(48 + 51 / 60 + 29.6 / 3600, abs=1e-9)
    assert lon == pytest.approx(2 + 17 / 60 + 40.2 / 3600, abs=1e-9)
    assert alt == pytest.approx(35.4)
    assert info["make"] == "SfmCam"
    assert info["model"] == "ModelX100"


def test_native_exif_none_for_plain_jpeg(tmp_path):
    if not native_ingest.available():
        pytest.skip("native library unavailable")
    path = tmp_path / "plain.jpg"
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(path, "JPEG")
    assert native_ingest.exif_info(path) is None
    # Non-JPEG input is rejected cleanly.
    png = tmp_path / "x.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(png, "PNG")
    assert native_ingest.exif_info(png) is None


def test_image_record_uses_native_exif(jpeg_with_exif):
    """io.images focal-prior path consumes the native EXIF values
    (focal = max(w,h) * f_mm / ccd_mm, sparseBuilder.cpp:455)."""
    if not native_ingest.available():
        pytest.skip("native library unavailable")
    from tpusfm.io import images as im_io

    db = {"sfmcam modelx100": 7.6}
    rec = im_io.read_image_record(jpeg_with_exif, sensor_db=db)
    assert rec.camera_model == "SfmCam ModelX100"
    assert rec.focal_px == pytest.approx(max(96, 64) * 23.5 / 7.6, rel=1e-6)
    assert rec.gps is not None and rec.gps[0] == pytest.approx(48.858, abs=1e-3)
